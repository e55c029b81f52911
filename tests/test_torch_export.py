"""The port's export (bin/export_model.py, runtime/exported_model.py)
against the JAX package's at a tiny width, on the same weights: the
exported chunk step, full encoder and rescoring decoder against the JAX
package's `forward_encoder_chunk` + `ctc_activation`, `forward_encoder`
and `forward_attention_decoder`; `export_meta.json` against the JAX
export's; a save/load round trip in a process without jax; and
`ExportedAsrDecoder` against the JAX package's `ExportedAsrDecoder` and
the port's own `AsrDecoder` (the holds that need no exported flagship
are in tests/test_torch_export_plain.py).  K1 is the registered operator
`wenet_tpu_torch::relpos_attention_fwd`, one node per rel-pos block.

Bars: every exported output within 2e-4 of JAX (the torch-import bar);
the exported chunk step equal to the port's eager step bit for bit (the
same operator on the same inputs); decoders' sentences identical and
scores within 2e-4, the rescored final within 2e-3 absolute / 1e-5
relative (as tests/test_torch_runtime.py holds it)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_runtime import OPTS, SYMS, _same, _stream, _wave
from torch_port_utils import IDIM, jax_model, tiny_config, torch_model

ATOL = 2e-4
EXPORT_ARGS = ['--chunk_size', '4', '--num_left_chunks', '2', '--beam', '3',
               '--max_hyp_len', '16', '--reverse_weight', '0.3']
OP = 'wenet_tpu_torch.relpos_attention_fwd'


@pytest.fixture(autouse=True)
def numpy_fbank(request, monkeypatch):
    """The JAX package's feature pipeline on its numpy fbank (the one the
    port copies), not its C++ one (not for the card's test, which runs
    where there is no JAX)."""
    if request.node.get_closest_marker('cuda'):
        return
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """Both packages' exports of one tiny U2++ model: (JAX model,
    variables, the port's eager model, the port's export dir, the JAX
    package's export dir)."""
    from wenet_tpu.bin.export_model import main as jax_main
    from wenet_tpu.utils.checkpoint import (save_checkpoint,
                                            save_torch_checkpoint)
    from wenet_tpu_torch.bin.export_model import main
    d = tmp_path_factory.mktemp('export')
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=31)
    (d / 'train.yaml').write_text(yaml.safe_dump(cfg))
    save_torch_checkpoint(variables, str(d / 'final.pt'))
    save_checkpoint(variables, str(d / 'jax_ckpt'))
    main(['--config', str(d / 'train.yaml'), '--checkpoint',
          str(d / 'final.pt'), '--output_dir', str(d / 'port'),
          '--device', 'cpu', *EXPORT_ARGS])
    jax_main(['--config', str(d / 'train.yaml'), '--checkpoint',
              str(d / 'jax_ckpt'), '--output_dir', str(d / 'jax'),
              *EXPORT_ARGS])
    return (model, variables, torch_model(cfg, variables), d / 'port',
            d / 'jax')


def _exported_model(exported):
    from wenet_tpu_torch.runtime.exported_model import ExportedAsrModel
    return ExportedAsrModel(str(exported[3]), device='cpu')


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _op_nodes(program):
    return sum(1 for n in program.graph.nodes
               if n.op == 'call_function' and OP in str(n.target))


def test_op_once_per_rel_pos_block(exported):
    from wenet_tpu_torch.runtime.exported_model import load_program
    d = exported[3]
    blocks = tiny_config()['encoder_conf']['num_blocks']
    for name, want in (('encoder_chunk.pt2', blocks),
                       ('encoder_full.pt2', blocks),
                       ('decoder_rescore.pt2', 0)):
        assert _op_nodes(load_program(str(d / name), 'cpu')) == want, name


def test_export_meta_matches_jax(exported):
    got = json.loads((exported[3] / 'export_meta.json').read_text())
    want = json.loads((exported[4] / 'export_meta.json').read_text())
    assert got == want
    assert set(os.listdir(exported[3])) == {
        'encoder_chunk.pt2', 'encoder_full.pt2', 'decoder_rescore.pt2',
        'export_meta.json'}


def test_exported_chunk_matches_jax_and_eager(exported):
    """141 frames chunk after chunk (the last a padded tail): the loaded
    chunk program against JAX's chunk step + CTC on the same state, and
    against the port's eager step on its own state, bit for bit."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, init_streaming_state as jax_state,
        streaming_att_mask as jax_mask)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, streaming_att_mask)
    model, variables, tmodel = exported[:3]
    em = _exported_model(exported)
    cfg, jcfg = StreamingConfig(4, 2), JaxConfig(4, 2)
    x = np.random.RandomState(4).randn(1, 141, IDIM).astype(np.float32)
    js = jax_state(model.encoder, 1, jcfg)
    cache = em.zero_cache()
    eager = tmodel.encoder.zero_cache(1, cfg.required_cache_size)
    offset = valid = 0
    context = cfg.right_context + 1
    for cur in range(0, 141 - context + 1, cfg.stride):
        xs = x[:, cur:cur + cfg.decoding_window]
        real_out = (xs.shape[1] - context) // cfg.subsampling_rate + 1
        xs = np.pad(xs, ((0, 0), (0, cfg.decoding_window - xs.shape[1]),
                         (0, 0)))
        jy, js.att_cache, js.cnn_cache = model.apply(
            variables, jnp.asarray(xs), jnp.asarray(offset), js.att_cache,
            js.cnn_cache, jax_mask(1, cfg.required_cache_size, 4, valid,
                                   real_out),
            method=model.forward_encoder_chunk)
        jlogp = model.apply(variables, jy, method=model.ctc_activation)
        mask = streaming_att_mask(1, cfg.required_cache_size, 4, valid,
                                  real_out)
        ty, tlogp, cache = em.forward_chunk(torch.from_numpy(xs), offset,
                                            cache, mask)
        _close(ty[:, :real_out], jy[:, :real_out])
        _close(tlogp[:, :real_out], jlogp[:, :real_out])
        for got, want in zip(cache, js.att_cache + (js.cnn_cache,)):
            _close(got, want)
        with torch.inference_mode():
            ey, eager_att, eager_cnn = tmodel.forward_encoder_chunk(
                torch.from_numpy(xs), offset, *eager, mask)
            elogp = tmodel.ctc_activation(ey)
        eager = (eager_att, eager_cnn)
        for got, want in zip((ty, tlogp) + cache,
                             (ey, elogp) + eager_att + (eager_cnn,)):
            assert torch.equal(got, want)
        offset += real_out
        valid = min(valid + real_out, cfg.required_cache_size)


def test_exported_full_encoder_matches_jax(exported):
    """Two (B, T) pairs that meet the time constraint, rows of their own
    lengths."""
    import jax.numpy as jnp
    model, variables = exported[:2]
    em = _exported_model(exported)
    sub = model.encoder.subsampling_rate
    base = model.encoder.right_context + sub
    assert em.meta['time_constraint'] == f'{sub}*t + {base}'
    rng = np.random.RandomState(1)
    for B, T in ((2, sub * 8 + base), (3, sub * 13 + base)):
        speech = rng.randn(B, T, IDIM).astype(np.float32)
        lens = np.asarray([T] + list(rng.randint(T // 2, T, B - 1)),
                          np.int64)
        out, mask, logp = em.forward_full(torch.from_numpy(speech),
                                          torch.from_numpy(lens))
        jout, jmask = model.apply(variables, jnp.asarray(speech),
                                  jnp.asarray(lens, jnp.int32),
                                  method=model.forward_encoder)
        jlogp = model.apply(variables, jout, method=model.ctc_activation)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        valid = np.asarray(jmask)[:, 0, :, None]
        _close(out * torch.from_numpy(valid), np.asarray(jout) * valid)
        _close(logp * torch.from_numpy(valid), np.asarray(jlogp) * valid)


def test_exported_decoder_matches_jax(exported):
    import jax.numpy as jnp
    model, variables = exported[:2]
    em = _exported_model(exported)
    rng = np.random.RandomState(2)
    sos = em.meta['sos']
    for T in (9, 23):
        hyps = rng.randint(3, 30, (3, 16))
        hyps[:, 0] = sos
        lens = np.asarray([1, 9, 16])
        enc = rng.randn(1, T, 64).astype(np.float32)
        dec, r_dec = em.rescore(torch.from_numpy(hyps),
                                torch.from_numpy(lens),
                                torch.from_numpy(enc))
        jdec, jr_dec = model.apply(
            variables, jnp.asarray(hyps, jnp.int32),
            jnp.asarray(lens, jnp.int32), jnp.asarray(enc), 0.3,
            method=model.forward_attention_decoder)
        _close(dec, jdec)
        _close(r_dec, jr_dec)


ROUND_TRIP = r'''
import sys
import numpy as np
import torch
from wenet_tpu_torch.runtime.exported_model import ExportedAsrModel
from wenet_tpu_torch.models.transformer.streaming import streaming_att_mask
em = ExportedAsrModel(sys.argv[1], device='cpu')
xs = torch.from_numpy(np.load(sys.argv[2]))
ys, logp, cache = em.forward_chunk(xs, 0, em.zero_cache(),
                                   streaming_att_mask(1, 8, 4, 0, 4))
np.save(sys.argv[3], logp.numpy())
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'wenet_tpu')]
print('FOREIGN', bad)
'''


def test_round_trip_in_a_process_without_jax(exported, tmp_path):
    """A fresh process that imports neither jax nor the JAX package loads
    the programs and steps a chunk to the log-probs of this process."""
    em = _exported_model(exported)
    xs = np.random.RandomState(5).randn(1, em.meta['decoding_window'],
                                        IDIM).astype(np.float32)
    np.save(tmp_path / 'xs.npy', xs)
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    _, want, _ = em.forward_chunk(torch.from_numpy(xs), 0, em.zero_cache(),
                                  streaming_att_mask(1, 8, 4, 0, 4))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, '-c', ROUND_TRIP, str(exported[3]),
         str(tmp_path / 'xs.npy'), str(tmp_path / 'logp.npy')],
        capture_output=True, text=True, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'FOREIGN []' in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / 'logp.npy'),
                                  want.numpy())


def _port_decoder(tmodel):
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    return AsrDecoder(tmodel, CharTokenizer(SYMS),
                      DecodeOptions(**OPTS, reverse_weight=0.3),
                      FeaturePipelineConfig(num_mel_bins=IDIM), device='cpu')


def test_exported_asr_decoder_matches_jax_and_eager(exported):
    """Streaming from the exported programs alone, as
    tests/test_export.py runs the JAX package's, against its
    `ExportedAsrDecoder` and against the port's eager `AsrDecoder`,
    partial by partial."""
    from wenet_tpu.runtime.asr_decoder import DecodeOptions as JaxOptions
    from wenet_tpu.runtime.exported_model import (
        ExportedAsrDecoder as JaxExported)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipelineConfig as JaxFeatures)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.runtime.asr_decoder import DecodeOptions
    from wenet_tpu_torch.runtime.exported_model import ExportedAsrDecoder
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    tmodel, port_dir, jax_dir = exported[2:]
    wav = _wave(3, 1.6)
    got_partials, got_final = _stream(ExportedAsrDecoder(
        str(port_dir), CharTokenizer(SYMS),
        DecodeOptions(**OPTS, reverse_weight=0.3),
        FeaturePipelineConfig(num_mel_bins=IDIM), device='cpu'), wav)
    want_partials, want_final = _stream(JaxExported(
        str(jax_dir), JaxTokenizer(SYMS),
        JaxOptions(**OPTS, reverse_weight=0.3),
        JaxFeatures(num_mel_bins=IDIM)), wav)
    eager_partials, eager_final = _stream(_port_decoder(tmodel), wav)
    assert len(got_partials) == len(want_partials) == len(eager_partials)
    for g, w, e in zip(got_partials, want_partials, eager_partials):
        _same(g, w)
        _same(g, e)
    _same(got_final[1:], want_final[1:])
    _same(got_final[:1], want_final[:1], atol=2e-3, rtol=1e-5)
    _same(got_final, eager_final, atol=2e-3, rtol=1e-5)
    assert got_final[0][0]  # something was decoded


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernel')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the subsampling convs


@pytest.mark.cuda
def test_cuda_exported_chunk_step_launches_k1(cuda, tmp_path):
    """The chunk program exported on the card, saved and loaded: K1 launches
    once per block inside it, its outputs equal the eager step's (bar 1e-5,
    the same operator on the same inputs) and the CPU's (2e-4)."""
    import copy
    from wenet_tpu_torch.bin.export_model import export_encoder_chunk
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, streaming_att_mask)
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    model = init_model(copy.deepcopy(tiny_config()),
                       torch.Generator().manual_seed(0), device='cpu').eval()
    model.requires_grad_(False)
    cpu_model = copy.deepcopy(model)
    model = model.cuda()
    cfg = StreamingConfig(4, 2)
    program, _ = export_encoder_chunk(model, cfg, IDIM, 'cuda')
    torch.export.save(program, str(tmp_path / 'chunk.pt2'))
    step = torch.export.load(str(tmp_path / 'chunk.pt2')).module()
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(1, cfg.decoding_window, IDIM).astype(
        np.float32))
    (k, v), cnn = cpu_model.encoder.zero_cache(1, cfg.required_cache_size)
    k = torch.from_numpy(rng.randn(*k.shape).astype(np.float32))
    v = torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
    mask = streaming_att_mask(1, cfg.required_cache_size, 4, 5, 3)
    offset = torch.tensor([9])
    args = (xs, offset, k, v, cnn, mask)
    fa.reset_launches()
    got = step(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    assert fa.LAUNCHES['relpos_attention_fwd'] == 2
    with torch.inference_mode():
        ys, (nk, nv), ncnn = model.forward_encoder_chunk(
            xs.cuda(), 9, (k.cuda(), v.cuda()), cnn.cuda(), mask.cuda())
        eager = (ys, model.ctc_activation(ys), nk, nv, ncnn)
        ys, (nk, nv), ncnn = cpu_model.forward_encoder_chunk(
            xs, 9, (k, v), cnn, mask)
        plain = (ys, cpu_model.ctc_activation(ys), nk, nv, ncnn)
    for g, e, p in zip(got, eager, plain):
        assert (g - e).abs().max().item() <= 1e-5
        np.testing.assert_allclose(g.cpu().numpy(), p.numpy(), atol=ATOL,
                                   rtol=0)
