"""The zoo slice of the PyTorch port against the JAX package at tiny width:
the U2++ conformer with MoE FFNs, GQA (2 kv heads of 4) and RMSNorm in
encoder and decoder, without FFN biases (chip_smoke 19a); the RoPE
transformer with MQA and gated FFNs (19b); the Shaw transformer without
positions (19c); the CTL model over a `dual_conformer` with static chunks
(19d).

Same weights (`state_dict_from_jax`), same numpy inputs, every dropout 0.
Bars: encoder output and CTC log-probs within 2e-4; the training losses
within rtol 1e-5 and every gradient within 2e-4 (tests/test_torch_train.py's
GRAD_ATOL); hypotheses of CTC greedy, CTC prefix beam and attention
rescoring identical; the CTL step, on the uniforms of the JAX key (its
negatives), likewise.  The conformer and the RoPE transformer stream
equal to their full forward under the chunk mask within 1e-4 (and to the
JAX package's chunk loop within 2e-4); their batched chunk step with a
vector of offsets equals each row alone within 2e-4 and the JAX package's
step, and `BatchedChunkRunner` serves each of three sessions as alone.
Export equals eager; bin/train.py and bin/recognize.py run the models'
yamls.
The MoE conformer's step under `--mesh model=2` on two gloo ranks
(tests/torch_parallel_worker.py) equals one process's, its stacked expert
tensors whole on every rank.  The `cuda` tests hold the card against the
CPU on these paths (K1 over repeated kv heads, K4 with Shaw's full bias,
K5's full dbias) and skip without a card."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_utils import IDIM, TINY_CONFIG, VOCAB, feats, jax_model, \
    rank_batch, torch_model

ATOL = 2e-4
FULL_ATOL = 1e-4
GRAD_ATOL = 2e-4
MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring']
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_parallel_worker.py')


def _no_dropout(cfg):
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate'):
                conf[k] = 0.0
    return cfg


_MOE = dict(n_kv_head=2, mlp_type='moe', n_expert=4, n_expert_activated=2,
            mlp_bias=False, layer_norm_type='rms_norm')
_TRANSFORMER = dict(output_size=128, attention_heads=4, linear_units=128,
                    num_blocks=2, dropout_rate=0.1,
                    positional_dropout_rate=0.1, attention_dropout_rate=0.0,
                    input_layer='conv2d', normalize_before=True,
                    use_dynamic_chunk=True)
SLICE = {
    # 19a: train_u2pp_conformer.yaml's options with the MoE overrides
    'moe_gqa_conformer': ('conformer', dict(
        output_size=128, attention_heads=4, linear_units=128, **_MOE),
        'bitransformer', dict(attention_heads=4, **_MOE)),
    # 19b: train_transformer.yaml with RoPE, MQA and gated FFNs
    'rope_mqa_transformer': ('transformer', dict(
        _TRANSFORMER, pos_enc_layer_type='rope_pos',
        selfattention_layer_type='rope_abs_selfattn', n_kv_head=1,
        mlp_type='gated'), 'transformer', dict(attention_heads=4)),
    # 19c: the same yaml with Shaw's attention and no positions
    'shaw_transformer': ('transformer', dict(
        _TRANSFORMER, pos_enc_layer_type='no_pos',
        selfattention_layer_type='shaw_rel_selfattn'), 'transformer',
        dict(attention_heads=4)),
}
_MODELS = {}


def slice_config(name):
    encoder, enc, decoder, dec = SLICE[name]
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['encoder'] = encoder
    if encoder == 'transformer':
        cfg['encoder_conf'] = dict(enc)
    else:
        cfg['encoder_conf'].update(enc)
    cfg['decoder'] = decoder
    cfg['decoder_conf'].update(dec)
    if decoder == 'transformer':
        cfg['decoder_conf'].pop('r_num_blocks')
        cfg['model_conf']['reverse_weight'] = 0.0
    return _no_dropout(cfg)


def ctl_config():
    """19d: the flagship as `model: ctl_model` over a dual_conformer with
    static chunks."""
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['model'] = 'ctl_model'
    cfg['encoder'] = 'dual_conformer'
    cfg['encoder_conf'].update(static_chunk_size=4, use_dynamic_chunk=False)
    cfg['model_conf'].update(n_negatives=3, ctl_weight=0.5,
                             logit_temp=0.1)
    return _no_dropout(cfg)


def models(name):
    if name not in _MODELS:
        cfg = ctl_config() if name == 'ctl' else slice_config(name)
        model, variables = jax_model(cfg, seed=len(_MODELS) + 70)
        _MODELS[name] = (cfg, model, variables, torch_model(cfg, variables))
    return _MODELS[name]


def batch(seed, B=3, T=71):
    x, lens = feats(seed, B, T)
    rng = np.random.RandomState(seed + 100)
    tl = rng.randint(2, 8, size=B)
    tgt = np.full((B, 7), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, VOCAB, size=n)
    return x, lens, tgt, tl


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize('name', sorted(SLICE))
def test_forward_matches_jax(name):
    import jax.numpy as jnp
    _, model, variables, tmodel = models(name)
    x, lens, _, _ = batch(1)
    jeo, jem = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                           method=model.forward_encoder)
    jlogp = model.apply(variables, jeo, method=model.ctc_logprobs)
    with torch.no_grad():
        teo, tem = tmodel.forward_encoder(torch.from_numpy(x),
                                          torch.from_numpy(lens))
        tlogp = tmodel.ctc_logprobs(teo)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    _close(teo, jeo)
    _close(tlogp, jlogp)


def _jax_loss_and_grads(model, variables, args, **kw):
    import jax

    def loss_fn(params):
        out = model.apply({**variables, 'params': params}, *args,
                          train=True, rngs={'dropout': jax.random.PRNGKey(0)},
                          **kw)
        return out['loss'], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    return out, grads


def _same_grads(tmodel, grads):
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    want = state_dict_from_jax({'params': grads})
    assert set(want) == {n for n, _ in tmodel.named_parameters()}
    for pname, p in tmodel.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), pname
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   atol=GRAD_ATOL, err_msg=pname)


@pytest.mark.parametrize('name', sorted(SLICE))
def test_loss_and_grads_match_jax(name):
    import jax.numpy as jnp
    cfg, model, variables, _ = models(name)
    tmodel = torch_model(cfg, variables).train()
    x, lens, tgt, tl = batch(2)
    want, grads = _jax_loss_and_grads(
        model, variables, [jnp.asarray(a) for a in (x, lens, tgt, tl)])
    got = tmodel(*(torch.from_numpy(np.asarray(a)) for a in (x, lens, tgt,
                                                              tl)))
    got['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    _same_grads(tmodel, grads)


@pytest.mark.parametrize('name', sorted(SLICE))
def test_decode_matches_jax(name):
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    cfg, model, variables, tmodel = models(name)
    x, lens, _, _ = batch(3, B=4, T=91)
    kw = dict(beam_size=4, ctc_weight=0.3,
              reverse_weight=cfg['model_conf']['reverse_weight'])
    want = JaxRunner(model, variables).decode(MODES, x, lens, **kw)
    got = AsrRunner(tmodel, 'cpu').decode(MODES, x, lens, **kw)
    for mode in MODES:
        assert [r.tokens for r in got[mode]] == \
            [r.tokens for r in want[mode]], mode
    assert any(r.tokens for r in got['attention_rescoring'])


def test_ctl_step_matches_jax():
    """The CTL loss terms and gradients on the JAX key's negatives: the
    port gets the uniforms `jax.random.uniform(r_neg, (B, T' x N))` that
    the JAX model draws from its chunk key."""
    import jax
    import jax.numpy as jnp
    cfg, model, variables, _ = models('ctl')
    tmodel = torch_model(cfg, variables).train()
    x, lens, tgt, tl = batch(4)
    key = jax.random.PRNGKey(11)
    want, grads = _jax_loss_and_grads(
        model, variables, [jnp.asarray(a) for a in (x, lens, tgt, tl)],
        chunk_rng=key)
    T = (((x.shape[1] - 1) // 2 - 1) // 2)  # after conv2d x4
    _, r_neg = jax.random.split(key)
    draws = np.asarray(jax.random.uniform(
        r_neg, (x.shape[0], T * cfg['model_conf']['n_negatives'])))
    got = tmodel(*(torch.from_numpy(np.asarray(a)) for a in (x, lens, tgt,
                                                              tl)),
                 draws=torch.from_numpy(draws))
    got['loss'].backward()
    for k in ('loss', 'loss_full', 'loss_chunk', 'loss_ctl'):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(want['loss_ctl']) > 0.1
    _same_grads(tmodel, grads)


def test_ctl_negatives_stay_in_the_valid_frames():
    """Every negative of a row is another of its valid frames."""
    from wenet_tpu_torch.models.ctl_model.asr_model_ctl import (
        sample_negatives)
    B, T, N = 3, 20, 5
    y = torch.arange(B * T, dtype=torch.float32).reshape(B, T, 1)
    lens = torch.tensor([20, 7, 2])
    negs = sample_negatives(y, torch.rand(B, T * N,
                                          generator=torch.Generator()
                                          .manual_seed(0)), N, lens)
    frame = negs[..., 0] - (torch.arange(B) * T)[None, :, None]
    for b in range(B):
        assert int(frame[:, b].max()) < max(int(lens[b]), 2)
        own = torch.arange(T)[None, :].expand(N, T)
        assert not (frame[:, b] == own).any()


STREAMED = ['moe_gqa_conformer', 'rope_mqa_transformer']


@pytest.mark.parametrize('name', STREAMED)
def test_streaming_equals_full_and_jax(name):
    """Chunk 4 with two left chunks over a padded tail: the port's chunk
    loop equals its full forward under the chunk mask (1e-4) and the JAX
    package's chunk loop (2e-4); the caches hold h_kv heads."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, forward_chunk_by_chunk as jax_fcc)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    cfg, model, variables, tmodel = models(name)
    frames = 143
    x = np.random.RandomState(5).randn(1, frames, IDIM).astype(np.float32)
    jy, _ = jax_fcc(model, variables, jnp.asarray(x), JaxConfig(4, 2))
    with torch.inference_mode():
        ty, _ = forward_chunk_by_chunk(tmodel, torch.from_numpy(x),
                                       StreamingConfig(4, 2))
        full, _ = tmodel.forward_encoder(torch.from_numpy(x),
                                         torch.tensor([frames]), 4, 2)
    (k, _), _ = tmodel.encoder.zero_cache(1, 8)
    assert k.shape[2] == cfg['encoder_conf']['n_kv_head']
    assert tuple(ty.shape) == jy.shape == tuple(full.shape)
    _close(ty, jy)
    _close(ty, full.numpy(), FULL_ATOL)


@pytest.mark.parametrize('name', STREAMED)
def test_batched_step_equals_rows_alone_and_jax(name):
    """B = 3 streams at offsets 0, 5 and 37 with 0, 5 and all 8 cache
    slots valid, the last a tail chunk with 2 of 4 frames: the batched
    step (RoPE's angles per row) equals each row alone and the JAX
    package's step; then `BatchedChunkRunner` serves three sessions in
    one flush, each equal to itself alone."""
    import jax.numpy as jnp
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, streaming_att_mask)
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    _, model, variables, tmodel = models(name)
    enc = tmodel.encoder
    cfg = StreamingConfig(4, 2, enc.subsampling_rate, enc.right_context)
    C, chunk_out = cfg.required_cache_size, 4
    offsets, valid, real = [0, 5, 37], [0, 5, 8], [4, 4, 2]
    rng = np.random.RandomState(30)
    xs = rng.randn(3, cfg.decoding_window, IDIM).astype(np.float32)
    (k, _), cnn = enc.zero_cache(3, C)
    k, v = (rng.randn(*k.shape).astype(np.float32) for _ in range(2))
    cnn = None if cnn is None else rng.randn(*cnn.shape).astype(np.float32)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    mask = torch.cat([streaming_att_mask(1, C, chunk_out, valid[i], real[i])
                      for i in range(3)])
    with torch.inference_mode():
        ys, (nk, nv), _ = tmodel.forward_encoder_chunk(
            t(xs), torch.tensor(offsets), (t(k), t(v)), t(cnn), mask)
        rows = [tmodel.forward_encoder_chunk(
            t(xs[i:i + 1]), offsets[i], (t(k[:, i:i + 1]), t(v[:, i:i + 1])),
            None if cnn is None else t(cnn[:, i:i + 1]), mask[i:i + 1])[0]
            for i in range(3)]
    jys, (jk, _), _ = model.apply(
        variables, jnp.asarray(xs), jnp.asarray(offsets, jnp.int32),
        (jnp.asarray(k), jnp.asarray(v)),
        None if cnn is None else jnp.asarray(cnn),
        jnp.asarray(mask.numpy()), method=model.forward_encoder_chunk)
    _close(ys, jys)
    _close(nk, jk)
    for i, row in enumerate(rows):
        _close(ys[i:i + 1], row.numpy())
    sessions = [rng.randn(cfg.decoding_window, IDIM).astype(np.float32)
                for _ in range(3)]
    runner = BatchedChunkRunner(tmodel, cfg, max_batch=8, flush_ms=500.0,
                                beam_size=3, device='cpu')
    solo = BatchedChunkRunner(tmodel, cfg, max_batch=1, beam_size=3,
                              device='cpu')
    try:
        futs = [runner.submit(f, runner.zero_cache(), 0, 0, chunk_out)
                for f in sessions]
        got = [f.result(timeout=120) for f in futs]
        want = [solo.submit(f, solo.zero_cache(), 0, 0,
                            chunk_out).result(timeout=120)
                for f in sessions]
    finally:
        runner.close()
        solo.close()
    assert runner.batch_sizes == {3: 1}
    for (gy, gh, (gkv, _)), (wy, wh, _) in zip(got, want):
        _close(gy, wy.numpy())
        np.testing.assert_allclose(gh, wh, atol=ATOL, rtol=0)
        assert gkv[0].shape[2] == enc.n_kv_head


@pytest.mark.parametrize('name', sorted(SLICE))
def test_export_equals_eager(name):
    """bin/export_model's programs of each new attention type: the chunk
    step (GQA/MQA caches, RoPE at a traced offset, Shaw over cache +
    chunk), the full encoder at a batch and length it was not traced at,
    and the rescoring decoder (2 kv heads, MoE and RMSNorm in 19a's)
    equal eager within 1e-5."""
    from wenet_tpu_torch.bin import export_model as E
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    _, _, _, tmodel = models(name)
    enc = tmodel.encoder
    cfg = StreamingConfig(4, 2, enc.subsampling_rate, enc.right_context)
    prog, args = E.export_encoder_chunk(tmodel, cfg, IDIM, device='cpu')
    args = list(args)
    args[1] = torch.tensor([13])
    args[2] = torch.randn(args[2].shape, generator=torch.Generator()
                          .manual_seed(1))
    outs = [prog.module()(*args)]
    x, lens = (torch.from_numpy(a) for a in feats(9, B=3, T=4 * 20 + 7))
    full, _ = E.export_encoder_full(tmodel, IDIM, device='cpu')
    outs.append(full.module()(x, lens))
    dec = E.export_decoder(tmodel, 3, 8, enc.output_size(), 0.0, 'cpu')
    hyps = torch.tensor([[2, 5, 6, 2, 2, 2, 2, 2]] * 3)
    dec_args = (hyps, torch.tensor([3, 4, 1]), torch.randn(1, 13, 128))
    outs.append(dec.module()(*dec_args))
    with torch.no_grad():
        wants = [E._ChunkStep(tmodel)(*args),
                 E._FullEncoder(tmodel)(x, lens),
                 E._Rescore(tmodel, 0.0)(*dec_args)]
    for got, want in zip(outs, wants):
        for g, w in zip(got, want):
            if w is not None:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize('name', ['moe_gqa_conformer', 'rope_mqa_transformer',
                                  'ctl'])
def test_train_and_recognize_entry_points(tmp_path, name):
    """bin/compute_cmvn_stats, bin/train.py (one epoch of four steps) and
    bin/recognize.py run a slice model's yaml as they run the flagship's
    (one block each, the train-entry tests' data list): finite losses,
    an epoch checkpoint linked as final.pt, a hypothesis line per
    utterance in each mode."""
    from test_torch_train_main import (CHARS, N_UTTS, _config, _speech,
                                       _write_yaml)
    from wenet_tpu_torch.bin import recognize, train
    from wenet_tpu_torch.bin.compute_cmvn_stats import main as cmvn_main
    from wenet_tpu_torch.dataset.audio import write_wav
    rng = np.random.RandomState(0)
    syms = ['<blank>', '<unk>', '<sos/eos>'] + list(CHARS)
    (tmp_path / 'units.txt').write_text(''.join(
        f'{s} {i}\n' for i, s in enumerate(syms)), encoding='utf-8')
    lines = []
    for i in range(N_UTTS):
        path = tmp_path / f'u{i}.wav'
        write_wav(str(path), _speech(rng, 0.6 + 0.13 * i), 16000)
        txt = ''.join(rng.choice(list(CHARS), size=2 + i % 4))
        lines.append(json.dumps({'key': f'u{i}', 'wav': str(path),
                                 'txt': txt}, ensure_ascii=False) + '\n')
    (tmp_path / 'data.list').write_text(''.join(lines), encoding='utf-8')
    (tmp_path / 'wav.scp').write_text(''.join(
        f'u{i} {tmp_path / f"u{i}.wav"}\n' for i in range(N_UTTS)))
    model_cfg = ctl_config() if name == 'ctl' else slice_config(name)
    cfg = _config(tmp_path, max_epoch=1)
    for key in ('model', 'encoder', 'decoder', 'model_conf'):
        cfg[key] = model_cfg[key]
    cfg['encoder_conf'] = dict(model_cfg['encoder_conf'], num_blocks=1)
    cfg['decoder_conf'] = dict(model_cfg['decoder_conf'], num_blocks=1)
    if 'r_num_blocks' in cfg['decoder_conf']:
        cfg['decoder_conf']['r_num_blocks'] = 1
    config = _write_yaml(tmp_path / 'train.yaml', cfg)
    cmvn_main(['--train_config', config, '--in_scp',
               str(tmp_path / 'wav.scp'), '--out_cmvn',
               str(tmp_path / 'global_cmvn')])
    exp = tmp_path / 'exp'
    summary = train.main(['--config', config, '--train_data',
                          str(tmp_path / 'data.list'), '--cv_data',
                          str(tmp_path / 'data.list'), '--model_dir',
                          str(exp), '--device', 'cpu'])
    assert summary['epochs'][0]['steps'] == 4
    assert np.isfinite(summary['epochs'][0]['cv']['loss'])
    modes = ['ctc_greedy_search', 'attention_rescoring']
    recognize.main(['--config', str(exp / 'train.yaml'), '--test_data',
                    str(tmp_path / 'data.list'), '--checkpoint',
                    str(exp / 'final.pt'), '--result_dir',
                    str(tmp_path / 'out'), '--modes', *modes,
                    '--batch_size', '3', '--beam_size', '3',
                    '--ctc_weight', '0.3', '--device', 'cpu'])
    for mode in modes:
        text = (tmp_path / 'out' / mode / 'text').read_text(
            encoding='utf-8').splitlines()
        assert len(text) == N_UTTS, mode


# -- the MoE step under --mesh model=2 ------------------------------------------
MOE_OPTIM = dict(optim='adam', optim_conf={'lr': 0.002, 'eps': 1e-3},
                 scheduler='warmuplr', scheduler_conf={'warmup_steps': 5})


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = os.pathsep.join([REPO, env.get('PYTHONPATH', '')])
    for k in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT', 'JAX_COORDINATOR'):
        env.pop(k, None)
    return env


def test_moe_model2_step_equals_one_process(tmp_path):
    """Two gloo ranks, `model_axis` over model=2 (min_dim 64): the linear
    maps are cut as the JAX rule cuts them, the stacked experts (E, D, H)
    and their biases over the experts, two of the four on each rank (the
    JAX 3-D rule), and the step's losses, gradients (the router's on each
    rank too) and weights equal one process's (losses rtol 1e-5, weights
    1e-6, gradients 2e-4)."""
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    cfg = dict(slice_config('moe_gqa_conformer'), **MOE_OPTIM)
    cfg['encoder_conf']['use_dynamic_chunk'] = False
    (tmp_path / 'moe.json').write_text(json.dumps(cfg))
    model = init_model(copy.deepcopy(cfg), torch.Generator().manual_seed(3),
                       device='cpu')
    torch.save(model.state_dict(), tmp_path / 'moe.pt')
    procs = [subprocess.Popen(
        [sys.executable, WORKER, 'moe_model2', str(r), '2',
         str(tmp_path / 'moe.init'), str(tmp_path)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    # the one-process step meanwhile
    opt, schedule = init_optimizer_and_scheduler(cfg, model)
    step = make_train_step(model, opt, schedule, None, 1, 5.0)
    _, metrics = step(TrainState(model, opt),
                      to_device_batch(rank_batch(0, 0), 'cpu'), (777, 0))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    for r in range(2):
        got = torch.load(tmp_path / f'moe_model2_rank{r}.pt')
        sharded = got['sharded']
        experts = [k for k in model.state_dict() if '.experts_' in k]
        assert experts and all(sharded[k] == 0 for k in experts)
        assert got['local_shapes'][
            'encoder.encoders.0.feed_forward.experts_w1'] == (2, 128, 128)
        for k in ('loss', 'loss_att', 'loss_ctc', 'grad_norm'):
            np.testing.assert_allclose(got['step']['metrics'][k],
                                       float(metrics[k]), rtol=1e-5,
                                       err_msg=k)
        for k, g in grads.items():
            np.testing.assert_allclose(got['step']['grads'][k].numpy(),
                                       g.numpy(), atol=GRAD_ATOL, err_msg=k)
        for k, w in model.state_dict().items():
            np.testing.assert_allclose(got['step']['weights'][k].numpy(),
                                       w.numpy(), atol=1e-6, err_msg=k)


# -- on the card ------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _float64_grads(model, args):
    """The loss's parameter gradients on a float64 copy of `model` on the
    CPU, its float32 casts (`Tensor.float`) left in float64."""
    m = copy.deepcopy(model).double().train()
    m.zero_grad(set_to_none=True)
    to_float = torch.Tensor.float
    torch.Tensor.float = (lambda t, *a, **k: t if t.dtype == torch.float64
                          else to_float(t, *a, **k))
    try:
        x, lens, tgt, tl = args
        m(x.double(), lens, tgt, tl)['loss'].backward()
    finally:
        torch.Tensor.float = to_float
    return {n: p.grad for n, p in m.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(SLICE) + ['ctl'])
def test_cuda_step_matches_cpu(cuda, name):
    """Each slice model on the card against the CPU, at shapes above the
    flash gate for the transformers (B=2 x 2200 frames: T' = 549, K4 with
    Shaw's full bias, K4-train, K5's full dbias, K6): encoder output
    within 2e-4, every loss term within rtol 1e-4, the loss's gradients
    within 1e-3 + 2e-4 of each tensor's largest (chip_smoke 12c's bar),
    and the kernels of each path launched.  A gradient past the bar is
    held to the float64 gradient within the bar plus the CPU's own error
    there (chip_smoke `hold_gradients`): at T' = 549 the CTC term's
    float32 gradient, the CPU's too, can sit past the bar from float64
    (chip_smoke `ctc_grad_precision`)."""
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = ctl_config() if name == 'ctl' else slice_config(name)
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device='cpu')
    gpu = copy.deepcopy(cpu).cuda()
    initial = copy.deepcopy(cpu)
    long = 'transformer' in name
    args = tuple(torch.from_numpy(np.asarray(a))
                 for a in batch(6, B=2, T=2200 if long else 91))
    x, lens = args[:2]
    with torch.no_grad():
        want, _ = cpu.eval().forward_encoder(x, lens)
        fa.reset_launches()
        got, _ = gpu.eval().forward_encoder(x.cuda(), lens.cuda())
    kernel = 'flash_attention_fwd' if long else 'relpos_attention_fwd'
    assert fa.LAUNCHES[kernel] == 2
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=0)
    outs = []
    for model, dev in ((cpu, 'cpu'), (gpu, 'cuda')):
        fa.reset_launches()
        out = model.train()(*(a.to(dev) for a in args))
        out['loss'].backward()
        outs.append(out)
    train = 'flash_attention_bwd_dq' if long else 'relpos_attention_bwd_dq'
    assert fa.LAUNCHES[train] == (4 if name == 'ctl' else 2)
    for k, v in outs[0].items():
        if v is not None and k != 'th_accuracy':
            np.testing.assert_allclose(outs[1][k].item(), v.item(),
                                       rtol=1e-4, err_msg=k)
    want_grads = dict(cpu.named_parameters())
    exact = None
    for pname, p in gpu.named_parameters():
        w = want_grads[pname].grad
        g = p.grad.cpu()
        bar = 1e-3 + 2e-4 * w.abs().max().item()
        if (g - w).abs().max().item() <= bar:
            continue
        exact = exact if exact is not None else _float64_grads(initial, args)
        own = (w.double() - exact[pname]).abs().max().item()
        assert (g.double() - exact[pname]).abs().max().item() <= bar + own, \
            pname
