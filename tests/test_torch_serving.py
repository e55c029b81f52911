"""The port's cross-stream batched serving against the JAX package at a
tiny width: the chunk step with a vector of offsets (one per stream),
`BatchedChunkRunner`, `AsrDecoder` over a runner, and the text
post-processor with its builtin ITN.

Bars: the batched chunk step within 2e-4 of the JAX package's (the
torch-import bar) and within 1e-5 of the same rows run alone in the port;
the runner's top-k log-probs within 1e-4 of the JAX runner's (its own
test's bar, tests/test_runtime.py) with the ids equal; decoders'
sentences identical and scores within 2e-4 (the rescored final within
2e-3 absolute / 1e-5 relative of the JAX package's, as
tests/test_torch_runtime.py holds it); post-processed strings identical."""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

from test_torch_runtime import OPTS, SYMS, _same, _stream, _wave
from torch_port_utils import IDIM, jax_model, tiny_config, torch_model

K = OPTS['beam_size']


@pytest.fixture(scope='module')
def pair():
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=21)
    return model, variables, torch_model(cfg, variables)


@pytest.fixture(autouse=True)
def numpy_fbank(monkeypatch):
    """The JAX package's feature pipeline on its numpy fbank (the one the
    port copies), not its C++ one."""
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)


def _cfg(encoder):
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    return StreamingConfig(OPTS['chunk_size'], OPTS['num_left_chunks'],
                           encoder.subsampling_rate, encoder.right_context)


def _chunk_out(cfg):
    return (cfg.decoding_window - cfg.right_context - 1) \
        // cfg.subsampling_rate + 1


def test_batched_chunk_step_matches_jax_and_rows_alone(pair):
    """B = 3 streams at offsets 0, 5 and 37 with 0, 5 and all 8 cache
    slots valid, the last a tail chunk with 2 of 4 frames: the port's step
    with an offset vector equals JAX's with the same vector, and each row
    equals that row stepped alone with an int offset."""
    import jax.numpy as jnp
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    model, variables, tmodel = pair
    cfg = _cfg(tmodel.encoder)
    C, chunk_out = cfg.required_cache_size, _chunk_out(cfg)
    offsets, valid, real = [0, 5, 37], [0, 5, 8], [4, 4, 2]
    rng = np.random.RandomState(30)
    xs = rng.randn(3, cfg.decoding_window, IDIM).astype(np.float32)
    (k, _), cnn = tmodel.encoder.zero_cache(3, C)
    k, v, cnn = (rng.randn(*a.shape).astype(np.float32) for a in (k, k, cnn))
    mask = torch.cat([streaming_att_mask(1, C, chunk_out, valid[i], real[i])
                      for i in range(3)])
    with torch.inference_mode():
        ys, (nk, nv), ncnn = tmodel.forward_encoder_chunk(
            torch.from_numpy(xs), torch.tensor(offsets),
            (torch.from_numpy(k), torch.from_numpy(v)), torch.from_numpy(cnn),
            mask)
        rows = [tmodel.forward_encoder_chunk(
            torch.from_numpy(xs[i:i + 1]), offsets[i],
            (torch.from_numpy(k[:, i:i + 1]), torch.from_numpy(v[:, i:i + 1])),
            torch.from_numpy(cnn[:, i:i + 1]), mask[i:i + 1])
            for i in range(3)]
    jys, (jk, jv), jcnn = model.apply(
        variables, jnp.asarray(xs), jnp.asarray(offsets, jnp.int32),
        (jnp.asarray(k), jnp.asarray(v)), jnp.asarray(cnn),
        jnp.asarray(mask.numpy()), method=model.forward_encoder_chunk)
    for got, want in ((ys, jys), (nk, jk), (nv, jv), (ncnn, jcnn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=0)
    for i, (rys, (rk, rv), rcnn) in enumerate(rows):
        for got, want in ((ys[i:i + 1], rys), (nk[:, i:i + 1], rk),
                          (nv[:, i:i + 1], rv), (ncnn[:, i:i + 1], rcnn)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                       rtol=0)


def test_position_encoding_offsets():
    """An int offset gives (1, size, d) and a (B,) tensor (B, size, d),
    row b equal to the int encoding at offset b; negative positions read
    position 0, as the JAX package's do."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.embedding import (
        sinusoidal_position_encoding as jax_pe)
    from wenet_tpu_torch.models.transformer.embedding import (
        sinusoidal_position_encoding)
    offsets = [-12, 0, 7, 300]
    batched = sinusoidal_position_encoding(20, 16, offset=torch.tensor(
        offsets))
    assert batched.shape == (4, 20, 16)
    for b, off in enumerate(offsets):
        one = sinusoidal_position_encoding(20, 16, offset=off)
        assert one.shape == (1, 20, 16)
        assert torch.equal(batched[b:b + 1], one)
    np.testing.assert_allclose(
        batched.numpy(), np.asarray(jax_pe(jnp.asarray(offsets), 20, 16)),
        atol=1e-5, rtol=0)
    assert torch.equal(batched[0, :13], batched[1, :1].expand(13, 16))


def test_streaming_att_mask_per_row():
    """(B,) tensors of valid cache slots and chunk frames give, row by
    row, the JAX package's mask at those ints (a count above the cache
    clamped to it); without valid_chunk every chunk frame is on."""
    from wenet_tpu.models.transformer.streaming import (
        streaming_att_mask as jax_mask)
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    C, chunk = 8, 4
    valid, real = [0, 5, 8, 30], [4, 4, 2, 1]
    for chunks in (real, None):
        got = streaming_att_mask(4, C, chunk, torch.tensor(valid),
                                 None if chunks is None else
                                 torch.tensor(chunks))
        assert got.shape == (4, 1, C + chunk)
        want = np.concatenate([jax_mask(
            1, C, chunk, valid[i], None if chunks is None else chunks[i])
            for i in range(4)])
        np.testing.assert_array_equal(got.numpy(), want)


def _chunks(cfg, seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, cfg.decoding_window, IDIM).astype(np.float32)
            for _ in range(2)]


def _port_session(runner, feats, chunk_out):
    """Step one stream through `runner` -> its host rows, (T, 2K + 1)."""
    cache = runner.zero_cache()
    offset = valid = 0
    rows = []
    for f in feats:
        ys, host, cache = runner.submit(f, cache, offset, valid,
                                        chunk_out).result(timeout=120)
        assert ys.shape[:2] == (1, chunk_out)
        rows.append(host)
        offset += chunk_out
        valid = min(valid + chunk_out, runner.cfg.required_cache_size)
    return np.concatenate(rows)


def _jax_session(runner, feats, chunk_out):
    """The same stream through the JAX package's runner -> its log-probs."""
    cache = runner.zero_cache()
    offset = valid = 0
    logps = []
    for f in feats:
        _, logp, cache = runner.submit(f, cache, offset, valid,
                                       chunk_out).result(timeout=120)
        logps.append(np.asarray(logp)[0])
        offset += chunk_out
        valid = min(valid + chunk_out, runner.cfg.required_cache_size)
    return np.concatenate(logps)


def _same_topk(host, logp):
    """The runner's packed top-k against the JAX log-probs."""
    ids = np.argsort(-logp, axis=-1, kind='stable')[:, :K]
    np.testing.assert_array_equal(host[:, K:2 * K].astype(np.int64), ids)
    np.testing.assert_allclose(host[:, :K],
                               np.take_along_axis(logp, ids, -1),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(host[:, 2 * K], logp[:, 0], atol=1e-4,
                               rtol=1e-4)


def test_batch_runner_matches_jax_runner(pair):
    """Two concurrent sessions of three chunks each, batched: the port's
    top-k and blank column equal the JAX runner's log-probs'."""
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig)
    from wenet_tpu.runtime.batch_runner import (
        BatchedChunkRunner as JaxRunner)
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    model, variables, tmodel = pair
    cfg = _cfg(tmodel.encoder)
    chunk_out = _chunk_out(cfg)
    feats = _chunks(cfg, 0, 3)
    runner = BatchedChunkRunner(tmodel, cfg, max_batch=2, flush_ms=50.0,
                                beam_size=K, device='cpu')
    jrunner = JaxRunner(model, variables, JaxConfig(**vars(cfg)),
                        max_batch=2, flush_ms=50.0)
    try:
        with cf.ThreadPoolExecutor(2) as ex:
            got = list(ex.map(lambda f: _port_session(runner, f, chunk_out),
                              feats))
            want = list(ex.map(lambda f: _jax_session(jrunner, f, chunk_out),
                               feats))
    finally:
        runner.close()
        jrunner.close()
    assert max(runner.batch_sizes) == 2  # the sessions shared steps
    for g, w in zip(got, want):
        assert g.shape == (3 * chunk_out, 2 * K + 1)
        _same_topk(g, w)


def test_batch_runner_three_session_flush(pair):
    """Three requests in one flush run as ONE step of B = 3 (no padding):
    each row equals that session stepped alone (1e-5) and the JAX runner,
    which pads the flush to 4 rows; `precompile` runs sizes 1..max_batch."""
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig)
    from wenet_tpu.runtime.batch_runner import (
        BatchedChunkRunner as JaxRunner)
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    model, variables, tmodel = pair
    cfg = _cfg(tmodel.encoder)
    chunk_out = _chunk_out(cfg)
    rng = np.random.RandomState(1)
    feats = [rng.randn(cfg.decoding_window, IDIM).astype(np.float32)
             for _ in range(3)]
    runner = BatchedChunkRunner(tmodel, cfg, max_batch=8, flush_ms=500.0,
                                beam_size=K, device='cpu')
    try:
        assert runner.precompile(idim=IDIM) == list(range(1, 9))
        assert not runner.batch_sizes  # warm-up steps are not counted
        futs = [runner.submit(f, runner.zero_cache(), 0, 0, chunk_out)
                for f in feats]
        got = [fut.result(timeout=120)[1] for fut in futs]
        assert runner.batch_sizes == {3: 1}
    finally:
        runner.close()
    solo = BatchedChunkRunner(tmodel, cfg, max_batch=1, beam_size=K,
                              device='cpu')
    jrunner = JaxRunner(model, variables, JaxConfig(**vars(cfg)),
                        max_batch=8, flush_ms=500.0)
    try:
        want = [solo.submit(f, solo.zero_cache(), 0, 0,
                            chunk_out).result(timeout=120)[1]
                for f in feats]
        jfuts = [jrunner.submit(f, jrunner.zero_cache(), 0, 0, chunk_out)
                 for f in feats]
        jwant = [np.asarray(fut.result(timeout=120)[1])[0] for fut in jfuts]
    finally:
        solo.close()
        jrunner.close()
    for g, w, j in zip(got, want, jwant):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        _same_topk(g, j)


@pytest.mark.parametrize('mesh', [object(), [], 'cpu'])
def test_batch_runner_rejects_a_mesh(pair, mesh):
    """A mesh is a list of local devices along data (the data-parallel
    runner itself: tests/test_torch_batch_wfst.py); anything else
    raises."""
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    _, _, tmodel = pair
    with pytest.raises(ValueError, match='mesh'):
        BatchedChunkRunner(tmodel, _cfg(tmodel.encoder), mesh=mesh,
                           device='cpu')


def _port_decoder(tmodel, runner=None, **kw):
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    return AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                      FeaturePipelineConfig(num_mel_bins=IDIM),
                      batch_runner=runner, device='cpu', **kw)


def _two_streams(make, waves):
    """Stream `waves` concurrently, each through a decoder from `make`."""
    with cf.ThreadPoolExecutor(len(waves)) as ex:
        return list(ex.map(lambda w: _stream(make(), w), waves))


def test_asr_decoder_with_runner_matches_jax_and_unbatched(pair):
    """Two concurrent streams over one runner: every partial and the final
    equal the JAX decoders' over the JAX runner and the port's unbatched
    decoder's."""
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig)
    from wenet_tpu.runtime.asr_decoder import (AsrDecoder as JaxDecoder,
                                               DecodeOptions as JaxOptions)
    from wenet_tpu.runtime.batch_runner import (
        BatchedChunkRunner as JaxRunner)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipelineConfig as JaxFeatures)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    model, variables, tmodel = pair
    cfg = _cfg(tmodel.encoder)
    waves = [_wave(8, 1.9), _wave(9, 1.4)]
    runner = BatchedChunkRunner(tmodel, cfg, max_batch=2, flush_ms=20.0,
                                beam_size=K, device='cpu')
    jrunner = JaxRunner(model, variables, JaxConfig(**vars(cfg)),
                        max_batch=2, flush_ms=20.0)
    try:
        got = _two_streams(lambda: _port_decoder(tmodel, runner), waves)
        want = _two_streams(lambda: JaxDecoder(
            model, variables, JaxTokenizer(SYMS), JaxOptions(**OPTS),
            JaxFeatures(num_mel_bins=IDIM), batch_runner=jrunner), waves)
    finally:
        runner.close()
        jrunner.close()
    alone = [_stream(_port_decoder(tmodel), w) for w in waves]
    assert max(runner.batch_sizes) == 2  # the streams shared steps
    for (g_part, g_final), (w_part, w_final), (a_part, a_final) in zip(
            got, want, alone):
        assert len(g_part) == len(w_part) == len(a_part)
        for g, w, a in zip(g_part, w_part, a_part):
            _same(g, w)
            _same(g, a)
        _same(g_final, a_final)
        _same(g_final[1:], w_final[1:])
        _same(g_final[:1], w_final[:1], atol=2e-3, rtol=1e-5)
        assert g_final[0][0]


def test_asr_decoder_rejects_a_mismatched_runner(pair):
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    _, _, tmodel = pair
    cfg = _cfg(tmodel.encoder)
    other = StreamingConfig(8, OPTS['num_left_chunks'],
                            cfg.subsampling_rate, cfg.right_context)
    for runner_cfg, beam in ((other, K), (cfg, K + 1)):
        runner = BatchedChunkRunner(tmodel, runner_cfg, beam_size=beam,
                                    device='cpu')
        try:
            with pytest.raises(ValueError):
                _port_decoder(tmodel, runner)
        finally:
            runner.close()


def test_asr_decoder_post_processor(pair):
    """Partials and the final go through the post-processor, as the JAX
    decoder's do: lowercasing `SYMS`' letters leaves them as they are, so
    upper-case symbols show it."""
    from wenet_tpu_torch.runtime.post_processor import PostProcessor
    _, _, tmodel = pair
    wav = _wave(3, 1.6)
    plain = _stream(_port_decoder(tmodel), wav)

    class Upper:
        def process(self, text, finish):
            return text.upper() + ('.' if finish else '')

    shouted = _stream(_port_decoder(tmodel, post_processor=Upper()), wav)
    for g, w in zip(shouted[0], plain[0][:-1]):
        assert [s for s, _ in g] == [s.upper() for s, _ in w]
    assert [s for s, _ in shouted[1]] == [s.upper() + '.'
                                          for s, _ in plain[1]]
    lowered = _stream(_port_decoder(tmodel, post_processor=PostProcessor()),
                      wav)
    assert lowered == plain


POST_CASES = ['你 好 HELLO WORLD 吗', '▁hi▁▁there▁',
              '你<unk> 好<context>x</context>', 'GUTEN▁MORGEN wie',
              '共一百二十三人']
ITN_CASES = ['一百二十三', '两千零一', '三点一四', '百分之三十', '一九九七年',
             '三万五千', '一个人', '十块钱', '五亿零三百万', '五百分之一',
             '三分之十二']


@pytest.mark.parametrize('options', [
    {}, {'language_type': 'INDO_EUROPEAN', 'lowercase': False},
    {'itn': True}])
def test_post_processor_matches_jax(options):
    from wenet_tpu.runtime import post_processor as jpp
    from wenet_tpu_torch.runtime import post_processor as tpp
    procs = []
    for mod in (jpp, tpp):
        kw = dict(options)
        if 'language_type' in kw:
            kw['language_type'] = mod.LanguageType[kw['language_type']]
        procs.append(mod.PostProcessor(mod.PostProcessOptions(**kw)))
    for s in POST_CASES + ITN_CASES:
        for finish in (False, True):
            assert procs[1].process(s, finish) == procs[0].process(s, finish)
    if options.get('itn'):
        assert procs[1].process('共一百二十三人') == '共123人'


def test_builtin_itn_matches_jax():
    from wenet_tpu.runtime.itn import normalize as jax_normalize
    from wenet_tpu_torch.runtime.itn import Normalizer, normalize
    for s in ITN_CASES + POST_CASES:
        assert normalize(s) == jax_normalize(s)
        assert Normalizer().normalize(s) == normalize(s)
    assert normalize('五亿零三百万') == '503000000'


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernel')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the subsampling convs


# fp32: summation order and 3xTF32; bf16: about 2 bf16 ulps (K1's bars)
CUDA_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_k1_at_the_batched_step(cuda, dtype):
    """K1 at the flagship's batched chunk step: eight streams, each with
    its own p (its own offset) and its own cache fill, a tail among them."""
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    from wenet_tpu_torch.ops.flash_attention import (
        LAUNCHES, flash_attention_relpos, relpos_fwd_reference)
    rng = np.random.RandomState(12)
    B, h, T1, C, d = 8, 4, 16, 512, 64
    fills = [(16, 16), (256, 16), (512, 16), (368, 7), (0, 16), (128, 16),
             (448, 16), (512, 16)]

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda(
            ).to(dtype)
    q1 = t(B, T1, h, d).transpose(1, 2)
    q2 = t(B, T1, h, d).transpose(1, 2)
    k, v, p = (t(B, h, C + T1, d) for _ in range(3))
    mask = torch.cat([streaming_att_mask(1, C, T1, *f, 'cuda')
                      for f in fills])
    before = LAUNCHES['relpos_attention_fwd']
    got = flash_attention_relpos(q1, q2, k, p, v, mask, d ** -0.5)
    torch.cuda.synchronize()
    assert LAUNCHES['relpos_attention_fwd'] == before + 1
    want, _ = relpos_fwd_reference(*(x.float() for x in (q1, q2, k, p, v)),
                                   mask, d ** -0.5)
    torch.testing.assert_close(got.float(), want, **CUDA_TOL[dtype])


@pytest.mark.cuda
def test_cuda_batch_runner_matches_cpu(cuda):
    """Three sessions in one flush on the card against the same on the
    CPU: the top-k within 2e-4 with the ids equal, one K1 launch per block
    for the batched step."""
    import copy
    from wenet_tpu_torch.ops.flash_attention import LAUNCHES
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    from wenet_tpu_torch.utils.init_model import init_model
    tmodel = init_model(tiny_config(), torch.Generator().manual_seed(0),
                        device='cpu').eval()
    gpu = copy.deepcopy(tmodel).cuda()
    cfg = _cfg(tmodel.encoder)
    chunk_out = _chunk_out(cfg)
    rng = np.random.RandomState(13)
    feats = [rng.randn(cfg.decoding_window, IDIM).astype(np.float32)
             for _ in range(3)]
    hosts = {}
    for device, model in (('cpu', tmodel), ('cuda', gpu)):
        runner = BatchedChunkRunner(model, cfg, max_batch=3, flush_ms=500.0,
                                    beam_size=K, device=device)
        try:
            before = LAUNCHES['relpos_attention_fwd']
            futs = [runner.submit(f, runner.zero_cache(), 5 * i, 3 * i,
                                  chunk_out) for i, f in enumerate(feats)]
            hosts[device] = np.stack([fut.result(timeout=120)[1]
                                      for fut in futs])
            assert runner.batch_sizes == {3: 1}
        finally:
            runner.close()
    assert LAUNCHES['relpos_attention_fwd'] - before == \
        len(gpu.encoder.encoders)
    got, want = hosts['cuda'], hosts['cpu']
    np.testing.assert_array_equal(got[..., K:2 * K], want[..., K:2 * K])
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
