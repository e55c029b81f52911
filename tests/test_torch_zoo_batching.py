"""Batched serving of the rest of the encoder zoo in the PyTorch port
against the JAX package at tiny width: Branchformer (learned-average
merge, whose pooling reads each row's valid frames), E-Branchformer (the
cgMLP conv's cache), Squeezeformer (time reduction and recovery inside
the chunk step) and the efficient conformer (caches at the base
resolution, half as many output frames), each causal
(tests/torch_port_utils.py `ZOO_ENCODERS`), chunk 4 with two left chunks.

Same weights, same numpy inputs.  Bars: the batched chunk step with a
vector of offsets within 2e-4 of each row stepped alone and of the JAX
package's batched step (the torch-import bar); `BatchedChunkRunner`'s
top-k within 1e-5 of each session stepped alone, and within 1e-4 of the
JAX runner's log-probs with the ids equal where the JAX runner serves the
encoder with the same frame count (the efficient conformer's differs by
design: the JAX package counts its frames at the base resolution);
streams started at different steps and ending on a padded tail chunk,
each runner step against the JAX runner's (rows within 2e-4, log-probs
1e-4) and alone (1e-5); `AsrDecoder` over the runner gives each
stream's partials and final as alone and as the JAX decoder over the JAX
runner (sentences identical, scores within 2e-4).  The `cuda` test holds
the card's batched step against the CPU's and skips without a card."""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

from test_torch_runtime import OPTS, SYMS, _same, _stream, _wave
from torch_port_utils import IDIM, jax_model, torch_model, zoo_config

ATOL = 2e-4
K = OPTS['beam_size']
STREAMED = {  # name: (ZOO_ENCODERS entry, causal and dynamic-chunk options)
    'branchformer': ('branchformer_learned_ave',
                     dict(causal=True, use_dynamic_chunk=True)),
    'e_branchformer': ('e_branchformer',
                       dict(causal=True, use_dynamic_chunk=True)),
    'efficient_conformer': ('efficient_conformer', {}),
    'squeezeformer': ('squeezeformer',
                      dict(causal=True, use_dynamic_chunk=True,
                           cnn_norm_type='batch_norm')),
}
_MODELS = {}


def models(name):
    if name not in _MODELS:
        entry, overrides = STREAMED[name]
        cfg = zoo_config(entry, **overrides)
        model, variables = jax_model(cfg, seed=len(_MODELS) + 80)
        _MODELS[name] = (model, variables, torch_model(cfg, variables))
    return _MODELS[name]


@pytest.fixture(autouse=True)
def numpy_fbank(monkeypatch):
    """The JAX package's feature pipeline on its numpy fbank (the one the
    port copies), not its C++ one."""
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _cfg(encoder):
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    return StreamingConfig(OPTS['chunk_size'], OPTS['num_left_chunks'],
                           encoder.subsampling_rate, encoder.right_context)


@pytest.mark.parametrize('name', sorted(STREAMED))
def test_batched_step_equals_rows_alone_and_jax(name):
    """B = 3 streams at offsets 0, 3 and 37 with 0, 5 and all 8 cache
    slots valid, the last a tail chunk with 3 of 4 base frames: the batched
    step equals each row alone and the JAX package's step, outputs and
    caches."""
    import jax.numpy as jnp
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    model, variables, tmodel = models(name)
    enc = tmodel.encoder
    cfg = _cfg(enc)
    C, chunk_base = cfg.required_cache_size, 4
    offsets, valid, real = [0, 3, 37], [0, 5, 8], [4, 4, 3]
    rng = np.random.RandomState(40)
    xs = rng.randn(3, cfg.decoding_window, IDIM).astype(np.float32)
    (k, _), cnn = enc.zero_cache(3, C)
    k, v = (rng.randn(*k.shape).astype(np.float32) for _ in range(2))
    cnn = None if cnn is None else rng.randn(*cnn.shape).astype(np.float32)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    mask = torch.cat([streaming_att_mask(1, C, chunk_base, valid[i],
                                         real[i]) for i in range(3)])
    with torch.inference_mode():
        ys, (nk, nv), ncnn = tmodel.forward_encoder_chunk(
            t(xs), torch.tensor(offsets), (t(k), t(v)), t(cnn), mask)
        rows = [tmodel.forward_encoder_chunk(
            t(xs[i:i + 1]), offsets[i], (t(k[:, i:i + 1]), t(v[:, i:i + 1])),
            None if cnn is None else t(cnn[:, i:i + 1]), mask[i:i + 1])
            for i in range(3)]
    jys, (jk, jv), jcnn = model.apply(
        variables, jnp.asarray(xs), jnp.asarray(offsets, jnp.int32),
        (jnp.asarray(k), jnp.asarray(v)),
        None if cnn is None else jnp.asarray(cnn),
        jnp.asarray(mask.numpy()), method=model.forward_encoder_chunk)
    factor = enc.output_downsampling_factor
    assert tuple(ys.shape) == jys.shape == (3, chunk_base // factor, 64)
    for i, (ry, (rk, rv), rc) in enumerate(rows):
        n = -(-real[i] // factor)
        _close(ys[i:i + 1], ry.numpy())
        _close(ys[i, :n], jys[i, :n])
        for got, alone, want in ((nk, rk, jk), (nv, rv, jv),
                                 (ncnn, rc, jcnn)):
            if alone is not None:
                _close(got[:, i:i + 1], alone.numpy())
                _close(got[:, i], want[:, i])


def _session(runner, feats, valid_chunk, whole_rows=False):
    """One session's first chunk through `runner` (zero caches) -> its
    (ys, host rows)."""
    fut = runner.submit(feats, runner.zero_cache(), 0, 0, valid_chunk,
                        whole_rows=whole_rows)
    ys, host, _ = fut.result(timeout=120)
    return ys, host


def _same_topk(host, logp):
    """The runner's packed top-k against the JAX log-probs."""
    ids = np.argsort(-logp, axis=-1, kind='stable')[:, :K]
    np.testing.assert_array_equal(host[:, K:2 * K].astype(np.int64), ids)
    np.testing.assert_allclose(host[:, :K],
                               np.take_along_axis(logp, ids, -1),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(host[:, 2 * K], logp[:, 0], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize('name', sorted(STREAMED))
def test_runner_serves_three_sessions_as_alone_and_jax(name):
    """Three sessions in one flush, with 4, 3 and 2 valid base frames, the
    last asking for whole rows (a WFST session): one step of B = 3 whose
    rows equal each session stepped alone, and the JAX runner's where it
    serves the encoder with the same frame count."""
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig)
    from wenet_tpu.runtime.batch_runner import (
        BatchedChunkRunner as JaxRunner)
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    model, variables, tmodel = models(name)
    cfg = _cfg(tmodel.encoder)
    factor = tmodel.encoder.output_downsampling_factor
    rng = np.random.RandomState(41)
    feats = [rng.randn(cfg.decoding_window, IDIM).astype(np.float32)
             for _ in range(3)]
    valid, whole = [4, 3, 2], [False, False, True]
    runner = BatchedChunkRunner(tmodel, cfg, max_batch=8, flush_ms=500.0,
                                beam_size=K, device='cpu')
    assert runner.chunk_base == 4
    frames = 4 // factor  # the encoder's output frames of a chunk
    try:
        with cf.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda a: _session(runner, *a),
                              zip(feats, valid, whole)))
        assert runner.batch_sizes == {3: 1}
    finally:
        runner.close()
    solo = BatchedChunkRunner(tmodel, cfg, max_batch=1, beam_size=K,
                              device='cpu')
    try:
        want = [_session(solo, *a) for a in zip(feats, valid, whole)]
    finally:
        solo.close()
    for (gy, gh), (wy, wh), w in zip(got, want, whole):
        _close(gy, wy.numpy(), 1e-5)
        assert gh.shape == ((frames, len(tmodel.ctc.ctc_lo.bias))
                            if w else (frames, 2 * K + 1))
        np.testing.assert_allclose(gh, wh, atol=1e-5, rtol=0)
    if factor != 1:
        return
    jrunner = JaxRunner(model, variables, JaxConfig(**vars(cfg)),
                        max_batch=8, flush_ms=500.0)
    try:
        jfuts = [jrunner.submit(f, jrunner.zero_cache(), 0, 0, n)
                 for f, n in zip(feats, valid)]
        jwant = [np.asarray(fut.result(timeout=120)[1])[0] for fut in jfuts]
    finally:
        jrunner.close()
    for (_, gh), j, w, n in zip(got, jwant, whole, valid):
        if w:
            _close(gh[:n], j[:n], 1e-4)
        else:
            _same_topk(gh[:n], j[:n])


# stream: (the step it starts at, its chunks, the valid base frames of its
# last chunk, a padded tail)
RAGGED = {0: (0, 3, 3), 1: (1, 3, 2), 2: (2, 2, 1)}


@pytest.mark.parametrize('name', sorted(STREAMED))
def test_runner_ragged_streams_match_jax(name):
    """Three streams that start at steps 0, 1 and 2 (so each step's rows
    have their own offsets and valid cache slots) and end on a padded
    tail chunk: every step of the port's runner (whole CTC rows) equals
    the JAX runner's on the same chunks, offsets and masks (encoder rows
    within 2e-4, log-probs within 1e-4) and the session stepped alone
    (1e-5).  Both runners are handed the port's offsets: the output
    frames emitted, which the JAX decoder counts at the base resolution
    for the efficient conformer (its frame count deliberately differs);
    the encoders read an offset alike."""
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig)
    from wenet_tpu.runtime.batch_runner import (
        BatchedChunkRunner as JaxRunner)
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    model, variables, tmodel = models(name)
    cfg = _cfg(tmodel.encoder)
    factor = tmodel.encoder.output_downsampling_factor
    C = cfg.required_cache_size
    rng = np.random.RandomState(43)
    port = BatchedChunkRunner(tmodel, cfg, max_batch=4, flush_ms=300.0,
                              beam_size=K, device='cpu')
    solo = BatchedChunkRunner(tmodel, cfg, max_batch=1, beam_size=K,
                              device='cpu')
    jax_runner = JaxRunner(model, variables, JaxConfig(**vars(cfg)),
                           max_batch=4, flush_ms=300.0)
    base = port.chunk_base
    state = {i: dict(port=port.zero_cache(), solo=solo.zero_cache(),
                     jax=jax_runner.zero_cache(), offset=0, valid=0)
             for i in RAGGED}
    try:
        for step in range(max(a + n for a, n, _ in RAGGED.values())):
            active = [i for i, (a, n, _) in RAGGED.items()
                      if a <= step < a + n]
            real, chunks = {}, {}
            for i in active:
                a, n, tail = RAGGED[i]
                real[i] = tail if step == a + n - 1 else base
                x = rng.randn(cfg.decoding_window, IDIM).astype(np.float32)
                # the frames a tail of real[i] base frames reads, zeros past
                x[(real[i] - 1) * cfg.subsampling_rate +
                  cfg.right_context + 1:] = 0.0
                chunks[i] = x
            futs = {i: (port.submit(chunks[i], state[i]['port'],
                                    state[i]['offset'], state[i]['valid'],
                                    real[i], whole_rows=True),
                        jax_runner.submit(chunks[i], state[i]['jax'],
                                          state[i]['offset'],
                                          state[i]['valid'], real[i]))
                    for i in active}
            for i in active:
                (ys, rows, state[i]['port']) = futs[i][0].result(timeout=120)
                (jys, jlogp, state[i]['jax']) = futs[i][1].result(
                    timeout=120)
                sys_, srows, state[i]['solo'] = solo.submit(
                    chunks[i], state[i]['solo'], state[i]['offset'],
                    state[i]['valid'], real[i],
                    whole_rows=True).result(timeout=120)
                n = -(-real[i] // factor)
                _close(ys[0, :n], np.asarray(jys)[0, :n])
                _close(rows[:n], np.asarray(jlogp)[0, :n], 1e-4)
                _close(ys, sys_.numpy(), 1e-5)
                np.testing.assert_allclose(rows, srows, atol=1e-5, rtol=0)
                state[i]['offset'] += n
                state[i]['valid'] = min(state[i]['valid'] + real[i], C)
    finally:
        port.close()
        solo.close()
        jax_runner.close()
    assert max(port.batch_sizes) == 3  # steps 2 served all three


@pytest.mark.parametrize('name', sorted(STREAMED))
def test_asr_decoder_over_runner_matches_jax_and_alone(name):
    """Two concurrent streams over one runner: every partial and the final
    equal the same stream decoded alone and, where the JAX decoder counts
    the encoder's frames as the port does (all but the efficient
    conformer, whose frames it counts at the base resolution), the JAX
    decoders' over the JAX runner."""
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig)
    from wenet_tpu.runtime.asr_decoder import (AsrDecoder as JaxDecoder,
                                               DecodeOptions as JaxOptions)
    from wenet_tpu.runtime.batch_runner import (
        BatchedChunkRunner as JaxRunner)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipelineConfig as JaxFeatures)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    model, variables, tmodel = models(name)
    cfg = _cfg(tmodel.encoder)
    runner = BatchedChunkRunner(tmodel, cfg, max_batch=2, flush_ms=20.0,
                                beam_size=K, device='cpu')

    def decoder(batch_runner=None):
        return AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                          FeaturePipelineConfig(num_mel_bins=IDIM),
                          batch_runner=batch_runner, device='cpu')

    def two_streams(make):
        with cf.ThreadPoolExecutor(2) as ex:
            return list(ex.map(lambda w: _stream(make(), w), waves))
    waves = [_wave(18, 1.7), _wave(19, 1.3)]
    try:
        got = two_streams(lambda: decoder(runner))
    finally:
        runner.close()
    alone = [_stream(decoder(), w) for w in waves]
    assert max(runner.batch_sizes) == 2  # the streams shared steps
    for (g_part, g_final), (a_part, a_final) in zip(got, alone):
        assert len(g_part) == len(a_part)
        for g, a in zip(g_part, a_part):
            _same(g, a)
        _same(g_final, a_final)
    if tmodel.encoder.output_downsampling_factor != 1:
        return
    jrunner = JaxRunner(model, variables, JaxConfig(**vars(cfg)),
                        max_batch=2, flush_ms=20.0)
    try:
        want = two_streams(lambda: JaxDecoder(
            model, variables, JaxTokenizer(SYMS), JaxOptions(**OPTS),
            JaxFeatures(num_mel_bins=IDIM), batch_runner=jrunner))
    finally:
        jrunner.close()
    for (g_part, g_final), (w_part, w_final) in zip(got, want):
        assert len(g_part) == len(w_part)
        for g, w in zip(g_part, w_part):
            _same(g, w)
        _same(g_final[1:], w_final[1:])
        _same(g_final[:1], w_final[:1], atol=2e-3, rtol=1e-5)
        assert g_final[0][0]


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernel')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(STREAMED))
def test_cuda_batched_step_matches_cpu(cuda, name):
    """The batched chunk step of three streams on the card against the
    CPU within 2e-4, K1 once per rel-pos block on the card (Squeezeformer's
    attention is plain)."""
    import copy
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    from wenet_tpu_torch.ops.flash_attention import LAUNCHES
    from wenet_tpu_torch.utils.init_model import init_model
    entry, overrides = STREAMED[name]
    model = init_model(zoo_config(entry, **overrides),
                       torch.Generator().manual_seed(0), device='cpu').eval()
    card = copy.deepcopy(model).cuda()
    cfg = _cfg(model.encoder)
    C = cfg.required_cache_size
    rng = np.random.RandomState(42)
    xs = torch.from_numpy(rng.randn(3, cfg.decoding_window, IDIM).astype(
        np.float32))
    (k, _), cnn = model.encoder.zero_cache(3, C)
    k, v = (torch.from_numpy(rng.randn(*k.shape).astype(np.float32))
            for _ in range(2))
    cnn = None if cnn is None else torch.from_numpy(
        rng.randn(*cnn.shape).astype(np.float32))
    mask = torch.cat([streaming_att_mask(1, C, 4, n, r)
                      for n, r in ((0, 4), (5, 4), (8, 3))])
    offsets = torch.tensor([0, 3, 37])
    with torch.inference_mode():
        want = model.forward_encoder_chunk(xs, offsets, (k, v), cnn, mask)
        before = LAUNCHES['relpos_attention_fwd']
        got = card.forward_encoder_chunk(
            xs.cuda(), offsets.cuda(), (k.cuda(), v.cuda()),
            None if cnn is None else cnn.cuda(), mask.cuda())
        torch.cuda.synchronize()
    from wenet_tpu_torch.models.transformer.attention import (
        RelPositionMultiHeadedAttention)
    rel_pos = sum(type(m) is RelPositionMultiHeadedAttention
                  for m in card.encoder.modules())
    assert LAUNCHES['relpos_attention_fwd'] - before == rel_pos
    _close(got[0].cpu(), want[0].numpy())
    for g, w in zip(got[1], want[1]):
        _close(g.cpu(), w.numpy())
