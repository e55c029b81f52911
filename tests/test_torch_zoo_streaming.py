"""Streaming the encoder zoo in the PyTorch port against the JAX package:
E-Branchformer (the cgMLP conv's cache), the efficient conformer (caches
at the base resolution, half as many output frames, grouped attention
on a broadcast mask) and Squeezeformer (the time reduction inside a
chunk, `rel_shift_window`), each causal, at tiny width
(tests/torch_port_utils.py `ZOO_ENCODERS`), chunk 4 with two left
chunks.

Same weights, same numpy features.  Chunk after chunk, the output and
the caches of `forward_encoder_chunk` agree with the JAX package's within
2e-4, up to a padded tail chunk whose valid base frames are even (139
frames: 2) or odd (143 frames: 3); `forward_chunk_by_chunk` agrees with
the JAX package's; E-Branchformer with a pointwise merge conv streams to
its full forward under the chunk mask within 1e-4, as
tests/test_branchformer.py holds the JAX one; `AsrDecoder` decodes the
zoo chunk by chunk: its partials and final equal the JAX decoder's for
E-Branchformer and Squeezeformer, and for the efficient conformer its
encoder outputs equal `forward_chunk_by_chunk`'s (the JAX decoder
counts the efficient conformer's frames at the base resolution)."""

import numpy as np
import pytest
import torch

from torch_port_utils import IDIM, VOCAB, jax_model, torch_model, zoo_config

ATOL = 2e-4
FULL_ATOL = 1e-4
STREAMED = {  # causal, dynamic-chunk variants of the zoo's yamls
    'e_branchformer': dict(causal=True, use_dynamic_chunk=True),
    'efficient_conformer': {},
    'squeezeformer': dict(causal=True, use_dynamic_chunk=True,
                          cnn_norm_type='batch_norm'),
}
_MODELS = {}


def models(name, **overrides):
    key = (name, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        cfg = zoo_config(name, **dict(STREAMED[name], **overrides))
        model, variables = jax_model(cfg, seed=len(_MODELS) + 60)
        _MODELS[key] = (model, variables, torch_model(cfg, variables))
    return _MODELS[key]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


def _chunks(num_frames, cfg):
    """(start, valid base frames) of each chunk of forward_chunk_by_chunk."""
    context = cfg.right_context + 1
    return [(cur, (min(cur + cfg.decoding_window, num_frames) - cur -
                   context) // cfg.subsampling_rate + 1)
            for cur in range(0, num_frames - context + 1, cfg.stride)]


@pytest.mark.parametrize('frames', [139, 143])
@pytest.mark.parametrize('name', sorted(STREAMED))
def test_forward_chunk_matches_jax(name, frames):
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, init_streaming_state as jax_state,
        streaming_att_mask as jax_mask)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, init_streaming_state, streaming_att_mask)
    model, variables, tmodel = models(name)
    factor = tmodel.encoder.output_downsampling_factor
    cfg, jcfg = StreamingConfig(4, 2), JaxConfig(4, 2)
    x = np.random.RandomState(frames).randn(1, frames, IDIM).astype(
        np.float32)
    js = jax_state(model.encoder, 1, jcfg)
    ts = init_streaming_state(tmodel.encoder, 1, cfg)
    chunks = _chunks(frames, cfg)
    assert chunks[-1][1] == 2 + (frames == 143)  # a padded tail
    for cur, real_base in chunks:
        real_out = -(-real_base // factor)
        xs = x[:, cur:cur + cfg.decoding_window]
        xs = np.pad(xs, ((0, 0), (0, cfg.decoding_window - xs.shape[1]),
                         (0, 0)))
        jy, js.att_cache, js.cnn_cache = model.apply(
            variables, jnp.asarray(xs), jnp.asarray(js.offset),
            js.att_cache, js.cnn_cache,
            jax_mask(1, cfg.required_cache_size, 4, js.valid_cache,
                     real_base), method=model.forward_encoder_chunk)
        with torch.inference_mode():
            ty, ts.att_cache, ts.cnn_cache = tmodel.forward_encoder_chunk(
                torch.from_numpy(xs), ts.offset, ts.att_cache, ts.cnn_cache,
                streaming_att_mask(1, cfg.required_cache_size, 4,
                                   ts.valid_cache, real_base))
        assert tuple(ty.shape) == jy.shape == (1, 4 // factor, 64)
        _close(ty[:, :real_out], jy[:, :real_out])
        for got, want in zip(ts.att_cache + (ts.cnn_cache,),
                             js.att_cache + (js.cnn_cache,)):
            assert tuple(got.shape) == want.shape
            _close(got, want)
        for s in (js, ts):
            s.offset += real_out
            s.valid_cache = min(s.valid_cache + real_base,
                                cfg.required_cache_size)


@pytest.mark.parametrize('name', sorted(STREAMED))
def test_chunk_by_chunk_matches_jax(name):
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, forward_chunk_by_chunk as jax_fcc)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    model, variables, tmodel = models(name)
    x = np.random.RandomState(5).randn(1, 143, IDIM).astype(np.float32)
    jy, _ = jax_fcc(model, variables, jnp.asarray(x), JaxConfig(4, 2))
    with torch.inference_mode():
        ty, mask = forward_chunk_by_chunk(tmodel, torch.from_numpy(x),
                                          StreamingConfig(4, 2))
    assert tuple(ty.shape) == jy.shape and bool(mask.all())
    _close(ty, jy)


def test_e_branchformer_streaming_matches_full():
    """A pointwise merge conv (kernel 1) keeps no context across chunks,
    so streaming equals the full forward under the chunk mask."""
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    _, _, tmodel = models('e_branchformer', merge_conv_kernel=1)
    x = torch.from_numpy(
        np.random.RandomState(6).randn(1, 143, IDIM).astype(np.float32))
    with torch.inference_mode():
        ty, _ = forward_chunk_by_chunk(tmodel, x, StreamingConfig(4, -1))
        full, _ = tmodel.forward_encoder(x, torch.tensor([143]), 4, -1)
    assert ty.shape == full.shape
    _close(ty, full.numpy(), FULL_ATOL)


SYMS = {'<blank>': 0, '<unk>': 1, '<sos/eos>': 2}
SYMS.update({chr(ord('a') + i): i + 3 for i in range(VOCAB - 3)})
OPTS = dict(chunk_size=4, num_left_chunks=2, beam_size=3)


def _wave(seed, seconds):
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = 0.15 * rng.randn(len(t))
    for f in rng.uniform(150, 3000, size=3):
        x += 0.1 * np.sin(2 * np.pi * f * t) * (np.sin(2 * np.pi * t) > 0)
    return np.round(np.clip(x, -1, 1) * 32767).astype(np.float32) / 32768


def _stream(dec, wav, piece=3200):
    """Feed `wav` in pieces; -> (partials after every decode(), final)."""
    partials = []
    for lo in range(0, len(wav), piece):
        dec.accept_waveform(wav[lo:lo + piece])
        dec.decode()
        partials.append([(r.sentence, r.score) for r in dec.result])
    dec.set_input_finished()
    dec.decode()
    partials.append([(r.sentence, r.score) for r in dec.result])
    dec.rescoring()
    return partials, [(r.sentence, r.score) for r in dec.result]


def _port_decoder(tmodel):
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    return AsrDecoder(tmodel, CharTokenizer(SYMS), DecodeOptions(**OPTS),
                      FeaturePipelineConfig(num_mel_bins=IDIM), device='cpu')


@pytest.mark.parametrize('name', ['e_branchformer', 'squeezeformer'])
def test_asr_decoder_matches_jax(name):
    from wenet_tpu.runtime.asr_decoder import (AsrDecoder as JaxDecoder,
                                               DecodeOptions as JaxOptions)
    from wenet_tpu.runtime.feature_pipeline import (
        FeaturePipeline as JaxPipeline, FeaturePipelineConfig as JaxConfig)
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    model, variables, tmodel = models(name)
    jd = JaxDecoder(model, variables, JaxTokenizer(SYMS), JaxOptions(**OPTS))
    jd.feature_pipeline = JaxPipeline(JaxConfig(num_mel_bins=IDIM),
                                      prefer_native=False)
    jd.reset()
    wav = _wave(3, 1.9)
    want_partials, want_final = _stream(jd, wav)
    got_partials, got_final = _stream(_port_decoder(tmodel), wav)
    assert len(got_partials) == len(want_partials)
    for g, w in zip(got_partials + [got_final], want_partials + [want_final]):
        assert [s for s, _ in g] == [s for s, _ in w]
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                                   atol=2e-3, rtol=1e-5)
    assert got_final[0][0]


def test_asr_decoder_efficient_conformer():
    """The decoder emits ceil(base / 2) frames per chunk and counts its
    offset in them: its encoder outputs are forward_chunk_by_chunk's on
    the same features, and its final is decoded."""
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipeline, FeaturePipelineConfig)
    _, _, tmodel = models('efficient_conformer')
    wav = _wave(4, 2.1)
    dec = _port_decoder(tmodel)
    assert dec.factor == 2 and dec.endpointer.frame_shift_in_ms == 80
    _, final = _stream(dec, wav)
    pipeline = FeaturePipeline(FeaturePipelineConfig(num_mel_bins=IDIM))
    feats = pipeline.accept_waveform(wav)
    with torch.inference_mode():
        want, _ = forward_chunk_by_chunk(
            tmodel, torch.from_numpy(feats)[None], StreamingConfig(4, 2))
    got = torch.cat(dec.encoder_outs)[None]
    assert got.shape == want.shape
    _close(got, want.numpy(), 1e-5)
    assert final[0][0]


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the subsampling convs


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(STREAMED))
def test_cuda_chunk_by_chunk_matches_cpu(cuda, name):
    """The zoo's chunk loop on the card against the CPU's within 2e-4."""
    import copy
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    from wenet_tpu_torch.utils.init_model import init_model
    cpu = init_model(zoo_config(name, **STREAMED[name]),
                     torch.Generator().manual_seed(0), device='cpu').eval()
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(
        np.random.RandomState(12).randn(1, 143, IDIM).astype(np.float32))
    with torch.inference_mode():
        want, _ = forward_chunk_by_chunk(cpu, x, StreamingConfig(4, 2))
        got, _ = forward_chunk_by_chunk(gpu, x.cuda(), StreamingConfig(4, 2))
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=0)
