"""The streaming slice against the JAX package at a tiny width: the chunk
step's parts (position encoding at negative offsets, subsampling with an
offset, rel-pos attention with its (k, v) cache, the causal conv module
with its cache), `forward_chunk` chunk by chunk with the caches after
each chunk, `forward_chunk_by_chunk`, and the runner's
`simulate_streaming`, `decode_wav` and `transcribe`.

Same weights (`state_dict_from_jax`), same numpy inputs.  Bars: each
module and chunk output, and each cache, within 2e-4 of JAX (the
torch-import bar); the chunk loop equal to the port's own full forward
under the same chunk mask within 1e-4 (the repo's streaming-equal-to-full
bar); hypotheses identical.  The `cuda` tests hold K1 at the serving
chunk step's shapes to its plain version and the chunk loop on the card
to the CPU's; they skip without a card.  jax is imported inside the CPU
tests only, so the file also collects where jax is absent."""

import numpy as np
import pytest
import torch

from torch_port_utils import IDIM, jax_model, tiny_config, torch_model

ATOL = 2e-4
FULL_ATOL = 1e-4
MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring']


@pytest.fixture(scope='module')
def pair():
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=7)
    return model, variables, torch_model(cfg, variables)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_position_encoding_negative_offset(pair):
    """Positions below 0 (a chunk step's empty cache slots) read 0."""
    import jax.numpy as jnp
    model, variables, tmodel = pair
    jm = model.bind(variables)
    for offset in (-40, -3, 0, 17):
        want = jm.encoder.embed.position_encoding(jnp.asarray(offset), 48)
        got = tmodel.encoder.embed.position_encoding(offset, 48)
        _close(got, want, 1e-6)


def test_subsampling_with_offset(pair):
    import jax.numpy as jnp
    model, variables, tmodel = pair
    jm = model.bind(variables)
    x = np.random.RandomState(1).randn(2, 19, IDIM).astype(np.float32)
    mask = np.ones((2, 1, 19), bool)
    jx, jpos, _ = jm.encoder.embed(jnp.asarray(x), jnp.asarray(mask), 12)
    tx, tpos, _ = tmodel.encoder.embed(torch.from_numpy(x),
                                       torch.from_numpy(mask), 12)
    _close(tx, jx)
    _close(tpos, jpos)


def test_attention_with_cache(pair):
    """The cache goes in front of the chunk's keys; the returned cache is
    the concatenation, as the JAX module returns it."""
    import jax.numpy as jnp
    model, variables, tmodel = pair
    jm = model.bind(variables)
    rng = np.random.RandomState(2)
    B, T, C, D, H = 2, 4, 8, 64, 2
    x = rng.randn(B, T, D).astype(np.float32)
    k, v = (rng.randn(B, H, C, D // H).astype(np.float32) for _ in range(2))
    mask = np.ones((B, 1, C + T), bool)
    mask[0, :, :5] = False  # 5 empty cache slots in the first row
    pos = rng.randn(1, C + T, D).astype(np.float32)
    jout, (jk, jv) = jm.encoder.encoders[1].self_attn(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(pos), cache=(jnp.asarray(k), jnp.asarray(v)))
    t = torch.from_numpy(x)
    out, (tk, tv) = tmodel.encoder.encoders[1].self_attn(
        t, t, t, torch.from_numpy(mask), torch.from_numpy(pos),
        cache=(torch.from_numpy(k), torch.from_numpy(v)))
    _close(out, jout)
    _close(tk, jk)
    _close(tv, jv)


def test_conv_module_with_cache(pair):
    import jax.numpy as jnp
    model, variables, tmodel = pair
    jm = model.bind(variables)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 64).astype(np.float32)
    cache = rng.randn(2, 7, 64).astype(np.float32)
    mask = np.ones((2, 1, 6), bool)
    mask[1, :, 4:] = False  # a padded tail
    jout, jcache = jm.encoder.encoders[0].conv_module(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(cache))
    out, new_cache = tmodel.encoder.encoders[0].conv_module(
        torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(cache))
    _close(out, jout)
    _close(new_cache, jcache)


def test_streaming_att_mask_matches_jax():
    from wenet_tpu.models.transformer.streaming import (
        streaming_att_mask as jax_mask)
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    for cache, valid, chunk in ((8, 0, None), (8, 5, None), (8, 30, 2),
                                (512, 16, 16), (512, 368, 7)):
        np.testing.assert_array_equal(
            streaming_att_mask(2, cache, 16, valid, chunk).numpy(),
            jax_mask(2, cache, 16, valid, chunk))


def _chunks(num_frames, cfg):
    """(start, real_out) of each chunk of forward_chunk_by_chunk."""
    context = cfg.right_context + 1
    out = []
    for cur in range(0, num_frames - context + 1, cfg.stride):
        n = min(cur + cfg.decoding_window, num_frames) - cur
        out.append((cur, (n - context) // cfg.subsampling_rate + 1))
    return out


# 141 frames: the last chunk holds 13 of its 19 frames (a padded tail)
@pytest.mark.parametrize('left', [-1, 2])
def test_forward_chunk_matches_jax(pair, left):
    """Chunk after chunk, the outputs and both caches against JAX's
    `forward_encoder_chunk` on the same state."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, init_streaming_state as jax_state,
        streaming_att_mask as jax_mask)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, init_streaming_state, streaming_att_mask)
    model, variables, tmodel = pair
    cfg = StreamingConfig(4, left)
    jcfg = JaxConfig(4, left)
    x = np.random.RandomState(4).randn(1, 141, IDIM).astype(np.float32)
    js = jax_state(model.encoder, 1, jcfg)
    ts = init_streaming_state(tmodel.encoder, 1, cfg)
    chunks = _chunks(141, cfg)
    assert chunks[-1][1] < cfg.decoding_chunk_size  # the tail is padded
    for cur, real_out in chunks:
        xs = x[:, cur:cur + cfg.decoding_window]
        xs = np.pad(xs, ((0, 0), (0, cfg.decoding_window - xs.shape[1]),
                         (0, 0)))
        jy, js.att_cache, js.cnn_cache = model.apply(
            variables, jnp.asarray(xs), jnp.asarray(js.offset),
            js.att_cache, js.cnn_cache,
            jax_mask(1, cfg.required_cache_size, 4, js.valid_cache,
                     real_out), method=model.forward_encoder_chunk)
        with torch.inference_mode():
            ty, ts.att_cache, ts.cnn_cache = tmodel.forward_encoder_chunk(
                torch.from_numpy(xs), ts.offset, ts.att_cache, ts.cnn_cache,
                streaming_att_mask(1, cfg.required_cache_size, 4,
                                   ts.valid_cache, real_out))
        _close(ty[:, :real_out], jy[:, :real_out])
        for got, want in zip(ts.att_cache + (ts.cnn_cache,),
                             js.att_cache + (js.cnn_cache,)):
            assert tuple(got.shape) == want.shape
            _close(got, want)
        for s in (js, ts):
            s.offset += real_out
            s.valid_cache = min(s.valid_cache + real_out,
                                cfg.required_cache_size)


@pytest.mark.parametrize('left,frames', [(-1, 141), (2, 141), (2, 150)])
def test_chunk_by_chunk_matches_jax_and_full(pair, left, frames):
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, forward_chunk_by_chunk as jax_fcc)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    model, variables, tmodel = pair
    x = np.random.RandomState(5).randn(1, frames, IDIM).astype(np.float32)
    jy, _ = jax_fcc(model, variables, jnp.asarray(x), JaxConfig(4, left))
    with torch.inference_mode():
        ty, tmask = forward_chunk_by_chunk(tmodel, torch.from_numpy(x),
                                           StreamingConfig(4, left))
        full, fmask = tmodel.forward_encoder(
            torch.from_numpy(x), torch.tensor([frames]), 4, left)
    assert tuple(ty.shape) == jy.shape == tuple(full.shape)
    assert bool(tmask.all()) and bool(fmask.all())
    _close(ty, jy)
    _close(ty, full.numpy(), FULL_ATOL)


def test_chunk_by_chunk_non_causal_conv_matches_jax():
    """A conformer whose conv module is not causal keeps no conv cache
    (None in both packages) and looks right within the chunk."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, forward_chunk_by_chunk as jax_fcc)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    cfg = tiny_config(causal=False, cnn_module_kernel=7, num_blocks=1)
    model, variables = jax_model(cfg, seed=8)
    tmodel = torch_model(cfg, variables)
    assert tmodel.encoder.zero_cnn_cache(1) is None
    x = np.random.RandomState(9).randn(1, 100, IDIM).astype(np.float32)
    jy, _ = jax_fcc(model, variables, jnp.asarray(x), JaxConfig(4, 2))
    with torch.inference_mode():
        ty, _ = forward_chunk_by_chunk(tmodel, torch.from_numpy(x),
                                       StreamingConfig(4, 2))
    _close(ty, jy)


@pytest.mark.parametrize('left', [-1, 2])
def test_simulate_streaming_matches_jax(pair, left):
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    model, variables, tmodel = pair
    x = np.random.RandomState(6).randn(1, 141, IDIM).astype(np.float32)
    kw = dict(beam_size=4, ctc_weight=0.3, reverse_weight=0.3,
              decoding_chunk_size=4, num_decoding_left_chunks=left,
              simulate_streaming=True)
    want = JaxRunner(model, variables).decode(MODES, x, [141], **kw)
    got = AsrRunner(tmodel, 'cpu').decode(MODES, x, [141], **kw)
    for mode in MODES:
        assert got[mode][0].tokens == want[mode][0].tokens, mode
    assert got['ctc_prefix_beam_search'][0].nbest == \
        want['ctc_prefix_beam_search'][0].nbest
    assert got['attention_rescoring'][0].tokens


def _waveforms(seed, B=3):
    rng = np.random.RandomState(seed)
    S = int(1.4 * 16000)
    wav = (0.2 * rng.randn(B, S)).astype(np.float32)
    lens = np.asarray([S] + list(rng.randint(S // 2, S, size=B - 1)))
    return wav, lens


def test_decode_wav_matches_jax(pair):
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    model, variables, tmodel = pair
    wav, lens = _waveforms(8)
    kw = dict(num_mel_bins=IDIM, beam_size=4, ctc_weight=0.3,
              reverse_weight=0.3)
    want = JaxRunner(model, variables).decode_wav(MODES, wav, lens, **kw)
    got = AsrRunner(tmodel, 'cpu').decode_wav(MODES, wav, lens, **kw)
    for mode in MODES:
        assert [r.tokens for r in got[mode]] == \
            [r.tokens for r in want[mode]], mode


def test_transcribe_matches_jax(pair, tmp_path):
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu.ops.fbank import compute_fbank_np as jax_fbank_np
    from wenet_tpu.text.char_tokenizer import CharTokenizer as JaxTokenizer
    from wenet_tpu_torch.dataset.audio import read_wav, write_wav
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops.fbank import compute_fbank_np
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    model, variables, tmodel = pair
    wav, _ = _waveforms(9, B=1)
    path = str(tmp_path / 'utt.wav')
    write_wav(path, wav[0], 16000)
    syms = {f'c{i}': i for i in range(30)}

    def feature(fbank_np):
        def compute(p):
            return fbank_np(read_wav(p)[0][0] * (1 << 15),
                            num_mel_bins=IDIM)
        return compute
    want = JaxRunner(model, variables).transcribe(
        path, JaxTokenizer(syms), feature(jax_fbank_np))
    got = AsrRunner(tmodel, 'cpu').transcribe(
        path, CharTokenizer(syms), feature(compute_fbank_np))
    assert got.tokens == want.tokens and got.tokens
    assert got.text == want.text


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
@pytest.mark.parametrize('valid_cache,valid_chunk', [(16, 16), (256, 16),
                                                     (368, 7)])
def test_cuda_k1_at_serving_shapes(cuda, dtype, valid_cache, valid_chunk):
    """K1 at the flagship's chunk step: 16 queries, 512 cache slots + 16
    keys, d = 64, p shared by the batch; the right-aligned cache mask,
    and a padded tail chunk's."""
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    from wenet_tpu_torch.ops.flash_attention import (
        LAUNCHES, flash_attention_relpos, relpos_fwd_reference)
    rng = np.random.RandomState(10)
    B, h, T1, C, d = 1, 4, 16, 512, 64

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda(
            ).to(dtype)
    q1 = t(B, T1, h, d).transpose(1, 2)
    q2 = t(B, T1, h, d).transpose(1, 2)
    k, v, p = t(B, h, C + T1, d), t(B, h, C + T1, d), t(1, h, C + T1, d)
    mask = streaming_att_mask(B, C, T1, valid_cache, valid_chunk, 'cuda')
    before = LAUNCHES['relpos_attention_fwd']
    got = flash_attention_relpos(q1, q2, k, p, v, mask, d ** -0.5)
    torch.cuda.synchronize()
    assert LAUNCHES['relpos_attention_fwd'] == before + 1
    want, _ = relpos_fwd_reference(*(x.float() for x in (q1, q2, k, p, v)),
                                   mask, d ** -0.5)
    torch.testing.assert_close(got.float(), want, **CUDA_TOL[dtype])


@pytest.mark.cuda
def test_cuda_chunk_by_chunk_matches_cpu(cuda):
    """The chunk loop on the card (K1 in every block) against the CPU's,
    within 2e-4, and against the card's full forward within 1e-4."""
    import copy
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    from wenet_tpu_torch.ops.flash_attention import LAUNCHES
    from wenet_tpu_torch.utils.init_model import init_model
    tmodel = init_model(tiny_config(), torch.Generator().manual_seed(0),
                        device='cpu').eval()
    gpu = copy.deepcopy(tmodel).cuda()
    x = torch.from_numpy(
        np.random.RandomState(11).randn(1, 141, IDIM).astype(np.float32))
    cfg = StreamingConfig(4, -1)
    with torch.inference_mode():
        want, _ = forward_chunk_by_chunk(tmodel, x, cfg)
        before = LAUNCHES['relpos_attention_fwd']
        got, _ = forward_chunk_by_chunk(gpu, x.cuda(), cfg)
        n = LAUNCHES['relpos_attention_fwd'] - before
        full, _ = gpu.forward_encoder(x.cuda(), torch.tensor([141]).cuda(),
                                      4, -1)
    assert n == len(gpu.encoder.encoders) * len(_chunks(141, cfg))
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=0)
    torch.testing.assert_close(got, full, atol=FULL_ATOL, rtol=0)
