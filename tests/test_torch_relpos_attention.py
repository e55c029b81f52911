"""Rel-pos attention: the port's plain version against the JAX kernel, and
the CUDA kernel against the plain version.

On the CPU the JAX `flash_attention_relpos` runs its Pallas kernel in
interpret mode (as tests/test_flash_attention.py does) and the port's
`relpos_fwd_reference` must agree within 1e-5.  The `cuda` tests
build the Hopper kernel and need a card; jax is imported inside the CPU
tests only, so the file also collects where jax is absent."""

import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch.ops.flash_attention import (LAUNCHES, NEG_INF,
                                                 flash_attention_relpos,
                                                 relpos_fwd,
                                                 relpos_fwd_reference)

from torch_port_utils import fill_allocator_with_nan


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(rng, B, h, T1, T2, d, p_batch, mask_kind):
    q1, q2 = (rng.randn(B, h, T1, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, h, T2, d).astype(np.float32) for _ in range(2))
    p = rng.randn(p_batch, h, T2, d).astype(np.float32)
    keys = np.arange(T2)
    if mask_kind is None:
        mask = None
    elif mask_kind in ('pad', 'peaked', 'gap'):  # (B, 1, T2) key padding
        lens = rng.randint(T2 // 2, T2 + 1, size=(B,))
        mask = (keys[None, :] < lens[:, None])[:, None, :]
        if mask_kind == 'peaked':  # a peaked softmax
            q1, q2 = q1 * 8, q2 * 8
        elif mask_kind == 'gap':  # key tiles 1 and 2 closed for every row
            mask = mask & ((keys < 64) | (keys >= 192))
    elif mask_kind == 'step':
        # a streaming chunk step: the last T1 keys are the chunk, the cache
        # before it holds `cache` frames (none for the first utterance)
        cache = rng.randint(0, T2 - T1 + 1, size=(B,))
        cache[0] = 0
        mask = (keys[None, :] >= T2 - T1 - cache[:, None])[:, None, :]
    else:  # (B, T1, T2) static chunk of 8 over key padding
        chunk = 8
        row = np.arange(T1)[:, None] // chunk
        chunk_mask = np.arange(T2)[None, :] < (row + 1) * chunk
        lens = rng.randint(T2 // 2, T2 + 1, size=(B,))
        mask = chunk_mask[None] & (np.arange(T2) < lens[:, None])[:, None]
        if mask_kind == 'masked_row':
            mask[0, 3] = False
    return q1, q2, k, p, v, mask


CASES = [  # B, h, T1, T2, d, p batch, mask
    (2, 4, 37, 53, 64, 2, None),           # ragged, no mask
    (2, 2, 40, 40, 32, 1, 'pad'),          # key padding, p broadcast
    (2, 2, 48, 48, 32, 1, 'chunk'),        # static chunk mask
    (1, 2, 24, 24, 32, 1, 'masked_row'),   # one fully masked row
]


@pytest.mark.parametrize('B,h,T1,T2,d,pb,mask_kind', CASES)
def test_reference_matches_jax_kernel(interpret_pallas, B, h, T1, T2, d,
                                      pb, mask_kind):
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import flash_attention_relpos as jfa
    rng = np.random.RandomState(0)
    arrs = _inputs(rng, B, h, T1, T2, d, pb, mask_kind)
    scale = 1.0 / np.sqrt(d)
    q1, q2, k, p, v, mask = arrs
    want = jfa(*(jnp.asarray(a) for a in (q1, q2, k, p, v)),
               None if mask is None else jnp.asarray(mask), scale,
               block_q=16, block_k=16)
    got, _ = relpos_fwd_reference(
        *(torch.from_numpy(a) for a in (q1, q2, k, p, v)),
        None if mask is None else torch.from_numpy(mask), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if mask_kind == 'masked_row':
        assert not got[0, :, 3].any()


def test_cpu_tensors_take_plain_version():
    rng = np.random.RandomState(1)
    q1, q2, k, p, v, mask = (torch.from_numpy(a) for a in _inputs(
        rng, 2, 2, 9, 11, 32, 1, 'pad'))
    before = dict(LAUNCHES)
    got = flash_attention_relpos(q1, q2, k, p, v, mask, 0.2)
    want, _ = relpos_fwd_reference(q1, q2, k, p, v, mask, 0.2)
    assert torch.equal(got, want)
    assert LAUNCHES == before


@pytest.mark.parametrize('bad', ['mask_heads', 'mask_len', 'mask_dtype',
                                 'p_batch', 'head_dim', 'dtype',
                                 'inner_stride', 'unaligned'])
def test_kernel_wrapper_rejects(bad):
    """What the kernel does not take raises before launch (checked on
    shape-only meta tensors, so no card is needed), with the 16-byte
    alignment K1's copies need."""
    from wenet_tpu_torch.ops.flash_attention import _check
    B, h, T1, T2, d = 2, 4, 5, 7, 64

    def t(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device='meta')
    q1 = t(B, T1, h, d).transpose(1, 2)  # strided views are fine
    k, p, v = t(B, h, T2, d), t(1, h, T2, d), t(B, h, T2, d)
    mask = t(B, 1, 1, T2, dtype=torch.bool)
    _check(q1, q1, k, p, v, mask, aligned=True)
    if bad == 'mask_heads':
        mask = t(B, h, T1, T2, dtype=torch.bool)
    elif bad == 'mask_len':
        mask = t(B, 1, T1, T2 + 1, dtype=torch.bool)
    elif bad == 'mask_dtype':
        mask = t(B, 1, T1, T2)
    elif bad == 'p_batch':
        p = t(3, h, T2, d)
    elif bad == 'head_dim':
        q1, k, p, v = (t(*x.shape[:3], 48) for x in (q1, k, p, v))
    elif bad == 'dtype':
        q1 = t(B, h, T1, d, dtype=torch.float16)
    elif bad == 'unaligned':  # rows 4 * 65 bytes apart: no 16-byte copies
        p = t(1, h, T2, d + 1)[..., :d]
    else:
        v = t(B, h, d, T2).transpose(2, 3)
    with pytest.raises(ValueError):
        _check(q1, q1, k, p, v, mask, aligned=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernel')
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda(arrs, dtype):
    """q1, q2, k, p, v on the card in `dtype`, q1 and q2 as strided
    (B, T, h, d)-ordered views, as the attention module gives them; the
    mask as is."""
    q1, q2, k, p, v = (torch.from_numpy(a).cuda().to(dtype)
                       for a in arrs[:5])
    q1, q2 = (x.transpose(1, 2).contiguous().transpose(1, 2)
              for x in (q1, q2))
    mask = None if arrs[5] is None else torch.from_numpy(arrs[5]).cuda()
    return [q1, q2, k, p, v], mask


# fp32: summation order and 3xTF32; bf16: against fp32 on the same rounded
# inputs, about 2 bf16 ulps of the output
CUDA_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,h,T1,T2,d,pb,mask_kind', CASES + [
    (3, 4, 130, 200, 64, 3, 'pad'), (2, 2, 70, 70, 128, 1, 'chunk'),
    (2, 4, 150, 150, 64, 1, 'peaked'), (2, 2, 100, 448, 64, 1, 'gap'),
    (4, 4, 16, 80, 64, 1, 'step'), (2, 2, 130, 200, 128, 1, 'pad')])
def test_cuda_kernel_matches_plain(cuda, dtype, B, h, T1, T2, d, pb,
                                   mask_kind):
    rng = np.random.RandomState(2)
    x, mask = _cuda(_inputs(rng, B, h, T1, T2, d, pb, mask_kind), dtype)
    scale = 1.0 / np.sqrt(d)
    got = flash_attention_relpos(*x, mask, scale)
    torch.cuda.synchronize()
    want, _ = relpos_fwd_reference(*(t.float() for t in x), mask, scale)
    torch.testing.assert_close(got.float(), want, **CUDA_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_closed_tiles_write_zeros(cuda, dtype):
    """K1 and K1-train skip the key tiles the mask closes for every row
    of a query block; a block with no open tile still writes zeros and
    lse = NEG_INF, not what the allocator held (NaN here).  One-row mask:
    the first utterance has no key at all; per-row mask: rows 64..127
    (the second query block) attend nothing."""
    rng = np.random.RandomState(12)
    B, h, T1, T2, d = 2, 2, 200, 150, 64
    arrs = _inputs(rng, B, h, T1, T2, d, 1, 'pad')
    one_row = arrs[5].copy()
    one_row[0] = False
    rows = np.broadcast_to(arrs[5], (B, T1, T2)).copy()
    rows[:, 64:128] = False
    for mask_np, closed in ((one_row, (0, slice(None))),
                            (rows, (slice(None), slice(64, 128)))):
        x, mask = _cuda(arrs[:5] + (mask_np,), dtype)
        scale = 1.0 / np.sqrt(d)
        x32 = [t.float() for t in x]
        fill_allocator_with_nan()
        out, _ = relpos_fwd(*x, mask, scale)
        fill_allocator_with_nan()
        out_t, lse = relpos_fwd(*x, mask, scale, True, 0.1, 7)
        torch.cuda.synchronize()
        b, r = closed
        for got in (out, out_t, lse):
            assert torch.isfinite(got).all()
        assert out[b, :, r].eq(0).all() and out_t[b, :, r].eq(0).all()
        assert lse[b, :, r].eq(NEG_INF).all()
        want, _ = relpos_fwd_reference(*x32, mask, scale)
        want_t, want_lse = relpos_fwd_reference(*x32, mask, scale, True,
                                                0.1, 7)
        torch.testing.assert_close(out.float(), want, **CUDA_TOL[dtype])
        torch.testing.assert_close(out_t.float(), want_t,
                                   **CUDA_TOL[dtype])
        torch.testing.assert_close(lse, want_lse,
                                   **CUDA_TOL[torch.float32])
