"""Masked flash attention (K4): the port's plain version against the JAX
kernel, the `attention_core` dispatch, and the CUDA kernel against the
plain version.

On the CPU the JAX `flash_attention` runs its Pallas kernel in interpret
mode (as tests/test_flash_attention.py does) and the port's
`flash_fwd_reference` must agree within 2e-5.  The `cuda` tests build
the Hopper kernel and need a card; jax is imported inside the CPU tests
only."""

import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch.ops import flash_attention as fa
from wenet_tpu_torch.models.transformer import attention as A


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(rng, B, h, T1, T2, d, mask_kind, use_bias):
    q = rng.randn(B, h, T1, d).astype(np.float32)
    k, v = (rng.randn(B, h, T2, d).astype(np.float32) for _ in range(2))
    lens = rng.randint(T2 // 2, T2 + 1, size=(B,))
    if mask_kind == 'short':  # the last two 64-key tiles closed
        lens = rng.randint(T2 // 4, T2 - 127, size=(B,))
    pad = np.arange(T2)[None, :] < lens[:, None]
    if mask_kind is None:
        mask = None
    elif mask_kind in ('pad', 'short', 'peaked'):  # (B, 1, T2) key padding
        mask = pad[:, None, :]
        if mask_kind == 'peaked':  # a peaked softmax
            q = q * 8
    elif mask_kind in ('heads', 'gap'):  # (B, h, 1, T2): a pad mask per head
        mask = np.stack([np.arange(T2)[None, :] < rng.randint(
            1, T2 + 1, size=(B, 1)) for _ in range(h)], axis=1)[:, :, None]
        if mask_kind == 'gap':  # keys 64..191 closed: whole tiles mid-row
            mask = mask & ((np.arange(T2) < 64) | (np.arange(T2) >= 192))
    else:  # (B, T1, T2): causal over key padding
        mask = ((np.arange(T2)[None, :] <= np.arange(T1)[:, None])[None]
                & pad[:, None, :])
        if mask_kind == 'masked_row':
            mask[0, 3] = False
    bias = (rng.randn(1, h, T1, T2).astype(np.float32) * 0.5
            if use_bias else None)
    return q, k, v, mask, bias


CASES = [  # B, h, T1, T2, d, mask, bias
    (2, 4, 100, 100, 64, 'pad', False),        # tests/test_flash_attention.py
    (1, 2, 37, 53, 32, 'pad', True),
    (2, 2, 64, 64, 64, None, False),
    (1, 1, 130, 257, 64, 'pad', True),
    (2, 3, 40, 40, 32, 'heads', False),        # a mask per head
    (2, 2, 48, 48, 32, 'causal', False),       # a (B, T1, T2) mask
    (1, 2, 24, 24, 32, 'masked_row', False),   # one fully masked row
    (1, 2, 40, 70, 128, 'pad', True),          # d = 128
    (2, 2, 70, 20, 64, 'pad', False),          # T2 shorter than a key tile
    (1, 2, 129, 191, 64, 'pad', True),         # one past a 64- and a 128-tile
    (1, 2, 191, 129, 32, 'causal', False),     # the same, the other way
    (2, 3, 40, 320, 64, 'gap', False),         # closed key tiles mid-row
    (1, 2, 64, 320, 128, 'short', False),      # d = 128, last two tiles closed
    (2, 2, 100, 150, 64, 'peaked', False),     # q scaled by 8
]


@pytest.mark.parametrize('B,h,T1,T2,d,mask_kind,use_bias', CASES)
def test_reference_matches_jax_kernel(interpret_pallas, B, h, T1, T2, d,
                                      mask_kind, use_bias):
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import flash_attention as jfa
    rng = np.random.RandomState(0)
    q, k, v, mask, bias = _inputs(rng, B, h, T1, T2, d, mask_kind, use_bias)
    scale = 1.0 / np.sqrt(d)
    want = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               None if mask is None else jnp.asarray(mask),
               None if bias is None else jnp.asarray(bias), scale=scale,
               block_q=32, block_k=32)
    got, _ = fa.flash_fwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
        None if bias is None else torch.from_numpy(bias), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    if mask_kind == 'masked_row':
        assert not got[0, :, 3].any()


def test_cpu_tensors_take_plain_version():
    rng = np.random.RandomState(1)
    q, k, v, mask, bias = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(rng, 2, 2, 9, 11, 32, 'pad',
                                            True))
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, mask, bias, 0.2)
    want, _ = fa.flash_fwd_reference(q, k, v, mask, bias, 0.2)
    assert torch.equal(got, want)
    assert fa.LAUNCHES == before


def test_plain_path_matches_reference():
    """attention_core's plain path (matmul, softmax, re-mask) and K4's
    plain version (online-softmax arithmetic) agree."""
    rng = np.random.RandomState(2)
    q, k, v, mask, bias = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(rng, 2, 3, 33, 45, 32,
                                            'masked_row', True))
    got = A.attention_core(q, k, v, mask.unsqueeze(1), 0.3, bias=bias)
    want, _ = fa.flash_fwd_reference(q, k, v, mask, bias, 0.3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


class _FakeCuda:
    """Shape, dtype and device of a tensor, for the gate only."""

    def __init__(self, *shape, dtype=torch.float32):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device('cuda')
        self.requires_grad = False

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize('B,h,T1,T2,d,dtype,want', [
    (4, 20, 1500, 1500, 64, torch.float32, True),   # whisper's encoder
    (1, 20, 512, 512, 64, torch.bfloat16, True),    # both T >= min_len
    (1, 4, 511, 1500, 64, torch.float32, False),    # one T below it
    (4, 20, 511, 1500, 64, torch.float32, True),    # 61M scores >= 24M
    (64, 4, 375, 375, 64, torch.float32, True),     # 36M scores >= 24M
    (32, 4, 375, 375, 64, torch.float32, False),    # 18M < 24M
    (256, 8, 127, 1024, 64, torch.float32, False),  # T1 < 128
    (20, 20, 1, 1500, 64, torch.float32, False),    # a decoder step
    (4, 20, 1500, 1500, 48, torch.float32, 'raise'),  # no kernel for d=48
    (4, 20, 1500, 1500, 64, torch.float16, 'raise'),  # nor for fp16
])
def test_gate(B, h, T1, T2, d, dtype, want):
    """The gate asks for lengths only: above it, a dtype or head dim K4
    has no instance for raises rather than taking the plain path."""
    q = _FakeCuda(B, h, T1, d, dtype=dtype)
    k = _FakeCuda(B, h, T2, d, dtype=dtype)
    if want == 'raise':
        assert A.flash_eligible(q, k)
        with pytest.raises(ValueError):
            A.attention_core(q, k, k, None, 0.125)
    else:
        assert A.flash_eligible(q, k) is want


def test_gate_is_cuda_only():
    q = torch.zeros(4, 20, 600, 64)
    assert not A.flash_eligible(q, q)


def test_dispatch(monkeypatch):
    """attention_core goes through `flash_attention` above the gate, in
    inference and when autograd records, and takes the plain path below
    it; above the gate, active attention dropout takes the plain path
    too, as the JAX package sends every call with a dropout function to
    XLA."""
    calls = []

    def fake_flash(q, k, v, mask, bias, scale):
        calls.append(q.shape)
        return fa.flash_attention(q, k, v, mask, bias, scale)

    monkeypatch.setattr(A, 'flash_attention', fake_flash)
    monkeypatch.setattr(A, 'flash_eligible',
                        lambda q, k: q.shape[2] >= 16 and k.shape[2] >= 16)
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 20, 32).astype(np.float32))
               for _ in range(3))
    A.attention_core(q, k, v, None, 0.2)
    assert len(calls) == 1
    A.attention_core(q[:, :, :8], k, v, None, 0.2)  # below the gate
    drop = torch.nn.Dropout(0.1).train()
    A.attention_core(q, k, v, None, 0.2, drop)  # training dropout: plain
    assert len(calls) == 1
    out = A.attention_core(q.requires_grad_(), k, v, None, 0.2)  # autograd
    assert len(calls) == 2 and type(out.grad_fn).__name__ == (
        'FlashAttentionBackward')
    out.sum().backward()
    assert q.grad is not None
    out = A.attention_core(q[:, :, :8], k, v, None, 0.2, drop)  # below
    out.sum().backward()
    assert len(calls) == 2
    with torch.no_grad():
        A.attention_core(q, k, v, None, 0.2, drop.eval())
    assert len(calls) == 3


@pytest.mark.parametrize('bad', ['mask_heads', 'mask_len', 'mask_dtype',
                                 'bias_rows', 'head_dim', 'dtype',
                                 'inner_stride', 'kv_len', 'unaligned'])
def test_kernel_wrapper_rejects(bad):
    """What the kernel does not take raises before launch (checked on
    shape-only meta tensors, so no card is needed)."""
    B, h, T1, T2, d = 2, 4, 5, 7, 64

    def t(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device='meta')
    q = t(B, T1, h, d).transpose(1, 2)  # strided views are fine
    k, v = t(B, h, T2, d), t(B, h, T2, d)
    mask = t(B, 1, 1, T2, dtype=torch.bool)
    bias = t(1, h, T1, T2)
    fa._flash_check(q, k, v, mask, bias, aligned=True)
    if bad == 'mask_heads':
        mask = t(B, 3, T1, T2, dtype=torch.bool)
    elif bad == 'mask_len':
        mask = t(B, 1, T1, T2 + 1, dtype=torch.bool)
    elif bad == 'mask_dtype':
        mask = t(B, 1, T1, T2)
    elif bad == 'bias_rows':
        bias = t(1, h, T1 + 1, T2)
    elif bad == 'head_dim':
        q, k, v = (t(*x.shape[:3], 48) for x in (q, k, v))
    elif bad == 'dtype':
        q = t(B, h, T1, d, dtype=torch.float16)
    elif bad == 'inner_stride':
        v = t(B, h, d, T2).transpose(2, 3)
    elif bad == 'unaligned':  # rows 4 * 65 bytes apart: no 16-byte copies
        k = t(B, h, T2, d + 1)[..., :d]
    else:
        k = t(B, h, T2 + 1, d)
    with pytest.raises(ValueError):
        fa._flash_check(q, k, v, mask, bias, aligned=True)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,h,T1,T2,d,mask_kind,use_bias', CASES + [
    (2, 4, 600, 600, 128, 'pad', False), (2, 4, 1500, 1500, 64, 'pad',
                                          False)])
def test_cuda_kernel_matches_plain(dtype, B, h, T1, T2, d, mask_kind,
                                   use_bias):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernel')
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(4)
    q, k, v, mask, bias = _inputs(rng, B, h, T1, T2, d, mask_kind, use_bias)
    q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in (q, k, v))
    mask = None if mask is None else torch.from_numpy(mask).cuda()
    bias = None if bias is None else torch.from_numpy(bias).cuda()
    # strided (B, T, h, d)-ordered views, as the attention module gives
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    scale = 1.0 / np.sqrt(d)
    before = fa.LAUNCHES['flash_attention_fwd']
    got = fa.flash_attention(q, k, v, mask, bias, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES['flash_attention_fwd'] == before + 1
    want, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(), mask,
                                     bias, scale)
    # bf16: the reference is fp32 on the same rounded inputs, so the
    # kernel is held to the rounding of its output (about 2 bf16 ulps)
    atol, rtol = (2e-5, 1e-5) if dtype == torch.float32 else (1e-3, 8e-3)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    if mask_kind == 'masked_row':
        assert not got[0, :, 3].any()


# Run in a process of its own: the bias lies at the end of the mapped
# device memory, so a read past its last row is an illegal address (which
# ends the process's CUDA context) rather than a read of a neighbour.
_BIAS_AT_END = '''
import sys, torch
from wenet_tpu_torch.ops import flash_attention as fa
dtype = getattr(torch, sys.argv[1])
B, h, T1, T2, d = 1, 2, 129, 1024, 64
g = torch.Generator().manual_seed(5)
q, k, v = (torch.randn(B, h, T, d, generator=g).cuda().to(dtype)
           for T in (T1, T2, T2))
mask = (torch.arange(T2) < 1000).view(1, 1, 1, T2).cuda()  # one row
# expandable segments grow the large pool 20 MiB at a time: its first
# blocks are a hole of n floats (K5's dbias takes it) and a buffer of the
# rest of the 20 MiB, which ends where the mapping does (checked here,
# and again after the kernels)
n = B * h * T1 * T2
hole = torch.empty(n, device='cuda')
buf = torch.empty((20 << 20) // 4 - n, device='cuda')
end = buf.data_ptr() + 4 * buf.numel()


def ends_mapping():
    segs = [(s['address'], s['total_size'])
            for s in torch.cuda.memory_snapshot()
            if s['address'] <= buf.data_ptr() < s['address'] + s['total_size']]
    assert [a + size for a, size in segs] == [end], (buf.data_ptr(), end,
                                                     segs)


ends_mapping()
del hole
bias = buf[buf.numel() - n:].view(B, h, T1, T2)
bias.copy_(torch.randn(B, h, T1, T2, generator=g))
got = fa.flash_attention(q, k, v, mask, bias, 0.125)
# K5 on the same bias (K4-train gives its lse)
do = torch.randn(B, h, T1, d, generator=g).cuda().to(dtype)
_, lse = fa.flash_fwd(q, k, v, mask, bias, 0.125, want_lse=True)
delta = (do.float() * got.float()).sum(-1)
dq, dbias = fa.flash_bwd_dq(q, k, v, mask, bias, do, lse, delta, 0.125)
torch.cuda.synchronize()
ends_mapping()
want, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(), mask,
                                 bias, 0.125)
tol = (2e-5, 1e-5) if dtype == torch.float32 else (1e-3, 8e-3)
torch.testing.assert_close(got.float(), want, atol=tol[0], rtol=tol[1])
want_dq, want_dbias = fa.flash_bwd_dq_reference(
    q.float(), k.float(), v.float(), mask, bias, do.float(), lse, delta,
    0.125)
tol = (2e-4, 1e-4) if dtype == torch.float32 else (5e-2, 2e-2)
torch.testing.assert_close(dq.float(), want_dq, atol=tol[0], rtol=tol[1])
torch.testing.assert_close(dbias, want_dbias, atol=tol[0], rtol=tol[1])
print('ok')
'''


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_bias_read_stays_in_bounds(dtype):
    """The last query block of a ragged T1 (129: 63 rows past it) with a
    one-row mask and a bias, in K4 and in K5: the rows past T1 read no
    bias, even where the bias ends at the end of mapped device memory."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernel')
    import os
    import subprocess
    import sys
    fa.build()  # here, so that the child only loads the library
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF='expandable_segments:True')
    run = subprocess.run([sys.executable, '-c', _BIAS_AT_END, dtype],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == 'ok', (
        run.stdout[-2000:] + run.stderr[-4000:])
