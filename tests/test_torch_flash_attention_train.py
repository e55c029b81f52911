"""Masked flash attention in training (K4 with lse, K5, K6): the port's
`FlashAttention` Function and its plain versions against the JAX
package, the `attention_core` dispatch in training, and the CUDA kernels
against their plain versions.

On the CPU the JAX `flash_attention` runs its Pallas kernels in
interpret mode (as tests/test_flash_attention.py does), and `jax.grad`
goes through its custom VJP (`_bwd_dq_kernel`, `_bwd_dkv_kernel`).  The
port's Function, which takes the plain versions of K4-train, K5 and K6
on CPU tensors, must agree with its output, lse and gradients (dq, dk,
dv, dbias summed over the bias's broadcast dims) within 1e-5.  The
`cuda` tests build the Hopper kernels and need a card; jax is imported
inside the CPU tests only."""

import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch.models.transformer import attention as A
from wenet_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5
BLOCK = 16  # the JAX kernels' tiles: ragged T is padded to them


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(rng, B, h, T1, T2, d, mask_kind, bias_shape):
    q, do = (rng.randn(B, h, T1, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, h, T2, d).astype(np.float32) for _ in range(2))
    lens = rng.randint(T2 // 2, T2 + 1, size=(B,))
    pad = np.arange(T2)[None, :] < lens[:, None]
    if mask_kind is None:
        mask = None
    elif mask_kind == 'pad':  # (B, 1, T2) key padding
        mask = pad[:, None, :]
    elif mask_kind == 'heads':  # (B, h, 1, T2): a pad mask per head
        mask = np.stack([np.arange(T2)[None, :] < rng.randint(
            1, T2 + 1, size=(B, 1)) for _ in range(h)], axis=1)[:, :, None]
    else:  # (B, T1, T2): causal over key padding
        mask = ((np.arange(T2)[None, :] <= np.arange(T1)[:, None])[None]
                & pad[:, None, :])
        if mask_kind == 'masked_row':
            mask[0, 3] = False
    bias = (None if bias_shape is None else
            (rng.randn(*bias_shape) * 0.5).astype(np.float32))
    return q, k, v, mask, bias, do


CASES = [  # B, h, T1, T2, d, mask, bias shape
    (2, 4, 100, 100, 64, 'pad', None),            # tests/test_flash_attention.py
    (1, 2, 37, 53, 32, 'pad', (1, 2, 37, 53)),    # ragged T, a bias
    (2, 2, 64, 64, 64, None, None),                # no mask
    (2, 2, 48, 40, 32, 'rows', (2, 2, 48, 40)),   # (B, T1, T2) mask, full bias
    (2, 2, 48, 40, 32, 'pad', (1, 2, 48, 40)),    # bias shared by the batch
    (2, 2, 48, 40, 32, 'pad', (2, 48, 40)),       # 3-d bias, shared by heads
    (1, 2, 24, 24, 32, 'masked_row', None),       # one fully masked row
    (2, 3, 40, 40, 32, 'heads', None),            # a mask per head
    (1, 2, 40, 70, 128, 'pad', (1, 2, 40, 70)),   # d = 128
]


def _torch(*arrays, grad=False):
    return [None if a is None else
            torch.from_numpy(a).requires_grad_(grad and a.dtype != bool)
            for a in arrays]


@pytest.mark.parametrize('B,h,T1,T2,d,mask_kind,bias_shape', CASES)
def test_function_matches_jax(interpret_pallas, B, h, T1, T2, d, mask_kind,
                              bias_shape):
    """out, lse and the gradients of sum(o·cos(o)) against the JAX kernels
    in interpret mode (jax.grad through the custom VJP)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import _fwd_call
    from wenet_tpu.ops.flash_attention import flash_attention as jfa
    rng = np.random.RandomState(0)
    q, k, v, mask, bias, _ = _inputs(rng, B, h, T1, T2, d, mask_kind,
                                     bias_shape)
    scale = 1.0 / np.sqrt(d)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v, bias):
        o = jfa(q, k, v, jmask, bias, scale=scale, block_q=BLOCK,
                block_k=BLOCK)
        return jnp.sum(o * jnp.cos(o)), o

    jargs = [jnp.asarray(a) for a in (q, k, v)] + [
        None if bias is None else jnp.asarray(bias)]
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    (_, want), want_grads = jax.value_and_grad(
        loss, argnums=argnums, has_aux=True)(*jargs)
    m4 = None if mask is None else (jmask[:, None] if mask.ndim == 3
                                    else jmask)
    b4 = None if bias is None else (jargs[3][:, None] if bias.ndim == 3
                                    else jargs[3])
    _, want_lse = _fwd_call(*jargs[:3], m4, b4, scale, BLOCK, BLOCK,
                            want_lse=True)

    tq, tk, tv, tbias = _torch(q, k, v, bias, grad=True)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fa.flash_attention(tq, tk, tv, tmask, tbias, scale)
    assert type(got.grad_fn).__name__ == 'FlashAttentionBackward'
    (got * torch.cos(got)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)
    with torch.no_grad():
        _, lse = fa.flash_fwd_reference(tq, tk, tv, tmask, tbias, scale,
                                        want_lse=True)
    assert lse.shape == (B, h, T1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=ATOL)
    names = ('dq', 'dk', 'dv', 'dbias')
    for name, t, w in zip(names, (tq, tk, tv, tbias), want_grads):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=ATOL, rtol=ATOL, err_msg=name)
    if mask_kind == 'masked_row':
        assert lse[0, :, 3].eq(fa.NEG_INF).all()
        assert not got[0, :, 3].any() and not tq.grad[0, :, 3].any()


@pytest.mark.parametrize('B,h,T1,T2,d,mask_kind,bias_shape', CASES[1:7])
def test_function_matches_dense_autograd(B, h, T1, T2, d, mask_kind,
                                         bias_shape):
    """The Function's backward (plain K5 and K6 from lse and delta)
    against autograd through the dense forward `flash_fwd_reference`,
    with an upstream gradient `do` as the caller passes it."""
    rng = np.random.RandomState(1)
    q, k, v, mask, bias, do = _inputs(rng, B, h, T1, T2, d, mask_kind,
                                      bias_shape)
    tmask = None if mask is None else torch.from_numpy(mask)
    scale = 0.3
    x = _torch(q, k, v, bias, grad=True)
    fa.flash_attention(*x[:3], tmask, x[3], scale).backward(
        torch.from_numpy(do))
    ref = _torch(q, k, v, bias, grad=True)
    out, _ = fa.flash_fwd_reference(*ref[:3], tmask, ref[3], scale)
    out.backward(torch.from_numpy(do))
    for name, t, r in zip(('dq', 'dk', 'dv', 'dbias'), x, ref):
        if t is not None:
            torch.testing.assert_close(t.grad, r.grad, atol=ATOL, rtol=ATOL,
                                       msg=name)


def test_bwd_plain_versions_split_the_work():
    """K5's plain version gives dq and ds per (b, h) as dbias; K6's gives
    dk and dv; together they are the dense vjp, with delta =
    rowsum(do·out) and the lse of the forward."""
    rng = np.random.RandomState(2)
    q, k, v, mask, bias, do = (None if a is None else torch.from_numpy(a)
                               for a in _inputs(rng, 2, 2, 30, 20, 32,
                                                'rows', (1, 1, 30, 20)))
    out, lse = fa.flash_fwd_reference(q, k, v, mask, bias, 0.2, True)
    delta = (do * out).sum(-1)
    dq, dbias = fa.flash_bwd_dq(q, k, v, mask, bias, do, lse, delta, 0.2)
    dk, dv = fa.flash_bwd_dkv(q, k, v, mask, bias, do, lse, delta, 0.2)
    assert dbias.shape == (2, 2, 30, 20) and dq.shape == q.shape
    _, none = fa.flash_bwd_dq(q, k, v, mask, None, do, lse, delta, 0.2)
    assert none is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    ref, _ = fa.flash_fwd_reference(*leaves[:3], mask, leaves[3], 0.2)
    grads = torch.autograd.grad(ref, leaves, do)
    for name, got, want in (('dq', dq, grads[0]), ('dk', dk, grads[1]),
                            ('dv', dv, grads[2]),
                            ('dbias', dbias.sum((0, 1), keepdim=True),
                             grads[3])):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL,
                                   msg=name)


def test_no_grad_runs_forward_only():
    rng = np.random.RandomState(3)
    q, k, v = _torch(*_inputs(rng, 1, 2, 9, 11, 32, None, None)[:3],
                     grad=True)
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, None, None, 0.2)
    assert out.grad_fn is None
    mask = torch.ones(1, 1, 11, dtype=torch.bool)
    out = fa.flash_attention(q.detach(), k.detach(), v.detach(), mask)
    assert out.grad_fn is None  # nothing requires grad


def test_expanded_upstream_grad():
    """out.sum() hands the backward an expanded (stride-0) gradient."""
    rng = np.random.RandomState(4)
    q, k, v = _torch(*_inputs(rng, 2, 2, 20, 20, 32, None, None)[:3],
                     grad=True)
    fa.flash_attention(q, k, v, None, None, 0.2).sum().backward()
    ref = _torch(*(t.detach().numpy() for t in (q, k, v)), grad=True)
    fa.flash_fwd_reference(*ref, None, None, 0.2)[0].sum().backward()
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r.grad, atol=ATOL, rtol=ATOL)


def _open_gate(monkeypatch, calls):
    """Gate open at T >= 16 for CPU tensors; count the flash calls."""
    def counted(*args):
        calls.append(torch.is_grad_enabled())
        return fa.flash_attention(*args)
    monkeypatch.setattr(A, 'flash_attention', counted)
    monkeypatch.setattr(A, 'flash_eligible',
                        lambda q, k: q.shape[2] >= 16 and k.shape[2] >= 16)


def test_dispatch_training_takes_function(monkeypatch):
    """Above the gate, an autograd-recording `attention_core` goes through
    the FlashAttention Function (whose backward is K5 and K6 on the card)
    and gives the plain path's gradients; a MultiHeadedAttention in
    training without attention dropout does the same."""
    calls = []
    _open_gate(monkeypatch, calls)
    rng = np.random.RandomState(5)
    q, k, v, mask, _, do = _inputs(rng, 2, 2, 20, 24, 32, 'pad', None)
    x = _torch(q, k, v, grad=True)
    m = torch.from_numpy(mask).unsqueeze(1)
    out = A.attention_core(*x, m, 0.2)
    assert calls == [True]
    assert type(out.grad_fn).__name__ == 'FlashAttentionBackward'
    out.backward(torch.from_numpy(do))
    monkeypatch.setattr(A, 'flash_eligible', lambda q, k: False)
    ref = _torch(q, k, v, grad=True)
    A.attention_core(*ref, m, 0.2).backward(torch.from_numpy(do))
    for t, r in zip(x, ref):
        torch.testing.assert_close(t.grad, r.grad, atol=ATOL, rtol=ATOL)

    _open_gate(monkeypatch, calls)
    attn = A.MultiHeadedAttention(2, 64, dropout_rate=0.0).train()
    feats = torch.randn(2, 20, 64)
    attn(feats, feats, feats, torch.ones(2, 1, 20, dtype=torch.bool)).sum(
        ).backward()
    assert calls == [True, True]
    assert attn.linear_q.weight.grad is not None


def test_dispatch_attention_dropout_takes_plain_path(monkeypatch):
    """Above the gate, active attention dropout takes the plain path with
    `nn.Dropout` on the weights (the JAX package sends every call with a
    dropout function to XLA): a result, not a raise, equal to the plain
    path under the same seed, with gradients."""
    calls = []
    _open_gate(monkeypatch, calls)
    rng = np.random.RandomState(6)
    q, k, v, mask, _, _ = _inputs(rng, 2, 2, 20, 24, 32, 'pad', None)
    m = torch.from_numpy(mask).unsqueeze(1)
    drop = torch.nn.Dropout(0.3).train()
    x = _torch(q, k, v, grad=True)
    torch.manual_seed(7)
    got = A.attention_core(*x, m, 0.2, drop)
    assert calls == []
    got.sum().backward()
    assert all(t.grad is not None for t in x)
    monkeypatch.setattr(A, 'flash_eligible', lambda q, k: False)
    torch.manual_seed(7)
    want = A.attention_core(*_torch(q, k, v), m, 0.2, drop)
    torch.testing.assert_close(got.detach(), want)
    # dropout in eval mode (or p = 0) is no dropout: the flash path
    _open_gate(monkeypatch, calls)
    A.attention_core(*x, m, 0.2, drop.eval())
    A.attention_core(*x, m, 0.2, torch.nn.Dropout(0.0).train())
    assert calls == [True, True]


@pytest.mark.parametrize('bad', ['do_dtype', 'do_shape', 'do_stride',
                                 'lse_shape', 'delta_dtype', 'head_dim'])
def test_bwd_wrapper_rejects(bad):
    """What K5 and K6 do not take raises before the build (checked on
    shape-only meta tensors, so no card is needed)."""
    B, h, T1, T2, d = 2, 4, 5, 7, 64

    def t(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device='meta')
    q = t(B, T1, h, d).transpose(1, 2)
    k, v, do = t(B, h, T2, d), t(B, h, T2, d), t(B, h, T1, d)
    lse, delta = t(B, h, T1), t(B, h, T1)
    if bad == 'do_dtype':
        do = t(B, h, T1, d, dtype=torch.bfloat16)
    elif bad == 'do_shape':
        do = t(B, h, T1 + 1, d)
    elif bad == 'do_stride':
        do = t(B, h, d, T1).transpose(2, 3)
    elif bad == 'lse_shape':
        lse = t(B, h, T1 + 1)
    elif bad == 'delta_dtype':
        delta = t(B, h, T1, dtype=torch.bfloat16)
    else:
        q, k, v, do = (t(*x.shape[:3], 48) for x in (q, k, v, do))
    for which in ('dq', 'dkv'):
        with pytest.raises(ValueError):
            fa._flash_bwd_cuda(which, q, k, v, None, None, do, lse, delta,
                               0.125)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
CUDA_CASES = CASES + [
    (2, 20, 300, 300, 64, 'pad', None),
    (1, 2, 130, 257, 32, 'rows', (1, 2, 130, 257)),
    (2, 2, 130, 257, 32, 'rows', (2, 130, 257)),
]
TOL = {torch.float32: dict(atol=2e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_inputs(rng, dtype, *case):
    q, k, v, mask, bias, do = _inputs(rng, *case)
    q, k, v, do = (torch.from_numpy(a).cuda().to(dtype)
                   for a in (q, k, v, do))
    # q as a strided (B, T, h, d)-ordered view, as the module hands it
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    return (q, k, v, None if mask is None else torch.from_numpy(mask).cuda(),
            None if bias is None else torch.from_numpy(bias).cuda(), do)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,h,T1,T2,d,mask_kind,bias_shape', CUDA_CASES)
def test_cuda_train_kernels_match_plain(cuda, dtype, B, h, T1, T2, d,
                                        mask_kind, bias_shape):
    """K4-train, K5 and K6, each against its plain version in fp32 on the
    same (bf16-rounded) inputs and the same lse and delta."""
    rng = np.random.RandomState(7)
    q, k, v, mask, bias, do = _cuda_inputs(rng, dtype, B, h, T1, T2, d,
                                           mask_kind, bias_shape)
    scale = 1.0 / np.sqrt(d)
    x32 = [t.float() for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_fwd(q, k, v, mask, bias, scale, want_lse=True)
    want, want_lse = fa.flash_fwd_reference(*x32, mask, bias, scale, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[dtype])
    delta = (do.float() * want).sum(-1)
    args = (mask, bias, do, want_lse, delta, scale)
    dq, dbias = fa.flash_bwd_dq(q, k, v, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, *args)
    ref_args = (mask, bias, do.float(), want_lse, delta, scale)
    rdq, rdbias = fa.flash_bwd_dq_reference(*x32, *ref_args)
    rdk, rdv = fa.flash_bwd_dkv_reference(*x32, *ref_args)
    torch.cuda.synchronize()
    for name, g, r in (('dq', dq, rdq), ('dk', dk, rdk), ('dv', dv, rdv),
                       ('dbias', dbias, rdbias)):
        if r is None:
            assert g is None, name
            continue
        assert g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r, **TOL[dtype], msg=name)
    for name in ('flash_attention_fwd_train', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert fa.LAUNCHES[name] == before[name] + 1, name
    if mask_kind == 'masked_row':
        assert lse[0, :, 3].eq(fa.NEG_INF).all()
        assert not dq[0, :, 3].any() and not out[0, :, 3].any()


@pytest.mark.cuda
def test_cuda_function_matches_cpu_function(cuda):
    """The Function on the card (K4-train, K5, K6) against the same
    Function on the CPU (plain versions), dbias of a 3-d bias included."""
    rng = np.random.RandomState(8)
    q, k, v, mask, bias, do = _cuda_inputs(rng, torch.float32, 2, 4, 130,
                                           150, 64, 'rows', (2, 130, 150))
    dev = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v, bias)]
    out = fa.flash_attention(*dev[:3], mask, dev[3], 0.125)
    out.backward(do)
    want = fa.flash_attention(*cpu[:3], mask.cpu(), cpu[3], 0.125)
    want.backward(do.cpu())
    torch.testing.assert_close(out.detach().cpu(), want.detach(),
                               **TOL[torch.float32])
    for t, w in zip(dev, cpu):
        torch.testing.assert_close(t.grad.cpu(), w.grad,
                                   **TOL[torch.float32])
