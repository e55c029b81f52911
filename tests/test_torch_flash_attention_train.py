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

from torch_port_utils import fill_allocator_with_nan

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
    elif mask_kind in ('pad', 'peaked', 'gap'):  # (B, 1, T2) key padding
        mask = pad[:, None, :]
        if mask_kind == 'peaked':  # a peaked softmax
            q = q * 8
        elif mask_kind == 'gap':  # keys 64..191 closed: whole tiles mid-row
            mask = mask & ((np.arange(T2) < 64) | (np.arange(T2) >= 192))
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
    (1, 2, 40, 256, 32, 'gap', (1, 2, 40, 256)),  # closed key tiles, a bias
    (1, 2, 60, 90, 64, 'peaked', None),           # q scaled by 8
    (1, 2, 129, 70, 32, 'pad', (1, 2, 129, 70)),  # T1 one past two tiles
]


def _torch(*arrays, grad=False):
    return [None if a is None else
            torch.from_numpy(a).requires_grad_(grad and a.dtype != bool)
            for a in arrays]


def _jax_vjp(q, k, v, mask, bias, scale):
    """The JAX `flash_attention` (its Pallas kernels in interpret mode) ->
    (out, lse, grads of sum(o·cos(o)) for q, k, v and the bias)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import _fwd_call
    from wenet_tpu.ops.flash_attention import flash_attention as jfa
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v, bias):
        o = jfa(q, k, v, jmask, bias, scale=scale, block_q=BLOCK,
                block_k=BLOCK)
        return jnp.sum(o * jnp.cos(o)), o

    jargs = [jnp.asarray(a) for a in (q, k, v)] + [
        None if bias is None else jnp.asarray(bias)]
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    (_, out), grads = jax.value_and_grad(
        loss, argnums=argnums, has_aux=True)(*jargs)
    m4 = None if mask is None else (jmask[:, None] if mask.ndim == 3
                                    else jmask)
    b4 = None if bias is None else (jargs[3][:, None] if bias.ndim == 3
                                    else jargs[3])
    _, lse = _fwd_call(*jargs[:3], m4, b4, scale, BLOCK, BLOCK,
                       want_lse=True)
    return (np.asarray(out), np.asarray(lse),
            [np.asarray(g) for g in grads])


def _port_vjp(q, k, v, mask, bias, scale, dtype=torch.float32):
    """The port's Function on CPU tensors (plain K4-train, K5, K6) in
    `dtype` -> (out, lse, the leaves q, k, v, bias with their .grad)."""
    x = [None if a is None else
         torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v,
                                                                   bias)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fa.flash_attention(*x[:3], tmask, x[3], scale)
    assert type(out.grad_fn).__name__ == 'FlashAttentionBackward'
    (out * torch.cos(out)).sum().backward()
    with torch.no_grad():
        _, lse = fa.flash_fwd_reference(*x[:3], tmask, x[3], scale,
                                        want_lse=True)
    return out.detach(), lse, x


JAX_CASES = [c for c in CASES if c[5] != 'peaked']


@pytest.mark.parametrize('B,h,T1,T2,d,mask_kind,bias_shape', JAX_CASES)
def test_function_matches_jax(interpret_pallas, B, h, T1, T2, d, mask_kind,
                              bias_shape):
    """out, lse and the gradients of sum(o·cos(o)) against the JAX kernels
    in interpret mode (jax.grad through the custom VJP)."""
    rng = np.random.RandomState(0)
    q, k, v, mask, bias, _ = _inputs(rng, B, h, T1, T2, d, mask_kind,
                                     bias_shape)
    scale = 1.0 / np.sqrt(d)
    want, want_lse, want_grads = _jax_vjp(q, k, v, mask, bias, scale)
    got, lse, (tq, tk, tv, tbias) = _port_vjp(q, k, v, mask, bias, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    assert lse.shape == (B, h, T1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=ATOL)
    names = ('dq', 'dk', 'dv', 'dbias')
    for name, t, w in zip(names, (tq, tk, tv, tbias), want_grads):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), w, atol=ATOL, rtol=ATOL,
                                   err_msg=name)
    if mask_kind == 'masked_row':
        assert lse[0, :, 3].eq(fa.NEG_INF).all()
        assert not got[0, :, 3].any() and not tq.grad[0, :, 3].any()
    if mask_kind == 'gap':  # no gradient reaches the closed keys
        assert not tbias.grad[..., 64:192].any()
        assert not tk.grad[:, :, 64:192].any()


@pytest.mark.parametrize('B,h,T1,T2,d,mask_kind,bias_shape',
                         [c for c in CASES if c[5] == 'peaked'])
def test_peaked_function_matches_jax_and_float64(
        interpret_pallas, B, h, T1, T2, d, mask_kind, bias_shape):
    """q scaled by 8: scores reach ≈ 30, where fp32 rounding of s − lse
    moves P by a few 1e-6.  out, lse, dq and dv against the JAX kernels at
    1e-5 as above; dk (dsᵀ·q, with q eight times larger) against the
    float64 evaluation of the same Function at that bar, because the JAX
    kernel's own fp32 dk is 5.4e-5 from float64 on this case, 2.7 times
    the bar, where the port's is 8.8e-6, half of it (held in
    tests/test_torch_flash_bwd_precision.py): the JAX side would miss the
    bar, not the port."""
    rng = np.random.RandomState(0)
    q, k, v, mask, bias, _ = _inputs(rng, B, h, T1, T2, d, mask_kind,
                                     bias_shape)
    scale = 1.0 / np.sqrt(d)
    want, want_lse, want_grads = _jax_vjp(q, k, v, mask, bias, scale)
    got, lse, (tq, tk, tv, _) = _port_vjp(q, k, v, mask, bias, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=ATOL)
    for name, t, w in (('dq', tq, want_grads[0]), ('dv', tv, want_grads[2])):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=ATOL, rtol=ATOL,
                                   err_msg=name)
    _, _, exact = _port_vjp(q, k, v, mask, bias, scale, torch.float64)
    np.testing.assert_allclose(tk.grad.numpy(), exact[1].grad.numpy(),
                               atol=ATOL, rtol=ATOL, err_msg='dk')


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


def test_unaligned_upstream_grad():
    """An upstream gradient at an offset that is not 16-byte aligned (a
    view into a larger buffer) is taken, and gives the same gradients."""
    rng = np.random.RandomState(10)
    q, k, v, _, _, do = _inputs(rng, 2, 2, 20, 20, 32, None, None)
    flat = torch.from_numpy(np.concatenate([[0.0], do.ravel()]).astype(
        np.float32))
    odd = flat[1:].view(do.shape)  # 4 bytes past an aligned base
    assert odd.data_ptr() % 16 != 0
    x = _torch(q, k, v, grad=True)
    fa.flash_attention(*x, None, None, 0.2).backward(odd)
    ref = _torch(q, k, v, grad=True)
    fa.flash_fwd_reference(*ref, None, None, 0.2)[0].backward(
        torch.from_numpy(do))
    for t, r in zip(x, ref):
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
                                 'lse_shape', 'delta_dtype', 'head_dim',
                                 'unaligned'])
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
    elif bad == 'unaligned':  # rows of d + 1 floats: 16-byte copies fail
        do = t(B, h, T1, d + 1)[..., :d]
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
    (2, 4, 300, 300, 64, 'peaked', None),           # q scaled by 8
    (2, 4, 200, 448, 64, 'gap', (2, 4, 200, 448)),  # closed tiles, a bias
    (2, 4, 129, 300, 64, 'pad', (2, 4, 129, 300)),  # T1 = 129, a bias
]
TOL = {torch.float32: dict(atol=2e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
# K4-train's output and lse are held to K4's bars: fp32's, and in bf16
# the rounding of the output (fp32 reference on the same rounded inputs)
FWD_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
           torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}


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
    same (bf16-rounded) inputs and the same lse and delta: K4-train at
    K4's bars, the gradients at TOL."""
    rng = np.random.RandomState(7)
    q, k, v, mask, bias, do = _cuda_inputs(rng, dtype, B, h, T1, T2, d,
                                           mask_kind, bias_shape)
    scale = 1.0 / np.sqrt(d)
    x32 = [t.float() for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_fwd(q, k, v, mask, bias, scale, want_lse=True)
    want, want_lse = fa.flash_fwd_reference(*x32, mask, bias, scale, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, **FWD_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **FWD_TOL[torch.float32])
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


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_closed_tiles_write_zeros(cuda, dtype):
    """K5 skips the key tiles the mask closes for every row, K6 the key
    blocks it closes for every query: their dbias, dk and dv are written
    as zeros, not left as what the allocator held (NaN here)."""
    rng = np.random.RandomState(11)
    B, h, T1, T2, d = 2, 4, 200, 448, 64
    q, k, v, mask, bias, do = _cuda_inputs(rng, dtype, B, h, T1, T2, d,
                                           'gap', (B, h, T1, T2))
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_fwd(q, k, v, mask, bias, scale, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (mask, bias, do, lse, delta, scale)
    fill_allocator_with_nan()
    dq, dbias = fa.flash_bwd_dq(q, k, v, *args)
    fill_allocator_with_nan()
    dk, dv = fa.flash_bwd_dkv(q, k, v, *args)
    torch.cuda.synchronize()
    closed = ~mask[:, None].expand(B, h, T1, T2)  # (B, 1, T2) key mask
    assert closed[..., 64:192].all()
    for name, g in (('dq', dq), ('dbias', dbias), ('dk', dk), ('dv', dv)):
        assert torch.isfinite(g).all(), name
    assert dbias[closed].eq(0).all()
    keys = closed.all(2)  # (B, h, T2): keys no query attends
    assert dk[keys].eq(0).all() and dv[keys].eq(0).all()
    rdq, rdbias = fa.flash_bwd_dq_reference(
        q.float(), k.float(), v.float(), mask, bias, do.float(), lse, delta,
        scale)
    rdk, rdv = fa.flash_bwd_dkv_reference(
        q.float(), k.float(), v.float(), mask, bias, do.float(), lse, delta,
        scale)
    for name, g, r in (('dq', dq, rdq), ('dbias', dbias, rdbias),
                       ('dk', dk, rdk), ('dv', dv, rdv)):
        torch.testing.assert_close(g.float(), r, **TOL[dtype], msg=name)
