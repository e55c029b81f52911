"""The rel-pos attention training kernels: the dropout hash, the forward
with lse and dropout, and the backward, against the JAX package; and the
CUDA kernels against their plain versions.

On the CPU the JAX `flash_attention_relpos` runs its Pallas kernels in
interpret mode (as tests/test_flash_attention.py does).  The port's
`RelPosAttention` Function, which takes the plain versions of K1, K2 and
K3 on CPU tensors, must agree with its forward, lse and vjp within 1e-5,
and with `jax.vjp` through the dense `_relpos_reference` too.  The hash
must agree bit for bit.  The `cuda` tests build the Hopper kernels and
need a card; jax is imported inside the CPU tests only, so the file also
collects where jax is absent."""

import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch.ops import flash_attention as fa

from torch_port_utils import fill_allocator_with_nan

ATOL = 1e-5
SEEDS = [0, 1, 0x9E3779B1, 0xFFFFFFFF]


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize('seed', SEEDS)
def test_dropout_mult_matches_jax_exactly(seed):
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import _dropout_mult
    qi = np.concatenate([np.arange(0, 4096, 7), [4095]])
    ki = np.concatenate([np.arange(0, 4096, 5), [4094, 4095]])
    for bh in (0, 1, 17, 63):
        for rate in (0.1, 0.5, 0.9):
            want = np.asarray(_dropout_mult(
                jnp.uint32(seed), jnp.int32(bh),
                jnp.asarray(qi[:, None], jnp.int32),
                jnp.asarray(ki[None, :], jnp.int32), rate))
            got = fa.dropout_mult(seed, torch.tensor(bh),
                                  torch.from_numpy(qi[:, None]),
                                  torch.from_numpy(ki[None, :]), rate)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f'bh={bh} rate={rate}')


def _inputs(rng, B, h, T1, T2, d, p_batch, mask_kind):
    q1, q2, do = (rng.randn(B, h, T1, d).astype(np.float32)
                  for _ in range(3))
    k, v = (rng.randn(B, h, T2, d).astype(np.float32) for _ in range(2))
    p = rng.randn(p_batch, h, T2, d).astype(np.float32)
    lens = rng.randint(T2 // 2, T2 + 1, size=(B,))
    if mask_kind == 'tail':  # whole key blocks in the last one's padding
        lens[-1] = T2 // 3
    pad = np.arange(T2)[None, :] < lens[:, None]
    if mask_kind is None:
        mask = None
    elif mask_kind in ('pad', 'tail', 'peaked', 'gap'):  # (B, 1, T2)
        mask = pad[:, None, :]
        if mask_kind == 'peaked':  # a peaked softmax
            q1, q2 = q1 * 8, q2 * 8
        elif mask_kind == 'gap':  # keys 64..191 closed: whole tiles mid-row
            mask = mask & ((np.arange(T2) < 64) | (np.arange(T2) >= 192))
    else:  # (B, T1, T2) dynamic chunk of 8 over key padding
        row = np.arange(T1)[:, None] // 8
        mask = (np.arange(T2)[None, :] < (row + 1) * 8)[None] & pad[:, None]
        if mask_kind == 'masked_row':
            mask[0, 3] = False
    return (q1, q2, k, p, v), mask, do


CASES = [  # B, h, T1, T2, d, p batch, mask
    (2, 2, 37, 53, 32, 2, None),           # ragged, no mask
    (2, 2, 40, 40, 32, 1, 'pad'),          # key padding, p broadcast
    (2, 2, 48, 48, 32, 1, 'chunk'),        # chunk mask over padding
    (1, 2, 24, 24, 32, 1, 'masked_row'),   # one fully masked row
]


@pytest.mark.parametrize('rate', [0.0, 0.2])
@pytest.mark.parametrize('B,h,T1,T2,d,pb,mask_kind', CASES)
def test_function_matches_jax(interpret_pallas, rate, B, h, T1, T2, d, pb,
                              mask_kind):
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops import flash_attention as jfa
    rng = np.random.RandomState(0)
    arrs, mask, do = _inputs(rng, B, h, T1, T2, d, pb, mask_kind)
    scale = 1.0 / np.sqrt(d)
    seed = 0xC0FFEE if rate > 0 else None
    jmask = None if mask is None else jnp.asarray(mask)
    jseed = None if seed is None else jnp.uint32(seed)
    jargs = [jnp.asarray(a) for a in arrs]

    def kernel(*a):
        return jfa.flash_attention_relpos(*a, jmask, scale, 16, 16, jseed,
                                          rate)

    def dense(*a):
        return jfa._relpos_reference(*a, jmask, scale, rate, jseed)

    want, vjp = jax.vjp(kernel, *jargs)
    want_grads = vjp(jnp.asarray(do))
    dense_out, dense_vjp = jax.vjp(dense, *jargs)
    dense_grads = dense_vjp(jnp.asarray(do))
    _, want_lse = jfa._relpos_fwd_call(*jargs, jmask, scale, 16, 16,
                                       want_lse=True, dropout_rate=rate,
                                       dropout_seed=jseed)

    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fa.flash_attention_relpos(*ts, tmask, scale, rate, seed)
    assert type(out.grad_fn).__name__ == 'RelPosAttentionBackward'
    out.backward(torch.from_numpy(do))
    _, lse = fa.relpos_fwd_reference(*(torch.from_numpy(a) for a in arrs),
                                     tmask, scale, True, rate, seed)

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(dense_out),
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL,
                               rtol=1e-6)
    for name, t, g, gd in zip(('q1', 'q2', 'k', 'p', 'v'), ts, want_grads,
                              dense_grads):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gd),
                                   atol=ATOL, err_msg=name)
    if mask_kind == 'masked_row':
        assert lse[0, :, 3].eq(fa.NEG_INF).all()
        assert not out[0, :, 3].any()
        assert not ts[0].grad[0, :, 3].any()


def test_function_takes_strided_and_expanded_grads():
    """A loss of `out.sum()` hands backward an expanded (all-zero-stride)
    gradient; the grads equal autograd through the dense plain version."""
    rng = np.random.RandomState(3)
    arrs, mask, _ = _inputs(rng, 2, 2, 19, 23, 32, 1, 'pad')
    tmask = torch.from_numpy(mask)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    fa.flash_attention_relpos(*ts, tmask, 0.3, 0.1, 7).sum().backward()
    ref = [torch.from_numpy(a).requires_grad_() for a in arrs]
    fa.relpos_fwd_reference(*ref, tmask, 0.3, False, 0.1, 7)[0].sum() \
        .backward()
    for t, r in zip(ts, ref):
        torch.testing.assert_close(t.grad, r.grad, atol=ATOL, rtol=1e-5)


def test_no_grad_runs_forward_only():
    rng = np.random.RandomState(4)
    arrs, mask, _ = _inputs(rng, 1, 2, 9, 9, 32, 1, 'pad')
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    with torch.no_grad():
        out = fa.flash_attention_relpos(*ts, torch.from_numpy(mask), 0.2)
    assert out.grad_fn is None
    with pytest.raises(ValueError):
        fa.flash_attention_relpos(*ts, None, 0.2, dropout_rate=0.1)


def test_training_wrapper_rejects_unsupported_head_dim():
    """K1-train, K2 and K3 take d in {32, 64, 128}: d = 128 passes the
    training check, d = 96 raises before launch, for inference and
    training (shape-only meta tensors, so no card is needed)."""
    B, h, T = 2, 2, 5
    t = torch.empty(B, h, T, 128, device='meta')
    fa._check(t, t, t, t, t, None, train=False)
    fa._check(t, t, t, t, t, None, train=True)
    t = torch.empty(B, h, T, 96, device='meta')
    for train in (False, True):
        with pytest.raises(ValueError):
            fa._check(t, t, t, t, t, None, train=train)


@pytest.mark.parametrize('bad', ['q1', 'q2', 'k', 'p', 'v', 'base'])
def test_training_wrapper_rejects_unaligned(bad):
    """K1-train's 16-byte copies need every operand's base and (batch,
    head, time) strides 16-byte aligned: a view with rows d + 1 floats
    apart, or one that starts 4 bytes into its storage, raises before
    launch (shape-only meta tensors, so no card is needed)."""
    B, h, T, d = 2, 2, 5, 64
    x = {n: torch.empty(B, h, T, d, device='meta')
         for n in ('q1', 'q2', 'k', 'p', 'v')}
    fa._check(*x.values(), None, train=True, aligned=True)
    if bad == 'base':
        x['k'] = torch.empty(B * h * T * d + 1, device='meta')[1:].view(
            B, h, T, d)
    else:
        x[bad] = torch.empty(B, h, T, d + 1, device='meta')[..., :d]
    with pytest.raises(ValueError):
        fa._check(*x.values(), None, train=True, aligned=True)


@pytest.mark.parametrize('bad', ['do', 'q1', 'k', 'do_base'])
def test_backward_wrapper_rejects_unaligned(bad):
    """K2's and K3's 16-byte copies need q1, q2, k, p, v and do with
    16-byte aligned bases and strides: an unaligned one raises before
    launch, do included (the Function makes do contiguous only when its
    last dim is not unit-stride); shape-only meta tensors, so no card is
    needed."""
    B, h, T, d = 2, 2, 5, 64
    x = {n: torch.empty(B, h, T, d, device='meta')
         for n in ('q1', 'q2', 'k', 'p', 'v', 'do')}

    def check():
        fa._bwd_check(*(x[n] for n in ('q1', 'q2', 'k', 'p', 'v')), None,
                      x['do'])
    check()
    if bad == 'do_base':
        x['do'] = torch.empty(B * h * T * d + 1, device='meta')[1:].view(
            B, h, T, d)
    else:
        x[bad] = torch.empty(B, h, T, d + 1, device='meta')[..., :d]
    with pytest.raises(ValueError):
        check()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
CUDA_CASES = CASES + [
    (3, 4, 130, 200, 64, 3, 'pad'),
    (2, 4, 299, 299, 64, 1, 'chunk'),
    (2, 2, 70, 70, 32, 1, 'chunk'),
    (2, 4, 300, 300, 64, 1, 'peaked'),  # q1, q2 scaled by 8
    (2, 4, 200, 448, 64, 1, 'gap'),     # key tiles closed mid-row
    (2, 4, 130, 300, 64, 1, 'tail'),    # key blocks wholly in the padding
    (2, 2, 100, 150, 32, 1, 'tail'),
]
TOL = {torch.float32: dict(atol=2e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_inputs(rng, dtype, B, h, T1, T2, d, pb, mask_kind):
    arrs, mask, do = _inputs(rng, B, h, T1, T2, d, pb, mask_kind)
    q1, q2, k, p, v = (torch.from_numpy(a).cuda().to(dtype) for a in arrs)
    # q1, q2 as strided (B, T, h, d)-ordered views, as the module hands them
    q1 = q1.transpose(1, 2).contiguous().transpose(1, 2)
    q2 = q2.transpose(1, 2).contiguous().transpose(1, 2)
    mask = None if mask is None else torch.from_numpy(mask).cuda()
    return [q1, q2, k, p, v], mask, torch.from_numpy(do).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,h,T1,T2,d,pb,mask_kind', CUDA_CASES)
def test_cuda_train_kernels_match_plain(cuda, rate, dtype, B, h, T1, T2, d,
                                        pb, mask_kind):
    """K1 with lse and dropout, K2 and K3, each against its plain version
    in fp32 on the same (bf16-rounded) inputs and the same lse/delta."""
    rng = np.random.RandomState(5)
    x, mask, do = _cuda_inputs(rng, dtype, B, h, T1, T2, d, pb, mask_kind)
    scale, seed = 1.0 / np.sqrt(d), 0xFFFFFFFF
    x32 = [t.float() for t in x]
    out, lse = fa.relpos_fwd(*x, mask, scale, True, rate, seed)
    want, want_lse = fa.relpos_fwd_reference(*x32, mask, scale, True, rate,
                                             seed)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **TOL[dtype])
    delta = (do.float() * want).sum(-1)
    args = (mask, do, want_lse, delta, scale, rate, seed)
    got = fa.relpos_bwd_dq(*x, *args) + fa.relpos_bwd_dkpv(*x, *args)
    ref = (fa.relpos_bwd_dq_reference(*x32, mask, do.float(), *args[2:]) +
           fa.relpos_bwd_dkpv_reference(*x32, mask, do.float(), *args[2:]))
    torch.cuda.synchronize()
    for name, g, r in zip(('dq1', 'dq2', 'dk', 'dp', 'dv'), got, ref):
        assert g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r, **TOL[dtype], msg=name)
    if mask_kind == 'masked_row':
        assert not got[0][0, :, 3].any() and not out[0, :, 3].any()


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_cuda_function_matches_cpu_function(cuda, rate):
    """The Function on the card (K1-train, K2, K3) against the same
    Function on the CPU (plain versions), grads included."""
    rng = np.random.RandomState(6)
    x, mask, do = _cuda_inputs(rng, torch.float32, 3, 4, 130, 130, 64, 1,
                               'chunk')
    before = dict(fa.LAUNCHES)
    dev = [t.detach().requires_grad_() for t in x]
    cpu = [t.detach().cpu().requires_grad_() for t in x]
    out = fa.flash_attention_relpos(*dev, mask, 0.125, rate, 99)
    out.backward(do)
    want = fa.flash_attention_relpos(*cpu, mask.cpu(), 0.125, rate, 99)
    want.backward(do.cpu())
    torch.testing.assert_close(out.detach().cpu(), want.detach(),
                               **TOL[torch.float32])
    for t, w in zip(dev, cpu):
        torch.testing.assert_close(t.grad.cpu(), w.grad,
                                   **TOL[torch.float32])
    for name in ('relpos_attention_fwd_train', 'relpos_attention_bwd_dq',
                 'relpos_attention_bwd_dkpv'):
        assert fa.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_cuda_dropout_mask_bit_exact(cuda, rate):
    """q1=q2=k=p=0 gives a uniform softmax, and v=I makes K1's output the
    mask itself: keep·mult/64, equal to the plain hash bit for bit."""
    B, h, T1, T2 = 2, 3, 256, 64
    z = torch.zeros(B, h, T1, T2, device='cuda')
    kz = torch.zeros(B, h, T2, T2, device='cuda')
    eye = torch.eye(T2, device='cuda').expand(B, h, T2, T2)
    for seed in SEEDS:
        out, _ = fa.relpos_fwd(z, z, kz, kz, eye, None, 1.0, True, rate,
                               seed)
        want = fa.dense_dropout(B, h, T1, T2, rate, seed, 'cuda') / T2
        assert torch.equal(out, want), seed


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_closed_tiles_write_zeros(cuda, dtype, rate):
    """K3 skips the key blocks the mask closes for every query (the gap's
    keys 64..191 and the padded tail of the second utterance) and writes
    zeros to their dk, dp and dv; K2 writes every row of dq1 and dq2.
    The caching allocator holds NaN before each kernel, so a row or a
    block left unwritten shows."""
    rng = np.random.RandomState(12)
    B, h, T1, T2, d = 2, 4, 130, 448, 64
    x, mask, do = _cuda_inputs(rng, dtype, B, h, T1, T2, d, 1, 'gap')
    mask[-1, :, T2 // 3:] = False  # the second utterance's padded tail
    scale, seed = 1.0 / np.sqrt(d), 77
    out, lse = fa.relpos_fwd(*x, mask, scale, True, rate, seed)
    delta = (do.float() * out.float()).sum(-1)
    args = (mask, do, lse, delta, scale, rate, seed)
    fill_allocator_with_nan()
    dq1, dq2 = fa.relpos_bwd_dq(*x, *args)
    fill_allocator_with_nan()
    dk, dp, dv = fa.relpos_bwd_dkpv(*x, *args)
    torch.cuda.synchronize()
    grads = {'dq1': dq1, 'dq2': dq2, 'dk': dk, 'dp': dp, 'dv': dv}
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
    closed = ~mask[:, 0]  # (B, T2): keys no query attends
    assert closed[:, 64:192].all() and closed[-1, 192:].all()
    for name in ('dk', 'dp', 'dv'):
        assert grads[name].transpose(1, 2)[closed].eq(0).all(), name
    x32 = [t.float() for t in x]
    ref = (fa.relpos_bwd_dq_reference(*x32, mask, do.float(), *args[2:]) +
           fa.relpos_bwd_dkpv_reference(*x32, mask, do.float(), *args[2:]))
    for (name, g), r in zip(grads.items(), ref):
        torch.testing.assert_close(g.float(), r, **TOL[dtype], msg=name)
