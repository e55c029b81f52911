"""Head dim 128 in training: rel-pos attention (K1-train, K2, K3) and the
masked flash backward (K5, K6) at d = 128.

On the CPU the port's `RelPosAttention` Function (the plain versions of
K1-K3 on CPU tensors) is held to the JAX `flash_attention_relpos` with
its Pallas kernels in interpret mode, at d = 128, within the bars of
tests/test_torch_train_kernels.py; and one train step of the flagship's
structure with two heads of d = 128 (2 encoder blocks) to the JAX
package's.  The `cuda` tests hold the Hopper kernels at d = 128 to their
plain versions; jax is imported inside the CPU tests only, so the file
also collects where jax is absent."""

import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch.ops import flash_attention as fa

from torch_port_utils import (feats, fill_allocator_with_nan, jax_model,
                              tiny_config, torch_model)

D = 128
ATOL = 1e-5  # the Function against the JAX kernels (as d <= 64)
GRAD_SHARE = 2e-4  # 12c's bar: 1e-3 + this x the tensor's largest |grad|


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _relpos_inputs(rng, B, h, T1, T2, mask_kind, p_batch=1):
    """q1, q2, k, p, v, the bool mask and do as numpy, d = 128.  'pad':
    (B, 1, T2) key padding; 'tail': the last row's keys past T2 // 3
    closed (whole key blocks); 'gap': keys 64..191 closed mid-row;
    'peaked': q1, q2 scaled by 8; 'chunk': a dynamic chunk of 8 over key
    padding; 'masked_row': that, with row 3 of batch 0 fully masked."""
    q1, q2, do = (rng.randn(B, h, T1, D).astype(np.float32)
                  for _ in range(3))
    k, v = (rng.randn(B, h, T2, D).astype(np.float32) for _ in range(2))
    p = rng.randn(p_batch, h, T2, D).astype(np.float32)
    lens = rng.randint(T2 // 2, T2 + 1, size=(B,))
    if mask_kind == 'tail':
        lens[-1] = T2 // 3
    pad = np.arange(T2)[None, :] < lens[:, None]
    if mask_kind is None:
        mask = None
    elif mask_kind in ('pad', 'tail', 'peaked', 'gap'):
        mask = pad[:, None, :]
        if mask_kind == 'peaked':
            q1, q2 = q1 * 8, q2 * 8
        elif mask_kind == 'gap':
            mask = mask & ((np.arange(T2) < 64) | (np.arange(T2) >= 192))
    else:
        row = np.arange(T1)[:, None] // 8
        mask = (np.arange(T2)[None, :] < (row + 1) * 8)[None] & pad[:, None]
        if mask_kind == 'masked_row':
            mask[0, 3] = False
    return (q1, q2, k, p, v), mask, do


JAX_CASES = [  # B, h, T1, T2, mask, dropout rate
    (2, 2, 40, 40, 'pad', 0.0),
    (2, 2, 48, 48, 'chunk', 0.1),
    (1, 2, 24, 24, 'masked_row', 0.0),
]


@pytest.mark.parametrize('B,h,T1,T2,mask_kind,rate', JAX_CASES)
def test_relpos_function_matches_jax(interpret_pallas, B, h, T1, T2,
                                     mask_kind, rate):
    """The port's Function at d = 128 against the JAX kernels: output and
    the five gradients within 1e-5, lse within 1e-5 / rtol 1e-6."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops import flash_attention as jfa
    rng = np.random.RandomState(31)
    arrs, mask, do = _relpos_inputs(rng, B, h, T1, T2, mask_kind)
    scale = 1.0 / np.sqrt(D)
    seed = 0xC0FFEE if rate > 0 else None
    jmask = jnp.asarray(mask)
    jseed = None if seed is None else jnp.uint32(seed)
    jargs = [jnp.asarray(a) for a in arrs]

    def kernel(*a):
        return jfa.flash_attention_relpos(*a, jmask, scale, 16, 16, jseed,
                                          rate)

    want, vjp = jax.vjp(kernel, *jargs)
    want_grads = vjp(jnp.asarray(do))
    _, want_lse = jfa._relpos_fwd_call(*jargs, jmask, scale, 16, 16,
                                       want_lse=True, dropout_rate=rate,
                                       dropout_seed=jseed)

    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tmask = torch.from_numpy(mask)
    out = fa.flash_attention_relpos(*ts, tmask, scale, rate, seed)
    assert type(out.grad_fn).__name__ == 'RelPosAttentionBackward'
    out.backward(torch.from_numpy(do))
    _, lse = fa.relpos_fwd_reference(*(torch.from_numpy(a) for a in arrs),
                                     tmask, scale, True, rate, seed)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL,
                               rtol=1e-6)
    for name, t, g in zip(('dq1', 'dq2', 'dk', 'dp', 'dv'), ts, want_grads):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL,
                                   err_msg=name)
    if mask_kind == 'masked_row':
        assert lse[0, :, 3].eq(fa.NEG_INF).all()
        assert not out[0, :, 3].any() and not ts[0].grad[0, :, 3].any()


def _d128_config():
    """The flagship's structure (rel-pos conformer, bitransformer decoder)
    at 256 wide with two heads, so d = 128, 2 + 1 + 1 blocks, every
    dropout 0."""
    cfg = tiny_config(output_size=256, attention_heads=2, linear_units=256,
                      dropout_rate=0.0, positional_dropout_rate=0.0,
                      attention_dropout_rate=0.0)
    cfg['decoder_conf'].update(
        attention_heads=2, linear_units=256, num_blocks=1, r_num_blocks=1,
        dropout_rate=0.0, positional_dropout_rate=0.0,
        self_attention_dropout_rate=0.0, src_attention_dropout_rate=0.0)
    return cfg


def test_train_step_matches_jax():
    """Loss and gradients of one step against the JAX package: the loss
    terms within rtol 1e-4, each gradient within 1e-3 + 2e-4 of its
    tensor's largest (12c's bar)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg = _d128_config()
    model, variables = jax_model(cfg, seed=41)
    tmodel = torch_model(cfg, variables).train()
    assert tmodel.encoder.encoders[0].self_attn.d_k == D
    x, lens = feats(42, B=2, T=71)
    rng = np.random.RandomState(43)
    tl = np.asarray([7, 5])
    tgt = np.full((2, 7), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, 30, size=n)
    b = dict(feats=x, feats_lengths=lens.astype(np.int64), target=tgt,
             target_lengths=tl.astype(np.int64))

    def loss_fn(params):
        out = model.apply({**variables, 'params': params},
                          *(jnp.asarray(b[k]) for k in (
                              'feats', 'feats_lengths', 'target',
                              'target_lengths')), train=True)
        return out['loss'], out

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables['params'])
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    got = tmodel(tb['feats'], tb['feats_lengths'], tb['target'],
                 tb['target_lengths'])
    got['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc'):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    for name, p in tmodel.named_parameters():
        w = want_grads[name].numpy()
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0,
            atol=1e-3 + GRAD_SHARE * float(np.abs(w).max()), err_msg=name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
# test_torch_train_kernels.py's ragged, gap, tail and peaked cases at d = 128
CUDA_CASES = [  # B, h, T1, T2, mask, p batch
    (2, 2, 37, 53, None, 2),
    (2, 4, 200, 448, 'gap', 1),
    (2, 4, 130, 300, 'tail', 1),
    (2, 4, 300, 300, 'peaked', 1),
]
TOL = {torch.float32: dict(atol=2e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
# K4-train's output and lse: K4's bars
FWD_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
           torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False


def _to_cuda(dtype, arrs, mask, do):
    x = [torch.from_numpy(a).cuda().to(dtype) for a in arrs]
    # q-side operands as strided (B, T, h, d)-ordered views, as the module
    # hands them
    x[0] = x[0].transpose(1, 2).contiguous().transpose(1, 2)
    if len(x) == 5:
        x[1] = x[1].transpose(1, 2).contiguous().transpose(1, 2)
    return (x, None if mask is None else torch.from_numpy(mask).cuda(),
            torch.from_numpy(do).cuda().to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,h,T1,T2,mask_kind,pb', CUDA_CASES)
def test_cuda_relpos_kernels_match_plain(cuda, rate, dtype, B, h, T1, T2,
                                         mask_kind, pb):
    """K1-train (lse, dropout), K2 and K3 at d = 128 against their plain
    versions in fp32 on the same (bf16-rounded) inputs, lse and delta."""
    rng = np.random.RandomState(51)
    x, mask, do = _to_cuda(dtype, *_relpos_inputs(rng, B, h, T1, T2,
                                                  mask_kind, pb))
    scale, seed = 1.0 / np.sqrt(D), 0xFFFFFFFF
    x32 = [t.float() for t in x]
    before = dict(fa.LAUNCHES)
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
    for name in ('relpos_attention_fwd_train', 'relpos_attention_bwd_dq',
                 'relpos_attention_bwd_dkpv'):
        assert fa.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
def test_cuda_relpos_function_matches_cpu(cuda):
    """The Function at d = 128 on the card (K1-train, K2, K3 with dropout)
    against the same Function on the CPU (plain versions), grads
    included."""
    rng = np.random.RandomState(52)
    arrs, mask, do = _relpos_inputs(rng, 2, 2, 150, 150, 'chunk')
    x, tmask, tdo = _to_cuda(torch.float32, arrs, mask, do)
    dev = [t.detach().requires_grad_() for t in x]
    cpu = [t.detach().cpu().requires_grad_() for t in x]
    out = fa.flash_attention_relpos(*dev, tmask, 0.088, 0.1, 99)
    out.backward(tdo)
    want = fa.flash_attention_relpos(*cpu, tmask.cpu(), 0.088, 0.1, 99)
    want.backward(tdo.cpu())
    tol = TOL[torch.float32]
    torch.testing.assert_close(out.detach().cpu(), want.detach(), **tol)
    for t, w in zip(dev, cpu):
        torch.testing.assert_close(t.grad.cpu(), w.grad, **tol)


def _flash_inputs(rng, B, h, T1, T2, mask_kind, with_bias):
    """q, k, v, the (B, 1, T2) mask, a (B, h, T1, T2) bias or None, do."""
    (q, _, k, _, v), mask, do = _relpos_inputs(rng, B, h, T1, T2, mask_kind)
    if mask is not None:
        mask = mask[:, None]
    bias = ((rng.randn(B, h, T1, T2) * 0.5).astype(np.float32)
            if with_bias else None)
    return (q, k, v), mask, bias, do


@pytest.mark.cuda
@pytest.mark.parametrize('with_bias', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,h,T1,T2,mask_kind,pb', CUDA_CASES)
def test_cuda_flash_bwd_match_plain(cuda, with_bias, dtype, B, h, T1, T2,
                                    mask_kind, pb):
    """K4-train, K5 (dbias with the bias) and K6 at d = 128 against their
    plain versions in fp32 on the same inputs, lse and delta."""
    rng = np.random.RandomState(53)
    arrs, mask, bias, do = _flash_inputs(rng, B, h, T1, T2, mask_kind,
                                         with_bias)
    (q, k, v), mask, do = _to_cuda(dtype, arrs, mask, do)
    bias = None if bias is None else torch.from_numpy(bias).cuda()
    scale = 1.0 / np.sqrt(D)
    x32 = [t.float() for t in (q, k, v)]
    out, lse = fa.flash_fwd(q, k, v, mask, bias, scale, want_lse=True)
    want, want_lse = fa.flash_fwd_reference(*x32, mask, bias, scale, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, **FWD_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, **FWD_TOL[torch.float32])
    delta = (do.float() * want).sum(-1)
    args = (mask, bias, do, want_lse, delta, scale)
    before = dict(fa.LAUNCHES)
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
    for name in ('flash_attention_bwd_dq', 'flash_attention_bwd_dkv'):
        assert fa.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cuda_closed_tiles_write_zeros(cuda, dtype):
    """At d = 128 K3 writes every key's dk, dp and dv, and K5 and K6 write
    zeros to dbias, dk and dv where the mask closes whole tiles (keys
    64..191, the second row's padded tail), with the caching allocator
    full of NaN before each kernel."""
    rng = np.random.RandomState(54)
    B, h, T1, T2 = 2, 2, 130, 448
    arrs, mask, do = _relpos_inputs(rng, B, h, T1, T2, 'gap')
    mask[-1, :, T2 // 3:] = False
    x, tmask, tdo = _to_cuda(dtype, arrs, mask, do)
    scale = 1.0 / np.sqrt(D)
    closed = ~tmask[:, 0]  # (B, T2): keys no query attends
    out, lse = fa.relpos_fwd(*x, tmask, scale, True, 0.1, 7)
    delta = (tdo.float() * out.float()).sum(-1)
    fill_allocator_with_nan()
    dk, dp, dv = fa.relpos_bwd_dkpv(*x, tmask, tdo, lse, delta, scale, 0.1,
                                    7)
    torch.cuda.synchronize()
    for name, g in (('dk', dk), ('dp', dp), ('dv', dv)):
        assert torch.isfinite(g).all(), name
        assert g.transpose(1, 2)[closed].eq(0).all(), name
    q, k, v = x[0], x[2], x[4]
    m4 = tmask[:, None]
    bias = torch.from_numpy(rng.randn(B, h, T1, T2).astype(
        np.float32)).cuda()
    out, lse = fa.flash_fwd(q, k, v, m4, bias, scale, want_lse=True)
    delta = (tdo.float() * out.float()).sum(-1)
    args = (m4, bias, tdo, lse, delta, scale)
    fill_allocator_with_nan()
    dq, dbias = fa.flash_bwd_dq(q, k, v, *args)
    fill_allocator_with_nan()
    dk, dv = fa.flash_bwd_dkv(q, k, v, *args)
    torch.cuda.synchronize()
    for name, g in (('dq', dq), ('dbias', dbias), ('dk', dk), ('dv', dv)):
        assert torch.isfinite(g).all(), name
    assert dbias[closed[:, None, None, :].expand(B, h, T1, T2)].eq(0).all()
    for g in (dk, dv):
        assert g.transpose(1, 2)[closed].eq(0).all()
    rdq, rdbias = fa.flash_bwd_dq_reference(
        q.float(), k.float(), v.float(), m4, bias, tdo.float(), lse, delta,
        scale)
    rdk, rdv = fa.flash_bwd_dkv_reference(
        q.float(), k.float(), v.float(), m4, bias, tdo.float(), lse, delta,
        scale)
    for name, g, r in (('dq', dq, rdq), ('dbias', dbias, rdbias),
                       ('dk', dk, rdk), ('dv', dv, rdv)):
        torch.testing.assert_close(g.float(), r, **TOL[dtype], msg=name)
