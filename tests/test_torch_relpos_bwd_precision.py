"""Precision of the tensor-core rel-pos backward (K2, K3) on the CPU: the
kernels' roundings emulated in fp32 on chip_smoke 6a's peaked shape
(2, 4, 300, 300, 64): q1 and q2 scaled by 8 over a pad mask, dropout
0.1.  Run with -s for each share of its bar.

The kernels take lse from K1-train (emulated as
tests/test_torch_relpos_precision.py does) and delta = rowsum(do·out).
`test_emulated_backward_within_its_bar` gives them the delta the
references take, from the reference forward's output rounded to the
working type (as chip_smoke 6a's chained reference and the JAX package's
`_relpos_vjp_bwd` take it), so that what it holds is K2's and K3's own
arithmetic, against:
- float64: the chain in float64 on the same (rounded) inputs;
- the JAX package's backward, `_relpos_bwd_call` with its Pallas kernels
  in interpret mode, in fp32 on the same inputs, output and lse;
at chip_smoke's `TRAIN_TOL` (fp32 atol 2e-4 / rtol 1e-4, bf16 atol 5e-2 /
rtol 2e-2), each gradient under the share it prints, rounded up.

The emulated roundings:
- bf16: every score product exact (bf16 values, fp32 sums); P·D rounded
  once to bf16 for dV; dS rounded once for [dQ1|dQ2] = dS·[K|P], and as
  hi = bf16(dS) and lo = bf16(dS - hi) for [dK|dP] = dSᵀ·[Q1|Q2]; each
  output rounded to bf16 (dp after the batch sum, as the Function casts
  it).
- fp32: 3xTF32 for all eight products (`_mm3`).

`test_bf16_roundings_on_the_peaked_shape` shows which rounding carries
the bf16 dk and dp shares that chip_smoke 6a reads: one rounding of dS
into [dK|dP] takes them past half the bar, the halves keep them under a
quarter of it, and what is left on the Function's chain is delta taken
from K1's bf16 output, where a few outputs round the other way from the
reference's: with exact K2 and K3 that alone takes them past half the
bar (on these inputs to about the bar itself), and the halves add
nothing to it."""

import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch.ops import flash_attention as fa

from test_torch_relpos_precision import _bf16, _inputs, _kernel, _mm3

B, H, T, D = 2, 4, 300, 64  # chip_smoke 6a's peaked shape
RATE, SEED = 0.1, 0x9E3779B1
BARS = {'fp32': (2e-4, 1e-4), 'bf16': (5e-2, 2e-2)}  # TRAIN_TOL
NAMES = ('dq1', 'dq2', 'dk', 'dp', 'dv')
# the largest share of the bar each gradient of the emulated kernels takes
# against either reference: the shares it prints (-s), rounded up
CEILINGS = {
    'fp32': {'dq1': 0.15, 'dq2': 0.15, 'dk': 0.50, 'dp': 0.50, 'dv': 0.10},
    'bf16': {'dq1': 0.25, 'dq2': 0.25, 'dk': 0.20, 'dp': 0.20, 'dv': 0.40},
}


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _case(dtype):
    """-> x (q1, q2, k, p, v), do, mask, scale, dropout multiplier; x and
    do hold the working type's values."""
    x, mask = _inputs(B, H, T, T, D, 'peaked')
    do = torch.from_numpy(
        np.random.RandomState(22).randn(B, H, T, D).astype(np.float32))
    if dtype == 'bf16':
        x, do = [_bf16(t) for t in x], _bf16(do)
    drop = fa.dense_dropout(B, H, T, T, RATE, SEED, 'cpu')
    return x, do, mask, D ** -0.5, drop


def _rnd(dtype):
    return _bf16 if dtype == 'bf16' else (lambda t: t)


def _scores(x, dtype):
    q1, q2, k, p, _ = x
    kt, pt = k.transpose(-1, -2), p.transpose(-1, -2)
    if dtype == 'fp32':
        return _mm3(q1, kt) + _mm3(q2, pt)
    return q1 @ kt + q2 @ pt


def _backward(x, do, mask, lse, delta, scale, drop, dtype, ds_kp='halves'):
    """K2's and K3's arithmetic in fp32 -> (dq1, dq2, dk, dp, dv) as the
    Function returns them.  ds_kp: how dS enters [dK|dP] in bf16
    ('halves', 'once', or 'exact')."""
    q1, q2, k, p, v = x
    s = _scores(x, dtype) * scale
    prob = torch.where(mask[:, None], torch.exp(s - lse[..., None]), 0.0)
    vt = v.transpose(-1, -2)
    dpv = (_mm3(do, vt) if dtype == 'fp32' else do @ vt) * drop
    ds = prob * (dpv - delta[..., None]) * scale
    pvt, dst = (prob * drop).transpose(-1, -2), ds.transpose(-1, -2)
    if dtype == 'fp32':
        grads = [_mm3(ds, k), _mm3(ds, p), _mm3(dst, q1), _mm3(dst, q2),
                 _mm3(pvt, do)]
    else:
        if ds_kp == 'halves':
            hi = _bf16(dst)
            lo = _bf16(dst - hi)
            dk, dp = lo @ q1 + hi @ q1, lo @ q2 + hi @ q2
        else:
            a = _bf16(dst) if ds_kp == 'once' else dst
            dk, dp = a @ q1, a @ q2
        grads = [_bf16(ds) @ k, _bf16(ds) @ p, dk, dp, _bf16(pvt) @ do]
    grads[3] = grads[3].sum(0, keepdim=True)
    return [_rnd(dtype)(g) for g in grads]


def _k1(x, mask, scale, drop, dtype):
    """K1-train's output (in the working type) and lse, emulated."""
    out = _kernel(x, mask, scale, drop, dtype)
    s = (_scores(x, dtype) * scale).masked_fill(~mask[:, None],
                                                -float('inf'))
    return out, torch.logsumexp(s, -1)


def _float64(x, do, mask, scale, drop, dtype):
    """The chain in float64: delta from the output rounded to the working
    type."""
    q1, q2, k, p, v = (t.double() for t in x)
    do, drop = do.double(), drop.double()
    s = (q1 @ k.transpose(-1, -2) + q2 @ p.transpose(-1, -2)) * scale
    s = s.masked_fill(~mask[:, None], -float('inf'))
    prob = torch.softmax(s, -1)
    out = (prob * drop) @ v
    delta = (do * _rnd(dtype)(out.float()).double()).sum(-1)
    ds = prob * (do @ v.transpose(-1, -2) * drop - delta[..., None]) * scale
    dst = ds.transpose(-1, -2)
    return [ds @ k, ds @ p, dst @ q1, (dst @ q2).sum(0, keepdim=True),
            (prob * drop).transpose(-1, -2) @ do]


def _jax(x, do, mask, scale, dtype):
    """The JAX package's backward kernels on the reference forward's
    output (rounded to the working type) and lse."""
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import _relpos_bwd_call
    want, lse = fa.relpos_fwd_reference(*x, mask, scale, True, RATE, SEED)
    j = [jnp.asarray(t.numpy()) for t in
         (*x, mask, _rnd(dtype)(want), lse, do)]
    got = _relpos_bwd_call(*j, scale, 128, 128, dropout_rate=RATE,
                           dropout_seed=jnp.uint32(SEED))
    got = [torch.from_numpy(np.array(g)).double() for g in got]
    got[3] = got[3].sum(0, keepdim=True)
    return got


def _shares(got, want, bar):
    atol, rtol = bar
    return {n: float(((g.double() - w.double()).abs() /
                      (atol + rtol * w.double().abs())).max())
            for n, g, w in zip(NAMES, got, want)}


def _line(shares):
    return ', '.join(f'{n} {100 * x:.1f}%' for n, x in shares.items())


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_emulated_backward_within_its_bar(interpret_pallas, dtype):
    """K2 and K3 on K1's lse and on the delta the references take (from
    the reference output rounded to the working type), so that what is
    held is their own arithmetic."""
    x, do, mask, scale, drop = _case(dtype)
    _, lse = _k1(x, mask, scale, drop, dtype)
    want, _ = fa.relpos_fwd_reference(*x, mask, scale, True, RATE, SEED)
    delta = (do * _rnd(dtype)(want)).sum(-1)
    got = _backward(x, do, mask, lse, delta, scale, drop, dtype)
    bar = BARS[dtype]
    refs = {'float64': _float64(x, do, mask, scale, drop, dtype),
            'JAX _relpos_bwd_call': _jax(x, do, mask, scale, dtype)}
    shares = {name: _shares(got, want, bar) for name, want in refs.items()}
    for name, sh in shares.items():
        print(f'peaked ({B},{H},{T},{T},{D}) dropout {RATE} {dtype}, bar '
              f'atol {bar[0]:g} / rtol {bar[1]:g}, emulated K2 + K3 against '
              f'{name}: {_line(sh)}')
    jax_share = _shares(refs['JAX _relpos_bwd_call'], refs['float64'], bar)
    print(f'  JAX against float64: {_line(jax_share)}')
    for n in NAMES:
        worst = max(sh[n] for sh in shares.values())
        assert worst < CEILINGS[dtype][n], (n, worst)


def test_bf16_roundings_on_the_peaked_shape():
    """Which rounding carries the bf16 dk and dp shares: against the
    reference chain with the kernels fed the reference's own delta and
    lse (no K1 in between), one rounding of dS into [dK|dP] takes dk or
    dp past half the bar and the halves keep both under a quarter; with
    exact K2 and K3 fed K1's delta, the few outputs that round the other
    way take dk or dp past half of it alone."""
    dtype = 'bf16'
    x, do, mask, scale, drop = _case(dtype)
    want, want_lse = fa.relpos_fwd_reference(*x, mask, scale, True, RATE,
                                             SEED)
    ref_delta = (do * _bf16(want)).sum(-1)
    ref = _float64(x, do, mask, scale, drop, dtype)
    out, lse = _k1(x, mask, scale, drop, dtype)
    k1_delta = (do * out).sum(-1)
    runs = {
        'dS once into [dK|dP], reference delta': _backward(
            x, do, mask, want_lse, ref_delta, scale, drop, dtype, 'once'),
        'dS halves into [dK|dP], reference delta': _backward(
            x, do, mask, want_lse, ref_delta, scale, drop, dtype),
        'exact K2 and K3, delta of the emulated K1 output': _backward(
            x, do, mask, lse, k1_delta, scale, drop, dtype, 'exact'),
        'dS halves into [dK|dP], delta of the emulated K1 output': _backward(
            x, do, mask, lse, k1_delta, scale, drop, dtype),
    }
    shares = {}
    for name, got in runs.items():
        shares[name] = _shares(got, ref, BARS[dtype])
        print(f'{name}: {_line(shares[name])} of the bf16 bar against '
              'float64')
    once, halves, exact_k1, halves_k1 = shares.values()
    assert max(once['dk'], once['dp']) > 0.5
    assert max(halves['dk'], halves['dp']) < 0.25
    assert max(exact_k1['dk'], exact_k1['dp']) > 0.5
    assert max(halves_k1['dk'], halves_k1['dp']) < (
        max(exact_k1['dk'], exact_k1['dp']) + 0.05)
