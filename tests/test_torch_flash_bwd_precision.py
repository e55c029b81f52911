"""Precision of the masked flash-attention backward (K5, K6) on a peaked
softmax (q scaled by 8), on the CPU: the figures behind two design
choices, printed (run with -s) and held.

1. The bf16 kernels' roundings, emulated in fp32 at chip_smoke 8a's
   peaked shape (2, 4, 300, 300, 64) with a pad mask, three draws: the
   largest share of `TRAIN_TOL` in bf16 (atol 5e-2, rtol 2e-2) that each
   gradient's error takes against fp32 on the same bf16 inputs.  One
   rounding of P and dS keeps dq and dv far inside it but takes dk past
   half of it (dk = dsᵀ·q, q eight times larger), so K6 gives dS to that
   product as hi + lo halves.  And delta = rowsum(do·out) taken from the
   output rounded to bf16, as the Function (and the JAX package's
   `_bwd_call`) take it, puts dk past the bar with exact kernels, so
   chip_smoke 8a holds the bf16 kernels to the plain versions chained
   the same way rather than to dense fp32 autograd.
2. The fp32 references on the CPU test's peaked case (1, 2, 60, 90, 64):
   the JAX `flash_attention` VJP (its Pallas kernels in interpret mode)
   leaves the 1e-5 bar in dk against float64, the port's Function does
   not, so `test_peaked_function_matches_jax_and_float64` holds dk
   against float64."""

import functools

import numpy as np
import pytest
import torch

from wenet_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 5e-2, 2e-2  # chip_smoke's TRAIN_TOL in bf16


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _share(got, want, atol=ATOL, rtol=RTOL):
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _peaked_grads(rng, B=2, h=4, T=300, d=64):
    """-> {case: {gradient: share of the bf16 bar}} for one draw."""
    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    q, k, v, do = (_bf16(randn(B, h, T, d)) for _ in range(4))
    q = q * 8
    lens = torch.from_numpy(rng.randint(T // 2, T + 1, size=B))
    lens[0] = T
    mask = (torch.arange(T)[None, :] < lens[:, None])[:, None, None, :]
    scale = d ** -0.5
    s = (q @ k.transpose(-1, -2) * scale).masked_fill(~mask, fa.NEG_INF)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    p = p.masked_fill(~mask, 0.0)
    out = p @ v
    dp = do @ v.transpose(-1, -2)

    def grads(delta, round_p, round_ds, round_ds_dk):
        ds = p * (dp - delta[..., None]) * scale
        return {'dq': round_ds(ds) @ k,
                'dk': round_ds_dk(ds).transpose(-1, -2) @ q,
                'dv': round_p(p).transpose(-1, -2) @ do}

    def keep(x):
        return x

    def halves(x):  # hi·q + lo·q, the two products summed in fp32
        hi = _bf16(x)
        return hi + _bf16(x - hi)

    delta = (do * out).sum(-1)
    want = grads(delta, keep, keep, keep)
    cases = {'one rounding': grads(delta, _bf16, _bf16, _bf16),
             'dS halves in dK': grads(delta, _bf16, _bf16, halves),
             'exact kernels, delta of the bf16 output': grads(
                 (do * _bf16(out)).sum(-1), keep, keep, keep)}
    return {name: {g: _share(_bf16(got[g]), want[g]) for g in want}
            for name, got in cases.items()}


def test_bf16_roundings_on_a_peaked_softmax():
    rng = np.random.RandomState(15)
    draws = [_peaked_grads(rng) for _ in range(3)]
    for i, draw in enumerate(draws):
        for name, shares in draw.items():
            print(f'draw {i}, {name}: ' + ', '.join(
                f'{g} {100 * x:.0f}%' for g, x in shares.items())
                + ' of the bf16 bar')
    worst = {name: {g: max(d[name][g] for d in draws)
                    for g in ('dq', 'dk', 'dv')} for name in draws[0]}
    one, split = worst['one rounding'], worst['dS halves in dK']
    assert one['dk'] > 0.5 and split['dk'] < 0.25
    assert one['dq'] < 0.25 and one['dv'] < 0.25
    assert worst['exact kernels, delta of the bf16 output']['dk'] > 1.0


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def test_jax_reference_dk_on_the_peaked_case(interpret_pallas, B=1, h=2,
                                             T1=60, T2=90, d=64):
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import flash_attention as jfa
    rng = np.random.RandomState(0)  # the draws of the CPU test's case
    q, _ = (rng.randn(B, h, T1, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, h, T2, d).astype(np.float32) for _ in range(2))
    lens = rng.randint(T2 // 2, T2 + 1, size=(B,))
    mask = (np.arange(T2)[None, :] < lens[:, None])[:, None, :]
    q = q * 8
    scale = 1.0 / np.sqrt(d)

    def loss(q, k, v):
        o = jfa(q, k, v, jnp.asarray(mask), None, scale=scale, block_q=16,
                block_k=16)
        return jnp.sum(o * jnp.cos(o))
    jax_dk = np.asarray(jax.grad(loss, argnums=1)(
        *(jnp.asarray(a) for a in (q, k, v))), dtype=np.float64)

    def port_dk(dtype):
        x = [torch.from_numpy(a).to(dtype).requires_grad_()
             for a in (q, k, v)]
        o = fa.flash_attention(*x, torch.from_numpy(mask), None, scale)
        (o * torch.cos(o)).sum().backward()
        return x[1].grad.double()
    exact = port_dk(torch.float64)
    shares = {}
    for name, got in (('JAX', torch.from_numpy(jax_dk)),
                      ('port', port_dk(torch.float32))):
        shares[name] = _share(got, exact, 1e-5, 1e-5)
        print(f'peaked case ({B},{h},{T1},{T2},{d}), {name} fp32 dk: max '
              f'|dk - float64| {float((got - exact).abs().max()):.3g}, '
              f'{100 * shares[name]:.0f}% of the 1e-5 bar')
    assert shares['JAX'] > 1.0 and shares['port'] < 1.0
