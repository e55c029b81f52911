"""Precision of the tensor-core rel-pos forward (K1, K1-train) on the CPU:
the kernel's roundings emulated in fp32, held against float64 and against
the JAX package's `_relpos_reference` on the same inputs, at the bars
chip_smoke holds the kernel to; run with -s for each share of its bar.

Two shapes:
1. chip_smoke 3's peaked case (2, 4, 300, 300, 64): q1 and q2 scaled by
   8 over a pad mask, at K1's bars (fp32 atol 2e-5 / rtol 1e-5; bf16
   atol 1e-3 / rtol 8e-3 against fp32 on the same rounded inputs).
2. The train step's shape with a static chunk mask of 16 over key padding
   and dropout 0.1 (chip_smoke 6a's, (16, 4, 299, 299, 64), cut here to
   B = 4), at `TRAIN_TOL` (fp32 atol 2e-4 / rtol 1e-4; bf16 atol 5e-2 /
   rtol 2e-2).

The emulated roundings:
- bf16: q1, q2, k, p and v rounded to bf16; both score products exact
  (products of bf16 values summed in fp32); the softmax in fp32; the
  dropout mask multiplied into the probabilities after their sum was
  taken; P split into hi = bf16(P) and lo = bf16(P - hi) for P·V; the
  output rounded to bf16.  P rounded once instead of split is printed
  beside it, for the record.
- fp32: 3xTF32 for all three products: each operand split into
  hi = tf32(x) and lo = tf32(x - hi), tf32 emulated as the kernel's
  `cvt.rna` rounds (half of the 13 dropped mantissa bits added, then
  cleared), and lo·hi + hi·lo + hi·hi summed in fp32."""

import numpy as np
import pytest
import torch

from wenet_tpu_torch.ops import flash_attention as fa

CASES = {  # name: (B, h, T1, T2, d, mask, dropout rate)
    'peaked': (2, 4, 300, 300, 64, 'peaked', 0.0),
    'train': (4, 4, 299, 299, 64, 'chunk', 0.1),
}
BARS = {  # (case, dtype): the chip check's bar
    ('peaked', 'fp32'): (2e-5, 1e-5), ('peaked', 'bf16'): (1e-3, 8e-3),
    ('train', 'fp32'): (2e-4, 1e-4), ('train', 'bf16'): (5e-2, 2e-2),
}
SEED = 0x9E3779B1  # the dropout seed


def _inputs(B, h, T1, T2, d, mask_kind):
    rng = np.random.RandomState(21)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    q1, q2 = randn(B, h, T1, d), randn(B, h, T1, d)
    k, p, v = randn(B, h, T2, d), randn(1, h, T2, d), randn(B, h, T2, d)
    lens = torch.from_numpy(rng.randint(T2 // 2, T2 + 1, size=B))
    lens[0] = T2
    keys = torch.arange(T2)
    pad = keys[None, :] < lens[:, None]
    if mask_kind == 'peaked':
        q1, q2 = q1 * 8, q2 * 8
        mask = pad[:, None, :]
    else:
        rows = torch.arange(T1)[:, None] // 16
        mask = (keys[None, :] < (rows + 1) * 16)[None] & pad[:, None, :]
    return [q1, q2, k, p, v], mask


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tf32(x):
    """fp32 -> tf32 as cvt.rna.tf32.f32: round to nearest, ties away."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b):
    """a @ b in 3xTF32: lo·hi + hi·lo + hi·hi, summed in fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _kernel(x, mask, scale, drop, dtype, split_p=True):
    """The kernel's arithmetic in fp32: x (q1, q2, k, p, v) already in the
    working type's values; drop: the dense dropout multiplier or None."""
    q1, q2, k, p, v = x
    kt, pt = k.transpose(-1, -2), p.transpose(-1, -2)
    if dtype == 'fp32':
        s = _mm3(q1, kt) + _mm3(q2, pt)
    else:
        s = q1 @ kt + q2 @ pt
    s = (s * scale).masked_fill(~mask[:, None], -float('inf'))
    m = s.amax(-1, keepdim=True)
    prob = torch.exp(s - m)
    l = prob.sum(-1, keepdim=True)
    if drop is not None:
        prob = prob * drop
    if dtype == 'fp32':
        o = _mm3(prob, v)
    elif split_p:
        hi = _bf16(prob)
        o = _bf16(prob - hi) @ v + hi @ v
    else:
        o = _bf16(prob) @ v
    o = o / l
    return o if dtype == 'fp32' else _bf16(o)


def _float64(x, mask, scale, drop):
    q1, q2, k, p, v = (t.double() for t in x)
    s = (q1 @ k.transpose(-1, -2) + q2 @ p.transpose(-1, -2)) * scale
    a = torch.softmax(s.masked_fill(~mask[:, None], -float('inf')), -1)
    if drop is not None:
        a = a * drop.double()
    return a @ v


def _jax(x, mask, scale, rate):
    import jax.numpy as jnp
    from wenet_tpu.ops.flash_attention import _relpos_reference
    out = _relpos_reference(*(jnp.asarray(t.numpy()) for t in x),
                            jnp.asarray(mask.numpy()), scale,
                            dropout_rate=rate, dropout_seed=SEED)
    return torch.from_numpy(np.array(out)).double()


def _share(got, want, bar):
    atol, rtol = bar
    return float(((got.double() - want).abs() /
                  (atol + rtol * want.abs())).max())


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('case', list(CASES))
def test_emulated_kernel_within_its_bar(case, dtype):
    B, h, T1, T2, d, mask_kind, rate = CASES[case]
    x, mask = _inputs(B, h, T1, T2, d, mask_kind)
    if dtype == 'bf16':
        x = [_bf16(t) for t in x]
    scale = d ** -0.5
    drop = (fa.dense_dropout(B, h, T1, T2, rate, SEED, 'cpu')
            if rate > 0 else None)
    got = _kernel(x, mask, scale, drop, dtype)
    bar = BARS[case, dtype]
    refs = {'float64': _float64(x, mask, scale, drop),
            'JAX _relpos_reference': _jax(x, mask, scale, rate)}
    shares = {name: _share(got, want, bar) for name, want in refs.items()}
    line = ', '.join(f'{100 * x:.1f}% of the bar against {name}'
                     for name, x in shares.items())
    jax_share = _share(refs['JAX _relpos_reference'], refs['float64'], bar)
    print(f'{case} ({B},{h},{T1},{T2},{d}) {dtype}, bar atol {bar[0]:g} / '
          f'rtol {bar[1]:g}: emulated kernel {line}; JAX against float64 '
          f'{100 * jax_share:.1f}%')
    if dtype == 'bf16':
        once = _kernel(x, mask, scale, drop, dtype, split_p=False)
        print(f'  P rounded once instead of split: '
              f'{100 * _share(once, refs["float64"], bar):.0f}% of the bar '
              f'against float64')
    assert max(shares.values()) < 1.0
