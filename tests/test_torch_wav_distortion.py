"""The port's waveform distortions (wenet_tpu_torch/dataset/wav_distortion.py)
against the JAX package's, every `distort_type`: the JAX functions draw
from numpy's global state after `np.random.seed(s)`, the port's from a
`np.random.RandomState(s)`; the arrays are equal."""

import numpy as np
import pytest

TYPES = [('gain_db', {'db': -20}), ('gain_db', {}),
         ('max_distortion', {'max_db': -6}), ('max_distortion', {}),
         ('fence_distortion', {'max_db': -20}),
         ('jag_distortion', {'point_rate': 0.1}), ('jag_distortion', {}),
         ('poly_distortion', {'a': 2, 'm': 1, 'n': 3}),
         ('quad_distortion', {}), ('amp_mask', {}),
         ('amp_mask', {'db_mask': [(-40, -20), (-6, 0)]}), ('none', {})]


def _wave(seed=0, n=3200):
    rng = np.random.RandomState(seed)
    return (0.4 * rng.randn(n)).astype(np.float32).clip(-1, 1)


@pytest.mark.parametrize('kind,conf', TYPES,
                         ids=[f'{t}-{i}' for i, (t, _) in enumerate(TYPES)])
def test_distort_matches_jax(kind, conf):
    from wenet_tpu.dataset import wav_distortion as jax_wd
    from wenet_tpu_torch.dataset import wav_distortion as wd
    x = _wave()
    np.random.seed(5)
    want = jax_wd.distort(x, kind, dict(conf))
    got = wd.distort(x, kind, dict(conf), np.random.RandomState(5))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if kind == 'jag_distortion':
        assert (got == 0).sum() > (x == 0).sum()


@pytest.mark.parametrize('rate', [0.0, 0.5, 1.0])
def test_distort_wav_sample_matches_jax(rate):
    from wenet_tpu.dataset import wav_distortion as jax_wd
    from wenet_tpu_torch.dataset import wav_distortion as wd
    np.random.seed(9)
    rng = np.random.RandomState(9)
    for i in range(8):
        s = {'wav': _wave(i, 800), 'key': i}
        want = jax_wd.distort_wav_sample(dict(s), 'jag_distortion',
                                         {'point_rate': 0.2}, rate)
        got = wd.distort_wav_sample(dict(s), 'jag_distortion',
                                    {'point_rate': 0.2}, rate, rng=rng)
        np.testing.assert_array_equal(got['wav'], want['wav'])


def test_unknown_distortion_raises():
    from wenet_tpu_torch.dataset import wav_distortion as wd
    with pytest.raises(ValueError, match='unsupported distortion'):
        wd.distort(_wave(), 'reverb')
    with pytest.raises(ValueError, match='RandomState'):
        wd.distort(_wave(), 'jag_distortion')
