"""Waveform distortions for robustness training.  Counterpart of
wenet_tpu/dataset/wav_distortion.py (a host copy in numpy): max-clip,
gain, fence, jag (segment dropout), poly/quad waveshaping and amplitude
masking, on float waveforms in [-1, 1].

The random draws (the jag's segments, `distort_wav_sample`'s coin) come
from the `np.random.RandomState` passed in, where the JAX package's draw
from numpy's global state: a RandomState seeded as `np.random.seed` was
gives the same draws."""

from typing import Optional

import numpy as np


def db2amp(db: float) -> float:
    return 10.0 ** (db / 20.0)


def amp2db(amp: float) -> float:
    return 20.0 * np.log10(np.maximum(np.abs(amp), 1e-10))


def make_poly_distortion(conf: dict):
    """a * sign(x) * (|x| / m)^n, clipped to [-1, 1]; conf {'a', 'm',
    'n'}."""
    a, m, n = conf['a'], conf['m'], conf['n']

    def poly(x, rng=None):
        return np.clip(a * np.sign(x) * (np.abs(x) / m) ** n, -1.0, 1.0)

    return poly


def make_quad_distortion():
    return make_poly_distortion({'a': 1, 'm': 1, 'n': 2})


def make_max_distortion(conf: dict):
    """Hard clip at `max_db` (0.95 without it)."""
    max_db = conf.get('max_db')
    thr = db2amp(max_db) if max_db is not None else 0.95

    def clip(x, rng=None):
        return np.clip(x, -thr, thr)

    return clip


def make_amp_mask(db_mask=None):
    """Zero the samples whose level falls inside one of the dB bands."""
    bands = db_mask or [(-110, -95), (-90, -80), (-65, -60), (-50, -30),
                        (-15, 0)]

    def mask(x, rng=None):
        level = amp2db(x)
        keep = np.ones_like(x, bool)
        for lo, hi in bands:
            keep &= ~((level >= lo) & (level <= hi))
        return np.where(keep, x, 0.0)

    return mask


def make_fence_distortion(conf: dict):
    """Keep only the samples at or above the level `max_db` (-30 dB)."""
    thr = db2amp(conf.get('max_db', -30))

    def fence(x, rng=None):
        return np.where(np.abs(x) >= thr, x, 0.0)

    return fence


def make_jag_distortion(conf: dict):
    """Zero max(int(n * point_rate) // 20, 1) segments of 1-19 samples at
    random starts."""
    num_jags = conf.get('point_rate', 0.05)

    def jag(x, rng):
        out = x.copy()
        n = len(x)
        for _ in range(max(int(n * num_jags) // 20, 1)):
            start = rng.randint(0, max(n - 20, 1))
            width = rng.randint(1, 20)
            out[start:start + width] = 0.0
        return out

    return jag


def make_gain_db(conf: dict):
    """A static gain of `db` (-6 dB), clipped to [-1, 1]."""
    g = db2amp(conf.get('db', -6))

    def gain(x, rng=None):
        return np.clip(x * g, -1.0, 1.0)

    return gain


_DISTORTIONS = {
    'gain_db': make_gain_db,
    'max_distortion': make_max_distortion,
    'fence_distortion': make_fence_distortion,
    'jag_distortion': make_jag_distortion,
    'poly_distortion': make_poly_distortion,
    'quad_distortion': lambda conf: make_quad_distortion(),
    'amp_mask': lambda conf: make_amp_mask(conf.get('db_mask')),
}


def distort(x: np.ndarray, distort_type: str, conf: Optional[dict] = None,
            rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """`distort_type`'s distortion of x as float32 ('none' returns x as it
    is); `rng` draws the jag's segments."""
    if distort_type == 'none':
        return x
    if distort_type not in _DISTORTIONS:
        raise ValueError(f'unsupported distortion {distort_type}')
    if distort_type == 'jag_distortion' and rng is None:
        raise ValueError('jag_distortion draws from rng: pass a '
                         'np.random.RandomState')
    fn = _DISTORTIONS[distort_type](conf or {})
    return fn(np.asarray(x, np.float32), rng)


def distort_wav_sample(sample: dict, distort_type: str = 'none',
                       distort_conf: Optional[dict] = None,
                       rate: float = 0.0, *,
                       rng: np.random.RandomState) -> dict:
    """Processor stage: distort sample['wav'] with probability `rate` (one
    draw from `rng` when rate > 0)."""
    if rate > 0 and rng.random_sample() < rate:
        sample = dict(sample)
        sample['wav'] = distort(sample['wav'], distort_type, distort_conf,
                                rng)
    return sample
