"""The port's learning-rate schedules (wenet_tpu_torch/utils/scheduler.py)
against the JAX package's, through `build_schedule` under every name and
alias it takes, with steps and ratios: at steps 0 and 1, each edge (the
warmup's, the hold's, max_steps, constant_steps) and one step either
side of it, and a few steps between, within rtol 1e-6 and atol 1e-9 * lr
(the JAX schedules compute in float32, the port's in Python floats but
for the cosine, which it computes as the JAX one does)."""

import numpy as np
import pytest

LR = 2e-3
# (name, conf, the edges of this conf)
CASES = [
    ('warmuplr', {'warmup_steps': 25}, [25]),
    ('warmuplr', {'warmup_steps': 0}, []),
    ('NoamHoldAnnealing', {'warmup_steps': 10, 'hold_steps': 20,
                           'max_steps': 200, 'min_lr': 1e-5}, [10, 30, 200]),
    ('noamholdannealing', {'warmup_ratio': 0.1, 'hold_ratio': 0.25,
                           'max_steps': 160, 'decay_rate': 1.0},
     [16, 56, 160]),
    ('NoamHoldAnnealing', {'warmup_ratio': 0.05, 'max_steps': 100,
                           'min_lr': 1e-3}, [5, 100]),
    ('noam_annealing', {'d_model': 256, 'warmup_steps': 25, 'min_lr': 1e-6},
     [25]),
    ('noam_annealing', {'d_model': 512, 'warmup_steps': 0}, []),
    ('cosine_annealing', {'max_steps': 200, 'warmup_steps': 20,
                          'min_lr': 1e-5}, [20, 200]),
    ('cosine_annealing', {'max_steps': 90}, [90]),
    ('constantlr', {}, []),
    ('sqrt_constant', {'constant_steps': 16, 'max_steps': 100,
                       'min_lr': 1e-6}, [16, 100]),
    ('SquareRootConstantPolicy', {'constant_ratio': 0.2, 'max_steps': 50},
     [10, 50]),
    ('warmup_hold', {'warmup_steps': 10, 'hold_steps': 20,
                     'max_steps': 100, 'min_lr': 1e-5}, [10, 30, 100]),
    ('WarmupHoldPolicy', {'warmup_ratio': 0.1, 'hold_ratio': 0.3,
                          'max_steps': 70}, [7, 28, 70]),
]


def _steps(edges):
    steps = {0, 1, 2, 3, 7, 50, 123, 1000, 10 ** 5}
    for e in edges:
        steps |= {e - 1, e, e + 1, e // 2, e + e // 3}
    return sorted(s for s in steps if s >= 0)


@pytest.mark.parametrize('name,conf,edges', CASES,
                         ids=[f'{c[0]}-{i}' for i, c in enumerate(CASES)])
def test_schedule_matches_jax(name, conf, edges):
    from wenet_tpu.utils.scheduler import build_schedule as jax_build
    from wenet_tpu_torch.utils.scheduler import build_schedule
    got, want = build_schedule(name, conf, LR), jax_build(name, conf, LR)
    for step in _steps(edges):
        g, w = got(step), float(want(step))
        assert isinstance(g, float)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9 * LR,
                                   err_msg=f'{name} step {step}')


def test_unknown_scheduler_raises_as_jax():
    from wenet_tpu.utils.scheduler import build_schedule as jax_build
    from wenet_tpu_torch.utils.scheduler import build_schedule
    for fn in (build_schedule, jax_build):
        with pytest.raises(ValueError, match='unknown scheduler'):
            fn('exponential', {}, LR)


def test_every_jax_name_is_taken():
    """Each name the JAX `build_schedule` branches on builds here."""
    import inspect
    import re
    from wenet_tpu.utils import scheduler as jax_scheduler
    from wenet_tpu_torch.utils.scheduler import build_schedule
    src = inspect.getsource(jax_scheduler.build_schedule)
    names = set(re.findall(r"'([A-Za-z_]+)'", src.split('conf = ')[1]))
    names = {n for n in names if not n.endswith(('_steps', '_ratio', '_lr',
                                                 '_rate', '_model'))}
    assert {'warmuplr', 'noamholdannealing', 'noam_annealing',
            'cosine_annealing', 'constantlr', 'sqrt_constant',
            'SquareRootConstantPolicy', 'warmup_hold',
            'WarmupHoldPolicy'} <= names
    for n in names:
        assert build_schedule(n, {'max_steps': 10, 'constant_steps': 4,
                                  'warmup_steps': 2}, LR)(3) > 0
