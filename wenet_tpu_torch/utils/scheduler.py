"""Learning-rate schedules as pure `step -> lr` functions.  Counterpart of
wenet_tpu/utils/scheduler.py: `warmuplr`, `noam_annealing`,
`NoamHoldAnnealing`, `cosine_annealing`, `constantlr`, `sqrt_constant`
(`SquareRootConstantPolicy`) and `warmup_hold` (`WarmupHoldPolicy`), with
the `*_ratio` keys of `max_steps` where the JAX `build_schedule` reads
them.  The JAX schedules compute in float32, these in Python floats but
for the cosine, which cancels near its end (`cosine_annealing`).

The train step sets each param group's lr to `schedule(update)` right
before `optimizer.step()`, `update` counting the optimizer updates made
before this one, so the first update uses `schedule(0)` as optax does
(`LambdaLR` would be one step off)."""

import math
from typing import Callable

import numpy as np


def warmup_lr(lr: float, warmup_steps: float = 25000) -> Callable[[int],
                                                                 float]:
    """Noam-style warmup: lr * w^0.5 * min(s^-0.5, s * w^-1.5), s = step+1."""

    def schedule(step: int) -> float:
        s = float(max(step + 1, 1))
        if warmup_steps == 0:
            return lr * s ** -0.5
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)

    return schedule


def noam_annealing(lr: float, d_model: int, warmup_steps: int,
                   min_lr: float = 0.0) -> Callable[[int], float]:
    """lr * d_model^-0.5 * min(s^-0.5, s * w^-1.5), s = step+1, clamped to
    min_lr only after the warmup."""

    def schedule(step: int) -> float:
        s = float(max(step + 1, 1))
        if warmup_steps and warmup_steps > 0:
            mult = d_model ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
        else:
            mult = d_model ** -0.5 * s ** -0.5
        out = lr * mult
        return max(out, min_lr) if s > warmup_steps else out

    return schedule


def noam_hold_annealing(lr: float, warmup_steps: int, hold_steps: int,
                        max_steps: int = 0, decay_rate: float = 0.5,
                        min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup (step+1)/(warmup+1), the base lr until warmup + hold,
    then lr * warmup^decay / (step - hold)^decay down to min_lr, and min_lr
    past max_steps (max_steps > 0)."""
    hold_total = hold_steps + warmup_steps
    t_warm = max(1.0, warmup_steps ** decay_rate)

    def schedule(step: int) -> float:
        s = float(step)
        if s <= warmup_steps and warmup_steps > 0:
            return lr * (s + 1.0) / (warmup_steps + 1.0)
        if s < hold_total:
            return lr
        if max_steps > 0 and s > max_steps:
            return min_lr
        t_decay = max(1.0, max(s - hold_steps, 0.0) ** decay_rate)
        return max(lr * t_warm / t_decay, min_lr)

    return schedule


def cosine_annealing(lr: float, max_steps: int, warmup_steps: int = 0,
                     min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup, then a half cosine from lr to min_lr at max_steps,
    min_lr after it.  The cosine is computed in float32, in the JAX
    schedule's order: near max_steps 1 + cos cancels, and float64 there
    would differ from the reference by up to 1e-4 relative."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = float(step)
        if s <= warmup_steps and warmup_steps > 0:
            return lr * (s + 1.0) / (warmup_steps + 1.0)
        if s > max_steps:
            return min_lr
        frac = np.clip((f32(s) - f32(warmup_steps)) /
                       f32(max(max_steps - warmup_steps, 1)), f32(0), f32(1))
        mult = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * frac))
        return float(f32(lr - min_lr) * mult + f32(min_lr))

    return schedule


def constant_lr(lr: float) -> Callable[[int], float]:
    return lambda step: float(lr)


def sqrt_constant(lr: float, constant_steps: int, max_steps: int,
                  min_lr: float = 0.0) -> Callable[[int], float]:
    """An absolute 1/sqrt(constant_steps) plateau (not scaled by lr)
    through constant_steps, then lr until max_steps, then min_lr."""
    plateau = 1.0 / (constant_steps ** 0.5)

    def schedule(step: int) -> float:
        if step <= constant_steps:
            return plateau
        return min_lr if step > max_steps else float(lr)

    return schedule


def warmup_hold(lr: float, warmup_steps: int, hold_steps: int,
                max_steps: int, min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup (step+1)/(warmup+1), then lr until max_steps, then
    min_lr.  `hold_steps` is taken and changes nothing: the plain policy
    holds the base lr after the hold as during it, as the JAX one does."""

    def schedule(step: int) -> float:
        s = float(step)
        if s <= warmup_steps and warmup_steps > 0:
            return lr * (s + 1.0) / (warmup_steps + 1.0)
        return min_lr if s > max_steps else float(lr)

    return schedule


def _steps(conf: dict, key: str, max_steps: int) -> int:
    """`<key>_steps`, else int(`<key>_ratio` * max_steps), else 0."""
    steps = conf.get(f'{key}_steps')
    if steps is None:
        steps = int(conf.get(f'{key}_ratio', 0.0) * max_steps)
    return steps


def build_schedule(scheduler: str, scheduler_conf: dict,
                   lr: float) -> Callable[[int], float]:
    """From the train.yaml `scheduler` / `scheduler_conf` keys, with the
    JAX `build_schedule`'s names and defaults; another name raises
    ValueError, as there."""
    name = scheduler
    conf = dict(scheduler_conf or {})
    min_lr = conf.get('min_lr', 0.0)
    if name == 'warmuplr':
        return warmup_lr(lr, conf.get('warmup_steps', 25000))
    if name.lower() == 'noamholdannealing':
        max_steps = conf.get('max_steps', 100000)
        return noam_hold_annealing(lr, _steps(conf, 'warmup', max_steps),
                                   _steps(conf, 'hold', max_steps),
                                   max_steps, conf.get('decay_rate', 0.5),
                                   min_lr)
    if name == 'noam_annealing':
        return noam_annealing(lr, conf.get('d_model', 256),
                              conf.get('warmup_steps', 25000), min_lr)
    if name == 'cosine_annealing':
        return cosine_annealing(lr, conf.get('max_steps', 100000),
                                conf.get('warmup_steps', 0), min_lr)
    if name == 'constantlr':
        return constant_lr(lr)
    if name in ('sqrt_constant', 'SquareRootConstantPolicy'):
        max_steps = conf.get('max_steps', 100000)
        return sqrt_constant(lr, _steps(conf, 'constant', max_steps),
                             max_steps, min_lr)
    if name in ('warmup_hold', 'WarmupHoldPolicy'):
        max_steps = conf.get('max_steps', 100000)
        return warmup_hold(lr, _steps(conf, 'warmup', max_steps),
                           _steps(conf, 'hold', max_steps), max_steps,
                           min_lr)
    raise ValueError(f'unknown scheduler: {name}')
