"""Learning-rate schedules as pure `step -> lr` functions.  Counterpart of
wenet_tpu/utils/scheduler.py for the schedule the example configs use.

The train step sets each param group's lr to `schedule(update)` right
before `optimizer.step()`, `update` counting the optimizer updates made
before this one, so the first update uses `schedule(0)` as optax does
(`LambdaLR` would be one step off)."""

from typing import Callable


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


def build_schedule(scheduler: str, scheduler_conf: dict,
                   lr: float) -> Callable[[int], float]:
    """From the train.yaml `scheduler` / `scheduler_conf` keys."""
    conf = dict(scheduler_conf or {})
    if scheduler == 'warmuplr':
        return warmup_lr(lr, conf.get('warmup_steps', 25000))
    raise NotImplementedError(f'scheduler {scheduler!r} is not ported')
