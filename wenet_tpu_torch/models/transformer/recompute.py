"""Activation recomputation: the layers of an encoder or decoder with
`gradient_checkpointing`.  Counterpart of the JAX package's `nn.remat`
of each layer (wenet_tpu/models/transformer/encoder.py:266-281,
decoder.py:99-100).

`recompute(layer, args, generator)` runs `layer(*args)` under
`torch.utils.checkpoint` (non-reentrant): the forward keeps the layer's
inputs only, and the backward runs the layer again to get its
activations.  The recompute must draw what the forward drew:
- torch's default CPU and CUDA generators (nn.Dropout) are restored by
  the checkpoint itself (`preserve_rng_state`);
- the host `generator` the train step passes down (the rel-pos
  attention's dropout seeds, `attention.py`) is set back to where the
  layer's forward found it, and after the recompute to where the
  backward found it, so that the step leaves it where a step without
  recomputation does;
- a BatchNorm's running statistics are updated by the forward only: the
  recompute's update is undone, as flax's remat keeps one update."""

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_STATS = ('running_mean', 'running_var', 'num_batches_tracked')


def _running_stats(layer: nn.Module) -> list:
    return [getattr(m, k) for m in layer.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats for k in _STATS]


@contextlib.contextmanager
def _as_in_forward(generator: Optional[torch.Generator], start, stats):
    """The recompute's context: `generator` at `start` (the state the
    forward began from) and the running statistics kept, both put back
    on exit."""
    now = None if generator is None else generator.get_state()
    kept = [t.clone() for t in stats]
    if generator is not None:
        generator.set_state(start)
    try:
        yield
    finally:
        with torch.no_grad():
            for t, k in zip(stats, kept):
                t.copy_(k)
        if generator is not None:
            generator.set_state(now)


def recompute(layer: nn.Module, args: Sequence,
              generator: Optional[torch.Generator] = None):
    """layer(*args), its activations recomputed in the backward; the
    plain call when autograd does not record or the layer is in eval
    mode.  `generator`: the host generator the layer draws from (one of
    `args`), or None."""
    if not (torch.is_grad_enabled() and layer.training):
        return layer(*args)
    start = None if generator is None else generator.get_state()
    stats = _running_stats(layer)
    return checkpoint(
        layer, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _as_in_forward(generator, start, stats)))
