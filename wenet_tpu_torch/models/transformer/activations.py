"""Activation registry.  Counterpart of
wenet_tpu/models/transformer/activations.py (the reference's
WENET_ACTIVATION_CLASSES), with `identity`, which E-Branchformer's
cgMLP gate names (the JAX package special-cases it in cgmlp.py)."""

from typing import Callable

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    'hardtanh': lambda x: torch.clamp(x, -1.0, 1.0),
    'tanh': torch.tanh,
    'relu': F.relu,
    'selu': F.selu,
    'swish': F.silu,
    'silu': F.silu,
    'gelu': F.gelu,  # the exact erf form, as torch.nn.GELU's default
    'identity': lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise NotImplementedError(f'activation_type={name!r} is not ported')
    return ACTIVATIONS[name]
