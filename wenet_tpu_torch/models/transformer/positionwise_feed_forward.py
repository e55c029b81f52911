"""Positionwise FFN.  Counterpart of
wenet_tpu/models/transformer/positionwise_feed_forward.py
`PositionwiseFeedForward`."""

from typing import Callable

import torch
from torch import nn
import torch.nn.functional as F


# the activations the ported configs name (gelu is the exact erf form)
ACTIVATIONS = {'relu': F.relu, 'gelu': F.gelu, 'swish': F.silu}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise NotImplementedError(f'activation_type={name!r} is not ported')
    return ACTIVATIONS[name]


class PositionwiseFeedForward(nn.Module):
    """w_2(dropout(act(w_1(x))))."""

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu):
        super().__init__()
        self.w_1 = nn.Linear(idim, hidden_units)
        self.activation = activation
        self.dropout = nn.Dropout(dropout_rate)
        self.w_2 = nn.Linear(hidden_units, idim)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(self.activation(self.w_1(xs))))
