"""Positionwise FFN.  Counterpart of
wenet_tpu/models/transformer/positionwise_feed_forward.py
`PositionwiseFeedForward` and its `MLP_CLASSES` (the MoE and gated FFNs
are not ported: ROADMAP.md, queue 1 item 8)."""

from typing import Callable

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.activations import (  # noqa: F401
    get_activation)


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


MLP_CLASSES = {'position_wise_feed_forward': PositionwiseFeedForward}


def make_mlp(mlp_type: str, idim: int, hidden_units: int,
             dropout_rate: float, activation_type: str) -> nn.Module:
    if mlp_type not in MLP_CLASSES:
        raise NotImplementedError(f'mlp_type={mlp_type!r} is not ported '
                                  '(ROADMAP.md, queue 1 item 8)')
    return MLP_CLASSES[mlp_type](idim, hidden_units, dropout_rate,
                                 get_activation(activation_type))
