"""Sinusoidal positional encodings.  Counterpart of
wenet_tpu/models/transformer/embedding.py (absolute and rel-pos).

The encodings are computed for each call from the sequence length; no
position table is stored, so the state dict has no `pe` entry."""

import math
from typing import Tuple

import torch
from torch import nn


def sinusoidal_position_encoding(size: int, d_model: int,
                                 device=None) -> torch.Tensor:
    """Interleaved sin/cos encoding of positions [0, size) -> (1, size, d)."""
    pos = torch.arange(size, device=device, dtype=torch.float32)
    div = torch.exp(
        torch.arange(0, d_model, 2, device=device, dtype=torch.float32) *
        (-math.log(10000.0) / d_model))
    ang = pos[:, None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).reshape(1, size, d_model)


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + PE.  Returns (x, pos_emb)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.xscale = math.sqrt(d_model)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pos_emb = sinusoidal_position_encoding(x.shape[1], self.d_model,
                                               x.device).to(x.dtype)
        return self.dropout(x * self.xscale + pos_emb), self.dropout(pos_emb)


class RelPositionalEncoding(PositionalEncoding):
    """Transformer-XL style: scale x, return the PE separately."""

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pos_emb = sinusoidal_position_encoding(x.shape[1], self.d_model,
                                               x.device).to(x.dtype)
        return self.dropout(x * self.xscale), self.dropout(pos_emb)
