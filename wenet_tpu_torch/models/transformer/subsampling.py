"""Conv2d x4 subsampling front end.  Counterpart of
wenet_tpu/models/transformer/subsampling.py `Conv2dSubsampling4`.

The convs run NCHW; the (C, F) flatten is channel-major, the order the
JAX package reproduces from its NHWC layout, so converted weights of the
following Linear line up."""

from typing import Tuple

import torch
from torch import nn


class Conv2dSubsampling4(nn.Module):
    """Two stride-2 3x3 convs -> 1/4 length."""
    subsampling_rate = 4
    right_context = 6

    def __init__(self, idim: int, odim: int, dropout_rate: float,
                 pos_enc: nn.Module):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(1, odim, 3, 2), nn.ReLU(),
                                  nn.Conv2d(odim, odim, 3, 2), nn.ReLU())
        self.out = nn.Sequential(
            nn.Linear(odim * (((idim - 1) // 2 - 1) // 2), odim))
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, F); x_mask: (B, 1, T) -> (x (B, T', D), pos_emb
        (1, T', D), mask (B, 1, T'))."""
        x = self.conv(x.unsqueeze(1))  # (B, C, T', F')
        b, c, t, f = x.shape
        x = self.out(x.transpose(1, 2).reshape(b, t, c * f))
        x, pos_emb = self.pos_enc(x)
        return x, pos_emb, x_mask[:, :, 2::2][:, :, 2::2]
