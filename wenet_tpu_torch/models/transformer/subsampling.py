"""Subsampling front ends.  Counterpart of
wenet_tpu/models/transformer/subsampling.py `Conv2dSubsampling4` and
`Conv1dSubsampling2` (whisper).

The convs run NCHW; the (C, F) flatten is channel-major, the order the
JAX package reproduces from its NHWC layout, so converted weights of the
following Linear line up."""

from typing import Tuple, Union

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

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                offset: Union[int, torch.Tensor] = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, F); x_mask: (B, 1, T); offset: the position of the
        first output frame, or a (B,) tensor of them -> (x (B, T', D),
        pos_emb (1|B, T', D), mask (B, 1, T'))."""
        x = self.conv(x.unsqueeze(1))  # (B, C, T', F')
        b, c, t, f = x.shape
        x = self.out(x.transpose(1, 2).reshape(b, t, c * f))
        x, pos_emb = self.pos_enc(x, offset)
        return x, pos_emb, x_mask[:, :, 2::2][:, :, 2::2]

    def position_encoding(self, offset: Union[int, torch.Tensor], size: int,
                          device=None) -> torch.Tensor:
        return self.pos_enc.position_encoding(offset, size, device)


class Conv1dSubsampling2(nn.Module):
    """Whisper's front end: conv k3, then conv k3 stride 2, each followed
    by the exact GELU -> 1/2 length."""
    subsampling_rate = 2
    right_context = 4

    def __init__(self, idim: int, odim: int, dropout_rate: float,
                 pos_enc: nn.Module):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv1d(idim, odim, 3, padding=1), nn.GELU(),
            nn.Conv1d(odim, odim, 3, stride=2, padding=1), nn.GELU())
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, F); x_mask: (B, 1, T) -> (x (B, T', D), pos_emb
        (1, T', D), mask (B, 1, T')), T' = ceil(T / 2)."""
        time = x.shape[1]
        x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        x, pos_emb = self.pos_enc(x)
        return x, pos_emb, x_mask[:, :, (time + 1) % 2::2]
