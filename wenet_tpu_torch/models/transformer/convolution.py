"""Conformer convolution module.  Counterpart of
wenet_tpu/models/transformer/convolution.py (full-sequence forward)."""

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


class ConvolutionModule(nn.Module):
    """pointwise conv -> GLU -> depthwise conv -> norm -> swish -> pointwise.

    Causal: the input is left-padded by kernel_size - 1 zeros BEFORE the
    first pointwise conv (its bias reaches the pad frames, as in the
    reference), and the depthwise conv runs unpadded."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 norm: str = 'batch_norm', causal: bool = False,
                 norm_eps: float = 1e-5):
        super().__init__()
        self.lorder = kernel_size - 1 if causal else 0
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, groups=channels,
            padding=0 if causal else kernel_size // 2)
        if norm == 'batch_norm':
            self.norm = nn.BatchNorm1d(channels, eps=norm_eps)
        elif norm == 'layer_norm':
            self.norm = nn.LayerNorm(channels, eps=norm_eps)
        else:
            raise NotImplementedError(f'conv norm {norm!r} is not ported')
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, C); mask_pad: (B, 1, T) bool valid -> (B, T, C)."""
        x = x.transpose(1, 2)  # (B, C, T)
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad, 0.0)
        if self.lorder > 0:
            x = F.pad(x, (self.lorder, 0))
        x = F.glu(self.pointwise_conv1(x), dim=1)
        x = self.depthwise_conv(x)
        if isinstance(self.norm, nn.LayerNorm):
            x = self.norm(x.transpose(1, 2)).transpose(1, 2)
        else:
            x = self.norm(x)
        x = self.pointwise_conv2(F.silu(x))
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad, 0.0)
        return x.transpose(1, 2)
