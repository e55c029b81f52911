"""Convolutional gating MLP (cgMLP), the convolutional branch of
Branchformer and E-Branchformer.  Counterpart of
wenet_tpu/models/branchformer/cgmlp.py."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.activations import get_activation


class ConvolutionalSpatialGatingUnit(nn.Module):
    """Split the channels in half (r, g); g goes through LayerNorm, a
    depthwise conv (causal: left context `lorder`, no right) and the gate
    activation, then gates r: r * g."""

    def __init__(self, size: int, kernel_size: int,
                 dropout_rate: float = 0.0,
                 use_linear_after_conv: bool = False,
                 gate_activation: str = 'identity', causal: bool = True):
        super().__init__()
        n = size // 2
        self.lorder = kernel_size - 1 if causal else 0
        self.norm = nn.LayerNorm(n, eps=1e-5)
        self.conv = nn.Conv1d(n, n, kernel_size, groups=n,
                              padding=0 if causal else kernel_size // 2)
        self.linear = nn.Linear(n, n) if use_linear_after_conv else None
        self.act = get_activation(gate_activation)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, T, size) -> ((B, T, size / 2), new cache).

        Causal: the gate half is left-padded in its raw space before the
        norm (the zero rows become LN(0) rows, as in the reference), or,
        with `cache` (B, lorder, size / 2), the raw gate frames before
        this chunk take the pad's place and the new cache is the last
        lorder raw frames.  Without `cache` the new cache is None."""
        x_r, x_g = x.chunk(2, dim=-1)
        new_cache = None
        if cache is not None:
            x_g = torch.cat([cache.to(x_g.dtype), x_g], dim=1)
            new_cache = x_g[:, x_g.shape[1] - self.lorder:]
        elif self.lorder > 0:
            x_g = F.pad(x_g, (0, 0, self.lorder, 0))
        x_g = self.conv(self.norm(x_g).transpose(1, 2)).transpose(1, 2)
        if self.linear is not None:
            x_g = self.linear(x_g)
        return self.dropout(x_r * self.act(x_g)), new_cache


class ConvolutionalGatingMLP(nn.Module):
    """channel_proj1 (Linear + GELU) -> CSGU -> channel_proj2."""

    def __init__(self, size: int, linear_units: int, kernel_size: int,
                 dropout_rate: float = 0.0,
                 use_linear_after_conv: bool = False,
                 gate_activation: str = 'identity', causal: bool = True):
        super().__init__()
        self.channel_proj1 = nn.Sequential(nn.Linear(size, linear_units),
                                           nn.GELU())
        self.csgu = ConvolutionalSpatialGatingUnit(
            linear_units, kernel_size, dropout_rate, use_linear_after_conv,
            gate_activation, causal)
        self.channel_proj2 = nn.Linear(linear_units // 2, size)

    @property
    def lorder(self) -> int:
        return self.csgu.lorder

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, T, size); cache: (B, lorder, linear_units / 2) or None.
        The pad mask is not applied (the JAX package ignores it too)."""
        h, new_cache = self.csgu(self.channel_proj1(x), cache)
        return self.channel_proj2(h), new_cache
