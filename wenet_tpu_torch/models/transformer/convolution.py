"""Conformer convolution module.  Counterpart of
wenet_tpu/models/transformer/convolution.py, with the causal left-context
cache of the streaming chunk step."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.activations import get_activation
from wenet_tpu_torch.models.transformer.norm import channel_norm, get_norm


class ConvolutionModule(nn.Module):
    """pointwise conv -> GLU -> depthwise conv -> norm -> activation
    (`activation`, swish by default) -> pointwise.  The GLU's input is
    `conv_inner_factor` x channels wide and the depthwise conv half that;
    `bias` puts a bias on the three convs.  The norm is `batch_norm`,
    `layer_norm`, or for any other name RMSNorm, as the JAX module reads
    it.

    Causal: the input is left-padded by kernel_size - 1 zeros BEFORE the
    first pointwise conv (its bias reaches the pad frames, as in the
    reference), and the depthwise conv runs unpadded."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 norm: str = 'batch_norm', causal: bool = False,
                 norm_eps: float = 1e-5, activation: str = 'swish',
                 bias: bool = True, conv_inner_factor: int = 2):
        super().__init__()
        inner = conv_inner_factor * channels
        self.lorder = kernel_size - 1 if causal else 0
        self.activation = get_activation(activation)
        self.pointwise_conv1 = nn.Conv1d(channels, inner, 1, bias=bias)
        self.depthwise_conv = nn.Conv1d(
            inner // 2, inner // 2, kernel_size, groups=inner // 2,
            padding=0 if causal else kernel_size // 2, bias=bias)
        self.norm = get_norm(
            norm if norm in ('batch_norm', 'layer_norm') else 'rms_norm',
            inner // 2, norm_eps)
        self.pointwise_conv2 = nn.Conv1d(inner // 2, channels, 1, bias=bias)

    def forward(self, x: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, T, C); mask_pad: (B, 1, T) bool valid -> (out (B, T, C),
        new cache).

        With `cache` (B, lorder, C), a causal streaming chunk step: the
        cache (the masked inputs before `pointwise_conv1` of the frames
        before this chunk; zeros before the first) takes the place of the
        left zero pad, and the new cache is the last lorder frames of
        [cache | x].  Without, the new cache is None."""
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        new_cache = None
        if cache is not None:
            x = torch.cat([cache.to(x.dtype), x], dim=1)
            new_cache = x[:, x.shape[1] - self.lorder:]
        elif self.lorder > 0:
            x = F.pad(x, (0, 0, self.lorder, 0))
        x = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        x = channel_norm(self.norm, self.depthwise_conv(x))
        x = self.pointwise_conv2(self.activation(x))
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad, 0.0)
        return x.transpose(1, 2), new_cache
