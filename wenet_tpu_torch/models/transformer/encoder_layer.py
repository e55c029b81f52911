"""Conformer encoder layer.  Counterpart of
wenet_tpu/models/transformer/encoder_layer.py `ConformerEncoderLayer`."""

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.attention import (
    RelPositionMultiHeadedAttention)
from wenet_tpu_torch.models.transformer.convolution import ConvolutionModule
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    PositionwiseFeedForward)


class ConformerEncoderLayer(nn.Module):
    """Macaron FFN (x 1/2) + rel-pos MHSA + conv module + FFN (x 1/2),
    each a pre-norm residual block, then a final norm.  Swish activation."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, norm_eps: float = 1e-5,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = 'batch_norm',
                 conv_norm_eps: float = 1e-5):
        super().__init__()
        self.self_attn = RelPositionMultiHeadedAttention(
            attention_heads, size, attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, dropout_rate, F.silu)
        self.feed_forward_macaron = PositionwiseFeedForward(
            size, linear_units, dropout_rate, F.silu)
        self.conv_module = ConvolutionModule(
            size, cnn_module_kernel, cnn_module_norm, causal, conv_norm_eps)
        self.norm_ff_macaron = nn.LayerNorm(size, eps=norm_eps)
        self.norm_mha = nn.LayerNorm(size, eps=norm_eps)
        self.norm_conv = nn.LayerNorm(size, eps=norm_eps)
        self.norm_ff = nn.LayerNorm(size, eps=norm_eps)
        self.norm_final = nn.LayerNorm(size, eps=norm_eps)
        self.dropout = nn.Dropout(dropout_rate)

    def _residual(self, x, norm, fn, scale=1.0):
        return x + scale * self.dropout(fn(norm(x)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T, D); mask: (B, T|1, T) attention mask; mask_pad:
        (B, 1, T) valid frames for the conv module; generator: the host
        generator for the attention-dropout seeds (training)."""
        x = self._residual(x, self.norm_ff_macaron,
                           self.feed_forward_macaron, 0.5)
        x = self._residual(
            x, self.norm_mha,
            lambda y: self.self_attn(y, y, y, mask, pos_emb, generator))
        x = self._residual(x, self.norm_conv,
                           lambda y: self.conv_module(y, mask_pad))
        x = self._residual(x, self.norm_ff, self.feed_forward, 0.5)
        return self.norm_final(x)
