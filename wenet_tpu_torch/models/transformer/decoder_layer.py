"""Transformer decoder layer, full-sequence forward.  Counterpart of
wenet_tpu/models/transformer/decoder_layer.py `DecoderLayer`."""

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.attention import (
    MultiHeadedAttention, MultiHeadedCrossAttention)
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    PositionwiseFeedForward)


class DecoderLayer(nn.Module):
    """Self-attention, cross-attention to the encoder, ReLU FFN; each a
    pre-norm residual block."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 norm_eps: float = 1e-5):
        super().__init__()
        self.self_attn = MultiHeadedAttention(attention_heads, size,
                                              self_attention_dropout_rate)
        self.src_attn = MultiHeadedCrossAttention(attention_heads, size,
                                                  src_attention_dropout_rate)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, dropout_rate)
        self.norm1 = nn.LayerNorm(size, eps=norm_eps)
        self.norm2 = nn.LayerNorm(size, eps=norm_eps)
        self.norm3 = nn.LayerNorm(size, eps=norm_eps)
        self.dropout = nn.Dropout(dropout_rate)

    def _residual(self, x, norm, fn):
        return x + self.dropout(fn(norm(x)))

    def forward(self, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                memory: torch.Tensor, memory_mask: torch.Tensor
                ) -> torch.Tensor:
        """tgt: (B, L, D); tgt_mask: (B, L, L); memory: (B|B/N, T, D);
        memory_mask: (B|B/N, 1, T)."""
        x = self._residual(tgt, self.norm1,
                           lambda y: self.self_attn(y, y, y, tgt_mask))
        x = self._residual(
            x, self.norm2,
            lambda y: self.src_attn(y, memory, memory, memory_mask))
        return self._residual(x, self.norm3, self.feed_forward)
