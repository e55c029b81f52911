"""Transformer decoder layer: the full-sequence forward and the one-token
step of the beam search.  Counterpart of
wenet_tpu/models/transformer/decoder_layer.py `DecoderLayer`."""

from typing import Optional

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.attention import (
    T_CACHE, MultiHeadedAttention, MultiHeadedCrossAttention)
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    PositionwiseFeedForward, get_activation)


class DecoderLayer(nn.Module):
    """Self-attention, cross-attention to the encoder, FFN; each a
    pre-norm residual block."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 norm_eps: float = 1e-5, activation_type: str = 'relu',
                 query_bias: bool = True, key_bias: bool = True,
                 value_bias: bool = True, src_query_bias: bool = True,
                 src_key_bias: bool = True, src_value_bias: bool = True,
                 lora_conf: Optional[dict] = None):
        super().__init__()
        self.self_attn = MultiHeadedAttention(
            attention_heads, size, self_attention_dropout_rate, query_bias,
            key_bias, value_bias, lora_conf)
        self.src_attn = MultiHeadedCrossAttention(
            attention_heads, size, src_attention_dropout_rate,
            src_query_bias, src_key_bias, src_value_bias, lora_conf)
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, dropout_rate, get_activation(activation_type))
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

    def precompute_cross_kv(self, memory: torch.Tensor) -> T_CACHE:
        """The encoder's projected (k, v), each (B, h, T, d)."""
        return self.src_attn.project_kv(memory, memory)

    def step(self, x: torch.Tensor, step: int, self_cache: T_CACHE,
             cross_kv: T_CACHE, memory_mask: Optional[torch.Tensor]
             ) -> torch.Tensor:
        """One token: x (R, 1, D) at position `step`.  The self cache
        (R, h, L_max, d) is written in place; cross_kv may hold B = R / N
        rows (queries are beam-expanded against it)."""
        x = x + self.self_attn.decode_step(self.norm1(x), self_cache, step)
        x = x + self.src_attn(self.norm2(x), None, None, memory_mask,
                              cache=cross_kv)
        return x + self.feed_forward(self.norm3(x))
