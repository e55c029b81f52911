"""Transformer decoder layer: the full-sequence forward and the one-token
step of the beam search.  Counterpart of
wenet_tpu/models/transformer/decoder_layer.py `DecoderLayer`."""

from typing import Optional

import torch

from wenet_tpu_torch.models.transformer.attention import (
    T_CACHE, MultiHeadedCrossAttention)
from wenet_tpu_torch.models.transformer.encoder_layer import ResidualLayer


class DecoderLayer(ResidualLayer):
    """Self-attention, cross-attention to the encoder (unless
    `src_attention` is False: then neither it nor its norm), FFN; each a
    residual block of the encoder layers' kind (`layer_options`: the
    norm type and order, the FFN, `n_kv_head` key/value heads of
    `head_dim`)."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 norm_eps: float = 1e-5, activation_type: str = 'relu',
                 src_query_bias: bool = True, src_key_bias: bool = True,
                 src_value_bias: bool = True,
                 lora_conf: Optional[dict] = None,
                 src_attention: bool = True, **layer_options):
        super().__init__()
        self._setup(size, linear_units, norm_eps, dropout_rate,
                    layer_options)
        self.self_attn = self._attention(
            'selfattn', attention_heads, self_attention_dropout_rate,
            lora_conf)
        self.src_attn = (MultiHeadedCrossAttention(
            attention_heads, size, src_attention_dropout_rate,
            src_query_bias, src_key_bias, src_value_bias, lora_conf,
            self._options['n_kv_head'], self._options['head_dim'])
            if src_attention else None)
        self.feed_forward = self._mlp(activation_type)
        self.norm1 = self._norm()
        self.norm2 = self._norm() if src_attention else None
        self.norm3 = self._norm()

    def _residual(self, x, norm, fn):
        return self._block(x, norm, lambda y: (fn(y), None))[0]

    def forward(self, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                memory: torch.Tensor, memory_mask: torch.Tensor
                ) -> torch.Tensor:
        """tgt: (B, L, D); tgt_mask: (B, L, L); memory: (B|B/N, T, D);
        memory_mask: (B|B/N, 1, T)."""
        x = self._residual(tgt, self.norm1,
                           lambda y: self.self_attn(y, y, y, tgt_mask))
        if self.src_attn is not None:
            x = self._residual(
                x, self.norm2,
                lambda y: self.src_attn(y, memory, memory, memory_mask))
        return self._residual(x, self.norm3, self.feed_forward)

    def precompute_cross_kv(self, memory: torch.Tensor
                            ) -> Optional[T_CACHE]:
        """The encoder's projected (k, v), each (B, h_kv, T, d); None
        without cross attention."""
        if self.src_attn is None:
            return None
        return self.src_attn.project_kv(memory, memory)

    def step(self, x: torch.Tensor, step: int, self_cache: T_CACHE,
             cross_kv: Optional[T_CACHE],
             memory_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """One token: x (R, 1, D) at position `step`.  The self cache
        (R, h_kv, L_max, d) is written in place; cross_kv may hold B = R / N
        rows (queries are beam-expanded against it).  The beam search runs
        in eval mode: no dropout."""
        x = self._residual(x, self.norm1, lambda y: self.self_attn.decode_step(
            y, self_cache, step))
        if self.src_attn is not None:
            x = self._residual(x, self.norm2, lambda y: self.src_attn(
                y, None, None, memory_mask, cache=cross_kv))
        return self._residual(x, self.norm3, self.feed_forward)
