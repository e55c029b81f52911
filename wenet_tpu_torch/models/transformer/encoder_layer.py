"""Encoder layers.  Counterpart of
wenet_tpu/models/transformer/encoder_layer.py `TransformerEncoderLayer`
and `ConformerEncoderLayer`."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.attention import (
    T_CACHE, RelPositionMultiHeadedAttention, make_self_attention)
from wenet_tpu_torch.models.transformer.convolution import ConvolutionModule
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    PositionwiseFeedForward, make_mlp)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm self-attention + FFN, each a residual block (whisper's
    encoder block, and the conv2d transformer's)."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, norm_eps: float = 1e-5,
                 activation_type: str = 'relu', query_bias: bool = True,
                 key_bias: bool = True, value_bias: bool = True,
                 lora_conf: Optional[dict] = None,
                 selfattention_layer_type: str = 'selfattn',
                 mlp_type: str = 'position_wise_feed_forward'):
        super().__init__()
        self.self_attn = make_self_attention(
            selfattention_layer_type, attention_heads, size,
            attention_dropout_rate, lora_conf, query_bias=query_bias,
            key_bias=key_bias, value_bias=value_bias)
        self.feed_forward = make_mlp(mlp_type, size, linear_units,
                                     dropout_rate, activation_type)
        self.norm1 = nn.LayerNorm(size, eps=norm_eps)
        self.norm2 = nn.LayerNorm(size, eps=norm_eps)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: Optional[torch.Tensor] = None,
                mask_pad: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                att_cache: Optional[T_CACHE] = None,
                cnn_cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[T_CACHE], None]:
        """x: (B, T, D); mask: (B, T|1, T2) attention mask -> (x, new att
        cache, None), the call of every encoder layer (see
        `ConformerEncoderLayer`); there is no conv, so no cnn cache."""
        y, new_att = self.self_attn.forward_self(self.norm1(x), mask,
                                                 pos_emb, generator,
                                                 att_cache)
        x = x + self.dropout(y)
        return x + self.dropout(self.feed_forward(self.norm2(x))), \
            new_att, None


class ConformerEncoderLayer(nn.Module):
    """Macaron FFN (x 1/2) + rel-pos MHSA + conv module + FFN (x 1/2),
    each a pre-norm residual block, then a final norm.  Swish activation."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, norm_eps: float = 1e-5,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = 'batch_norm',
                 conv_norm_eps: float = 1e-5,
                 lora_conf: Optional[dict] = None):
        super().__init__()
        self.self_attn = RelPositionMultiHeadedAttention(
            attention_heads, size, attention_dropout_rate, lora_conf)
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
                generator: Optional[torch.Generator] = None,
                att_cache: Optional[T_CACHE] = None,
                cnn_cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[T_CACHE],
                           Optional[torch.Tensor]]:
        """x: (B, T, D); mask: (B, T|1, T2) attention mask; mask_pad:
        (B, 1, T) valid frames for the conv module; generator: the host
        generator for the attention-dropout seeds (training).

        Returns (x, new att cache, new cnn cache).  A streaming chunk step
        passes `att_cache` (k, v) of (B, h, cache_t, d) and, with a causal
        conv module, `cnn_cache` (B, lorder, D); it gets back (k, v) with
        cache_t + T keys and the new cnn cache.  A cache not passed comes
        back as None."""
        x = self._residual(x, self.norm_ff_macaron,
                           self.feed_forward_macaron, 0.5)
        y = self.norm_mha(x)
        y, new_att = self.self_attn(y, y, y, mask, pos_emb, generator,
                                    att_cache)
        x = x + self.dropout(y)
        y, new_cnn = self.conv_module(self.norm_conv(x), mask_pad, cnn_cache)
        x = x + self.dropout(y)
        x = self._residual(x, self.norm_ff, self.feed_forward, 0.5)
        return self.norm_final(x), new_att, new_cnn
