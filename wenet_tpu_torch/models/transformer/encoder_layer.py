"""Encoder layers.  Counterpart of
wenet_tpu/models/transformer/encoder_layer.py `TransformerEncoderLayer`
and `ConformerEncoderLayer`: pre-norm (`normalize_before`) or post-norm
residual blocks, LayerNorm or RMSNorm (`layer_norm_type`), any
`ATTENTION_CLASSES` self-attention and any `MLP_CLASSES` FFN."""

from typing import Optional, Tuple

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.attention import (
    T_CACHE, make_self_attention)
from wenet_tpu_torch.models.transformer.convolution import ConvolutionModule
from wenet_tpu_torch.models.transformer.norm import get_norm
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    make_mlp)


# The options every encoder and decoder layer takes, at the JAX layers'
# defaults.  The encoders and decoders take them by name and pass them on
# to each layer as `**layer_options`.
LAYER_OPTIONS = {'layer_norm_type': 'layer_norm', 'normalize_before': True,
                 'mlp_type': 'position_wise_feed_forward', 'mlp_bias': True,
                 'n_expert': 8, 'n_expert_activated': 2, 'query_bias': True,
                 'key_bias': True, 'value_bias': True, 'n_kv_head': None,
                 'head_dim': None}


def layer_options(options: dict) -> dict:
    """`LAYER_OPTIONS` with `options` over them; an unknown name raises."""
    unknown = set(options) - set(LAYER_OPTIONS)
    if unknown:
        raise TypeError(f'unknown layer options {sorted(unknown)}')
    return {**LAYER_OPTIONS, **options}


class ResidualLayer(nn.Module):
    """What every layer shares: the residual blocks (the norm type and
    order, the dropout on each block's output), and its norms,
    attentions and FFNs built from the layer options."""

    def _setup(self, size, linear_units, norm_eps, dropout_rate,
               options: dict):
        self._options = layer_options(options)
        self._size, self._units = size, linear_units
        self._eps, self._dropout_rate = norm_eps, dropout_rate
        self.normalize_before = self._options['normalize_before']
        self.dropout = nn.Dropout(dropout_rate)

    def _norm(self) -> nn.Module:
        return get_norm(self._options['layer_norm_type'], self._size,
                        self._eps)

    def _attention(self, kind, heads, dropout_rate, lora_conf) -> nn.Module:
        """`kind` self-attention of `n_kv_head` key/value heads of
        `head_dim`."""
        o = self._options
        return make_self_attention(
            kind, heads, self._size, dropout_rate, lora_conf,
            o['n_kv_head'], o['head_dim'], query_bias=o['query_bias'],
            key_bias=o['key_bias'], value_bias=o['value_bias'])

    def _mlp(self, activation_type) -> nn.Module:
        o = self._options
        return make_mlp(o['mlp_type'], self._size, self._units,
                        self._dropout_rate, activation_type, o['mlp_bias'],
                        o['n_expert'], o['n_expert_activated'])

    def _block(self, x, norm, fn, scale=1.0):
        """x + scale * dropout(fn(norm(x))) pre-norm, norm(x + scale *
        dropout(fn(x))) post-norm; fn -> (y, extra) -> (x, extra)."""
        y, extra = fn(norm(x) if self.normalize_before else x)
        x = x + scale * self.dropout(y)
        return (x if self.normalize_before else norm(x)), extra


def _no_extra(fn):
    return lambda x: (fn(x), None)


class TransformerEncoderLayer(ResidualLayer):
    """Self-attention + FFN, each a residual block (whisper's encoder
    block, the conv2d transformers', the RoPE and Shaw transformers)."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, norm_eps: float = 1e-5,
                 activation_type: str = 'relu',
                 lora_conf: Optional[dict] = None,
                 selfattention_layer_type: str = 'selfattn',
                 **layer_options):
        super().__init__()
        self._setup(size, linear_units, norm_eps, dropout_rate,
                    layer_options)
        self.self_attn = self._attention(
            selfattention_layer_type, attention_heads,
            attention_dropout_rate, lora_conf)
        self.feed_forward = self._mlp(activation_type)
        self.norm1 = self._norm()
        self.norm2 = self._norm()

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
        x, new_att = self._block(x, self.norm1, lambda y: (
            self.self_attn.forward_self(y, mask, pos_emb, generator,
                                        att_cache)))
        x, _ = self._block(x, self.norm2, _no_extra(self.feed_forward))
        return x, new_att, None


class ConformerEncoderLayer(ResidualLayer):
    """Macaron FFN (x 1/2; `macaron_style`) + MHSA (rel-pos unless the
    config names another) + conv module (`use_cnn_module`) + FFN (x 1/2
    with the macaron FFN, else x 1), each a residual block, then a final
    norm where there is a conv module, as in the JAX layer.  Swish unless
    `activation_type` names another, in the FFNs and the conv module."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0, norm_eps: float = 1e-5,
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = 'batch_norm',
                 conv_norm_eps: float = 1e-5,
                 lora_conf: Optional[dict] = None,
                 selfattention_layer_type: str = 'rel_selfattn',
                 activation_type: str = 'swish', macaron_style: bool = True,
                 use_cnn_module: bool = True, conv_bias: bool = True,
                 conv_inner_factor: int = 2, **layer_options):
        super().__init__()
        self._setup(size, linear_units, norm_eps, dropout_rate,
                    layer_options)
        self.self_attn = self._attention(
            selfattention_layer_type, attention_heads,
            attention_dropout_rate, lora_conf)
        self.ff_scale = 0.5 if macaron_style else 1.0
        # built in the order of the flagship's modules, whose weights a
        # generator draws in this order
        self.feed_forward = self._mlp(activation_type)
        self.feed_forward_macaron = (self._mlp(activation_type)
                                     if macaron_style else None)
        self.conv_module = (ConvolutionModule(
            size, cnn_module_kernel, cnn_module_norm, causal, conv_norm_eps,
            activation_type, conv_bias, conv_inner_factor)
            if use_cnn_module else None)
        self.norm_ff_macaron = self._norm() if macaron_style else None
        self.norm_mha = self._norm()
        self.norm_conv = self._norm() if use_cnn_module else None
        self.norm_ff = self._norm()
        self.norm_final = self._norm() if use_cnn_module else None

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
        passes `att_cache` (k, v) of (B, h_kv, cache_t, d) and, with a
        causal conv module, `cnn_cache` (B, lorder, D); it gets back (k,
        v) with cache_t + T keys and the new cnn cache.  A cache not
        passed, or a layer without a conv module, gives None."""
        if self.feed_forward_macaron is not None:
            x, _ = self._block(x, self.norm_ff_macaron,
                               _no_extra(self.feed_forward_macaron),
                               self.ff_scale)
        x, new_att = self._block(x, self.norm_mha, lambda y: (
            self.self_attn.forward_self(y, mask, pos_emb, generator,
                                        att_cache)))
        new_cnn = None
        if self.conv_module is not None:
            x, new_cnn = self._block(x, self.norm_conv, lambda y: (
                self.conv_module(y, mask_pad, cnn_cache)))
        x, _ = self._block(x, self.norm_ff, _no_extra(self.feed_forward),
                           self.ff_scale)
        return (x if self.conv_module is None else self.norm_final(x),
                new_att, new_cnn)
