"""E-Branchformer encoder: macaron FFNs around self-attention and cgMLP
in parallel, merged through a depthwise conv.  Counterpart of
wenet_tpu/models/e_branchformer/encoder.py."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.branchformer.cgmlp import ConvolutionalGatingMLP
from wenet_tpu_torch.models.transformer.attention import (T_CACHE,
                                                          make_self_attention)
from wenet_tpu_torch.models.transformer.encoder import BaseEncoder
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    make_mlp)


class EBranchformerEncoderLayer(nn.Module):
    """[x + ½·FFN] -> x + merge_proj(c + dwconv(c)), c = [attn | cgmlp]
    -> [x + ½·FFN] -> norm_final."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 attention_dropout_rate: float = 0.0,
                 selfattention_layer_type: str = 'rel_selfattn',
                 cgmlp_linear_units: int = 2048, cgmlp_conv_kernel: int = 31,
                 use_linear_after_conv: bool = False,
                 gate_activation: str = 'identity', causal: bool = False,
                 dropout_rate: float = 0.1, merge_conv_kernel: int = 3,
                 use_ffn: bool = True, macaron_style: bool = True,
                 activation_type: str = 'swish',
                 mlp_type: str = 'position_wise_feed_forward',
                 mlp_bias: bool = True):
        super().__init__()
        self.attn = make_self_attention(selfattention_layer_type,
                                        attention_heads, size,
                                        attention_dropout_rate)
        self.cgmlp = ConvolutionalGatingMLP(
            size, cgmlp_linear_units, cgmlp_conv_kernel, dropout_rate,
            use_linear_after_conv, gate_activation, causal)
        self.use_ffn = use_ffn
        self.macaron = use_ffn and macaron_style
        self.ff_scale = 0.5 if macaron_style else 1.0
        if use_ffn:
            self.feed_forward = make_mlp(mlp_type, size, linear_units,
                                         dropout_rate, activation_type,
                                         mlp_bias)
            self.norm_ff = nn.LayerNorm(size, eps=1e-5)
            if macaron_style:
                self.feed_forward_macaron = make_mlp(
                    mlp_type, size, linear_units, dropout_rate,
                    activation_type, mlp_bias)
                self.norm_ff_macaron = nn.LayerNorm(size, eps=1e-5)
        self.norm_mha = nn.LayerNorm(size, eps=1e-5)
        self.norm_mlp = nn.LayerNorm(size, eps=1e-5)
        self.norm_final = nn.LayerNorm(size, eps=1e-5)
        # the merge conv is zero-padded on every call, in a chunk step
        # too: neither the reference nor the JAX package caches it
        self.merge_lorder = merge_conv_kernel - 1 if causal else 0
        self.depthwise_conv_fusion = nn.Conv1d(
            2 * size, 2 * size, merge_conv_kernel, groups=2 * size,
            padding=0 if causal else merge_conv_kernel // 2)
        self.merge_proj = nn.Linear(2 * size, size)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: Optional[torch.Tensor] = None,
                mask_pad: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                att_cache: Optional[T_CACHE] = None,
                cnn_cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[T_CACHE],
                           Optional[torch.Tensor]]:
        """The encoder layers' call (see `BaseEncoder`); cnn_cache is the
        cgMLP conv's (B, lorder, cgmlp_linear_units / 2)."""
        if self.macaron:
            x = x + self.ff_scale * self.dropout(
                self.feed_forward_macaron(self.norm_ff_macaron(x)))
        x1, new_att = self.attn.forward_self(self.norm_mha(x), mask,
                                             pos_emb, generator, att_cache)
        x2, new_cnn = self.cgmlp(self.norm_mlp(x), cnn_cache)
        x_concat = torch.cat([self.dropout(x1), self.dropout(x2)], dim=-1)
        x_tmp = x_concat.transpose(1, 2)
        if self.merge_lorder > 0:
            x_tmp = F.pad(x_tmp, (self.merge_lorder, 0))
        x_tmp = self.depthwise_conv_fusion(x_tmp).transpose(1, 2)
        x = x + self.dropout(self.merge_proj(x_concat + x_tmp))
        if self.use_ffn:
            x = x + self.ff_scale * self.dropout(
                self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x), new_att, new_cnn


class EBranchformerEncoder(BaseEncoder):
    """conv2d x4 front end, rel-pos encoding and E-Branchformer layers.
    `cmvn_norm_var`, `final_norm` and the layer options (`LAYER_OPTIONS`)
    are the JAX `BaseEncoder`'s fields, as for Branchformer; the FFNs
    also read `mlp_type` and `mlp_bias` (an MoE FFN with the JAX
    module's default experts, 8 of which 2 are active, as the JAX layer
    passes neither count)."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 12, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = 'conv2d',
                 pos_enc_layer_type: str = 'rel_pos',
                 selfattention_layer_type: str = 'rel_selfattn',
                 activation_type: str = 'swish',
                 cgmlp_linear_units: int = 2048, cgmlp_conv_kernel: int = 31,
                 use_linear_after_conv: bool = False,
                 gate_activation: str = 'identity',
                 merge_conv_kernel: int = 3, use_ffn: bool = True,
                 macaron_style: bool = True, causal: bool = False,
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 static_chunk_size: int = 0, use_cmvn: bool = False,
                 norm_eps: float = 1e-5, cmvn_norm_var: bool = True,
                 final_norm: bool = True, **layer_options):
        super().__init__(input_size, output_size, attention_heads,
                         dropout_rate, positional_dropout_rate, input_layer,
                         pos_enc_layer_type, use_dynamic_chunk,
                         use_dynamic_left_chunk, static_chunk_size, use_cmvn,
                         norm_eps, cmvn_norm_var, final_norm,
                         **layer_options)
        options = self.layer_options
        self._lorder = cgmlp_conv_kernel - 1 if causal else 0
        self._cnn_channels = cgmlp_linear_units // 2
        self.encoders.extend(
            EBranchformerEncoderLayer(
                output_size, attention_heads, linear_units,
                attention_dropout_rate, selfattention_layer_type,
                cgmlp_linear_units, cgmlp_conv_kernel, use_linear_after_conv,
                gate_activation, causal, dropout_rate, merge_conv_kernel,
                use_ffn, macaron_style, activation_type,
                options['mlp_type'], options['mlp_bias'])
            for _ in range(num_blocks))

    @property
    def cnn_lorder(self) -> int:
        return self._lorder

    @property
    def cnn_cache_channels(self) -> int:
        return self._cnn_channels
