"""Branchformer encoder: self-attention and cgMLP as parallel branches,
merged by concatenation, a learned or a fixed average.  Counterpart of
wenet_tpu/models/branchformer/encoder.py."""

from typing import Optional, Tuple

import torch
from torch import nn

from wenet_tpu_torch.models.branchformer.cgmlp import ConvolutionalGatingMLP
from wenet_tpu_torch.models.transformer.attention import (T_CACHE,
                                                          make_self_attention)
from wenet_tpu_torch.models.transformer.encoder import BaseEncoder


class BranchformerEncoderLayer(nn.Module):
    """x + merge(attn(norm_mha(x)), cgmlp(norm_mlp(x))), then norm_final.
    `fixed_ave` at a cgmlp weight of 0 or 1 keeps one branch and still
    projects it; any other single-branch layer merges by identity."""

    def __init__(self, size: int, attention_heads: int,
                 attention_dropout_rate: float = 0.0,
                 selfattention_layer_type: str = 'rel_selfattn',
                 use_attn: bool = True, use_cgmlp: bool = True,
                 cgmlp_linear_units: int = 2048, cgmlp_conv_kernel: int = 31,
                 use_linear_after_conv: bool = False,
                 gate_activation: str = 'identity', causal: bool = False,
                 dropout_rate: float = 0.1, merge_method: str = 'concat',
                 cgmlp_weight: float = 0.5,
                 attn_branch_drop_rate: float = 0.0,
                 stochastic_depth_rate: float = 0.0):
        super().__init__()
        if merge_method not in ('concat', 'learned_ave', 'fixed_ave'):
            raise ValueError(f'merge_method {merge_method!r}')
        fixed = merge_method == 'fixed_ave'
        self.use_attn = use_attn and not (fixed and cgmlp_weight == 1.0)
        self.use_cgmlp = use_cgmlp and not (fixed and cgmlp_weight == 0.0)
        self.size = size
        self.merge_method = merge_method
        self.cgmlp_weight = cgmlp_weight
        self.attn_branch_drop_rate = attn_branch_drop_rate
        self.stochastic_depth_rate = stochastic_depth_rate
        if self.use_attn:
            self.attn = make_self_attention(selfattention_layer_type,
                                            attention_heads, size,
                                            attention_dropout_rate)
            self.norm_mha = nn.LayerNorm(size, eps=1e-5)
        if self.use_cgmlp:
            self.cgmlp = ConvolutionalGatingMLP(
                size, cgmlp_linear_units, cgmlp_conv_kernel, dropout_rate,
                use_linear_after_conv, gate_activation, causal)
            self.norm_mlp = nn.LayerNorm(size, eps=1e-5)
        self.norm_final = nn.LayerNorm(size, eps=1e-5)
        two = self.use_attn and self.use_cgmlp
        if two and merge_method == 'learned_ave':
            self.pooling_proj1 = nn.Linear(size, 1)
            self.pooling_proj2 = nn.Linear(size, 1)
            self.weight_proj1 = nn.Linear(size, 1)
            self.weight_proj2 = nn.Linear(size, 1)
        self.merge_proj = None
        if two or (fixed and (use_attn or use_cgmlp)):
            self.merge_proj = nn.Linear(size, size) if merge_method != \
                'concat' else nn.Linear(2 * size, size)
        self.dropout = nn.Dropout(dropout_rate)

    def _pool_weight(self, proj: nn.Module, wproj: nn.Module,
                     x: torch.Tensor,
                     mask_pad: Optional[torch.Tensor]) -> torch.Tensor:
        """Attention pooling of x (B, T, D) over its valid frames, then a
        Linear -> (B, 1)."""
        score = proj(x).transpose(1, 2) / self.size ** 0.5  # (B, 1, T)
        if mask_pad is not None:
            score = score.masked_fill(~mask_pad, -1e30)
        w = torch.softmax(score, dim=-1)
        if mask_pad is not None:
            w = w.masked_fill(~mask_pad, 0.0)
        return wproj(torch.matmul(w, x)[:, 0])

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
        x1 = x2 = x
        new_att = new_cnn = None
        if self.use_attn:
            x1, new_att = self.attn.forward_self(self.norm_mha(x), mask,
                                                 pos_emb, generator,
                                                 att_cache)
            x1 = self.dropout(x1)
        if self.use_cgmlp:
            x2, new_cnn = self.cgmlp(self.norm_mlp(x), cnn_cache)
            x2 = self.dropout(x2)
        if self.use_attn and self.use_cgmlp:
            if self.merge_method == 'concat':
                merged = self.merge_proj(torch.cat([x1, x2], dim=-1))
            elif self.merge_method == 'learned_ave':
                w1 = self._pool_weight(self.pooling_proj1,
                                       self.weight_proj1, x1, mask_pad)
                w2 = self._pool_weight(self.pooling_proj2,
                                       self.weight_proj2, x2, mask_pad)
                mw = torch.softmax(torch.cat([w1, w2], dim=-1), dim=-1)
                mw1, mw2 = mw[:, 0:1, None], mw[:, 1:2, None]
                if self.training and self.attn_branch_drop_rate > 0.0 and \
                        float(torch.rand((), generator=generator)) < \
                        self.attn_branch_drop_rate:
                    mw1, mw2 = torch.zeros_like(mw1), torch.ones_like(mw2)
                merged = self.merge_proj(mw1 * x1 + mw2 * x2)
            else:
                merged = self.merge_proj((1.0 - self.cgmlp_weight) * x1 +
                                         self.cgmlp_weight * x2)
        elif self.merge_proj is not None:
            merged = self.merge_proj(x1 if self.use_attn else x2)
        else:
            merged = x1 if self.use_attn else x2
        # stochastic depth: the residual scaled by 1 / (1 - p) in training,
        # as the JAX package does
        coeff = 1.0
        if self.training and self.stochastic_depth_rate > 0.0:
            coeff = 1.0 / (1.0 - self.stochastic_depth_rate)
        x = x + coeff * self.dropout(merged)
        return self.norm_final(x), new_att, new_cnn


class BranchformerEncoder(BaseEncoder):
    """conv2d x4 front end, rel-pos encoding and Branchformer layers.
    `cmvn_norm_var`, `final_norm` and the layer options (`LAYER_OPTIONS`)
    are the JAX `BaseEncoder`'s fields: they set the cmvn, the after_norm
    (none unless `normalize_before` and `final_norm`; `layer_norm_type`)
    and the cache's heads, and the layers read none of them, as the JAX
    layers take none."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, num_blocks: int = 12,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = 'conv2d',
                 pos_enc_layer_type: str = 'rel_pos',
                 selfattention_layer_type: str = 'rel_selfattn',
                 use_attn: bool = True, use_cgmlp: bool = True,
                 cgmlp_linear_units: int = 2048, cgmlp_conv_kernel: int = 31,
                 use_linear_after_conv: bool = False,
                 gate_activation: str = 'identity',
                 merge_method: str = 'concat', cgmlp_weight: float = 0.5,
                 attn_branch_drop_rate: float = 0.0,
                 stochastic_depth_rate: float = 0.0, causal: bool = False,
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
        self._lorder = cgmlp_conv_kernel - 1 if use_cgmlp and causal else 0
        self._cnn_channels = cgmlp_linear_units // 2
        self.encoders.extend(
            BranchformerEncoderLayer(
                output_size, attention_heads, attention_dropout_rate,
                selfattention_layer_type, use_attn, use_cgmlp,
                cgmlp_linear_units, cgmlp_conv_kernel, use_linear_after_conv,
                gate_activation, causal, dropout_rate, merge_method,
                cgmlp_weight, attn_branch_drop_rate, stochastic_depth_rate)
            for _ in range(num_blocks))

    @property
    def cnn_lorder(self) -> int:
        return self._lorder

    @property
    def cnn_cache_channels(self) -> int:
        return self._cnn_channels
