"""Efficient Conformer encoder: grouped attention in the first layers and
a strided conv module that halves the time resolution inside the trunk.
Counterpart of wenet_tpu/models/efficient_conformer/encoder.py.

The grouped attention stays plain (matmul, softmax, matmul), as the JAX
package computes it outside any kernel; the plain rel-pos layers after
the stride run K1 on the card, at the reduced resolution (d_k =
output_size / heads: 32 at the recipe's 256 / 8)."""

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.activations import get_activation
from wenet_tpu_torch.models.transformer.attention import (
    T_CACHE, RelPositionMultiHeadedAttention)
from wenet_tpu_torch.models.transformer.convolution import ConvolutionModule
from wenet_tpu_torch.models.transformer.encoder import BaseEncoder
from wenet_tpu_torch.models.transformer.encoder_layer import (
    ConformerEncoderLayer)
from wenet_tpu_torch.models.transformer.norm import channel_norm
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    make_mlp)
from wenet_tpu_torch.utils.mask import add_optional_chunk_mask


class GroupedRelPosAttention(nn.Module):
    """Rel-pos attention over groups of `group_size` frames: each head's
    (T, d) rows are regrouped to (ceil(T / g), d·g) by concatenation
    (the frames padded to a multiple of g first), and the mask read at
    every g-th frame.  No attention dropout (none in the JAX package)."""

    def __init__(self, n_head: int, n_feat: int, group_size: int = 3):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.g = group_size
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k *
                                                   group_size))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k *
                                                   group_size))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[0], x.shape[1], self.h, self.d_k).transpose(1, 2)

    def _group(self, t: torch.Tensor) -> torch.Tensor:
        """(B, T, h·d) -> (B, h, ceil(T / g), d·g): g consecutive frames'
        features side by side, split into h heads."""
        t = F.pad(t, (0, 0, 0, (-t.shape[1]) % self.g))
        return t.reshape(t.shape[0], -1, self.h,
                         self.d_k * self.g).transpose(1, 2)

    def forward_self(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                     pos_emb: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     cache: Optional[T_CACHE] = None
                     ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        """x: (B, T, F); mask: (B, T|1, T2) bool; pos_emb: (1|B, T2, F);
        cache: (k, v) of (B, h, cache_t, d) -> (out, new cache or None).

        A broadcast mask (B, 1, T2), the streaming step's and that of a
        model without dynamic chunks, zeroes the k, v, q and p of invalid
        frames first, so a half-valid group holds zeros where the
        reference's dynamic shapes hold nothing."""
        B, T, F_ = x.shape
        q = self._heads(self.linear_q(x))
        k = self._heads(self.linear_k(x))
        v = self._heads(self.linear_v(x))
        if cache is not None:
            k = torch.cat([cache[0], k], dim=2)
            v = torch.cat([cache[1], v], dim=2)
        new_cache = None if cache is None else (k, v)
        p = self.linear_pos(pos_emb)
        if mask is not None and mask.shape[1] == 1:
            kvalid = mask[:, 0, :, None].to(k.dtype)  # (B, T2, 1)
            k = k * kvalid[:, None]
            v = v * kvalid[:, None]
            q = q * kvalid[:, None, kvalid.shape[1] - T:]
            p = p * kvalid.to(p.dtype)

        def regroup(t):  # (B, h, T, d) -> (B, h, ceil(T / g), d·g)
            return self._group(t.transpose(1, 2).reshape(t.shape[0],
                                                         t.shape[2], F_))
        qg, kg, vg, pg = regroup(q), regroup(k), regroup(v), self._group(p)
        u = self.pos_bias_u.to(qg.dtype)[None, :, None, :]
        w = self.pos_bias_v.to(qg.dtype)[None, :, None, :]
        scores = (torch.matmul((qg + u).float(), kg.float().transpose(-1, -2))
                  + torch.matmul((qg + w).float(),
                                 pg.float().transpose(-1, -2)))
        scores = scores / math.sqrt(self.d_k * self.g)
        if mask is not None:
            gmask = mask[:, ::self.g, ::self.g].unsqueeze(1)
            scores = scores.masked_fill(~gmask, -1.0e30)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn.masked_fill(~gmask, 0.0)
        ctx = torch.matmul(attn.to(vg.dtype), vg)
        ctx = ctx.transpose(1, 2).reshape(B, -1, F_)[:, :T]
        return self.linear_out(ctx), new_cache


class StrideConvModule(nn.Module):
    """The conformer conv module with a strided depthwise conv: the
    output has ceil(T / stride) frames."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 activation: str = 'swish', norm: str = 'batch_norm',
                 causal: bool = False, stride: int = 1):
        super().__init__()
        self.lorder = kernel_size - 1 if causal else 0
        self.stride = stride
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, stride, groups=channels,
            padding=0 if causal else kernel_size // 2)
        # the JAX package's flax norms: LayerNorm's eps is 1e-6
        self.norm = (nn.BatchNorm1d(channels, eps=1e-5)
                     if norm == 'batch_norm'
                     else nn.LayerNorm(channels, eps=1e-6))
        self.act = get_activation(activation)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, T, C); mask_pad: (B, 1, T); cache: (B, lorder, C) ->
        (out (B, ceil(T / stride), C), new cache or None)."""
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        new_cache = None
        if cache is not None:
            x = torch.cat([cache.to(x.dtype), x], dim=1)
            new_cache = x[:, x.shape[1] - self.lorder:]
        elif self.lorder > 0:
            x = F.pad(x, (0, 0, self.lorder, 0))
        h = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        h = channel_norm(self.norm, self.depthwise_conv(h))
        out = self.pointwise_conv2(self.act(h)).transpose(1, 2)
        if mask_pad is not None:
            mp = mask_pad[:, :, ::self.stride].transpose(1, 2)
            out = out.masked_fill(~mp[:, :out.shape[1]], 0.0)
        return out, new_cache


def avg_pool_ceil(x: torch.Tensor, stride: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AvgPool1d(ceil_mode=True, count_include_pad=False) over the time
    of x (B, T, C).  `mask` (B, T) marks the frames that exist (a padded
    tail chunk's pad frames stay out of the averages); without it a data
    pad frame counts as data, as the reference's full forward counts
    it."""
    B, T, C = x.shape
    padl = (-T) % stride
    xp = F.pad(x, (0, 0, 0, padl)).reshape(B, -1, stride, C)
    if mask is None:
        counts = torch.clamp(
            T - torch.arange(xp.shape[1], device=x.device) * stride,
            max=stride).to(x.dtype)[None, :, None]
    else:
        m = F.pad(mask.to(x.dtype), (0, padl)).reshape(B, -1, stride)
        xp = xp * m[..., None]
        counts = torch.clamp(m.sum(dim=2), min=1.0)[..., None]
    return xp.sum(dim=2) / counts


class _ConformerLayerBase(nn.Module):
    """Macaron FFN, self-attention, conv module and FFN, each a pre-norm
    residual block, then norm_final; the subclasses choose the attention
    and the conv, and the conv block's residual (`_residual_conv`)."""

    def __init__(self, size: int, linear_units: int, dropout_rate: float,
                 activation_type: str, macaron_style: bool):
        super().__init__()
        self.feed_forward = make_mlp('position_wise_feed_forward', size,
                                     linear_units, dropout_rate,
                                     activation_type)
        self.macaron = macaron_style
        self.ff_scale = 0.5 if macaron_style else 1.0
        if macaron_style:
            self.feed_forward_macaron = make_mlp(
                'position_wise_feed_forward', size, linear_units,
                dropout_rate, activation_type)
            self.norm_ff_macaron = nn.LayerNorm(size, eps=1e-5)
        self.norm_ff = nn.LayerNorm(size, eps=1e-5)
        self.norm_mha = nn.LayerNorm(size, eps=1e-5)
        self.norm_conv = nn.LayerNorm(size, eps=1e-5)
        self.norm_final = nn.LayerNorm(size, eps=1e-5)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                att_cache: Optional[T_CACHE] = None,
                cnn_cache: Optional[torch.Tensor] = None,
                pool_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[T_CACHE],
                           Optional[torch.Tensor]]:
        if self.macaron:
            x = x + self.ff_scale * self.dropout(
                self.feed_forward_macaron(self.norm_ff_macaron(x)))
        y, new_att = self.self_attn.forward_self(self.norm_mha(x), mask,
                                                 pos_emb, generator,
                                                 att_cache)
        x = x + self.dropout(y)
        y, new_cnn = self.conv_module(self.norm_conv(x), mask_pad, cnn_cache)
        x = self._residual_conv(x, y, pool_mask)
        x = x + self.ff_scale * self.dropout(self.feed_forward(
            self.norm_ff(x)))
        return self.norm_final(x), new_att, new_cnn


class GroupedConformerLayer(_ConformerLayerBase):
    """A conformer layer whose self-attention is grouped."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1, group_size: int = 3,
                 cnn_module_kernel: int = 15,
                 cnn_module_norm: str = 'batch_norm', causal: bool = False,
                 macaron_style: bool = True, activation_type: str = 'swish'):
        super().__init__(size, linear_units, dropout_rate, activation_type,
                         macaron_style)
        self.self_attn = GroupedRelPosAttention(attention_heads, size,
                                                group_size)
        self.conv_module = ConvolutionModule(size, cnn_module_kernel,
                                             cnn_module_norm, causal)

    def _residual_conv(self, x, y, pool_mask=None):
        return x + self.dropout(y)


class StrideConformerEncoderLayer(_ConformerLayerBase):
    """A conformer layer whose conv module strides: its residual is
    average-pooled to the conv's ceil(T / stride) frames."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 use_grouped_attn: bool = False, group_size: int = 3,
                 cnn_module_kernel: int = 15,
                 cnn_module_norm: str = 'batch_norm', causal: bool = False,
                 stride: int = 2, macaron_style: bool = True,
                 activation_type: str = 'swish'):
        super().__init__(size, linear_units, dropout_rate, activation_type,
                         macaron_style)
        self.stride = stride
        self.self_attn = (
            GroupedRelPosAttention(attention_heads, size, group_size)
            if use_grouped_attn else
            RelPositionMultiHeadedAttention(attention_heads, size,
                                            attention_dropout_rate))
        self.conv_module = StrideConvModule(size, cnn_module_kernel,
                                            activation_type, cnn_module_norm,
                                            causal, stride)

    def _residual_conv(self, x, y, pool_mask=None):
        res = avg_pool_ceil(x, self.stride, pool_mask)
        return res[:, :y.shape[1]] + self.dropout(y)


def _as_list(v) -> list:
    return [v] if isinstance(v, int) else list(v)


class EfficientConformerEncoder(BaseEncoder):
    """Grouped-attention conformer layers (`group_layer_idx`), strided
    layers (`stride_layer_idx`, each halving the resolution by its
    `stride`) and plain rel-pos conformer layers; each stride divides the
    conv kernel of the layers after it (`stride_kernel`)."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 12, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = 'conv2d',
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False, use_cmvn: bool = False,
                 macaron_style: bool = True, activation_type: str = 'swish',
                 cnn_module_kernel: int = 15, causal: bool = False,
                 cnn_module_norm: str = 'batch_norm',
                 stride_layer_idx: Union[int, Sequence[int]] = 3,
                 stride: Union[int, Sequence[int]] = 2,
                 group_layer_idx: Union[int, Sequence[int]] = (0, 1, 2, 3),
                 group_size: int = 3, stride_kernel: bool = True):
        super().__init__(input_size, output_size, attention_heads,
                         dropout_rate, positional_dropout_rate, input_layer,
                         'rel_pos', use_dynamic_chunk, use_dynamic_left_chunk,
                         0, use_cmvn, 1e-5)
        self.strides = _as_list(stride)
        self.stride_layers = _as_list(stride_layer_idx)
        self.group_layers = _as_list(group_layer_idx)
        self.causal = causal
        self.cnn_module_kernel = cnn_module_kernel
        kernels, k = [], cnn_module_kernel
        for s in self.strides:
            kernels.append(k)
            if stride_kernel:
                k = max(k // s, 3)
        kernels.append(k)
        index = 0
        for i in range(num_blocks):
            grouped = i in self.group_layers
            if i in self.stride_layers:
                layer = StrideConformerEncoderLayer(
                    output_size, attention_heads, linear_units, dropout_rate,
                    attention_dropout_rate, grouped, group_size,
                    kernels[index], cnn_module_norm, causal,
                    self.strides[index], macaron_style, activation_type)
                index += 1
            elif grouped:
                layer = GroupedConformerLayer(
                    output_size, attention_heads, linear_units, dropout_rate,
                    group_size, kernels[min(index, len(kernels) - 1)],
                    cnn_module_norm, causal, macaron_style, activation_type)
            else:
                layer = ConformerEncoderLayer(
                    output_size, attention_heads, linear_units, dropout_rate,
                    attention_dropout_rate, 1e-5,
                    kernels[min(index, len(kernels) - 1)], causal,
                    cnn_module_norm)
            self.encoders.append(layer)

    @property
    def output_downsampling_factor(self) -> int:
        return math.prod(self.strides)

    @property
    def cnn_lorder(self) -> int:
        return self.cnn_module_kernel - 1 if self.causal else 0

    def _layer_factor(self, i: int) -> int:
        """The downsampling seen at layer i's input (a stride layer still
        attends at the resolution before its stride)."""
        return math.prod(s for idx, s in zip(self.stride_layers,
                                             self.strides) if i > idx)

    def _grouped(self, layer: nn.Module) -> bool:
        return isinstance(layer.self_attn, GroupedRelPosAttention)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """As `BaseEncoder.forward` (the chunk draw's largest chunk is 25,
        as in the JAX package); the output has ceil(T' / factor) frames
        and the masks follow each stride."""
        xs, pos_emb, masks = self.embed_input(xs, xs_lens)
        mask_pad = masks
        chunk_masks = add_optional_chunk_mask(
            masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            decoding_chunk_size, num_decoding_left_chunks, generator,
            dynamic_chunk)
        # a dynamic-chunk model's full context is a (B, T, T) mask in the
        # JAX package, so its grouped attention zeroes nothing: the
        # grouped layers get the broadcast mask expanded
        group_masks = chunk_masks
        if self.use_dynamic_chunk and chunk_masks.shape[1] == 1:
            group_masks = chunk_masks.expand(-1, chunk_masks.shape[2], -1)
        index = 0
        for i, layer in enumerate(self.encoders):
            xs, _, _ = layer(xs, group_masks if self._grouped(layer)
                             else chunk_masks, pos_emb, mask_pad, generator)
            if i in self.stride_layers:
                s = self.strides[index]
                masks = masks[:, :, ::s]
                chunk_masks = chunk_masks[:, ::s, ::s]
                group_masks = group_masks[:, ::s, ::s]
                mask_pad = masks
                pos_emb = pos_emb[:, ::s]
                index += 1
        return self.after_norm(xs), masks

    def forward_chunk(self, xs: torch.Tensor,
                      offset: Union[int, torch.Tensor],
                      att_cache: Tuple[torch.Tensor, torch.Tensor],
                      cnn_cache: Optional[torch.Tensor],
                      att_mask: Optional[torch.Tensor] = None):
        """One streaming chunk step, as `BaseEncoder.forward_chunk`, with
        the caches at the base (first layer's) resolution for every
        layer: layer i reads every f-th slot (f its `_layer_factor`) and
        its new keys are repeated f times back into the window.  `offset`
        counts final-resolution frames; the output has chunk / factor
        frames; cache_t1 and the chunk must be multiples of the factor.
        A layer's conv reads the last lorder frames of its cnn cache,
        which is left-padded to the widest conv's lorder."""
        B = xs.shape[0]
        total = self.output_downsampling_factor
        base_offset = offset * total
        ones = torch.ones(B, 1, xs.shape[1], dtype=torch.bool,
                          device=xs.device)
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, _, _ = self.embed(xs, ones, base_offset)
        k_cache, v_cache = att_cache
        cache_t1 = k_cache.shape[-2]
        chunk = xs.shape[1]
        if cache_t1 % total or chunk % total:
            raise ValueError(f'the cache ({cache_t1}) and the chunk '
                             f'({chunk}) must be multiples of the '
                             f'downsampling factor {total}')
        pos_emb = self.embed.position_encoding(
            base_offset - cache_t1, cache_t1 + chunk, xs.device).to(xs.dtype)
        if att_mask is None:
            att_mask = torch.ones(B, 1, cache_t1 + chunk, dtype=torch.bool,
                                  device=xs.device)
        new_k: List[torch.Tensor] = []
        new_v: List[torch.Tensor] = []
        new_cnn: List[torch.Tensor] = []
        for i, layer in enumerate(self.encoders):
            f = self._layer_factor(i)
            lorder = layer.conv_module.lorder
            layer_cnn = None
            if cnn_cache is not None and lorder:
                layer_cnn = cnn_cache[i][:, cnn_cache.shape[2] - lorder:]
            kw = {}
            if isinstance(layer, StrideConformerEncoderLayer):
                kw['pool_mask'] = att_mask[:, 0, cache_t1:][:, ::f]
            xs, (k, v), layer_cnn = layer(
                xs, att_mask[:, :, ::f], pos_emb[:, ::f], None,
                att_cache=(k_cache[i][:, :, ::f], v_cache[i][:, :, ::f]),
                cnn_cache=layer_cnn, **kw)
            keep = cache_t1 // f
            new_k.append(k[:, :, k.shape[2] - keep:].repeat_interleave(f, 2))
            new_v.append(v[:, :, v.shape[2] - keep:].repeat_interleave(f, 2))
            if cnn_cache is not None:
                if layer_cnn is None:
                    layer_cnn = xs.new_zeros(B, 0, self._output_size)
                new_cnn.append(F.pad(layer_cnn, (0, 0, cnn_cache.shape[2] -
                                                 layer_cnn.shape[1], 0)))
        xs = self.after_norm(xs)
        return (xs, (torch.stack(new_k), torch.stack(new_v)),
                None if cnn_cache is None else torch.stack(new_cnn))
