"""Squeezeformer encoder: post-norm MHSA / FFN / conv / FFN blocks with
adaptive scales, on a U-net trunk that halves the time resolution at
`reduce_idx` and recovers it at `recover_idx`.  Counterpart of
wenet_tpu/models/squeezeformer/encoder.py.

Its rel-pos attention (with the legacy `rel_shift`) stays plain (matmul,
softmax, matmul), as the JAX package computes it outside any kernel.
Its norms are the JAX package's flax defaults: LayerNorm eps 1e-6,
BatchNorm eps 1e-5."""

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.activations import get_activation
from wenet_tpu_torch.models.transformer.attention import T_CACHE
from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.embedding import (
    sinusoidal_position_encoding)
from wenet_tpu_torch.models.transformer.norm import BatchNorm1d, channel_norm
from wenet_tpu_torch.utils.mask import add_optional_chunk_mask, make_pad_mask

LN_EPS = 1e-6


def add_adaptive_scale(module: nn.Module, size: int,
                       adaptive_scale: bool) -> None:
    """Give `module` its (1, 1, size) `ada_scale` / `ada_bias`, where
    `adaptive_scale` is set (the reference's names, on the module
    itself)."""
    module.adaptive_scale = adaptive_scale
    if adaptive_scale:
        module.ada_scale = nn.Parameter(torch.empty(1, 1, size))
        module.ada_bias = nn.Parameter(torch.empty(1, 1, size))


def adaptive_scale(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """scale * x + bias, or x where the module has no adaptive scale."""
    if not module.adaptive_scale:
        return x
    return module.ada_scale.to(x.dtype) * x + module.ada_bias.to(x.dtype)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """The Transformer-XL zero-pad / reshape shift of (B, H, T1, T2)."""
    B, H, T1, T2 = x.shape
    padded = torch.cat([x.new_zeros(B, H, T1, 1), x], dim=-1)
    return padded.view(B, H, T2 + 1, T1)[:, :, 1:].reshape(B, H, T1, T2)


def rel_shift_window(x: torch.Tensor, valid_cache: torch.Tensor,
                     valid_chunk: torch.Tensor, cache_len: int
                     ) -> torch.Tensor:
    """`rel_shift` at the reference's dynamic window geometry: its
    streaming window holds the valid cache slots and the chunk's valid
    frames (t1 = valid_chunk, t2 = valid_cache + valid_chunk), here the
    columns [cache_len - valid_cache, cache_len + valid_chunk) of the
    fixed (T1, T2) matrix; pad columns read 0.  With a full cache and a
    full chunk it is `rel_shift(x)`.  valid_cache, valid_chunk: (B,)."""
    B, H, T1, T2 = x.shape
    vcache = valid_cache.to(torch.int64).reshape(B, 1, 1, 1)
    t1 = valid_chunk.to(torch.int64).reshape(B, 1, 1, 1)
    pad = cache_len - vcache
    t2 = vcache + t1
    i = torch.arange(T1, device=x.device).reshape(1, 1, T1, 1)
    m = torch.arange(T2, device=x.device).reshape(1, 1, 1, T2)
    j = m - pad  # the column inside the reference's window
    flat = i * t2 + j + t1
    ip = torch.div(flat, t2 + 1, rounding_mode='floor')
    jp = flat - ip * (t2 + 1)
    src = jp - 1 + pad
    gather = ip.clamp(0, T1 - 1) * T2 + src.clamp(0, T2 - 1)
    gather = gather.expand(B, H, T1, T2).reshape(B, H, -1)
    val = torch.gather(x.reshape(B, H, -1), 2, gather).reshape(B, H, T1, T2)
    bad = (jp <= 0) | (j < 0) | (j >= t2)
    return val.masked_fill(bad, 0.0)


class SqueezeRelPosAttention(nn.Module):
    """Rel-pos MHA on adaptively scaled input, with `rel_shift` of the
    position scores.  No attention dropout (none in the JAX package)."""

    def __init__(self, n_head: int, n_feat: int, do_rel_shift: bool = True,
                 adaptive_scale: bool = True):
        super().__init__()
        self.h = n_head
        self.d_k = n_feat // n_head
        self.do_rel_shift = do_rel_shift
        add_adaptive_scale(self, n_feat, adaptive_scale)
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[0], x.shape[1], self.h, self.d_k).transpose(1, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                pos_emb: torch.Tensor, cache: Optional[T_CACHE] = None
                ) -> Tuple[torch.Tensor, Optional[T_CACHE]]:
        """x: (B, T, F); mask: (B, T|1, T2); pos_emb: (1|B, T2, F);
        cache: (k, v) of (B, h, cache_t, d) -> (out, new cache or None).
        In a chunk step (a cache and a mask) the shift runs at the
        reference's window (`rel_shift_window`)."""
        x = adaptive_scale(self, x)
        B, T, F_ = x.shape
        q = self._heads(self.linear_q(x))
        k = self._heads(self.linear_k(x))
        v = self._heads(self.linear_v(x))
        if cache is not None:
            k = torch.cat([cache[0], k], dim=2)
            v = torch.cat([cache[1], v], dim=2)
        p = self._heads(self.linear_pos(pos_emb))
        u = self.pos_bias_u.to(q.dtype)[None, :, None, :]
        w = self.pos_bias_v.to(q.dtype)[None, :, None, :]
        ac = torch.matmul((q + u).float(), k.float().transpose(-1, -2))
        bd = torch.matmul((q + w).float(), p.float().transpose(-1, -2))
        if self.do_rel_shift:
            if cache is not None and mask is not None:
                cache_len = k.shape[2] - T
                bd = rel_shift_window(bd, mask[:, 0, :cache_len].sum(-1),
                                      mask[:, 0, cache_len:].sum(-1),
                                      cache_len)
            else:
                bd = rel_shift(bd)
        scores = (ac + bd) / math.sqrt(self.d_k)
        if mask is not None:
            m = mask.unsqueeze(1)
            scores = scores.masked_fill(~m, -1.0e30)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn.masked_fill(~m, 0.0)
        ctx = torch.matmul(attn.to(v.dtype), v)
        ctx = ctx.transpose(1, 2).reshape(B, T, F_)
        return self.linear_out(ctx), None if cache is None else (k, v)


class SqueezeFFN(nn.Module):
    """w_2(dropout(act(w_1(scale * x + bias))))."""

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.1, activation: str = 'swish',
                 adaptive_scale: bool = True):
        super().__init__()
        add_adaptive_scale(self, idim, adaptive_scale)
        self.w_1 = nn.Linear(idim, hidden_units)
        self.act = get_activation(activation)
        self.dropout = nn.Dropout(dropout_rate)
        self.w_2 = nn.Linear(hidden_units, idim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(self.act(self.w_1(adaptive_scale(self,
                                                                    x)))))


class SqueezeConvModule(nn.Module):
    """The conformer conv module on adaptively scaled input; its norm is
    `cnn_norm_type`."""

    def __init__(self, channels: int, kernel_size: int = 31,
                 activation: str = 'swish', norm: str = 'batch_norm',
                 causal: bool = False, adaptive_scale: bool = True):
        super().__init__()
        self.lorder = kernel_size - 1 if causal else 0
        add_adaptive_scale(self, channels, adaptive_scale)
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, groups=channels,
            padding=0 if causal else kernel_size // 2)
        if norm not in ('batch_norm', 'layer_norm'):
            raise NotImplementedError(f'cnn_norm_type={norm!r} is not ported')
        self.norm = (BatchNorm1d(channels, eps=1e-5)
                     if norm == 'batch_norm'
                     else nn.LayerNorm(channels, eps=LN_EPS))
        self.act = get_activation(activation)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = adaptive_scale(self, x)
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
        out = self.pointwise_conv2(self.act(h))
        if mask_pad is not None:
            out = out.masked_fill(~mask_pad, 0.0)
        return out.transpose(1, 2), new_cache


class DepthwiseConv2dSubsampling4(nn.Module):
    """Two stride-2 3x3 convs (the second depthwise with `dw_stride`),
    the flattened features scaled by sqrt(d) (RelPositionalEncoding's
    xscale, before `input_proj`), then input_proj (Linear + dropout)."""
    subsampling_rate = 4
    right_context = 6

    def __init__(self, idim: int, input_size: int, dw_stride: bool = False,
                 input_dropout_rate: float = 0.1, pos_enc_dim: int = 256):
        super().__init__()
        self.pos_enc_dim = pos_enc_dim
        self.pw_conv = nn.Conv2d(1, idim, 3, 2)
        self.dw_conv = nn.Conv2d(idim, idim, 3, 2,
                                 groups=idim if dw_stride else 1)
        self.input_proj = nn.Sequential(
            nn.Linear(idim * (((input_size - 1) // 2 - 1) // 2), idim),
            nn.Dropout(input_dropout_rate))

    def position_encoding(self, offset: Union[int, torch.Tensor], size: int,
                          device=None) -> torch.Tensor:
        return sinusoidal_position_encoding(size, self.pos_enc_dim, device,
                                            offset)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                offset: Union[int, torch.Tensor] = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = F.relu(self.dw_conv(F.relu(self.pw_conv(x.unsqueeze(1)))))
        b, c, t, f = x.shape
        x = x.transpose(1, 2).reshape(b, t, c * f)
        pos_emb = self.position_encoding(offset, t, x.device).to(x.dtype)
        x = self.input_proj(x * math.sqrt(self.pos_enc_dim))
        return x, pos_emb, x_mask[:, :, :-2:2][:, :, :-2:2]


class TimeReductionLayer1D(nn.Module):
    """Depthwise stride-2 conv (padded on both sides) and a pointwise
    conv: T -> the length of mask_pad[..., ::2], trimmed or zero-padded
    to it; lens -> (lens + 1) // 2."""

    def __init__(self, channel: int, out_dim: int, kernel_size: int = 5,
                 stride: int = 2):
        super().__init__()
        self.stride = stride
        self.dw_conv = nn.Conv1d(channel, channel, kernel_size, stride,
                                 padding=max(0, kernel_size - stride),
                                 groups=channel)
        self.pw_conv = nn.Conv1d(channel, out_dim, 1)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                mask: torch.Tensor, mask_pad: torch.Tensor):
        xs = xs.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        x = self.pw_conv(self.dw_conv(xs.transpose(1, 2))).transpose(1, 2)
        mask = mask[:, ::self.stride, ::self.stride]
        mask_pad = mask_pad[:, :, ::self.stride]
        L = mask_pad.shape[-1]
        x = F.pad(x, (0, 0, 0, L - x.shape[1])) if x.shape[1] < L \
            else x[:, :L]
        return x, (xs_lens + 1) // 2, mask, mask_pad


class SqueezeformerEncoderLayer(nn.Module):
    """MHSA -> FFN -> conv -> FFN, each a residual block, post-norm
    (pre-norm with `normalize_before`)."""

    def __init__(self, size: int, attention_heads: int,
                 feed_forward_expansion_factor: int = 4,
                 dropout_rate: float = 0.1,
                 feed_forward_dropout_rate: float = 0.1,
                 cnn_module_kernel: int = 31,
                 cnn_norm_type: str = 'batch_norm', causal: bool = False,
                 adaptive_scale: bool = True, activation_type: str = 'swish',
                 do_rel_shift: bool = True, normalize_before: bool = False):
        super().__init__()
        hidden = size * feed_forward_expansion_factor
        self.self_attn = SqueezeRelPosAttention(attention_heads, size,
                                                do_rel_shift, adaptive_scale)
        self.ffn1 = SqueezeFFN(size, hidden, feed_forward_dropout_rate,
                               activation_type, adaptive_scale)
        self.ffn2 = SqueezeFFN(size, hidden, feed_forward_dropout_rate,
                               activation_type, adaptive_scale)
        self.conv_module = SqueezeConvModule(size, cnn_module_kernel,
                                             activation_type, cnn_norm_type,
                                             causal, adaptive_scale)
        self.layer_norm1 = nn.LayerNorm(size, eps=LN_EPS)
        self.layer_norm2 = nn.LayerNorm(size, eps=LN_EPS)
        self.layer_norm3 = nn.LayerNorm(size, eps=LN_EPS)
        self.layer_norm4 = nn.LayerNorm(size, eps=LN_EPS)
        self.normalize_before = normalize_before
        self.dropout = nn.Dropout(dropout_rate)

    def _residual(self, x, norm, y_of):
        """x + dropout(y_of(x or norm(x))), post- or pre-norm."""
        if self.normalize_before:
            return x + self.dropout(y_of(norm(x)))
        return norm(x + self.dropout(y_of(x)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pos_emb: torch.Tensor,
                mask_pad: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                att_cache: Optional[T_CACHE] = None,
                cnn_cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[T_CACHE],
                           Optional[torch.Tensor]]:
        """The encoder layers' call (see wenet_tpu_torch's `BaseEncoder`);
        `generator` is not read (no attention dropout)."""
        caches = {}

        def attend(y):
            y, caches['att'] = self.self_attn(y, mask, pos_emb, att_cache)
            return y

        def conv(y):
            y, caches['cnn'] = self.conv_module(y, mask_pad, cnn_cache)
            return y
        x = self._residual(x, self.layer_norm1, attend)
        x = self._residual(x, self.layer_norm2, self.ffn1)
        x = self._residual(x, self.layer_norm3, conv)
        x = self._residual(x, self.layer_norm4, self.ffn2)
        return x, caches['att'], caches['cnn']


def _as_list(v) -> list:
    if v is None:
        return []
    return [v] if isinstance(v, int) else list(v)


class SqueezeformerEncoder(nn.Module):
    """Depthwise conv2d x4 front end, preln, Squeezeformer layers, the
    time reduction before each `reduce_idx` layer and the recovery (x2
    repeat, Linear, plus the saved activations) before each
    `recover_idx` layer; a final Linear where output_size differs from
    encoder_dim."""
    subsampling_rate = 4
    right_context = 6
    output_downsampling_factor = 1

    def __init__(self, input_size: int = 80, encoder_dim: int = 256,
                 output_size: int = 256, attention_heads: int = 4,
                 num_blocks: int = 12,
                 reduce_idx: Union[int, Sequence[int], None] = 5,
                 recover_idx: Union[int, Sequence[int], None] = 11,
                 feed_forward_expansion_factor: int = 4,
                 dw_stride: bool = False, input_dropout_rate: float = 0.1,
                 do_rel_shift: bool = True,
                 feed_forward_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.1,
                 cnn_module_kernel: int = 31,
                 cnn_norm_type: str = 'batch_norm', dropout: float = 0.1,
                 causal: bool = False, adaptive_scale: bool = True,
                 activation_type: str = 'swish', use_cmvn: bool = False,
                 normalize_before: bool = False,
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 static_chunk_size: int = 0, cmvn_norm_var: bool = True):
        super().__init__()
        # attention_dropout_rate is accepted and, as in the JAX package,
        # not applied
        self.encoder_dim = encoder_dim
        self._output_size = output_size
        self.attention_heads = attention_heads
        self.reduce_idx = _as_list(reduce_idx)
        self.recover_idx = _as_list(recover_idx) if self.reduce_idx else []
        self.causal = causal
        self.cnn_module_kernel = cnn_module_kernel
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.global_cmvn = (GlobalCMVN(input_size, cmvn_norm_var)
                            if use_cmvn else None)
        self.embed = DepthwiseConv2dSubsampling4(
            encoder_dim, input_size, dw_stride, input_dropout_rate,
            encoder_dim)
        self.preln = nn.LayerNorm(encoder_dim, eps=LN_EPS)
        self.encoders = nn.ModuleList(
            SqueezeformerEncoderLayer(
                encoder_dim, attention_heads, feed_forward_expansion_factor,
                dropout, feed_forward_dropout_rate, cnn_module_kernel,
                cnn_norm_type, causal, adaptive_scale, activation_type,
                do_rel_shift, normalize_before)
            for _ in range(num_blocks))
        self.time_reduction_layer = TimeReductionLayer1D(encoder_dim,
                                                         encoder_dim)
        self.time_recover_layer = nn.Linear(encoder_dim, encoder_dim)
        self.final_proj = (nn.Linear(encoder_dim, output_size)
                           if output_size != encoder_dim else None)

    def output_size(self) -> int:
        return self._output_size

    def _final(self, xs: torch.Tensor) -> torch.Tensor:
        return xs if self.final_proj is None else self.final_proj(xs)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs: (B, T, F); xs_lens: (B,) -> (xs (B, T', D), masks
        (B, 1, T')).  The masks, the pad mask and the position encoding
        follow each time reduction and come back at its recovery."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks)
        mask_pad = masks
        chunk_masks = add_optional_chunk_mask(
            masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            decoding_chunk_size, num_decoding_left_chunks, generator,
            dynamic_chunk, static_chunk_size=self.static_chunk_size)
        lens = mask_pad[:, 0, :].sum(-1)
        xs = self.preln(xs)
        recover: List[tuple] = []
        for i, layer in enumerate(self.encoders):
            if i in self.reduce_idx:
                recover.append((xs, chunk_masks, pos_emb, mask_pad))
                xs, lens, chunk_masks, mask_pad = self.time_reduction_layer(
                    xs, lens, chunk_masks, mask_pad)
                pos_emb = pos_emb[:, ::2]
            if i in self.recover_idx:
                rec_xs, chunk_masks, pos_emb, mask_pad = recover.pop()
                xs = self.time_recover_layer(xs.repeat_interleave(2, dim=1))
                xs = rec_xs + xs[:, :rec_xs.shape[1]]
                xs = xs.masked_fill(~mask_pad[:, 0, :, None], 0.0)
                lens = mask_pad[:, 0, :].sum(-1)
            xs, _, _ = layer(xs, chunk_masks, pos_emb, mask_pad, generator)
        return self._final(xs), masks

    def forward_chunk(self, xs: torch.Tensor,
                      offset: Union[int, torch.Tensor],
                      att_cache: Tuple[torch.Tensor, torch.Tensor],
                      cnn_cache: Optional[torch.Tensor],
                      att_mask: Optional[torch.Tensor] = None):
        """One streaming chunk step, as `BaseEncoder.forward_chunk`, with
        the caches at the base resolution for every layer (a reduced
        layer reads every 2nd slot and its new keys are repeated back);
        the reduction and recovery stay inside the chunk.  cache_t1 and
        the chunk must be multiples of 2 ** len(reduce_idx)."""
        B = xs.shape[0]
        ones = torch.ones(B, 1, xs.shape[1], dtype=torch.bool,
                          device=xs.device)
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, _, _ = self.embed(xs, ones, offset)
        k_cache, v_cache = att_cache
        cache_t1 = k_cache.shape[-2]
        chunk = xs.shape[1]
        max_f = 2 ** len(self.reduce_idx)
        if cache_t1 % max_f or chunk % max_f:
            raise ValueError(f'the cache ({cache_t1}) and the chunk '
                             f'({chunk}) must be multiples of {max_f}')
        base_pos = self.embed.position_encoding(
            offset - cache_t1, cache_t1 + chunk, xs.device).to(xs.dtype)
        if att_mask is None:
            att_mask = torch.ones(B, 1, cache_t1 + chunk, dtype=torch.bool,
                                  device=xs.device)
        xs = self.preln(xs)
        new_k: List[torch.Tensor] = []
        new_v: List[torch.Tensor] = []
        new_cnn: List[torch.Tensor] = []
        recover: List[torch.Tensor] = []
        lens = torch.full((B,), chunk, dtype=torch.int64, device=xs.device)
        # the chunk's valid frames: the reduction conv pads both sides, so
        # a padded tail's pad frames are zeroed before it
        chunk_mask = att_mask[:, :, cache_t1:]
        f = 1
        for i, layer in enumerate(self.encoders):
            if i in self.reduce_idx:
                recover.append(xs)
                mask_pad = chunk_mask[:, :, ::f]
                xs, lens, _, _ = self.time_reduction_layer(xs, lens,
                                                           mask_pad,
                                                           mask_pad)
                f *= 2
            if i in self.recover_idx:
                f //= 2
                rec_xs = recover.pop()
                xs = self.time_recover_layer(xs.repeat_interleave(2, dim=1))
                xs = rec_xs + xs[:, :rec_xs.shape[1]]
                xs = xs.masked_fill(~chunk_mask[:, 0, ::f, None], 0.0)
            xs, (k, v), cnn = layer(
                xs, att_mask[:, :, ::f], base_pos[:, ::f],
                chunk_mask[:, :, ::f],
                att_cache=(k_cache[i][:, :, ::f], v_cache[i][:, :, ::f]),
                cnn_cache=None if cnn_cache is None else cnn_cache[i])
            keep = cache_t1 // f
            new_k.append(k[:, :, k.shape[2] - keep:].repeat_interleave(f, 2))
            new_v.append(v[:, :, v.shape[2] - keep:].repeat_interleave(f, 2))
            new_cnn.append(cnn)
        return (self._final(xs), (torch.stack(new_k), torch.stack(new_v)),
                None if cnn_cache is None else torch.stack(new_cnn))

    def zero_cache(self, batch_size: int, required_cache_size: int,
                   dtype=torch.float32, device=None):
        """((k, v), cnn) before the first chunk, at the base resolution."""
        h = self.attention_heads
        k = torch.zeros(len(self.encoders), batch_size, h,
                        required_cache_size, self.encoder_dim // h,
                        dtype=dtype, device=device)
        return (k, k), self.zero_cnn_cache(batch_size, dtype, device)

    def zero_cnn_cache(self, batch_size: int, dtype=torch.float32,
                       device=None) -> Optional[torch.Tensor]:
        if not self.causal:
            return None
        return torch.zeros(len(self.encoders), batch_size,
                           self.cnn_module_kernel - 1, self.encoder_dim,
                           dtype=dtype, device=device)
