"""Conformer and transformer encoders.  Counterpart of
wenet_tpu/models/transformer/encoder.py `ConformerEncoder` (full-sequence
forward and the streaming chunk step `forward_chunk` with fixed-size
caches) and `TransformerEncoder` (full-sequence forward).  `lora_conf`
makes the attention projections LoRA layers, as the JAX encoders' field
does."""

from typing import List, Optional, Tuple

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.embedding import (
    RelPositionalEncoding, WhisperPositionalEncoding)
from wenet_tpu_torch.models.transformer.encoder_layer import (
    ConformerEncoderLayer, TransformerEncoderLayer)
from wenet_tpu_torch.models.transformer.subsampling import (
    Conv1dSubsampling2, Conv2dSubsampling4)
from wenet_tpu_torch.utils.mask import (add_optional_chunk_mask,
                                        make_pad_mask)


class ConformerEncoder(nn.Module):
    """conv2d x4 subsampling + rel-pos conformer blocks (pre-norm, with a
    final LayerNorm)."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False, use_cmvn: bool = False,
                 norm_eps: float = 1e-5, cnn_module_kernel: int = 15,
                 causal: bool = False, cnn_module_norm: str = 'batch_norm',
                 conv_norm_eps: float = 1e-5,
                 lora_conf: Optional[dict] = None):
        super().__init__()
        self._output_size = output_size
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.global_cmvn = GlobalCMVN(input_size) if use_cmvn else None
        self.embed = Conv2dSubsampling4(
            input_size, output_size, dropout_rate,
            RelPositionalEncoding(output_size, positional_dropout_rate))
        self.after_norm = nn.LayerNorm(output_size, eps=norm_eps)
        self.encoders = nn.ModuleList([
            ConformerEncoderLayer(
                output_size, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, norm_eps, cnn_module_kernel, causal,
                cnn_module_norm, conv_norm_eps, lora_conf)
            for _ in range(num_blocks)
        ])

    def output_size(self) -> int:
        return self._output_size

    @property
    def subsampling_rate(self) -> int:
        return self.embed.subsampling_rate

    @property
    def right_context(self) -> int:
        return self.embed.right_context

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs: (B, T, F) features; xs_lens: (B,) -> (xs (B, T', D),
        masks (B, 1, T') bool valid).

        Training passes its host `generator`: the dynamic-chunk draw
        (once per forward) and the attention-dropout seeds come from it;
        `dynamic_chunk` = (chunk_size, num_left_chunks) replaces the draw."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, pos_emb, masks = self.embed(xs, masks)
        chunk_masks = add_optional_chunk_mask(
            masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            decoding_chunk_size, num_decoding_left_chunks, generator,
            dynamic_chunk)
        for layer in self.encoders:
            xs, _, _ = layer(xs, chunk_masks, pos_emb, masks, generator)
        return self.after_norm(xs), masks

    def forward_chunk(self, xs: torch.Tensor, offset: int,
                      att_cache: Tuple[torch.Tensor, torch.Tensor],
                      cnn_cache: Optional[torch.Tensor],
                      att_mask: Optional[torch.Tensor] = None):
        """One streaming chunk step with fixed-size, right-aligned caches.

        xs: (B, time, F) features of the chunk, time = (chunk - 1) *
        subsampling_rate + right_context + 1; offset: the position of the
        chunk's first output frame; att_cache: (k, v), each (num_blocks,
        B, h, cache_t1, d_k), whose leading slots `att_mask` marks
        invalid until the cache fills; cnn_cache: (num_blocks, B, lorder,
        D) or None; att_mask: (B, 1, cache_t1 + chunk) bool, the valid
        cache slots followed by the chunk's valid frames (fewer than the
        chunk in a zero-padded tail).  Every block attends the cache_t1 +
        chunk keys through K1 on the card.

        Returns (ys (B, chunk, D), new att_cache, new cnn_cache), with the
        shapes of the caches given: each keeps the last cache_t1 keys."""
        B = xs.shape[0]
        ones = torch.ones(B, 1, xs.shape[1], dtype=torch.bool,
                          device=xs.device)
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, _, _ = self.embed(xs, ones, offset)
        k_cache, v_cache = att_cache
        cache_t1 = k_cache.shape[-2]
        # the keys' positions run from offset - cache_t1 (negative before
        # the cache fills: those slots are masked and read position 0)
        pos_emb = self.embed.position_encoding(
            offset - cache_t1, cache_t1 + xs.shape[1], xs.device).to(xs.dtype)
        mask_pad = att_mask[:, :, cache_t1:] if att_mask is not None else None
        new_k: List[torch.Tensor] = []
        new_v: List[torch.Tensor] = []
        new_cnn: List[torch.Tensor] = []
        for i, layer in enumerate(self.encoders):
            xs, (k, v), cnn = layer(
                xs, att_mask, pos_emb, mask_pad,
                att_cache=(k_cache[i], v_cache[i]),
                cnn_cache=None if cnn_cache is None else cnn_cache[i])
            new_k.append(k[:, :, k.shape[2] - cache_t1:])
            new_v.append(v[:, :, v.shape[2] - cache_t1:])
            new_cnn.append(cnn)
        xs = self.after_norm(xs)
        return (xs, (torch.stack(new_k), torch.stack(new_v)),
                None if cnn_cache is None else torch.stack(new_cnn))

    def zero_cache(self, batch_size: int, required_cache_size: int,
                   dtype=torch.float32, device=None):
        """The caches before the first chunk: ((k, v), cnn), k and v of
        (num_blocks, B, h, required_cache_size, d_k), all slots invalid,
        and `zero_cnn_cache`."""
        attn = self.encoders[0].self_attn
        k = torch.zeros(len(self.encoders), batch_size, attn.h,
                        required_cache_size, attn.d_k, dtype=dtype,
                        device=device)
        return (k, k), self.zero_cnn_cache(batch_size, dtype, device)

    def zero_cnn_cache(self, batch_size: int, dtype=torch.float32,
                       device=None) -> Optional[torch.Tensor]:
        """(num_blocks, B, lorder, D) zeros, or None for a non-causal conv
        module (it has no left context to carry)."""
        lorder = self.encoders[0].conv_module.lorder
        if not lorder:
            return None
        return torch.zeros(len(self.encoders), batch_size, lorder,
                           self._output_size, dtype=dtype, device=device)


class TransformerEncoder(nn.Module):
    """conv1d x2 subsampling + whisper's [sin | cos] encoding + pre-norm
    transformer blocks with a final LayerNorm (whisper's encoder: the
    front end and encoding the JAX package names `conv1d2` and
    `abs_pos_whisper`)."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 static_chunk_size: int = 0, use_cmvn: bool = False,
                 norm_eps: float = 1e-5, activation_type: str = 'relu',
                 query_bias: bool = True, key_bias: bool = True,
                 value_bias: bool = True, lora_conf: Optional[dict] = None):
        super().__init__()
        if static_chunk_size > 0:
            raise NotImplementedError('static_chunk_size > 0 is not ported')
        self._output_size = output_size
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.global_cmvn = GlobalCMVN(input_size) if use_cmvn else None
        self.embed = Conv1dSubsampling2(
            input_size, output_size, dropout_rate,
            WhisperPositionalEncoding(output_size, positional_dropout_rate))
        self.after_norm = nn.LayerNorm(output_size, eps=norm_eps)
        self.encoders = nn.ModuleList([
            TransformerEncoderLayer(
                output_size, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, norm_eps, activation_type,
                query_bias, key_bias, value_bias, lora_conf)
            for _ in range(num_blocks)
        ])

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs: (B, T, F); xs_lens: (B,) -> (xs (B, T', D), masks
        (B, 1, T') bool valid).  Static chunk size <= 0 is full context:
        without a dynamic chunk the attention mask is the pad mask."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs, _, masks = self.embed(xs, masks)
        chunk_masks = add_optional_chunk_mask(
            masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            decoding_chunk_size, num_decoding_left_chunks, generator,
            dynamic_chunk, 100 // self.embed.subsampling_rate)
        for layer in self.encoders:
            xs = layer(xs, chunk_masks)
        return self.after_norm(xs), masks
