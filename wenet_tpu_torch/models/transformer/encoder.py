"""Conformer and transformer encoders, full-sequence forward.
Counterpart of wenet_tpu/models/transformer/encoder.py `ConformerEncoder`
and `TransformerEncoder` (the chunked streaming forward is not ported
yet).  `lora_conf` makes the attention projections LoRA layers, as the
JAX encoders' field does."""

from typing import Optional, Tuple

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
            xs = layer(xs, chunk_masks, pos_emb, masks, generator)
        return self.after_norm(xs), masks


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
