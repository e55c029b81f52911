"""Paraformer layers: low-frame-rate stacking, the SAN-M encoder and the
SAN-M decoder.  Counterpart of wenet_tpu/models/paraformer/layers.py
(`lfr`, `SanmEncoder`, `_AliParaformerEncoderLayer`,
`PositionwiseFeedForwardDecoderSANM`, `SanmDecoderLayer`, `SanmDecoder`,
`_Decoders3`), with the reference wenet state_dict keys (`encoders0.0`,
`encoders.{i}`, `decoders.{i}`, `decoders3.0`)."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.paraformer.attention import (
    DummyMultiHeadSANM, MultiHeadAttentionCross, MultiHeadedAttentionSANM)
from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.embedding import (
    whisper_position_encoding)
from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
    PositionwiseFeedForward)
from wenet_tpu_torch.utils.mask import make_pad_mask


def lfr(input: torch.Tensor, input_lens: torch.Tensor, m: int = 7,
        n: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low frame rate: stack m frames every n.  input (B, T, D), lengths
    (B,) -> ((B, ceil(T / n), m * D), new lengths).

    Output frame i stacks source frames i·n - (m - 1) // 2 + j, j < m:
    those before the first frame read the first frame, those past the
    row's last valid frame read that frame (the JAX package's head and
    tail replication, as one gather)."""
    B, T, D = input.shape
    left = (m - 1) // 2
    n_lfr = (T + n - 1) // n
    dev = input.device
    idx = (torch.arange(n_lfr, device=dev)[:, None] * n - left +
           torch.arange(m, device=dev)[None, :])
    last = (input_lens - 1).clamp(min=0).to(dev)
    src = idx[None].clamp(min=0).minimum(last[:, None, None])
    out = input[torch.arange(B, device=dev)[:, None, None], src]
    ceil = (input_lens + n - 1) // n
    new_len = (left + input_lens + (
        m - (input_lens + left - n * (ceil - 1))).clamp(min=0)) // n
    return out.reshape(B, n_lfr, m * D), new_len.to(input_lens.dtype)


class AliParaformerEncoderLayer(nn.Module):
    """Pre-norm SAN-M attention (a residual only where in_size == size:
    the first block maps the LFR features to the model width) + FFN."""

    def __init__(self, size: int, in_size: int, attention_heads: int,
                 linear_units: int, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 kernel_size: int = 11, sanm_shfit: int = 0):
        super().__init__()
        self.self_attn = MultiHeadedAttentionSANM(
            attention_heads, in_size, size, attention_dropout_rate,
            kernel_size, sanm_shfit)
        self.feed_forward = PositionwiseFeedForward(size, linear_units,
                                                    dropout_rate)
        self.norm1 = nn.LayerNorm(in_size, eps=1e-5)
        self.norm2 = nn.LayerNorm(size, eps=1e-5)
        self.dropout = nn.Dropout(dropout_rate)
        self.residual = in_size == size

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                mask_pad: torch.Tensor) -> torch.Tensor:
        y = self.dropout(self.self_attn(self.norm1(x), mask, mask_pad))
        x = x + y if self.residual else y
        return x + self.dropout(self.feed_forward(self.norm2(x)))


class SanmEncoder(nn.Module):
    """The encoder-owned global cmvn (over the LFR features), x·√d + the
    [sin | cos] encoding of positions 1..T at the input width (the
    `paraformer_dummy` front end), `encoders0` (in_size -> output_size),
    num_blocks - 1 `encoders`, `after_norm`."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 kernel_size: int = 11, sanm_shfit: int = 0,
                 use_cmvn: bool = False):
        super().__init__()
        self._output_size = output_size
        self.input_size = input_size
        self.global_cmvn = GlobalCMVN(input_size) if use_cmvn else None

        def layer(in_size):
            return AliParaformerEncoderLayer(
                output_size, in_size, attention_heads, linear_units,
                dropout_rate, attention_dropout_rate, kernel_size,
                sanm_shfit)
        self.encoders0 = nn.ModuleList([layer(input_size)])
        self.encoders = nn.ModuleList(layer(output_size)
                                      for _ in range(num_blocks - 1))
        self.after_norm = nn.LayerNorm(output_size, eps=1e-5)

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xs: (B, T, input_size) LFR features -> (xs (B, T, D), masks
        (B, 1, T) bool valid), at full context."""
        masks = ~make_pad_mask(xs_lens, xs.shape[1])[:, None, :]
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        pos = whisper_position_encoding(xs.shape[1], self.input_size,
                                        xs.device, offset=1)
        xs = xs * (self._output_size ** 0.5) + pos.to(xs.dtype)
        for layer in [*self.encoders0, *self.encoders]:
            xs = layer(xs, masks, masks)
        return self.after_norm(xs), masks


class PositionwiseFeedForwardDecoderSANM(nn.Module):
    """w_2(norm(dropout(relu(w_1(x))))), w_2 without a bias."""

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.w_1 = nn.Linear(idim, hidden_units)
        self.dropout = nn.Dropout(dropout_rate)
        self.norm = nn.LayerNorm(hidden_units, eps=1e-5)
        self.w_2 = nn.Linear(hidden_units, idim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.norm(self.dropout(F.relu(self.w_1(x)))))


class SanmDecoderLayer(nn.Module):
    """FFN first, then the FSMN memory (residual from the layer input),
    then cross attention; norms with eps 1e-12."""

    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1, kernel_size: int = 11,
                 sanm_shfit: int = 0):
        super().__init__()
        self.self_attn = DummyMultiHeadSANM(size, dropout_rate, kernel_size,
                                            sanm_shfit)
        self.src_attn = MultiHeadAttentionCross(attention_heads, size)
        self.feed_forward = PositionwiseFeedForwardDecoderSANM(
            size, linear_units, dropout_rate)
        self.norm1 = nn.LayerNorm(size, eps=1e-12)
        self.norm2 = nn.LayerNorm(size, eps=1e-12)
        self.norm3 = nn.LayerNorm(size, eps=1e-12)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, tgt: torch.Tensor, tgt_mask: torch.Tensor,
                memory: torch.Tensor,
                memory_mask: torch.Tensor) -> torch.Tensor:
        """tgt (B, U, D) with tgt_mask (B, 1, U); memory (B, T, D) with
        memory_mask (B, 1, T)."""
        y = self.norm2(self.feed_forward(self.norm1(tgt)))
        x = tgt + self.dropout(self.self_attn(y, tgt_mask))
        return x + self.dropout(self.src_attn(self.norm3(x), memory,
                                              memory_mask))


class Decoders3(nn.Module):
    """norm1 then the decoder FFN, no residual."""

    def __init__(self, hidden: int, linear_units: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.feed_forward = PositionwiseFeedForwardDecoderSANM(
            hidden, linear_units, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feed_forward(self.norm1(x))


class SanmDecoder(nn.Module):
    """The non-autoregressive decoder over CIF acoustic embeddings:
    num_blocks `SanmDecoderLayer`s, each with cross attention (the yaml's
    `att_layer_num` must equal num_blocks: the JAX package builds every
    block with one), `decoders3`, `after_norm`, `output_layer`."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 att_layer_num: Optional[int] = None,
                 kernel_size: int = 11, sanm_shfit: int = 0):
        super().__init__()
        if att_layer_num is not None and att_layer_num != num_blocks:
            raise NotImplementedError(
                f'att_layer_num={att_layer_num} with num_blocks='
                f'{num_blocks}: the JAX package gives every block cross '
                'attention, so only att_layer_num == num_blocks is ported')
        dim = encoder_output_size
        self.decoders = nn.ModuleList(
            SanmDecoderLayer(dim, attention_heads, linear_units,
                             dropout_rate, kernel_size, sanm_shfit)
            for _ in range(num_blocks))
        self.decoders3 = nn.ModuleList([Decoders3(dim, linear_units,
                                                  dropout_rate)])
        self.after_norm = nn.LayerNorm(dim, eps=1e-5)
        self.output_layer = nn.Linear(dim, vocab_size)

    def forward(self, encoder_out: torch.Tensor,
                encoder_out_mask: torch.Tensor,
                sematic_embeds: torch.Tensor,
                ys_pad_lens: torch.Tensor) -> torch.Tensor:
        """-> logits (B, U, V) for the U embeddings, the first
        ys_pad_lens of each row valid."""
        ys_mask = ~make_pad_mask(ys_pad_lens, sematic_embeds.shape[1])[
            :, None, :]
        x = sematic_embeds
        for layer in self.decoders:
            x = layer(x, ys_mask, encoder_out, encoder_out_mask)
        for layer in self.decoders3:
            x = layer(x)
        return self.output_layer(self.after_norm(x))
