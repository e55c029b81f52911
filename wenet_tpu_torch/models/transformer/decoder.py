"""Transformer decoder and the U2++ bidirectional pair, full-sequence
forward.  Counterpart of wenet_tpu/models/transformer/decoder.py (the
incremental ring-cache step is not ported yet)."""

from typing import Optional, Tuple

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.decoder_layer import DecoderLayer
from wenet_tpu_torch.models.transformer.embedding import PositionalEncoding
from wenet_tpu_torch.utils.mask import make_pad_mask, subsequent_mask


class TransformerDecoder(nn.Module):

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 norm_eps: float = 1e-5):
        super().__init__()
        dim = encoder_output_size
        self.embed = nn.Sequential(
            nn.Embedding(vocab_size, dim),
            PositionalEncoding(dim, positional_dropout_rate))
        self.after_norm = nn.LayerNorm(dim, eps=norm_eps)
        self.output_layer = nn.Linear(dim, vocab_size)
        self.decoders = nn.ModuleList([
            DecoderLayer(dim, attention_heads, linear_units, dropout_rate,
                         self_attention_dropout_rate,
                         src_attention_dropout_rate, norm_eps)
            for _ in range(num_blocks)
        ])

    def forward(self, memory: torch.Tensor, memory_mask: torch.Tensor,
                ys_in_pad: torch.Tensor, ys_in_lens: torch.Tensor,
                r_ys_in_pad: Optional[torch.Tensor] = None,
                reverse_weight: float = 0.0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """ys_in_pad: (B, L) token ids with leading <sos> -> (logits
        (B, L, V), None); the reverse arguments are for the
        BiTransformerDecoder signature and unused here."""
        maxlen = ys_in_pad.shape[1]
        tgt_mask = ((~make_pad_mask(ys_in_lens, maxlen))[:, None, :] &
                    subsequent_mask(maxlen, ys_in_pad.device)[None])
        x, _ = self.embed(ys_in_pad)
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, memory_mask)
        return self.output_layer(self.after_norm(x)), None


class BiTransformerDecoder(nn.Module):
    """Left-to-right + right-to-left decoder pair (U2++)."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 num_blocks: int = 6, r_num_blocks: int = 0, **kwargs):
        super().__init__()
        self.left_decoder = TransformerDecoder(
            vocab_size, encoder_output_size, num_blocks=num_blocks, **kwargs)
        self.right_decoder = TransformerDecoder(
            vocab_size, encoder_output_size, num_blocks=r_num_blocks,
            **kwargs)

    def forward(self, memory: torch.Tensor, memory_mask: torch.Tensor,
                ys_in_pad: torch.Tensor, ys_in_lens: torch.Tensor,
                r_ys_in_pad: torch.Tensor, reverse_weight: float = 0.0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (left logits, right logits or None when reverse_weight is 0)."""
        l_x, _ = self.left_decoder(memory, memory_mask, ys_in_pad,
                                   ys_in_lens)
        r_x = None
        if reverse_weight > 0.0:
            r_x, _ = self.right_decoder(memory, memory_mask, r_ys_in_pad,
                                        ys_in_lens)
        return l_x, r_x
