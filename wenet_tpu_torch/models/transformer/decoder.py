"""Transformer decoder and the U2++ bidirectional pair: the full-sequence
forward and the incremental step of the attention beam search.
Counterpart of wenet_tpu/models/transformer/decoder.py."""

from typing import List, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.attention import T_CACHE
from wenet_tpu_torch.models.transformer.decoder_layer import DecoderLayer
from wenet_tpu_torch.models.transformer.encoder_layer import (
    layer_options as layer_options_of)
from wenet_tpu_torch.models.transformer.embedding import (
    LearnablePositionalEncoding, NoPositionalEncoding, PositionalEncoding)
from wenet_tpu_torch.models.transformer.norm import get_norm
from wenet_tpu_torch.models.transformer.recompute import recompute
from wenet_tpu_torch.utils.mask import make_pad_mask, subsequent_mask

# the beam search's state: per-layer self (k, v) buffers of
# (R, h_kv, L_max, d), written in place, and per-layer encoder (k, v)
# (None in a layer without cross attention)
DecodeState = Tuple[List[T_CACHE], List[Optional[T_CACHE]]]


class _OutputBias(nn.Module):
    """The bias of a weight-tied output projection (key
    `output_layer.bias`; the weight is the token embedding)."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(vocab_size))

    def forward(self, logits: torch.Tensor) -> torch.Tensor:
        return logits + self.bias.to(logits.dtype)


class TransformerDecoder(nn.Module):
    """input_layer 'embed' (sinusoidal, x-scaled), 'embed_learnable_pe'
    (whisper: a learned table of `learnable_pe_max_len` rows) or 'no_pos'
    (no token embedding and no positions: the input is taken as (B, L, D)
    embeddings, as the JAX decoder takes it, decoder.py:129;
    token ids, which the ASR models hand it, raise, as they fail there);
    tie_word_embedding: logits = x·Eᵀ + an own bias; without
    `use_output_layer` the output is the decoder's last hidden state, as
    the JAX decoder returns it; lora_conf makes the attention projections
    LoRA layers (init_model passes it with `lora_decoder`).
    `layer_options`: the layers' options (`LAYER_OPTIONS`); a post-norm
    decoder (`normalize_before` False) has no after_norm, as the JAX
    decoder has none then; `src_attention` False leaves the cross
    attention out of every layer; `gradient_checkpointing` recomputes
    each layer in the backward (the JAX decoder's remat, any true
    value)."""

    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 norm_eps: float = 1e-5, input_layer: str = 'embed',
                 learnable_pe_max_len: int = 448,
                 tie_word_embedding: bool = False,
                 activation_type: str = 'relu', src_query_bias: bool = True,
                 src_key_bias: bool = True, src_value_bias: bool = True,
                 use_output_layer: bool = True, src_attention: bool = True,
                 lora_conf: Optional[dict] = None,
                 gradient_checkpointing: bool = False, **layer_options):
        super().__init__()
        self.gradient_checkpointing = gradient_checkpointing
        dim = encoder_output_size
        self.no_pos = input_layer == 'no_pos'
        if input_layer == 'embed':
            pos_enc = PositionalEncoding(dim, positional_dropout_rate)
        elif input_layer == 'embed_learnable_pe':
            pos_enc = LearnablePositionalEncoding(
                dim, positional_dropout_rate, learnable_pe_max_len)
        elif self.no_pos:
            pos_enc = NoPositionalEncoding(dim, positional_dropout_rate)
        else:
            raise ValueError(f'decoder input_layer={input_layer!r}')
        self.embed = nn.Sequential(
            nn.Identity() if self.no_pos else nn.Embedding(vocab_size, dim),
            pos_enc)
        options = layer_options_of(layer_options)
        self.after_norm = (get_norm(options['layer_norm_type'], dim,
                                    norm_eps)
                           if options['normalize_before'] else None)
        self.tie_word_embedding = tie_word_embedding
        self.output_layer = None
        if use_output_layer:
            self.output_layer = (_OutputBias(vocab_size) if tie_word_embedding
                                 else nn.Linear(dim, vocab_size))
        self.decoders = nn.ModuleList([
            DecoderLayer(dim, attention_heads, linear_units, dropout_rate,
                         self_attention_dropout_rate,
                         src_attention_dropout_rate, norm_eps,
                         activation_type, src_query_bias, src_key_bias,
                         src_value_bias, lora_conf, src_attention,
                         **options)
            for _ in range(num_blocks)
        ])

    def _embed(self, tgt: torch.Tensor, offset=0) -> torch.Tensor:
        if self.no_pos and not tgt.is_floating_point():
            raise ValueError(
                'the no_pos decoder takes (B, L, D) embeddings, not token '
                'ids: it has no token embedding (the JAX decoder feeds '
                'the ids on as they are and fails, '
                'wenet_tpu/models/transformer/decoder.py:129)')
        x, _ = self.embed[1](self.embed[0](tgt), offset)
        return x

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        if self.after_norm is not None:
            x = self.after_norm(x)
        if self.output_layer is None:
            return x
        if self.tie_word_embedding:
            return self.output_layer(
                torch.matmul(x, self.embed[0].weight.to(x.dtype).t()))
        return self.output_layer(x)

    def forward(self, memory: torch.Tensor, memory_mask: torch.Tensor,
                ys_in_pad: torch.Tensor, ys_in_lens: torch.Tensor,
                r_ys_in_pad: Optional[torch.Tensor] = None,
                reverse_weight: float = 0.0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """ys_in_pad: (B, L) token ids with the leading prompt -> (logits
        (B, L, V), None); the reverse arguments are for the
        BiTransformerDecoder signature and unused here."""
        maxlen = ys_in_pad.shape[1]
        tgt_mask = ((~make_pad_mask(ys_in_lens, maxlen))[:, None, :] &
                    subsequent_mask(maxlen, ys_in_pad.device)[None])
        x = self._embed(ys_in_pad)
        for layer in self.decoders:
            args = (x, tgt_mask, memory, memory_mask)
            x = (recompute(layer, args) if self.gradient_checkpointing
                 else layer(*args))
        return self._output(x), None

    def init_state(self, memory: torch.Tensor, max_len: int,
                   beam_size: int = 1) -> DecodeState:
        """Zeroed self buffers of (B·beam_size, h_kv, max_len, d) in the
        memory's dtype, and each layer's encoder (k, v) over the B rows
        of `memory` (computed once, not per beam; None without cross
        attention)."""
        B = memory.shape[0]
        self_caches, cross_kv = [], []
        for layer in self.decoders:
            attn = layer.self_attn
            shape = (B * beam_size, attn.h_kv, max_len, attn.d_k)
            self_caches.append((memory.new_zeros(shape),
                                memory.new_zeros(shape)))
            cross_kv.append(layer.precompute_cross_kv(memory))
        return self_caches, cross_kv

    def forward_step(self, tokens: torch.Tensor, step: int,
                     state: DecodeState,
                     memory_mask: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, DecodeState]:
        """One step: tokens (R, 1) at 0-based position `step` -> (log-probs
        (R, V), state).  The self buffers are updated in place."""
        self_caches, cross_kv = state
        x = self._embed(tokens, step)
        for layer, cache, kv in zip(self.decoders, self_caches, cross_kv):
            x = layer.step(x, step, cache, kv, memory_mask)
        return F.log_softmax(self._output(x[:, -1]).float(), dim=-1), state


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

    def init_state(self, memory: torch.Tensor, max_len: int,
                   beam_size: int = 1) -> DecodeState:
        return self.left_decoder.init_state(memory, max_len, beam_size)

    def forward_step(self, tokens, step, state, memory_mask):
        return self.left_decoder.forward_step(tokens, step, state,
                                              memory_mask)
