"""Hybrid CTC/attention ASR model (U2/U2++): the joint training loss and
the decode-side methods.  Counterpart of
wenet_tpu/models/transformer/asr_model.py (`__call__`, `_calc_att_loss`
and the decode methods :169-250)."""

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.label_smoothing_loss import (
    label_smoothing_loss)
from wenet_tpu_torch.utils.common import (IGNORE_ID, add_sos_eos,
                                          reverse_pad_list, th_accuracy)
from wenet_tpu_torch.utils.ctc_utils import topk_host_rows


class ASRModel(nn.Module):
    default_decode_method = 'attention_rescoring'

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: nn.Module, ctc: nn.Module,
                 ctc_weight: float = 0.5, ignore_id: int = IGNORE_ID,
                 reverse_weight: float = 0.0, lsm_weight: float = 0.0,
                 length_normalized_loss: bool = False,
                 special_tokens: Optional[dict] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder = encoder
        self.decoder = decoder
        self.ctc = ctc
        self.ctc_weight = ctc_weight
        self.ignore_id = ignore_id
        self.reverse_weight = reverse_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.special_tokens = special_tokens
        tokens = special_tokens or {}
        self.sos = tokens.get('<sos>', vocab_size - 1)
        self.eos = tokens.get('<eos>', vocab_size - 1)

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """Encoder + joint loss -> {loss, loss_att, loss_ctc, th_accuracy}.

        feats (B, T, F), feats_lengths (B,), target (B, L) IGNORE_ID
        padded, target_lengths (B,).  loss = ctc_weight * loss_ctc +
        (1 - ctc_weight) * loss_att, where loss_att mixes the left and
        right decoders by reverse_weight.  Rows with feats_lengths == 0 are
        dummies and leave every loss.  `generator` / `dynamic_chunk` go to
        the encoder (training's chunk draw and dropout seeds); without
        them the encoder sees full context."""
        encoder_out, encoder_mask = self.encoder(
            feats, feats_lengths, generator=generator,
            dynamic_chunk=dynamic_chunk)
        encoder_out_lens = encoder_mask[:, 0, :].sum(-1)
        row_valid = feats_lengths > 0
        loss_ctc = loss_att = acc_att = None
        if self.ctc_weight != 0.0:
            loss_ctc, _ = self.ctc(encoder_out, encoder_out_lens, target,
                                   target_lengths, row_valid)
        if self.ctc_weight != 1.0:
            loss_att, acc_att = self._calc_att_loss(
                encoder_out, encoder_mask, target, target_lengths, row_valid)
        if loss_ctc is None:
            loss = loss_att
        elif loss_att is None:
            loss = loss_ctc
        else:
            loss = (self.ctc_weight * loss_ctc +
                    (1 - self.ctc_weight) * loss_att)
        return {'loss': loss, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
                'th_accuracy': acc_att}

    def _calc_att_loss(self, encoder_out, encoder_mask, ys_pad, ys_pad_lens,
                       row_valid):
        ys_in_pad, ys_out_pad = add_sos_eos(ys_pad, self.sos, self.eos,
                                            self.ignore_id)
        r_ys_pad = reverse_pad_list(ys_pad, ys_pad_lens, self.ignore_id)
        r_ys_in_pad, r_ys_out_pad = add_sos_eos(r_ys_pad, self.sos,
                                                self.eos, self.ignore_id)
        # dummy rows would still predict one <eos> each: ignore them
        ys_out_pad = ys_out_pad.masked_fill(~row_valid[:, None],
                                            self.ignore_id)
        r_ys_out_pad = r_ys_out_pad.masked_fill(~row_valid[:, None],
                                                self.ignore_id)
        num_valid = row_valid.sum()
        decoder_out, r_decoder_out = self.decoder(
            encoder_out, encoder_mask, ys_in_pad, ys_pad_lens + 1,
            r_ys_in_pad, self.reverse_weight)
        loss_att = label_smoothing_loss(
            decoder_out, ys_out_pad, self.vocab_size, self.ignore_id,
            self.lsm_weight, self.length_normalized_loss, num_valid)
        if self.reverse_weight > 0.0:
            r_loss_att = label_smoothing_loss(
                r_decoder_out, r_ys_out_pad, self.vocab_size,
                self.ignore_id, self.lsm_weight,
                self.length_normalized_loss, num_valid)
            loss_att = (loss_att * (1 - self.reverse_weight) +
                        r_loss_att * self.reverse_weight)
        return loss_att, th_accuracy(decoder_out, ys_out_pad, self.ignore_id)

    def forward_encoder(self, speech: torch.Tensor,
                        speech_lengths: torch.Tensor,
                        decoding_chunk_size: int = -1,
                        num_decoding_left_chunks: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(speech, speech_lengths, decoding_chunk_size,
                            num_decoding_left_chunks)

    def forward_encoder_chunk(self, xs: torch.Tensor,
                              offset: Union[int, torch.Tensor],
                              att_cache, cnn_cache,
                              att_mask: Optional[torch.Tensor] = None):
        """The streaming chunk step (the encoder's `forward_chunk`);
        `offset` is an int or a (B,) tensor with one per row."""
        return self.encoder.forward_chunk(xs, offset, att_cache, cnn_cache,
                                          att_mask)

    def ctc_activation(self, xs: torch.Tensor) -> torch.Tensor:
        """(B, T, V) CTC log-posteriors of encoder outputs."""
        return self.ctc.log_softmax(xs)

    def ctc_host_rows(self, ys: torch.Tensor, k: int,
                      blank: int) -> torch.Tensor:
        """(..., T, 2k + 1) on ys's device, what a streaming decoder's
        host beam and endpoint read of the CTC log-probs of encoder
        outputs `ys`: the top-k values, their ids (as floats, exact below
        2**24) and the blank column, packed for one device-to-host
        copy."""
        return topk_host_rows(self.ctc_activation(ys), k, blank)

    def ctc_logprobs(self, encoder_out: torch.Tensor,
                     blank_penalty: float = 0.0,
                     blank_id: int = 0) -> torch.Tensor:
        return self.ctc.log_softmax(encoder_out, blank_penalty, blank_id)

    def ctc_argmax(self, encoder_out: torch.Tensor,
                   blank_penalty: float = 0.0,
                   blank_id: int = 0) -> torch.Tensor:
        return self.ctc.argmax(encoder_out, blank_penalty, blank_id)

    def ctc_topk(self, encoder_out: torch.Tensor, k: int,
                 blank_penalty: float = 0.0, blank_id: int = 0):
        return self.ctc.topk(encoder_out, k, blank_penalty, blank_id)

    def forward_attention_decoder(
            self, hyps: torch.Tensor, hyps_lens: torch.Tensor,
            encoder_out: torch.Tensor, reverse_weight: float = 0.0,
            encoder_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Batched nbest decoder scores.

        hyps: (n, L) with leading <sos>; hyps_lens: (n,) counting the
        <sos>; encoder_out: (1|n, T, D) with an optional (n, 1, T) mask.
        Returns log-softmax (left, right-or-None), each (n, L, V); the
        right decoder reads each hyp reversed, padded with <eos>."""
        n, L = hyps.shape
        if encoder_out.shape[0] != n:
            encoder_out = encoder_out.expand(n, -1, -1)
        if encoder_mask is None:
            encoder_mask = torch.ones(n, 1, encoder_out.shape[1],
                                      dtype=torch.bool,
                                      device=encoder_out.device)
        r_lens = hyps_lens - 1
        j = torch.arange(L - 1, device=hyps.device)[None, :]
        idx = r_lens[:, None] - 1 - j
        r_hyps = torch.gather(hyps[:, 1:], 1, idx.clamp(min=0))
        r_hyps = torch.where(idx >= 0, r_hyps, self.eos)
        r_hyps = torch.cat([hyps[:, :1], r_hyps], dim=1)
        decoder_out, r_decoder_out = self.decoder(
            encoder_out, encoder_mask, hyps, hyps_lens, r_hyps,
            reverse_weight)
        decoder_out = F.log_softmax(decoder_out, dim=-1)
        if r_decoder_out is not None:
            r_decoder_out = F.log_softmax(r_decoder_out, dim=-1)
        return decoder_out, r_decoder_out

    # -- the attention beam search's step interface ----------------------
    def decoder_init_state(self, encoder_out: torch.Tensor, max_len: int,
                           beam_size: int = 1):
        """encoder_out: (B, T, D); the self buffers get B·beam_size rows."""
        return self.decoder.init_state(encoder_out, max_len, beam_size)

    def decoder_forward_step(self, tokens: torch.Tensor, step: int, state,
                             memory_mask: Optional[torch.Tensor]):
        """tokens (R, 1) at position `step` -> (log-probs (R, V), state)."""
        return self.decoder.forward_step(tokens, step, state, memory_mask)
