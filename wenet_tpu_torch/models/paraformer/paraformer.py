"""Paraformer: the non-autoregressive model with a CIF predictor.
Counterpart of wenet_tpu/models/paraformer/paraformer.py (`Predictor`
with the timestamp branch, `Paraformer` with its loss, the glancing
sampler, `forward_paraformer` and `forward_cif_peaks`)."""

from typing import Dict, Optional

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.paraformer.cif import Cif, cif_without_hidden
from wenet_tpu_torch.models.paraformer.layers import lfr
from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.models.transformer.label_smoothing_loss import (
    label_smoothing_loss)
from wenet_tpu_torch.utils.common import add_sos_eos, th_accuracy
from wenet_tpu_torch.utils.mask import make_pad_mask


class Predictor(nn.Module):
    """`Cif` (`predictor`) and the timestamp branch: the encoder frames
    upsampled by a transposed conv (`tp_upsample_cnn`), a bidirectional
    LSTM (`tp_blstm`, run over the padded frames as the JAX package's
    TorchLSTM runs it: no packing) and a sigmoid head (`tp_output`)."""

    def __init__(self, idim: int, l_order: int, r_order: int,
                 threshold: float = 1.0, dropout: float = 0.1,
                 smooth_factor: float = 1.0, noise_threshold: float = 0.0,
                 tail_threshold: float = 0.45, residual: bool = True,
                 cnn_groups: int = 0, smooth_factor2: float = 0.25,
                 noise_threshold2: float = 0.01, upsample_times: int = 3):
        super().__init__()
        self.predictor = Cif(idim, l_order, r_order, threshold, dropout,
                             smooth_factor, noise_threshold, tail_threshold,
                             residual, cnn_groups)
        self.tp_upsample_cnn = nn.ConvTranspose1d(
            idim, idim, upsample_times, stride=upsample_times)
        self.tp_blstm = nn.LSTM(idim, idim, 1, batch_first=True,
                                bidirectional=True)
        self.tp_output = nn.Linear(2 * idim, 1)
        self.smooth_factor2 = smooth_factor2
        self.noise_threshold2 = noise_threshold2
        self.upsample_times = upsample_times

    def forward(self, hidden: torch.Tensor,
                target_label_length: Optional[torch.Tensor],
                mask: torch.Tensor, max_out_len: Optional[int] = None):
        """-> (acoustic embeddings, token_num, alphas, fires, tp_alphas
        (B, 3T), tp_token_num, tp_mask (B, 3T))."""
        acoustic_embeds, token_num, alphas, fires = self.predictor(
            hidden, target_label_length, mask, max_out_len)
        up = self.tp_upsample_cnn(hidden.transpose(1, 2)).transpose(1, 2)
        out, _ = self.tp_blstm(up)
        tp_alphas = torch.sigmoid(self.tp_output(out))
        tp_alphas = F.relu(tp_alphas * self.smooth_factor2 -
                           self.noise_threshold2)
        tp_mask = mask[:, 0, :].repeat_interleave(
            self.upsample_times, dim=-1)[:, :tp_alphas.shape[1]]
        tp_alphas = tp_alphas[:, :, 0] * tp_mask
        return (acoustic_embeds, token_num, alphas, fires, tp_alphas,
                tp_alphas.sum(-1), tp_mask)


class Paraformer(ASRModel):
    """LFR features -> SAN-M encoder -> CIF acoustic embeddings -> SAN-M
    decoder.  The loss: the decoder's label smoothing over the labels
    with <eos> appended, the quantity losses of the CIF and timestamp
    token counts, and CTC when ctc_weight > 0 (the CTC head exists only
    then, as in the JAX package's parameters).  In training the glancing
    sampler replaces part of the acoustic embeddings with label
    embeddings (`embed`)."""

    default_decode_method = 'paraformer_greedy_search'

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: nn.Module, ctc: Optional[nn.Module],
                 predictor: Predictor, sampler: bool = True,
                 sampling_ratio: float = 0.75, add_eos: bool = True,
                 **kwargs):
        super().__init__(vocab_size, encoder, decoder, ctc, **kwargs)
        self.predictor = predictor
        self.sampler = sampler
        self.sampling_ratio = sampling_ratio
        self.add_eos = add_eos
        if sampler:
            self.embed = nn.Embedding(vocab_size, encoder.output_size())

    def _forward_encoder_lfr(self, speech: torch.Tensor,
                             speech_lengths: torch.Tensor):
        return self.encoder(*lfr(speech, speech_lengths))

    def forward_encoder(self, speech: torch.Tensor,
                        speech_lengths: torch.Tensor,
                        decoding_chunk_size: int = -1,
                        num_decoding_left_chunks: int = -1):
        """LFR, then the encoder at full context (the chunk arguments are
        not read, as in the JAX package)."""
        return self._forward_encoder_lfr(speech, speech_lengths)

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk=None) -> Dict[str, Optional[torch.Tensor]]:
        """-> {loss, loss_ctc, loss_decoder, loss_quantity,
        loss_quantity_tp, th_accuracy}.  In training the sampler's
        uniform scores come from `generator` (the train step's host
        generator), so the card and the CPU replace the same
        positions."""
        encoder_out, encoder_out_mask = self._forward_encoder_lfr(
            feats, feats_lengths)
        ys_pad, ys_pad_lens = target, target_lengths
        if self.add_eos:
            _, ys_pad = add_sos_eos(target, self.sos, self.eos,
                                    self.ignore_id)
            ys_pad_lens = target_lengths + 1
        U = ys_pad.shape[1]
        acoustic_embd, token_num, _, _, _, tp_token_num, _ = \
            self.predictor(encoder_out, ys_pad_lens, encoder_out_mask,
                           max_out_len=U)
        if self.sampler and self.training:
            scores = self.sampler_scores(ys_pad.shape, generator)
            acoustic_embd = self._sampler(encoder_out, encoder_out_mask,
                                          ys_pad, ys_pad_lens,
                                          acoustic_embd,
                                          scores.to(encoder_out.device))
        loss_ctc = None
        if self.ctc_weight != 0.0 and self.ctc is not None:
            loss_ctc, _ = self.ctc(encoder_out,
                                   encoder_out_mask[:, 0, :].sum(-1),
                                   target, target_lengths)
        fl = ys_pad_lens.float()
        loss_quantity = (token_num - fl).abs().sum() / fl.sum()
        loss_quantity_tp = (tp_token_num - fl).abs().sum() / fl.sum()
        decoder_out = self.decoder(encoder_out, encoder_out_mask,
                                   acoustic_embd, ys_pad_lens)
        loss_decoder = label_smoothing_loss(
            decoder_out, ys_pad, self.vocab_size, self.ignore_id,
            self.lsm_weight, self.length_normalized_loss)
        loss = loss_decoder + loss_quantity + loss_quantity_tp
        if loss_ctc is not None:
            loss = loss + self.ctc_weight * loss_ctc
        return {'loss': loss, 'loss_ctc': loss_ctc,
                'loss_decoder': loss_decoder, 'loss_quantity': loss_quantity,
                'loss_quantity_tp': loss_quantity_tp,
                'th_accuracy': th_accuracy(decoder_out, ys_pad,
                                           self.ignore_id)}

    @staticmethod
    def sampler_scores(shape, generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """The sampler's uniform scores, drawn on the host."""
        return torch.rand(shape, generator=generator)

    def _sampler(self, encoder_out, encoder_out_mask, ys_pad, ys_pad_lens,
                 pre_acoustic_embeds, scores):
        """The glancing sampler: a decoder pass without gradient and
        without dropout counts the positions it gets right; of the
        others, ⌊(len - right)·sampling_ratio⌋ valid positions, those
        with the lowest `scores`, take their label's embedding."""
        U = ys_pad.shape[1]
        tgt_mask = ~make_pad_mask(ys_pad_lens, U)
        ys_embed = self.embed(torch.where(tgt_mask, ys_pad, 0))
        with torch.no_grad():
            was_training = self.decoder.training
            self.decoder.eval()
            try:
                decoder_out = self.decoder(encoder_out, encoder_out_mask,
                                           pre_acoustic_embeds, ys_pad_lens)
            finally:
                self.decoder.train(was_training)
            pred = decoder_out.argmax(-1)
            same_num = ((pred == ys_pad) & tgt_mask).sum(1)
            target_num = ((ys_pad_lens - same_num).float() *
                          self.sampling_ratio).long()
            scores = torch.where(tgt_mask, scores, 2.0)
            rank = torch.argsort(torch.argsort(scores, dim=1, stable=True),
                                 dim=1, stable=True)
            replace = (rank < target_num[:, None]) & tgt_mask
        sematic = torch.where(replace[:, :, None], ys_embed,
                              pre_acoustic_embeds)
        return torch.where(tgt_mask[:, :, None], sematic, 0.0)

    def forward_paraformer(self, speech: torch.Tensor,
                           speech_lengths: torch.Tensor,
                           max_out_len: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
        """The decode forward: encoder, CIF over a static cap of
        max_out_len (the encoder frames when None) tokens, the decoder's
        log-softmax -> {encoder_out, encoder_out_mask, decoder_out (B,
        cap, V), tp_alphas, decoder_out_lens (B,) = ⌊token_num⌋,
        tp_mask}."""
        encoder_out, encoder_out_mask = self._forward_encoder_lfr(
            speech, speech_lengths)
        cap = max_out_len or encoder_out.shape[1]
        acoustic_embed, token_num, _, _, tp_alphas, _, tp_mask = \
            self.predictor(encoder_out, None, encoder_out_mask,
                           max_out_len=cap)
        token_num = torch.floor(token_num).int()
        decoder_out = self.decoder(encoder_out, encoder_out_mask,
                                   acoustic_embed, token_num)
        return {'encoder_out': encoder_out,
                'encoder_out_mask': encoder_out_mask,
                'decoder_out': F.log_softmax(decoder_out, dim=-1),
                'tp_alphas': tp_alphas, 'decoder_out_lens': token_num,
                'tp_mask': tp_mask}

    def forward_cif_peaks(self, alphas: torch.Tensor,
                          token_nums: torch.Tensor) -> torch.Tensor:
        """(B, 3T) fire trace of the timestamp alphas scaled to integrate
        to token_nums; a peak is a frame whose total reaches 1 - 1e-4."""
        cif2 = alphas.sum(-1)
        scaled = alphas / (cif2 / token_nums.to(alphas.dtype).clamp(
            min=1e-6))[:, None]
        return cif_without_hidden(scaled,
                                  self.predictor.predictor.threshold - 1e-4)
