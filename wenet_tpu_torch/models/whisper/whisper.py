"""Whisper as an ASRModel.  Counterpart of
wenet_tpu/models/whisper/whisper.py: sos and eos are the special tokens
`sot` and `eot`, the default decode mode is the attention beam search
over the [sot, lang, task, ...] prompt (search.py
`attention_beam_search`), and the train loss is the attention loss on
targets behind the prompt [sot, lang, task, notimestamps], built from
integer language and task ids as fixed-shape tensors."""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.models.transformer.label_smoothing_loss import (
    label_smoothing_loss)
from wenet_tpu_torch.models.whisper.tokens import WHISPER_LANGS
from wenet_tpu_torch.utils.common import th_accuracy

TASK_IDS = {'transcribe': 0, 'translate': 1, 'vad': 2}


def lang_id_array(langs: Sequence[str], default: str = 'en') -> np.ndarray:
    """['zh', 'en', ...] -> (B,) indices into WHISPER_LANGS; an unknown
    language takes `default`."""
    return np.asarray([WHISPER_LANGS.index(l if l in WHISPER_LANGS
                                           else default) for l in langs],
                      np.int32)


def task_id_array(tasks: Sequence[str]) -> np.ndarray:
    """['transcribe', 'translate', 'vad', ...] -> (B,) ids (unknown: 0)."""
    return np.asarray([TASK_IDS.get(t, 0) for t in tasks], np.int32)


class Whisper(ASRModel):
    default_decode_method = 'attention'

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: nn.Module, ctc: nn.Module,
                 special_tokens: dict, **kwargs):
        super().__init__(vocab_size, encoder, decoder, ctc,
                         special_tokens=special_tokens, **kwargs)
        self.sos = special_tokens['sot']
        self.eos = special_tokens['eot']

    def _build_prefix(self, B: int, lang_ids: Optional[torch.Tensor],
                      task_ids: Optional[torch.Tensor],
                      device=None) -> torch.Tensor:
        """(B, 4) int64: [sot, lang, task, notimestamps]; task 2 (vad)
        puts no_speech in the last two, an unknown task id 0 in the
        third.  Languages default to zh, tasks to transcribe."""
        st = self.special_tokens
        if lang_ids is None:
            lang_ids = torch.full((B,), WHISPER_LANGS.index('zh'),
                                  device=device)
        if task_ids is None:
            task_ids = torch.zeros(B, dtype=torch.int64, device=device)
        lang_ids = lang_ids.to(torch.int64)
        task_ids = task_ids.to(torch.int64)
        sot = torch.full_like(task_ids, st['sot'])
        task_tok = torch.where(
            task_ids == 0, st['transcribe'],
            torch.where(task_ids == 1, st['translate'],
                        torch.where(task_ids == 2, st['no_speech'], 0)))
        last = torch.where(task_ids == 2, st['no_speech'],
                           st['no_timestamps'])
        return torch.stack([sot, st['sot'] + 1 + lang_ids, task_tok, last],
                           dim=1)

    def _add_whisper_tokens(self, ys_pad: torch.Tensor,
                            prefix: torch.Tensor):
        """ys_in  = [prefix..., y..., eot-pad]
        ys_out = [prefix[1:]..., y..., eot, ignore-pad]
        -> (ys_in, ys_out, ys_in lengths)."""
        B, L = ys_pad.shape
        eot = self.eos
        lens = (ys_pad != self.ignore_id).sum(1)
        ys_in = torch.cat([prefix.to(ys_pad.dtype),
                           ys_pad.masked_fill(ys_pad == self.ignore_id, eot)],
                          dim=1)
        j = torch.arange(L + 1, device=ys_pad.device)[None, :]
        ys_ext = torch.cat([ys_pad, ys_pad.new_full((B, 1), self.ignore_id)],
                           dim=1)
        tail = torch.where(j < lens[:, None], ys_ext,
                           torch.where(j == lens[:, None], eot,
                                       self.ignore_id))
        ys_out = torch.cat([prefix[:, 1:].to(ys_pad.dtype),
                            tail.to(ys_pad.dtype)], dim=1)
        return ys_in, ys_out, lens + prefix.shape[1]

    def _calc_att_loss(self, encoder_out, encoder_mask, ys_pad, lang_ids,
                       task_ids):
        prefix = self._build_prefix(ys_pad.shape[0], lang_ids, task_ids,
                                    ys_pad.device)
        ys_in_pad, ys_out_pad, ys_in_lens = self._add_whisper_tokens(
            ys_pad, prefix)
        decoder_out, _ = self.decoder(encoder_out, encoder_mask, ys_in_pad,
                                      ys_in_lens)
        loss_att = label_smoothing_loss(decoder_out, ys_out_pad,
                                        self.vocab_size, self.ignore_id,
                                        self.lsm_weight,
                                        self.length_normalized_loss)
        return loss_att, th_accuracy(decoder_out, ys_out_pad, self.ignore_id)

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk=None,
                lang_ids: Optional[torch.Tensor] = None,
                task_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """Encoder + loss -> {loss, loss_att, loss_ctc, th_accuracy}, as
        `ASRModel.forward`, with the attention loss on the prompted
        targets (lang_ids / task_ids: (B,) ids, `lang_id_array` /
        `task_id_array`).  Losses are summed over tokens and divided by
        B, as the JAX model does (no dummy-row exclusion); with
        ctc_weight 0 there is no CTC loss."""
        encoder_out, encoder_mask = self.encoder(
            feats, feats_lengths, generator=generator,
            dynamic_chunk=dynamic_chunk)
        loss_ctc = loss_att = acc_att = None
        if self.ctc_weight != 0.0:
            loss_ctc, _ = self.ctc(encoder_out, encoder_mask[:, 0, :].sum(-1),
                                   target, target_lengths)
        if self.ctc_weight != 1.0:
            loss_att, acc_att = self._calc_att_loss(
                encoder_out, encoder_mask, target, lang_ids, task_ids)
        if loss_ctc is None:
            loss = loss_att
        elif loss_att is None:
            loss = loss_ctc
        else:
            loss = (self.ctc_weight * loss_ctc +
                    (1 - self.ctc_weight) * loss_att)
        return {'loss': loss, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
                'th_accuracy': acc_att}
