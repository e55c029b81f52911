"""SenseVoice-small: the SAN-M encoder with timestamp-prediction blocks,
a CTC head, and four context tokens (language, event, emotion, text
normalization) embedded in front of the speech.  Counterpart of
wenet_tpu/models/sensevoice/sensevoice_small_model.py: the cmvn is the
model's (`global_cmvn`, after LFR and before the context tokens), not the
encoder's."""

from typing import Dict, Optional

import torch
from torch import nn

from wenet_tpu_torch.models.paraformer.layers import (
    AliParaformerEncoderLayer, SanmEncoder, lfr)
from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.models.transformer.cmvn import GlobalCMVN
from wenet_tpu_torch.models.transformer.label_smoothing_loss import (
    label_smoothing_loss)

LID_DICT = {'auto': 0, 'zh': 3, 'en': 4, 'yue': 7, 'ja': 11, 'ko': 12,
            'nospeech': 13}
TEXTNORM_DICT = {'withitn': 14, 'woitn': 15}
N_CONTEXT = 4


class SanmEncoderWithTp(SanmEncoder):
    """`SanmEncoder`, then `tp_blocks` more SAN-M blocks and `tp_norm`."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 kernel_size: int = 11, sanm_shfit: int = 0,
                 use_cmvn: bool = False, tp_blocks: int = 5):
        super().__init__(input_size, output_size, attention_heads,
                         linear_units, num_blocks, dropout_rate,
                         positional_dropout_rate, attention_dropout_rate,
                         kernel_size, sanm_shfit, use_cmvn)
        self.tp_encoders = nn.ModuleList(
            AliParaformerEncoderLayer(
                output_size, output_size, attention_heads, linear_units,
                dropout_rate, attention_dropout_rate, kernel_size,
                sanm_shfit) for _ in range(tp_blocks))
        self.tp_norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor):
        xs, masks = super().forward(xs, xs_lens)
        for layer in self.tp_encoders:
            xs = layer(xs, masks, masks)
        return self.tp_norm(xs), masks


class SenseVoiceSmall(ASRModel):
    """Targets are [lid, event, emo, itn, text...]: CTC over the speech
    frames and text, label smoothing of the context frames' CTC logits
    against the four context tokens."""

    default_decode_method = 'ctc_greedy_search'

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: Optional[nn.Module], ctc: nn.Module, **kwargs):
        super().__init__(vocab_size, encoder, decoder, ctc, **kwargs)
        tokens = self.special_tokens or {}
        self.sos = tokens.get('<s>', self.sos)
        self.eos = tokens.get('</s>', self.eos)
        self.embed = nn.Embedding(7 + len(LID_DICT) + len(TEXTNORM_DICT),
                                  encoder.input_size)
        self.global_cmvn = GlobalCMVN(encoder.input_size)

    def _frontend(self, feats, feats_lengths, lid_ids=None, itn_ids=None):
        """LFR, the cmvn, then the context embeddings [lid, 1, 2, itn] in
        front -> (speech, lengths + 4)."""
        speech, speech_lengths = lfr(feats, feats_lengths)
        speech = self.global_cmvn(speech)
        B, dev = speech.shape[0], speech.device
        if lid_ids is None:
            lid_ids = torch.zeros(B, dtype=torch.long, device=dev)
        if itn_ids is None:
            itn_ids = torch.full((B,), TEXTNORM_DICT['woitn'],
                                 dtype=torch.long, device=dev)
        event_emo = torch.tensor([[1, 2]], device=dev).expand(B, 2)
        context = torch.cat([lid_ids[:, None].long(), event_emo,
                             itn_ids[:, None].long()], 1)
        speech = torch.cat([self.embed(context).to(speech.dtype), speech],
                           1)
        return speech, speech_lengths + N_CONTEXT

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk=None, lid_ids: Optional[torch.Tensor] = None,
                itn_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        speech, speech_lengths = self._frontend(feats, feats_lengths,
                                                lid_ids, itn_ids)
        encoder_out, encoder_mask = self.encoder(speech, speech_lengths)
        encoder_out_lens = encoder_mask[:, 0, :].sum(-1)
        loss_ctc_speech, _ = self.ctc(
            encoder_out[:, N_CONTEXT:], encoder_out_lens - N_CONTEXT,
            target[:, N_CONTEXT:], target_lengths - N_CONTEXT)
        loss_context = label_smoothing_loss(
            self.ctc.logits(encoder_out[:, :N_CONTEXT]),
            target[:, :N_CONTEXT], self.vocab_size, self.ignore_id,
            self.lsm_weight, self.length_normalized_loss)
        loss_ctc = loss_ctc_speech + loss_context
        loss, loss_att, acc_att = loss_ctc, None, None
        if self.ctc_weight != 1.0 and self.decoder is not None:
            loss_att, acc_att = self._calc_att_loss(
                encoder_out, encoder_mask, target, target_lengths,
                feats_lengths > 0)
            loss = (self.ctc_weight * loss_ctc +
                    (1 - self.ctc_weight) * loss_att)
        return {'loss': loss, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
                'loss_ctc_speech': loss_ctc_speech,
                'loss_context': loss_context, 'th_accuracy': acc_att}

    def forward_encoder(self, speech: torch.Tensor,
                        speech_lengths: torch.Tensor,
                        decoding_chunk_size: int = -1,
                        num_decoding_left_chunks: int = -1,
                        lid: str = 'auto', itn: str = 'woitn'):
        """The decode front end (language `lid`, normalization `itn`) and
        the encoder; the outputs keep the four context frames first."""
        B, dev = speech.shape[0], speech.device
        lid_ids = torch.full((B,), LID_DICT.get(lid, 0), device=dev)
        itn_ids = torch.full((B,), TEXTNORM_DICT.get(itn, 15), device=dev)
        speech, speech_lengths = self._frontend(speech, speech_lengths,
                                                lid_ids, itn_ids)
        return self.encoder(speech, speech_lengths)
