"""Hybrid CTC/attention ASR model (U2/U2++), decode-side methods.
Counterpart of wenet_tpu/models/transformer/asr_model.py:169-245 (the
training losses are not ported yet)."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F


class ASRModel(nn.Module):

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: nn.Module, ctc: nn.Module,
                 special_tokens: Optional[dict] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder = encoder
        self.decoder = decoder
        self.ctc = ctc
        tokens = special_tokens or {}
        self.sos = tokens.get('<sos>', vocab_size - 1)
        self.eos = tokens.get('<eos>', vocab_size - 1)

    def forward_encoder(self, speech: torch.Tensor,
                        speech_lengths: torch.Tensor,
                        decoding_chunk_size: int = -1,
                        num_decoding_left_chunks: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(speech, speech_lengths, decoding_chunk_size,
                            num_decoding_left_chunks)

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
