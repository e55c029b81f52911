"""CTC head.  Counterpart of wenet_tpu/models/transformer/ctc.py
(decode-side heads; the loss and the T-chunked heads are not ported
yet)."""

import torch
from torch import nn
import torch.nn.functional as F


class CTC(nn.Module):

    def __init__(self, odim: int, encoder_output_size: int):
        super().__init__()
        self.ctc_lo = nn.Linear(encoder_output_size, odim)

    def logits(self, hs_pad: torch.Tensor, blank_penalty: float = 0.0,
               blank_id: int = 0) -> torch.Tensor:
        logits = self.ctc_lo(hs_pad)
        if blank_penalty > 0.0:
            logits[..., blank_id] -= blank_penalty
        return logits

    def log_softmax(self, hs_pad: torch.Tensor, blank_penalty: float = 0.0,
                    blank_id: int = 0) -> torch.Tensor:
        """(B, T, V) log-posteriors, blank logit lowered by the penalty."""
        return F.log_softmax(self.logits(hs_pad, blank_penalty, blank_id),
                             dim=-1)

    def argmax(self, hs_pad: torch.Tensor, blank_penalty: float = 0.0,
               blank_id: int = 0) -> torch.Tensor:
        """(B, T) greedy ids; log_softmax is a per-frame shift, so the
        argmax of the logits is the same."""
        return self.logits(hs_pad, blank_penalty, blank_id).argmax(dim=-1)

    def topk(self, hs_pad: torch.Tensor, k: int, blank_penalty: float = 0.0,
             blank_id: int = 0):
        """Per-frame (log-prob values, ids), each (B, T, k)."""
        return torch.topk(self.log_softmax(hs_pad, blank_penalty, blank_id),
                          k, dim=-1)
