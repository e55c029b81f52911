"""CTC head and loss.  Counterpart of wenet_tpu/models/transformer/ctc.py.
The decode heads project the whole (B, T, V) posterior: the JAX package's
T-chunked heads bound a TPU's VMEM, and on an H100 the dense head was the
faster one at every batch measured (PERF.md)."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.utils.mask import make_pad_mask
from wenet_tpu_torch.parallel.mesh import data_denominator


class CTC(nn.Module):

    def __init__(self, odim: int, encoder_output_size: int,
                 blank_id: int = 0):
        super().__init__()
        self.blank_id = blank_id
        self.ctc_lo = nn.Linear(encoder_output_size, odim)

    def forward(self, hs_pad: torch.Tensor, hlens: torch.Tensor,
                ys_pad: torch.Tensor, ys_lens: torch.Tensor,
                row_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (batch-averaged CTC loss, log-probs (B, T, V)).

        ys_pad may be IGNORE_ID padded; pads are masked via ys_lens.
        Infeasible sequences (hlens < ys_lens + adjacent repeats) are
        zeroed explicitly, as the JAX package does; rows with row_valid
        False (zero-length dummies) leave numerator and denominator.  Both
        kinds enter F.ctc_loss with an empty target, so their loss and its
        gradient stay finite before they are zeroed."""
        per_seq, logprobs = self.loss_per_sequence(hs_pad, hlens, ys_pad,
                                                   ys_lens, row_valid)
        denom = (hs_pad.shape[0] if row_valid is None else
                 data_denominator(row_valid.sum()))
        return per_seq.sum() / denom, logprobs

    def loss_per_sequence(self, hs_pad: torch.Tensor, hlens: torch.Tensor,
                          ys_pad: torch.Tensor, ys_lens: torch.Tensor,
                          row_valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (the CTC loss of each row (B,), 0 for infeasible and invalid
        rows, as `forward` counts them; fp32 log-probs (B, T, V))."""
        logprobs = F.log_softmax(self.ctc_lo(hs_pad).float(), dim=-1)
        label_pad = make_pad_mask(ys_lens, ys_pad.shape[1])
        labels = ys_pad.masked_fill(label_pad, self.blank_id).long()
        same = (labels[:, 1:] == labels[:, :-1]) & ~label_pad[:, 1:]
        use = hlens >= ys_lens + same.sum(1)
        if row_valid is not None:
            use = use & row_valid
        per_seq = F.ctc_loss(
            logprobs.transpose(0, 1), labels,
            torch.where(use, hlens, hlens.clamp(min=1)).long(),
            torch.where(use, ys_lens, 0).long(), blank=self.blank_id,
            reduction='none', zero_infinity=False)
        per_seq = torch.where(use & torch.isfinite(per_seq), per_seq, 0.0)
        return per_seq, logprobs

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
