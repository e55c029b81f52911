"""Label-smoothing KL loss.  Counterpart of
wenet_tpu/models/transformer/label_smoothing_loss.py: the KL against the
smoothed one-hot in closed form from the log-softmax, no dense
true-distribution tensor."""

import math
from typing import Optional

import torch
import torch.nn.functional as F


def label_smoothing_loss(logits: torch.Tensor, target: torch.Tensor,
                         size: int, padding_idx: int, smoothing: float,
                         normalize_length: bool = False,
                         num_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """logits: (B, L, V); target: (B, L) with padding_idx pads.

    Sum of KL(p || q) over the non-padded positions, p the smoothed
    one-hot (the constant entropy of p included, as torch's KLDivLoss
    has it), divided by the number of tokens (normalize_length), or by
    num_valid (the count of real rows) when given, or by B."""
    confidence = 1.0 - smoothing
    low = smoothing / (size - 1)
    logp = F.log_softmax(logits.float(), dim=-1)
    ignore = target == padding_idx
    tgt = target.masked_fill(ignore, 0)
    logp_true = logp.gather(-1, tgt[..., None]).squeeze(-1)
    cross = -(confidence * logp_true + low * (logp.sum(-1) - logp_true))
    ent = confidence * math.log(confidence) if confidence > 0 else 0.0
    ent += (size - 1) * low * math.log(low) if low > 0 else 0.0
    kl = (cross + ent).masked_fill(ignore, 0.0)
    if normalize_length:
        denom = (~ignore).sum().clamp(min=1)
    elif num_valid is not None:
        denom = num_valid.clamp(min=1)
    else:
        denom = logits.shape[0]
    return kl.sum() / denom
