"""Continuous integrate-and-fire (CIF) predictor.  Counterpart of
wenet_tpu/models/paraformer/cif.py (`cif`, `cif_without_hidden`, `Cif`
with `compute_alphas` and `tail_process_fn`, `mae_loss`).

The integrate-and-fire recurrence stays sequential: one step per frame,
each adding the frame's alpha to the running total in float32 and firing
where it reaches the threshold, as the JAX scan does step for step.  A
parallel formulation (fires at the integer crossings of a cumulative
sum) loses the total's fraction at long T and moves fire positions
(BENCH_NOTES.md).  Only the weights come out of the loop: each frame
gives `cur` to the token being integrated and, where it fires, the rest
of its alpha to the next one, and the acoustic embeddings are then one
batched product of those weights with the hidden frames."""

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F


def _integrate(alphas: torch.Tensor, threshold: float):
    """The sequential recurrence over alphas (B, T) -> (fires: the total
    after each frame's alpha, before a fire subtracts 1; fired (B, T)
    bool; cur: the part of each frame's alpha that goes to the token it
    completes or continues)."""
    B, T = alphas.shape
    integrate = alphas.new_zeros(B)
    fires, fired, cur = [], [], []
    for t in range(T):
        alpha = alphas[:, t]
        completion = 1.0 - integrate
        integrate = integrate + alpha
        fire = integrate >= threshold
        fires.append(integrate)
        fired.append(fire)
        cur.append(torch.where(fire, completion, alpha))
        integrate = torch.where(fire, integrate - 1.0, integrate)
    return (torch.stack(fires, 1), torch.stack(fired, 1),
            torch.stack(cur, 1))


def cif(hidden: torch.Tensor, alphas: torch.Tensor, threshold: float,
        max_out_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden (B, T, D), alphas (B, T) -> (acoustic embeddings (B,
    max_out_len, D): the fired tokens in order, zeros after the last;
    fires (B, T), the integrated total at each frame)."""
    B, T, _ = hidden.shape
    fires, fired, cur = _integrate(alphas, threshold)
    rest = torch.where(fired, alphas - cur, torch.zeros_like(cur))
    # token index of each frame's `cur`: the fires before it
    token = torch.cumsum(fired.long(), 1) - fired.long()
    slots = torch.arange(max_out_len, device=hidden.device)
    weights = ((token[:, None, :] == slots[None, :, None]) * cur[:, None] +
               (token[:, None, :] + 1 == slots[None, :, None]) *
               rest[:, None])  # (B, U, T)
    n_fired = fired.sum(1)
    valid = slots[None, :] < n_fired[:, None]
    weights = weights * valid[:, :, None]
    frames = torch.bmm(weights.to(hidden.dtype), hidden)
    return frames, fires


def cif_without_hidden(alphas: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    """The integrated-alpha trace that timestamps read: (B, T) -> (B, T),
    the total after each frame, which falls by `threshold` where it
    fires.  Decode runs it on the host (the runner moves the alphas
    there first)."""
    integrate = alphas.new_zeros(alphas.shape[0])
    out = []
    for t in range(alphas.shape[1]):
        integrate = integrate + alphas[:, t]
        out.append(integrate)
        integrate = torch.where(integrate >= threshold,
                                integrate - threshold, integrate)
    return torch.stack(out, 1)


class Cif(nn.Module):
    """The CIF predictor: a depthwise conv over the encoder frames
    (+ the frames), relu, a sigmoid head -> one alpha per frame."""

    def __init__(self, idim: int, l_order: int, r_order: int,
                 threshold: float = 1.0, dropout: float = 0.1,
                 smooth_factor: float = 1.0, noise_threshold: float = 0.0,
                 tail_threshold: float = 0.45, residual: bool = True,
                 cnn_groups: int = 0):
        super().__init__()
        self.pad = (l_order, r_order)
        self.cif_conv1d = nn.Conv1d(idim, idim, l_order + r_order + 1,
                                    groups=cnn_groups or idim)
        self.cif_output = nn.Linear(idim, 1)
        self.dropout = nn.Dropout(dropout)
        self.threshold = threshold
        self.smooth_factor = smooth_factor
        self.noise_threshold = noise_threshold
        self.tail_threshold = tail_threshold
        self.residual = residual

    def compute_alphas(self, hidden: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """hidden (B, T, D), mask (B, 1, T) -> alphas (B, T)."""
        memory = self.cif_conv1d(F.pad(hidden.transpose(1, 2),
                                       self.pad)).transpose(1, 2)
        output = memory + hidden if self.residual else memory
        output = F.relu(self.dropout(output))
        alphas = torch.sigmoid(self.cif_output(output))
        alphas = F.relu(alphas * self.smooth_factor - self.noise_threshold)
        return alphas[:, :, 0] * mask[:, 0, :]

    def forward(self, hidden: torch.Tensor,
                target_label_length: Optional[torch.Tensor],
                mask: torch.Tensor, max_out_len: Optional[int] = None):
        """-> (acoustic embeddings (B, U, D), token_num (B,), alphas,
        fires).  With target lengths (training) the alphas are scaled to
        integrate to exactly them and U = max_out_len; without, the tail
        slot is appended (`tail_process_fn`) and U = max_out_len or the
        frames."""
        alphas = self.compute_alphas(hidden, mask)
        token_num = alphas.sum(-1)
        if target_label_length is not None:
            scale = target_label_length.to(alphas.dtype) / \
                token_num.clamp(min=1e-6)
            alphas = alphas * scale[:, None]
            out_len = max_out_len
        else:
            if self.tail_threshold > 0.0:
                hidden, alphas, token_num = self.tail_process_fn(
                    hidden, alphas, mask)
            out_len = max_out_len if max_out_len is not None else \
                hidden.shape[1]
        acoustic_embeds, fires = cif(hidden, alphas, self.threshold, out_len)
        return acoustic_embeds, token_num, alphas, fires

    def tail_process_fn(self, hidden: torch.Tensor, alphas: torch.Tensor,
                        mask: torch.Tensor):
        """Append one frame (zeros) whose alpha is tail_threshold right
        after each row's last valid frame -> (hidden (B, T+1, D), alphas
        (B, T+1), token_num = max(floor(sum of alphas), 1))."""
        B, _, D = hidden.shape
        m = mask[:, 0, :].to(alphas.dtype)
        zeros = alphas.new_zeros(B, 1)
        tail = (torch.cat([torch.ones_like(zeros), m], 1) -
                torch.cat([m, zeros], 1)) * self.tail_threshold
        alphas = torch.cat([alphas, zeros], 1) + tail
        hidden = torch.cat([hidden, hidden.new_zeros(B, 1, D)], 1)
        token_num = torch.floor(alphas.sum(-1)).clamp(min=1.0)
        return hidden, alphas, token_num


def mae_loss(token_length: torch.Tensor, pre_token_length: torch.Tensor,
             normalize_length: bool = False) -> torch.Tensor:
    denom = token_length.sum() if normalize_length else \
        token_length.shape[0]
    return (token_length.float() - pre_token_length.float()).abs().sum() / \
        denom
