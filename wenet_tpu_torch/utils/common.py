"""Label utilities for the attention and transducer losses.  Counterpart
of wenet_tpu/utils/common.py `add_sos_eos`, `reverse_pad_list`,
`th_accuracy` and `add_blank`: fixed-shape tensor transforms, no Python
lists."""

from typing import Tuple

import torch

from wenet_tpu_torch.parallel.mesh import data_denominator

IGNORE_ID = -1


def add_sos_eos(ys_pad: torch.Tensor, sos: int, eos: int,
                ignore_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """<sos>/<eos> insertion on ignore_id-padded labels ys_pad (B, L):
      ys_in  (B, L+1): [sos, y..., eos-pad]
      ys_out (B, L+1): [y..., eos, ignore-pad]"""
    B, L = ys_pad.shape
    lens = (ys_pad != ignore_id).sum(1, keepdim=True)
    sos_col = ys_pad.new_full((B, 1), sos)
    ys_in = torch.cat([sos_col, ys_pad.masked_fill(ys_pad == ignore_id, eos)],
                      dim=1)
    j = torch.arange(L + 1, device=ys_pad.device)[None, :]
    ys_ext = torch.cat([ys_pad, ys_pad.new_full((B, 1), ignore_id)], dim=1)
    ys_out = torch.where(j < lens, ys_ext,
                         torch.where(j == lens, eos, ignore_id))
    return ys_in, ys_out.to(ys_pad.dtype)


def reverse_pad_list(ys_pad: torch.Tensor, ys_lens: torch.Tensor,
                     pad_value: int = -1) -> torch.Tensor:
    """Reverse the valid prefix of every row, pad the rest."""
    L = ys_pad.shape[1]
    j = torch.arange(L, device=ys_pad.device)[None, :]
    idx = ys_lens[:, None] - 1 - j
    gathered = torch.gather(ys_pad, 1, idx.clamp(min=0))
    return torch.where(idx >= 0, gathered, pad_value).to(ys_pad.dtype)


def th_accuracy(pad_outputs: torch.Tensor, pad_targets: torch.Tensor,
                ignore_label: int) -> torch.Tensor:
    """Token accuracy over non-ignored positions; pad_outputs (B, L, V)
    logits, pad_targets (B, L).  A 0-d float tensor (no host sync)."""
    pred = pad_outputs.argmax(dim=-1)
    mask = pad_targets != ignore_label
    num = ((pred == pad_targets) & mask).sum()
    return num / data_denominator(mask.sum())


def add_blank(ys_pad: torch.Tensor, blank: int,
              ignore_id: int) -> torch.Tensor:
    """The transducer predictor's input: a blank column prepended to
    ignore_id-padded labels (B, L), pads turned to blank -> (B, L+1)."""
    col = ys_pad.new_full((ys_pad.shape[0], 1), blank)
    out = torch.cat([col, ys_pad], dim=1)
    return out.masked_fill(out == ignore_id, blank)
