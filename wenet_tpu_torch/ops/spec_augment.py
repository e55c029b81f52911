"""SpecAugment, SpecSub, SpecTrim and CMVN on batched device tensors, for
the on-device front end of the train step.  Counterpart of
wenet_tpu/ops/spec_augment.py.

Each augmentation is a draw and an apply.  The draw takes a few (B,)
integer tensors from a host `torch.Generator` (the train step's), so the
card and the CPU draw alike and no draw waits on the device; the apply
masks or substitutes frames on the features' device.  A caller may hand
the apply other draws of the same shapes, e.g. the JAX package's.  The
frames and bins outside the features (a start past the end, a width
past it) mask nothing, as there."""

from typing import Dict, Optional, Tuple

import torch

Draws = Dict[str, torch.Tensor]


def apply_cmvn(feats: torch.Tensor, mean: torch.Tensor,
               istd: torch.Tensor) -> torch.Tensor:
    return (feats - mean) * istd


def _randint(low: int, high, shape, generator) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=generator)


def spec_aug_draws(B: int, T: int, F: int, num_t_mask: int = 2,
                   num_f_mask: int = 2, max_t: int = 50, max_f: int = 10,
                   generator: Optional[torch.Generator] = None) -> Draws:
    """Each time band's start in [0, T) and width in [1, max_t], then each
    frequency band's in [0, F) and [1, max_f]: (num_masks, B) int64."""
    return {'t_start': _randint(0, max(T, 1), (num_t_mask, B), generator),
            't_width': _randint(1, max_t + 1, (num_t_mask, B), generator),
            'f_start': _randint(0, max(F, 1), (num_f_mask, B), generator),
            'f_width': _randint(1, max_f + 1, (num_f_mask, B), generator)}


def _bands(n: int, start: torch.Tensor, width: torch.Tensor,
           device) -> torch.Tensor:
    """(B, n) True inside any of the bands [start, start + width)."""
    idx = torch.arange(n, device=device)
    start = start.to(device)[..., None]
    end = start + width.to(device)[..., None]
    return ((idx >= start) & (idx < end)).any(0)


def spec_aug_apply(feats: torch.Tensor, draws: Draws) -> torch.Tensor:
    """feats (B, T, F) with the drawn time and frequency bands zeroed."""
    _, T, F = feats.shape
    t = _bands(T, draws['t_start'], draws['t_width'], feats.device)
    f = _bands(F, draws['f_start'], draws['f_width'], feats.device)
    return feats.masked_fill(t[:, :, None] | f[:, None, :], 0.0)


def spec_aug(feats: torch.Tensor, generator: Optional[torch.Generator],
             num_t_mask: int = 2, num_f_mask: int = 2, max_t: int = 50,
             max_f: int = 10) -> torch.Tensor:
    """Batched time and frequency masking (zero fill); feats (B, T, F)."""
    B, T, F = feats.shape
    return spec_aug_apply(feats, spec_aug_draws(
        B, T, F, num_t_mask, num_f_mask, max_t, max_f, generator))


def spec_sub_draws(B: int, T: int, max_t: int = 20, num_t_sub: int = 3,
                   generator: Optional[torch.Generator] = None) -> Draws:
    """Each band's start in [0, T), width in [1, max_t] and backward shift
    in [0, start]: (num_t_sub, B) int64."""
    start = _randint(0, T, (num_t_sub, B), generator)
    width = _randint(1, max_t + 1, (num_t_sub, B), generator)
    u = torch.rand((num_t_sub, B), generator=generator)
    pos = torch.floor(u * (start + 1).float()).long()
    return {'start': start, 'width': width, 'pos': pos}


def spec_sub_apply(feats: torch.Tensor, draws: Draws) -> torch.Tensor:
    """U2++'s SpecSub: band i of each row (in order, a later band over an
    earlier one) takes the frames `pos` before it, read from the features
    as given (never from a band already substituted)."""
    B, T, F = feats.shape
    idx = torch.arange(T, device=feats.device)
    x0, out = feats, feats
    for start, width, pos in zip(*(draws[k].to(feats.device)
                                   for k in ('start', 'width', 'pos'))):
        src = (idx[None, :] - pos[:, None]).clamp(min=0)
        substituted = torch.gather(x0, 1, src[:, :, None].expand(B, T, F))
        m = (idx[None, :] >= start[:, None]) & \
            (idx[None, :] < (start + width)[:, None])
        out = torch.where(m[:, :, None], substituted, out)
    return out


def spec_sub(feats: torch.Tensor, generator: Optional[torch.Generator],
             max_t: int = 20, num_t_sub: int = 3) -> torch.Tensor:
    B, T, _ = feats.shape
    return spec_sub_apply(feats, spec_sub_draws(B, T, max_t, num_t_sub,
                                                generator))


def spec_trim_draws(B: int, max_t: int = 20,
                    generator: Optional[torch.Generator] = None) -> Draws:
    """Each row's trim in [1, max_t]: (B,) int64."""
    return {'trim': _randint(1, max_t + 1, (B,), generator)}


def spec_trim_apply(feats: torch.Tensor, feats_lengths: torch.Tensor,
                    draws: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shorten each row's length by its trim where the trim is under half
    of it (at least one frame stays); the features are not touched."""
    trim = draws['trim'].to(feats_lengths.device)
    trim = torch.where(trim * 2 < feats_lengths, trim, 0)
    return feats, (feats_lengths - trim).clamp(min=1)


def spec_trim(feats: torch.Tensor, feats_lengths: torch.Tensor,
              generator: Optional[torch.Generator], max_t: int = 20
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return spec_trim_apply(feats, feats_lengths, spec_trim_draws(
        feats.shape[0], max_t, generator))
