"""Span masks and negative samples for SSL pretraining.  Counterpart of
wenet_tpu/models/ssl/mask.py, split in two: the uniforms are drawn on the
host's CPU from a `torch.Generator` (`mask_uniforms`,
`negative_uniforms`), and the masks and samples are computed from them
on any device (`compute_mask_indices`, `sample_negative_indices`).  So
the card and the CPU take the same masks from one generator, and the
tests hand the port the uniforms that the JAX package draws from its
key (`jax.random.split`, then `uniform`)."""

from typing import Optional, Tuple

import torch


def num_max_masks(T: int, mask_prob: float, mask_length: int,
                  min_masks: int) -> int:
    """The spans a row of T frames may hold: max(min_masks,
    int(mask_prob * T / mask_length) + 2)."""
    return max(min_masks, int(mask_prob * T / float(mask_length)) + 2)


def mask_uniforms(B: int, T: int, mask_prob: float, mask_length: int,
                  min_masks: int,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """U[0, 1) draws of `compute_mask_indices` on the host's CPU: (count
    (B,), starts (B, num_max_masks)), float32."""
    M = num_max_masks(T, mask_prob, mask_length, min_masks)
    return (torch.rand(B, generator=generator),
            torch.rand(B, M, generator=generator))


def compute_mask_indices(padding_mask: torch.Tensor, mask_prob: float,
                         mask_length: int, min_masks: int,
                         u_count: torch.Tensor,
                         u_start: torch.Tensor) -> torch.Tensor:
    """padding_mask: (B, T) True at PAD -> bool span mask (B, T).

    Per row: num_mask = max(min_masks, floor(mask_prob * sz / mask_length
    + u_count)) spans (at most `num_max_masks`) of `mask_length` frames,
    starting at int(u_start * max(sz - mask_length, 1)), where sz is the
    row's valid length; the padding is never masked."""
    B, T = padding_mask.shape
    device = padding_mask.device
    u_count = u_count.to(device, torch.float32)
    u_start = u_start.to(device, torch.float32)
    sz = T - padding_mask.sum(1).to(torch.int32)
    szf = sz.to(torch.float32)
    num_mask = torch.clamp(
        torch.floor(mask_prob * szf / float(mask_length) + u_count),
        min=min_masks).to(torch.int32)
    M = num_max_masks(T, mask_prob, mask_length, min_masks)
    if u_start.shape != (B, M):
        raise ValueError(f'u_start {tuple(u_start.shape)}, expected '
                         f'{(B, M)}')
    num_mask = num_mask.clamp(max=M)
    hi = (sz - mask_length).clamp(min=1).to(torch.float32)
    # the product is positive: int32 truncation is the floor, as astype
    starts = (u_start * hi[:, None]).to(torch.int32)
    span_valid = (torch.arange(M, device=device)[None, :] <
                  num_mask[:, None])
    t = torch.arange(T, device=device)[None, None, :]
    s = starts[:, :, None]
    covered = (t >= s) & (t < s + mask_length) & span_valid[:, :, None]
    return covered.any(1) & ~padding_mask


def negative_uniforms(B: int, T: int, num_negatives: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """U[0, 1) draws of `sample_negative_indices` on the host's CPU:
    (B, T, num_negatives) float32."""
    return torch.rand(B, T, num_negatives, generator=generator)


def sample_negative_indices(mask: torch.Tensor, num_negatives: int,
                            r: torch.Tensor) -> torch.Tensor:
    """(B, T * num_negatives) flat indices into (B * T, ...) features.

    Negatives come only from the masked positions of the same row, the
    anchor itself excluded: with cnt masked frames a row draws int(r *
    max(cnt - 1, 1)), skips the anchor's own index among the masked ones
    (+1 from it on) and reads that masked position (packed to the front
    by a stable sort, in frame order)."""
    mask = mask.bool()
    B, T = mask.shape
    r = r.to(mask.device, torch.float32)
    cnt = mask.sum(-1)
    masked_pos = torch.argsort((~mask).to(torch.uint8), dim=-1,
                               stable=True)
    order = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    high = (cnt - 1).clamp(min=1)[:, None, None]
    samp = (r * high).to(torch.int64)
    samp = torch.where(samp >= order[:, :, None], samp + 1, samp)
    samp = torch.minimum(samp.clamp(min=0),
                         (cnt - 1).clamp(min=0)[:, None, None])
    neg = torch.gather(masked_pos, -1, samp.reshape(B, -1)).reshape(
        B, T, num_negatives)
    offset = (torch.arange(B, device=mask.device) * T)[:, None, None]
    return (neg + offset).reshape(B, T * num_negatives)
