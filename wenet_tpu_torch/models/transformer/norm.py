"""Norm factory.  Counterpart of wenet_tpu/models/transformer/norm.py
(`RMSNorm`, `get_norm`: the reference's WENET_NORM_CLASSES) for
`layer_norm` and `rms_norm`, and the conv modules' `batch_norm`."""

import torch
import torch.nn.functional as F
from torch import nn

from wenet_tpu_torch.parallel.mesh import data_batch_stats


class BatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d whose running variance follows the batch's biased
    variance, as flax's BatchNorm (the JAX package's conv module,
    convolution.py:78) updates it; torch's own takes the unbiased one.
    Normalization and parameters are nn.BatchNorm1d's.  In a
    data-parallel train step the statistics are those of the global batch
    (summed over every rank on `data`), as GSPMD computes the JAX
    package's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        stats = data_batch_stats(x, (0, 2))
        if stats is not None:
            mean, var = stats
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
                self.num_batches_tracked += 1
            y = (x.float() - mean[:, None]) * torch.rsqrt(
                var[:, None] + self.eps)
            return (y * self.weight[:, None] + self.bias[:, None]).to(
                x.dtype)
        with torch.no_grad():
            xf = x.float()
            self.running_mean.lerp_(xf.mean(dim=(0, 2)), self.momentum)
            self.running_var.lerp_(xf.var(dim=(0, 2), unbiased=False),
                                   self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class RMSNorm(nn.Module):
    """x / rms(x) over the last dim, computed in fp32, times `weight`, or
    times (1 + `weight`) with `add_unit_offset` (the JAX package's
    default; its flax `scale` is this `weight` unchanged)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 add_unit_offset: bool = True):
        super().__init__()
        self.eps = eps
        self.add_unit_offset = add_unit_offset
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        w = 1 + self.weight if self.add_unit_offset else self.weight
        return xf.to(x.dtype) * w.to(x.dtype)

    def init_own(self, generator=None):
        """Ones, flax's init of `scale`."""
        with torch.no_grad():
            self.weight.fill_(1.0)
        return [self.weight]


def get_norm(norm_type: str, dim: int, eps: float = 1e-5) -> nn.Module:
    """nn.LayerNorm or RMSNorm (with its unit offset, as every JAX layer
    builds it) over the last dim, or nn.BatchNorm1d over the channels of
    (B, C, T) (its caller transposes for the others)."""
    if norm_type == 'layer_norm':
        return nn.LayerNorm(dim, eps=eps)
    if norm_type == 'rms_norm':
        return RMSNorm(dim, eps)
    if norm_type == 'batch_norm':
        return BatchNorm1d(dim, eps=eps)
    raise ValueError(f'unknown norm {norm_type!r}')


def channel_norm(norm: nn.Module, x):
    """Apply `get_norm`'s module to channels-first x (B, C, T)."""
    if isinstance(norm, (nn.LayerNorm, RMSNorm)):
        return norm(x.transpose(1, 2)).transpose(1, 2)
    return norm(x)
