"""Global CMVN.  Counterpart of wenet_tpu/models/transformer/cmvn.py."""

import torch
from torch import nn


class GlobalCMVN(nn.Module):
    """(x - mean) * istd over the feature dim (x - mean without
    `norm_var`); mean/istd are buffers."""

    def __init__(self, dim: int, norm_var: bool = True):
        super().__init__()
        self.norm_var = norm_var
        self.register_buffer('mean', torch.zeros(dim))
        self.register_buffer('istd', torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x - self.mean.to(x.dtype)
        return x * self.istd.to(x.dtype) if self.norm_var else x
