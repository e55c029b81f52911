"""Global CMVN.  Counterpart of wenet_tpu/models/transformer/cmvn.py."""

import torch
from torch import nn


class GlobalCMVN(nn.Module):
    """(x - mean) * istd over the feature dim; mean/istd are buffers."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer('mean', torch.zeros(dim))
        self.register_buffer('istd', torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean.to(x.dtype)) * self.istd.to(x.dtype)
