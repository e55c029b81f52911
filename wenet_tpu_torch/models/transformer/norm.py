"""Norm factory.  Counterpart of wenet_tpu/models/transformer/norm.py
`get_norm` (the reference's WENET_NORM_CLASSES) for `layer_norm`, and
the conv modules' `batch_norm`.  RMSNorm is not ported (ROADMAP.md,
queue 1 item 8)."""

from torch import nn


def get_norm(norm_type: str, dim: int, eps: float = 1e-5) -> nn.Module:
    """nn.LayerNorm over the last dim, or nn.BatchNorm1d over the channels
    of (B, C, T) (its caller transposes)."""
    if norm_type == 'layer_norm':
        return nn.LayerNorm(dim, eps=eps)
    if norm_type == 'batch_norm':
        return nn.BatchNorm1d(dim, eps=eps)
    raise NotImplementedError(f'norm {norm_type!r} is not ported '
                              '(ROADMAP.md, queue 1 item 8)')


def channel_norm(norm: nn.Module, x):
    """Apply `get_norm`'s module to channels-first x (B, C, T)."""
    if isinstance(norm, nn.LayerNorm):
        return norm(x.transpose(1, 2)).transpose(1, 2)
    return norm(x)
