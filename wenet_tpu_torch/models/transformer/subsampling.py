"""Subsampling front ends.  Counterpart of
wenet_tpu/models/transformer/subsampling.py `Conv2dSubsampling4`, `6`
and `8`, and `Conv1dSubsampling2` (whisper), by config name in
`SUBSAMPLE_CLASSES` (the `linear`, `embed`, `conv2d2` and
`stack_n_frames` front ends are not ported: ROADMAP.md, queue 1 item 8).

The convs run NCHW; the (C, F) flatten is channel-major, the order the
JAX package reproduces from its NHWC layout, so converted weights of the
following Linear line up."""

from typing import Tuple, Union

import torch
from torch import nn


class _Conv2dSubsampling(nn.Module):
    """Stacked ReLU convs over (T, F), a Linear over the flattened
    channels, then the position encoding.  Subclasses set the convs'
    (kernel, stride) list, the Linear's name (the reference's: `out` is a
    Sequential for x4, `linear` a Linear for x6 and x8) and the mask's
    slices."""
    subsampling_rate = 1
    right_context = 0
    convs: Tuple[Tuple[int, int], ...] = ()
    mask_slices: Tuple[slice, ...] = ()

    def __init__(self, idim: int, odim: int, dropout_rate: float,
                 pos_enc: nn.Module):
        super().__init__()
        layers, f, cin = [], idim, 1
        for kernel, stride in self.convs:
            layers += [nn.Conv2d(cin, odim, kernel, stride), nn.ReLU()]
            f, cin = (f - kernel) // stride + 1, odim
        self.conv = nn.Sequential(*layers)
        self._make_linear(odim * f, odim)
        self.pos_enc = pos_enc

    def _make_linear(self, fan_in: int, odim: int):
        self.linear = nn.Linear(fan_in, odim)

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                offset: Union[int, torch.Tensor] = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, F); x_mask: (B, 1, T); offset: the position of the
        first output frame, or a (B,) tensor of them -> (x (B, T', D),
        pos_emb (1|B, T', D), mask (B, 1, T'))."""
        x = self.conv(x.unsqueeze(1))  # (B, C, T', F')
        b, c, t, f = x.shape
        x = self._project(x.transpose(1, 2).reshape(b, t, c * f))
        x, pos_emb = self.pos_enc(x, offset)
        for s in self.mask_slices:
            x_mask = x_mask[:, :, s]
        return x, pos_emb, x_mask

    def position_encoding(self, offset: Union[int, torch.Tensor], size: int,
                          device=None) -> torch.Tensor:
        return self.pos_enc.position_encoding(offset, size, device)


class Conv2dSubsampling4(_Conv2dSubsampling):
    """Two stride-2 3x3 convs -> 1/4 length."""
    subsampling_rate = 4
    right_context = 6
    convs = ((3, 2), (3, 2))
    mask_slices = (slice(2, None, 2), slice(2, None, 2))

    def _make_linear(self, fan_in: int, odim: int):
        self.out = nn.Sequential(nn.Linear(fan_in, odim))

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(x)


class Conv2dSubsampling6(_Conv2dSubsampling):
    """A stride-2 3x3 conv, then a stride-3 5x5 one -> 1/6 length."""
    subsampling_rate = 6
    right_context = 10
    convs = ((3, 2), (5, 3))
    mask_slices = (slice(2, None, 2), slice(4, None, 3))


class Conv2dSubsampling8(_Conv2dSubsampling):
    """Three stride-2 3x3 convs -> 1/8 length."""
    subsampling_rate = 8
    right_context = 14
    convs = ((3, 2), (3, 2), (3, 2))
    mask_slices = (slice(2, None, 2),) * 3


class Conv1dSubsampling2(nn.Module):
    """Whisper's front end: conv k3, then conv k3 stride 2, each followed
    by the exact GELU -> 1/2 length."""
    subsampling_rate = 2
    right_context = 4

    def __init__(self, idim: int, odim: int, dropout_rate: float,
                 pos_enc: nn.Module):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv1d(idim, odim, 3, padding=1), nn.GELU(),
            nn.Conv1d(odim, odim, 3, stride=2, padding=1), nn.GELU())
        self.pos_enc = pos_enc

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, T, F); x_mask: (B, 1, T) -> (x (B, T', D), pos_emb
        (1, T', D), mask (B, 1, T')), T' = ceil(T / 2)."""
        time = x.shape[1]
        x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        x, pos_emb = self.pos_enc(x)
        return x, pos_emb, x_mask[:, :, (time + 1) % 2::2]


SUBSAMPLE_CLASSES = {'conv1d2': Conv1dSubsampling2,
                     'conv2d': Conv2dSubsampling4,
                     'conv2d6': Conv2dSubsampling6,
                     'conv2d8': Conv2dSubsampling8}


def make_subsampling(input_layer: str, idim: int, odim: int,
                     dropout_rate: float, pos_enc: nn.Module) -> nn.Module:
    if input_layer not in SUBSAMPLE_CLASSES:
        raise NotImplementedError(f'input_layer={input_layer!r} is not '
                                  'ported (ROADMAP.md, queue 1 item 8)')
    return SUBSAMPLE_CLASSES[input_layer](idim, odim, dropout_rate, pos_enc)
