"""Positional encodings.  Counterpart of
wenet_tpu/models/transformer/embedding.py (absolute, rel-pos, whisper's
[sin | cos] and the learnable table of whisper's decoder) and of
`make_pos_enc` (wenet_tpu/models/transformer/encoder.py).

The sinusoidal encodings are computed for each call from the sequence
length; no position table is stored, so their state dict has no `pe`
entry.  The learnable encoding's table is its `pe` parameter."""

import math
from typing import Tuple, Union

import torch
from torch import nn


def sinusoidal_position_encoding(size: int, d_model: int, device=None,
                                 offset: Union[int, torch.Tensor] = 0
                                 ) -> torch.Tensor:
    """Interleaved sin/cos encoding of positions [offset, offset + size):
    an int offset gives (1, size, d), a (B,) integer tensor of offsets
    (one per stream of a batched chunk step) gives (B, size, d).
    Negative positions (a streaming chunk step's empty cache slots) read
    position 0, as in the JAX package."""
    if isinstance(offset, torch.Tensor):
        pos = (offset.to(device)[:, None] +
               torch.arange(size, device=device)[None, :])
    else:
        pos = torch.arange(offset, offset + size, device=device)[None, :]
    pos = pos.clamp(min=0).float()
    div = torch.exp(
        torch.arange(0, d_model, 2, device=device, dtype=torch.float32) *
        (-math.log(10000.0) / d_model))
    ang = pos[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).reshape(pos.shape[0], size, d_model)


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + PE (`abs_pos`).  Returns (x, pos_emb)."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.xscale = math.sqrt(d_model)
        self.dropout = nn.Dropout(dropout_rate)

    def position_encoding(self, offset: Union[int, torch.Tensor], size: int,
                          device=None) -> torch.Tensor:
        """(1, size, d) encoding of positions [offset, offset + size), or
        (B, size, d) for a (B,) tensor of offsets."""
        return sinusoidal_position_encoding(size, self.d_model, device,
                                            offset)

    def forward(self, x: torch.Tensor,
                offset: Union[int, torch.Tensor] = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos_emb = self.position_encoding(offset, x.shape[1],
                                         x.device).to(x.dtype)
        return self.dropout(x * self.xscale + pos_emb), self.dropout(pos_emb)


class RelPositionalEncoding(PositionalEncoding):
    """Transformer-XL style (`rel_pos`): scale x, return the PE
    separately."""

    def forward(self, x: torch.Tensor,
                offset: Union[int, torch.Tensor] = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos_emb = self.position_encoding(offset, x.shape[1],
                                         x.device).to(x.dtype)
        return self.dropout(x * self.xscale), self.dropout(pos_emb)


def whisper_position_encoding(size: int, d_model: int,
                              device=None) -> torch.Tensor:
    """Whisper's [sin | cos] encoding (not interleaved; log step over
    d/2 - 1) of positions [0, size) -> (1, size, d)."""
    log_inc = math.log(10000.0) / (d_model // 2 - 1)
    inv = torch.exp(-log_inc * torch.arange(d_model // 2, device=device,
                                            dtype=torch.float32))
    ang = torch.arange(size, device=device, dtype=torch.float32)[:, None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]


class WhisperPositionalEncoding(PositionalEncoding):
    """x + PE, no x-scale (whisper's encoder)."""

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pos_emb = whisper_position_encoding(x.shape[1], self.d_model,
                                            x.device).to(x.dtype)
        return self.dropout(x + pos_emb), self.dropout(pos_emb)


def make_pos_enc(pos_enc_layer_type: str, output_size: int,
                 positional_dropout_rate: float) -> nn.Module:
    """The encoder's position encoding by config name.  Counterpart of
    wenet_tpu/models/transformer/encoder.py `make_pos_enc`."""
    if pos_enc_layer_type == 'abs_pos':
        return PositionalEncoding(output_size, positional_dropout_rate)
    if pos_enc_layer_type == 'rel_pos':
        return RelPositionalEncoding(output_size, positional_dropout_rate)
    if pos_enc_layer_type == 'abs_pos_whisper':
        return WhisperPositionalEncoding(output_size, positional_dropout_rate)
    if pos_enc_layer_type in ('rope_pos', 'no_pos'):
        raise NotImplementedError(f'pos_enc_layer_type='
                                  f'{pos_enc_layer_type!r} is not ported '
                                  '(ROADMAP.md, queue 1 item 8)')
    raise ValueError(pos_enc_layer_type)


class LearnablePositionalEncoding(nn.Module):
    """x + a learned (1, max_len, d) table (whisper's decoder).

    Positions past `max_len` read NaN, as the JAX package's `jnp.take`
    fills out-of-range rows; negative positions read row 0."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0,
                 max_len: int = 448):
        super().__init__()
        self.max_len = max_len
        self.pe = nn.Parameter(torch.empty(1, max_len, d_model))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, offset: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = torch.arange(offset, offset + x.shape[1], device=x.device)
        rows = self.pe[0, idx.clamp(0, self.max_len - 1)]
        pos_emb = torch.where((idx < self.max_len)[:, None], rows,
                              float('nan'))[None].to(x.dtype)
        return self.dropout(x + pos_emb), self.dropout(pos_emb)
