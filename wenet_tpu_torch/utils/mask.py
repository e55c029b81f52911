"""Mask construction.  Counterpart of wenet_tpu/utils/mask.py.

Masks are boolean with True == attend (valid), as in the JAX package,
except `make_pad_mask`, which is True at padded positions.
"""

import torch


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, max_len) True at PADDED positions."""
    seq = torch.arange(max_len, device=lengths.device)
    return seq[None, :] >= lengths[:, None]


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask (size, size)."""
    i = torch.arange(size, device=device)
    return i[None, :] <= i[:, None]


def subsequent_chunk_mask(size: int, chunk_size: int,
                          num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """Chunk-causal mask (size, size): row i attends keys in
    [max((i//chunk - num_left_chunks) * chunk, 0), (i//chunk + 1) * chunk)."""
    idx = torch.arange(size, device=device)
    chunk_of = idx // chunk_size
    ending = (chunk_of + 1) * chunk_size
    if num_left_chunks < 0:
        start = torch.zeros_like(idx)
    else:
        start = ((chunk_of - num_left_chunks) * chunk_size).clamp(min=0)
    j = idx[None, :]
    return (j >= start[:, None]) & (j < ending[:, None])


def add_optional_chunk_mask(masks: torch.Tensor, use_dynamic_chunk: bool,
                            decoding_chunk_size: int,
                            num_decoding_left_chunks: int) -> torch.Tensor:
    """Combine the (B, 1, L) pad mask with the decode-time chunk mask.

    A model trained with dynamic chunks and decoded with
    `decoding_chunk_size` > 0 gets the (B, L, L) chunk mask; every other
    case decodes with full context and gets the (B, 1, L) pad mask itself
    (the JAX package broadcasts it to (B, L, L); attention reads both the
    same).  Decode only: the random chunk draw of dynamic-chunk training
    and the `static_chunk_size` encoder option are not ported."""
    if not (use_dynamic_chunk and decoding_chunk_size > 0):
        return masks
    L = masks.shape[-1]
    return masks & subsequent_chunk_mask(L, decoding_chunk_size,
                                         num_decoding_left_chunks,
                                         masks.device)[None]
