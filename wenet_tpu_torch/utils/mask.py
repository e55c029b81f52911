"""Mask construction.  Counterpart of wenet_tpu/utils/mask.py.

Masks are boolean with True == attend (valid), as in the JAX package,
except `make_pad_mask`, which is True at padded positions.
"""

from typing import Optional, Tuple

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


def draw_dynamic_chunk(max_len: int, use_dynamic_left_chunk: bool,
                       generator: Optional[torch.Generator] = None,
                       max_chunk_size: int = 25) -> Tuple[int, int]:
    """The dynamic-chunk training draw, on the host: chunk ~ U[1, L); full
    context (chunk = L) when the draw exceeds L // 2, else
    draw % max_chunk_size + 1; with `use_dynamic_left_chunk`, a left-chunk
    count ~ U[0, (L - 1) // chunk), -1 (all) for full context.
    -> (chunk_size, num_left_chunks)."""
    draw = int(torch.randint(1, max(max_len, 2), (), generator=generator))
    chunk = max_len if draw > max_len // 2 else draw % max_chunk_size + 1
    left = -1
    if use_dynamic_left_chunk and chunk != max_len:
        max_left = (max_len - 1) // chunk
        left = int(torch.randint(0, max(max_left, 1), (),
                                 generator=generator))
    return chunk, left


def add_optional_chunk_mask(masks: torch.Tensor, use_dynamic_chunk: bool,
                            use_dynamic_left_chunk: bool,
                            decoding_chunk_size: int,
                            num_decoding_left_chunks: int,
                            generator: Optional[torch.Generator] = None,
                            dynamic_chunk: Optional[Tuple[int, int]] = None,
                            max_chunk_size: int = 25,
                            static_chunk_size: int = 0) -> torch.Tensor:
    """Combine the (B, 1, L) pad mask with the chunk mask of a chunked
    model.

    A dynamic-chunk model decoding with `decoding_chunk_size` > 0 uses
    that chunk; training (`decoding_chunk_size` == 0) uses `dynamic_chunk`
    = (chunk_size, num_left_chunks) when given, else draws it from
    `generator` (`draw_dynamic_chunk`).  A model that is not dynamic and
    has a `static_chunk_size` > 0 always uses that chunk, with
    `num_decoding_left_chunks`, as the JAX package does (mask.py:117).  A
    chunked case gets the (B, L, L) mask; full context (no chunk,
    decoding_chunk_size < 0 of a dynamic model, no draw, or a draw of the
    full length) gets the (B, 1, L) pad mask itself (the JAX package
    broadcasts it to (B, L, L); attention reads both the same)."""
    L = masks.shape[-1]
    if not use_dynamic_chunk:
        if static_chunk_size <= 0:
            return masks
        chunk, left = static_chunk_size, num_decoding_left_chunks
    elif decoding_chunk_size < 0:
        return masks
    elif decoding_chunk_size > 0:
        chunk, left = decoding_chunk_size, num_decoding_left_chunks
    elif dynamic_chunk is not None:
        chunk, left = dynamic_chunk
    elif generator is not None:
        chunk, left = draw_dynamic_chunk(L, use_dynamic_left_chunk,
                                         generator, max_chunk_size)
    else:
        return masks
    if chunk >= L and left < 0:
        return masks
    return masks & subsequent_chunk_mask(L, chunk, left, masks.device)[None]


def mask_finished_scores(score: torch.Tensor,
                         flag: torch.Tensor) -> torch.Tensor:
    """For finished beams keep only branch 0 alive, at score 0.
    score: (R, N) top-k log-probs; flag: (R, 1) finished."""
    col = torch.arange(score.shape[-1], device=score.device)[None, :]
    score = score.masked_fill(flag & (col > 0), -float('inf'))
    return score.masked_fill(flag & (col == 0), 0.0)


def mask_finished_preds(pred: torch.Tensor, flag: torch.Tensor,
                        eos: int) -> torch.Tensor:
    """Finished beams only emit <eos>."""
    return pred.masked_fill(flag, eos)
