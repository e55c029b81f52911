"""Streaming loops over the fixed-shape chunk step.  Counterpart of
wenet_tpu/models/transformer/streaming.py: the chunk geometry, the
encoder's cache state, the validity mask of the right-aligned cache
window and the simulate-streaming forward over a whole utterance."""

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclass
class StreamingConfig:
    decoding_chunk_size: int  # encoder frames per chunk (e.g. 16)
    num_decoding_left_chunks: int = -1  # < 0: a cache of max_left_frames
    subsampling_rate: int = 4
    right_context: int = 6
    max_left_frames: int = 512  # the cache when num_decoding_left_chunks < 0

    @property
    def required_cache_size(self) -> int:
        if self.num_decoding_left_chunks < 0:
            return self.max_left_frames
        return self.decoding_chunk_size * self.num_decoding_left_chunks

    @property
    def stride(self) -> int:
        """Feature frames between the starts of two chunks."""
        return self.subsampling_rate * self.decoding_chunk_size

    @property
    def decoding_window(self) -> int:
        """Feature frames one chunk reads."""
        return ((self.decoding_chunk_size - 1) * self.subsampling_rate +
                self.right_context + 1)


class StreamingEncoderState:
    """The caches of one stream between chunk steps."""

    def __init__(self, att_cache, cnn_cache, offset: int = 0,
                 valid_cache: int = 0):
        self.att_cache = att_cache
        self.cnn_cache = cnn_cache
        self.offset = offset
        self.valid_cache = valid_cache  # valid slots in the att cache


def init_streaming_state(encoder, batch_size: int, cfg: StreamingConfig,
                         dtype=torch.float32,
                         device=None) -> StreamingEncoderState:
    att_cache, cnn_cache = encoder.zero_cache(
        batch_size, cfg.required_cache_size, dtype, device)
    return StreamingEncoderState(att_cache, cnn_cache)


def streaming_att_mask(batch_size: int, cache_size: int, chunk_out: int,
                       valid_cache, valid_chunk=None,
                       device=None) -> torch.Tensor:
    """(B, 1, cache_size + chunk_out) bool: the first cache_size -
    valid_cache slots of the right-aligned cache window are off, and with
    `valid_chunk` (< chunk_out in a zero-padded tail chunk) so are the
    chunk's pad frames.  `valid_cache` and `valid_chunk` are ints, shared
    by every row, or (B,) tensors on `device`, one per row (the batch
    runner's sessions).  All three counts are at the encoder's base
    resolution, after the front end, for every encoder of the zoo (the
    efficient conformer's caches too, whose layers after a stride read
    every f-th slot).  Built on `device`, so ints cost no transfer."""
    idx = torch.arange(cache_size + chunk_out, device=device)
    if isinstance(valid_cache, torch.Tensor):
        valid_cache = valid_cache.clamp(max=cache_size)[:, None]
    else:
        valid_cache = min(valid_cache, cache_size)
    valid = idx >= cache_size - valid_cache
    if valid_chunk is not None:
        if isinstance(valid_chunk, torch.Tensor):
            valid_chunk = valid_chunk[:, None]
        valid = valid & (idx < cache_size + valid_chunk)
    return valid.reshape(-1, 1, cache_size + chunk_out).expand(
        batch_size, 1, cache_size + chunk_out)


def forward_chunk_by_chunk(model, xs: torch.Tensor, cfg: StreamingConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulated streaming over whole utterances: xs (B, T_frames, F),
    every row T_frames long -> (ys (B, T_out, D), masks (1, 1, T_out)).

    Chunks of `decoding_window` frames every `stride` frames, each through
    `model.forward_encoder_chunk` with the caches of the chunks before it;
    the tail chunk is zero padded to the window and its pad masked.  No
    subsampling cache: the windows overlap, as in the reference.  An
    encoder that downsamples inside its trunk (the efficient conformer's
    `output_downsampling_factor` f) emits ceil(base / f) frames of each
    chunk's base frames: its caches and masks stay at the base
    resolution, and `offset` counts the frames it emitted."""
    enc = model.encoder
    cache_size = cfg.required_cache_size
    B, num_frames = xs.shape[0], xs.shape[1]
    state = init_streaming_state(enc, B, cfg, xs.dtype, xs.device)
    context = cfg.right_context + 1
    chunk_out = (cfg.decoding_window - context) // cfg.subsampling_rate + 1
    factor = enc.output_downsampling_factor
    outputs = []
    for cur in range(0, num_frames - context + 1, cfg.stride):
        chunk_xs = xs[:, cur:cur + cfg.decoding_window]
        real_base = (chunk_xs.shape[1] - context) // cfg.subsampling_rate + 1
        real_out = -(-real_base // factor)
        pad = cfg.decoding_window - chunk_xs.shape[1]
        if pad > 0:
            chunk_xs = F.pad(chunk_xs, (0, 0, 0, pad))
        att_mask = streaming_att_mask(B, cache_size, chunk_out,
                                      state.valid_cache, real_base,
                                      xs.device)
        ys, state.att_cache, state.cnn_cache = model.forward_encoder_chunk(
            chunk_xs, state.offset, state.att_cache, state.cnn_cache,
            att_mask)
        outputs.append(ys[:, :real_out])
        state.offset += real_out
        state.valid_cache = min(state.valid_cache + real_base, cache_size)
    ys = torch.cat(outputs, dim=1)
    return ys, torch.ones(1, 1, ys.shape[1], dtype=torch.bool,
                          device=ys.device)
