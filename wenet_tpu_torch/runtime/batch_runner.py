"""Cross-stream batching of streaming sessions.  Counterpart of
wenet_tpu/runtime/batch_runner.py.

A chunk step of one stream leaves the card idle: its kernels are small
(K1 runs 4 blocks for one stream) and the host enqueues them far slower
than the card runs them.  Every session with the same `StreamingConfig`
has caches of the same shape, so the chunks of many live sessions can be
stacked on the batch axis and advanced by ONE chunk step.

`BatchedChunkRunner` owns a worker thread.  Sessions `submit()` their
chunk, caches, offset and number of valid cache slots and get a Future;
the worker coalesces up to `max_batch` pending requests (waiting at most
`flush_ms` for stragglers), stacks the row caches with `torch.cat`,
builds one cache-mask row per session, runs `forward_encoder_chunk` with
a vector of offsets (so the rel-pos encoding and K1's p are per row) and
the CTC top-k once for the batch, copies the top-k and the blank column
to the host once, and hands each session its rows: its encoder outputs
and new caches stay on the device, views of the batch's tensors.

The JAX runner pads each batch to a power of two, only to bound the
number of XLA programs it compiles.  Eager PyTorch compiles nothing, so
here the coalesced count runs as it is, and `precompile` is a warm-up
that runs each batch size once (the first calls' allocations and
library handles) and returns the sizes it ran.

Runs on `device` ('cuda' unless the caller asks for the CPU), under its
own `torch.inference_mode()`, which is per thread.  One card: `mesh=`
(data-parallel serving over several) raises NotImplementedError, and so
does a model whose encoder is not the conformer (the rest of the zoo is
served one stream per `AsrDecoder`)."""

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from wenet_tpu_torch.models.transformer.encoder import ConformerEncoder
from wenet_tpu_torch.models.transformer.streaming import (StreamingConfig,
                                                          streaming_att_mask)


@dataclass
class _Request:
    chunk: np.ndarray  # (decoding_window, mel), zero padded
    cache: Any  # ((k, v), cnn) of one row, as `zero_cache` gives
    offset: int
    valid_cache: int
    real_out: int
    future: Future


class BatchedChunkRunner:
    """submit() -> Future of (ys (1, chunk_out, D) on the device, the host
    rows (chunk_out, 2 * beam_size + 1) of `model.ctc_host_rows`, the new
    caches of the row).  `batch_sizes` counts the coalesced steps by
    their batch size."""

    def __init__(self, model, cfg: StreamingConfig, max_batch: int = 8,
                 flush_ms: float = 5.0, mesh=None, beam_size: int = 10,
                 blank_id: int = 0, device='cuda'):
        if mesh is not None:
            raise NotImplementedError('data-parallel serving over a mesh is '
                                      'not ported (one card)')
        if type(model.encoder) is not ConformerEncoder:
            raise NotImplementedError(
                f'batched serving of {type(model.encoder).__name__} is not '
                'ported (ROADMAP.md, queue 1 item 8): the batched chunk '
                'step is the conformer\'s')
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.max_batch = max_batch
        self.flush_ms = flush_ms
        self.beam_size = beam_size
        self.blank_id = blank_id
        self.chunk_out = (cfg.decoding_window - cfg.right_context - 1) \
            // cfg.subsampling_rate + 1
        self.batch_sizes: collections.Counter = collections.Counter()
        self._q: 'queue.Queue[Optional[_Request]]' = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- session API ----------------------------------------------------
    def zero_cache(self):
        return self.model.encoder.zero_cache(
            1, self.cfg.required_cache_size, device=self.device)

    def submit(self, chunk: np.ndarray, cache, offset: int,
               valid_cache: int, real_out: int) -> Future:
        fut: Future = Future()
        self._q.put(_Request(chunk, cache, offset, valid_cache, real_out,
                             fut))
        return fut

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)

    def precompile(self, idim: int = 80) -> List[int]:
        """Run one step at every batch size in [1, max_batch] before
        serving traffic (call it before the first `submit`) -> the sizes
        run."""
        sizes = list(range(1, self.max_batch + 1))
        cache = self.zero_cache()
        for b in sizes:
            self._run([_Request(
                np.zeros((self.cfg.decoding_window, idim), np.float32),
                cache, 0, 0, self.chunk_out, Future()) for _ in range(b)])
        return sizes

    # -- worker ---------------------------------------------------------
    def _worker(self):
        while True:
            req = self._q.get()
            if req is None:
                return
            batch: List[_Request] = [req]
            # coalesce whatever arrives within the flush window
            deadline = time.perf_counter() + self.flush_ms / 1000.0
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)
                    break
                batch.append(nxt)
            self.batch_sizes[len(batch)] += 1
            try:
                self._run(batch)
            except Exception as e:  # noqa: BLE001 — delivered to callers
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    @torch.inference_mode()
    def _run(self, batch: List[_Request]):
        dev = self.device
        cache_size = self.cfg.required_cache_size
        xs = torch.from_numpy(np.stack([r.chunk for r in batch])).to(dev)
        ints = torch.tensor([[r.offset, r.valid_cache, r.real_out]
                             for r in batch]).to(dev)
        att_mask = streaming_att_mask(len(batch), cache_size, self.chunk_out,
                                      ints[:, 1], ints[:, 2], dev)
        if len(batch) == 1:
            (k, v), cnn = batch[0].cache
        else:
            k = torch.cat([r.cache[0][0] for r in batch], dim=1)
            v = torch.cat([r.cache[0][1] for r in batch], dim=1)
            cnn = None if batch[0].cache[1] is None else torch.cat(
                [r.cache[1] for r in batch], dim=1)
        ys, (k, v), cnn = self.model.forward_encoder_chunk(
            xs, ints[:, 0], (k, v), cnn, att_mask)
        # one device-to-host copy for every session of the step
        host = self.model.ctc_host_rows(ys, self.beam_size,
                                        self.blank_id).cpu().numpy()
        for i, r in enumerate(batch):
            row = slice(i, i + 1)
            r.future.set_result((ys[row], host[i], (
                (k[:, row], v[:, row]), None if cnn is None else cnn[:, row])))
