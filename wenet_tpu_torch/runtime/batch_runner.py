"""Cross-stream batching of streaming sessions.  Counterpart of
wenet_tpu/runtime/batch_runner.py.

A chunk step of one stream leaves the card idle: its kernels are small
(K1 runs 4 blocks for one stream) and the host enqueues them far slower
than the card runs them.  Every session with the same `StreamingConfig`
has caches of the same shape, so the chunks of many live sessions can be
stacked on the batch axis and advanced by ONE chunk step.

`BatchedChunkRunner` owns a worker thread.  Sessions `submit()` their
chunk, caches, offset, number of valid cache slots and of valid chunk
frames, and get a Future; the worker coalesces up to `max_batch` pending
requests (waiting at most `flush_ms` for stragglers), stacks the row
caches with `torch.cat` on their batch axis, builds one cache-mask row
per session, runs `forward_encoder_chunk` with a vector of offsets (so
the rel-pos encoding and K1's p are per row) and the CTC top-k once for
the batch, copies the top-k and the blank column to the host once, and
hands each session its rows: its encoder outputs and new caches stay on
the device, views of the batch's tensors.  A session that asks for whole
rows (`submit(..., whole_rows=True)`, a WFST search) also gets its
CTC log-probs, a row for each output frame: one more copy a step, of
those sessions' rows only.

Every encoder of the zoo is served: the conformer and the transformer
with any of their attentions (rel-pos, plain, Shaw, RoPE: its angles per
row), pre- or post-norm, GQA/MQA caches of `n_kv_head` heads, with or
without a conv module; Branchformer and E-Branchformer (the cgMLP
conv's cache); Squeezeformer (its time reduction and recovery inside the
step, each row's tail masked on its own); and the efficient conformer.
Each keeps its caches as (num_blocks, B, ...) tensors or None, as
`zero_cache` builds them, so one `torch.cat` on dim 1 stacks any of
them.  The cache mask and the valid chunk frames a session submits are
at the encoder's base resolution (after the front end's subsampling);
the efficient conformer emits one frame per `output_downsampling_factor`
base frames of a chunk, and its offsets count output frames, as its
chunk step does.

The JAX runner pads each batch to a power of two, only to bound the
number of XLA programs it compiles.  Eager PyTorch compiles nothing, so
here the coalesced count runs as it is, and `precompile` is a warm-up
that runs each batch size once (the first calls' allocations and
library handles) and returns the sizes it ran.

Runs on `device` ('cuda' unless the caller asks for the CPU), under its
own `torch.inference_mode()`, which is per thread.  `mesh`, a list of
local devices along `data`, splits each coalesced step over them: one
replica per device, the rows in order, a ragged batch padded by
repeating its final row (the pad rows discarded), the shards run side by
side in threads; a session's caches move to the device of its shard and
its encoder rows come back to the first device."""

import collections
import copy
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from wenet_tpu_torch.models.transformer.streaming import (StreamingConfig,
                                                          streaming_att_mask)
from wenet_tpu_torch.utils.ctc_utils import topk_host_rows


@dataclass
class _Request:
    chunk: np.ndarray  # (decoding_window, mel), zero padded
    cache: Any  # ((k, v), cnn) of one row, as `zero_cache` gives
    offset: int
    valid_cache: int
    valid_chunk: int  # valid base-resolution frames (fewer in a tail)
    future: Future
    whole_rows: bool = False


class BatchedChunkRunner:
    """submit() -> Future of (ys (1, F, D) on the device, the host rows
    (F, 2 * beam_size + 1) of `model.ctc_host_rows`, or with `whole_rows`
    the (F, V) CTC log-probs, the new caches of the row), F the encoder's
    output frames of a chunk: `chunk_base` over its
    `output_downsampling_factor`.  `batch_sizes` counts the coalesced
    steps by their batch size."""

    def __init__(self, model, cfg: StreamingConfig, max_batch: int = 8,
                 flush_ms: float = 5.0, mesh=None, beam_size: int = 10,
                 blank_id: int = 0, device='cuda'):
        devices = [torch.device(device)]
        if mesh is not None:
            from wenet_tpu_torch.parallel.mesh import decode_devices
            devices = decode_devices(mesh)
        distinct = list(dict.fromkeys(devices))
        models = [model] + [copy.deepcopy(model) for _ in distinct[1:]]
        own = {d: m.to(d).eval() for d, m in zip(distinct, models)}
        # (device, replica) per shard of a step
        self.shards = [(d, own[d]) for d in devices]
        self._pool = (ThreadPoolExecutor(len(devices)) if len(devices) > 1
                      else None)
        self.device, self.model = self.shards[0]
        self.cfg = cfg
        self.max_batch = max_batch
        self.flush_ms = flush_ms
        self.beam_size = beam_size
        self.blank_id = blank_id
        # the chunk's frames at the cache mask's (base) resolution
        self.chunk_base = (cfg.decoding_window - cfg.right_context - 1) \
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
               valid_cache: int, valid_chunk: int,
               whole_rows: bool = False) -> Future:
        """chunk: (decoding_window, mel), zero padded; offset: the output
        frames the session has emitted; valid_cache and valid_chunk: its
        valid cache slots and chunk frames at the base resolution."""
        fut: Future = Future()
        self._q.put(_Request(chunk, cache, offset, valid_cache, valid_chunk,
                             fut, whole_rows))
        return fut

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown()

    def precompile(self, idim: int = 80) -> List[int]:
        """Run one step at every batch size in [1, max_batch] before
        serving traffic (call it before the first `submit`) -> the sizes
        run."""
        sizes = list(range(1, self.max_batch + 1))
        cache = self.zero_cache()
        for b in sizes:
            self._run([_Request(
                np.zeros((self.cfg.decoding_window, idim), np.float32),
                cache, 0, 0, self.chunk_base, Future()) for _ in range(b)])
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

    def _run(self, batch: List[_Request]):
        """One coalesced step: the rows split over the shards (the final
        row repeated up to a multiple of them), each session given its
        rows."""
        n = len(self.shards)
        n_real = len(batch)
        batch = batch + [batch[-1]] * (-n_real % n)
        rows = len(batch) // n
        parts = [batch[i * rows:(i + 1) * rows] for i in range(n)]
        if self._pool is None:
            outs = [self._step(*self.shards[0], parts[0])]
        else:
            outs = list(self._pool.map(self._step, *zip(*self.shards),
                                       parts))
        done = 0
        for part, (ys, host, whole, (k, v), cnn) in zip(parts, outs):
            for i, r in enumerate(part):
                if done == n_real:
                    return
                done += 1
                row = slice(i, i + 1)
                r.future.set_result((
                    ys[row].to(self.device),
                    whole[i] if r.whole_rows else host[i],
                    ((k[:, row], v[:, row]),
                     None if cnn is None else cnn[:, row])))

    @torch.inference_mode()
    def _step(self, dev, model, batch: List[_Request]):
        """The chunk step of `batch` on `dev` with `model` -> (ys, the
        top-k host rows, {row: whole log-prob rows} of the sessions that
        asked for them, the new (k, v) and cnn caches)."""
        cache_size = self.cfg.required_cache_size
        xs = torch.from_numpy(np.stack([r.chunk for r in batch])).to(dev)
        ints = torch.tensor([[r.offset, r.valid_cache, r.valid_chunk]
                             for r in batch]).to(dev)
        att_mask = streaming_att_mask(len(batch), cache_size,
                                      self.chunk_base, ints[:, 1],
                                      ints[:, 2], dev)
        if len(batch) == 1:
            (k, v), cnn = batch[0].cache
            k, v = k.to(dev), v.to(dev)
            cnn = None if cnn is None else cnn.to(dev)
        else:
            k = torch.cat([r.cache[0][0].to(dev) for r in batch], dim=1)
            v = torch.cat([r.cache[0][1].to(dev) for r in batch], dim=1)
            cnn = None if batch[0].cache[1] is None else torch.cat(
                [r.cache[1].to(dev) for r in batch], dim=1)
        ys, (k, v), cnn = model.forward_encoder_chunk(
            xs, ints[:, 0], (k, v), cnn, att_mask)
        logp = model.ctc_activation(ys)
        # one device-to-host copy for every session of the step
        host = topk_host_rows(logp, self.beam_size,
                              self.blank_id).cpu().numpy()
        wanted = [i for i, r in enumerate(batch) if r.whole_rows]
        whole = {}
        if wanted:
            # and one of the whole rows, for the sessions that asked
            rows = logp[wanted].float().cpu().numpy()
            whole = dict(zip(wanted, rows))
        return ys, host, whole, (k, v), cnn
