"""Epoch train/cv loops.  Counterpart of wenet_tpu/utils/executor.py:
host orchestration around the train step (skip empty batches, feed the
device, log, step-interval cv and checkpoint, a profiler window).

Batches are the `Dataset`'s dicts (numpy feats, feats_lengths, target
IGNORE_ID padded, target_lengths).  Over several ranks (`layout`, a
parallel/mesh.py `TrainLayout`) each step starts with the ranks'
agreement (`TrainLayout.agree`): every rank ends the epoch as soon as one
has run out of data, and each pads its batch to the most rows, frames and
label length of any rank, with zero-length dummy rows as the JAX
executor's `_pad_rows` (the model excludes them from every loss).  Rank 0
alone logs, writes summaries and writes checkpoints (whose shards every
rank gathers first); cv runs on every rank over the whole cv list.

`Executor.totals` sums the last epoch: steps, frames of audio, the
host's wait on the data pipeline, the steps' own wall time (which holds
the device's time on the steps that log, since logging reads the
metrics) and the seconds spent starting and writing the profiler trace,
which the other totals leave out.  A caller that wants each step's
record (batch size, padded frames, audio frames, data wait, step time)
passes `on_step`."""

import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from wenet_tpu_torch.utils.checkpoint import save_checkpoint

_BATCH_KEYS = {'feats': torch.float32, 'feats_lengths': torch.int64,
               'target': torch.int64, 'target_lengths': torch.int64}


def to_device_batch(batch: dict, device) -> Dict[str, torch.Tensor]:
    """The four model inputs of a batch as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device, dtype,
                                                        non_blocking=True)
            for k, dtype in _BATCH_KEYS.items()}


class Executor:

    def __init__(self, global_step: int = 0, device='cuda',
                 on_step: Optional[Callable[[dict], None]] = None,
                 layout=None):
        self.step = global_step
        self.device = torch.device(device)
        self.on_step = on_step
        self.layout = layout
        self.totals: Dict[str, float] = {}
        self.profile_trace: Optional[str] = None  # the last trace written
        self._timer = None  # (wall time, step) of the last log line
        self._prof = None

    def steps_per_second(self) -> float:
        now = time.perf_counter()
        last_time, last_step = self._timer
        self._timer = (now, self.step)
        return (self.step - last_step) / max(now - last_time, 1e-9)

    def _profile(self, prof_conf: Optional[dict]) -> float:
        """Start torch.profiler at step `start`, stop it at `start +
        steps` and write its Chrome trace into `dir`.  -> the seconds
        that took."""
        if prof_conf is None:
            return 0.0
        t0 = time.perf_counter()
        if self._prof is None and self.step == prof_conf['start']:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._prof_t0 = time.perf_counter()
        elif self._prof is not None and \
                self.step == prof_conf['start'] + prof_conf['steps']:
            self._stop_profile(prof_conf)
        return time.perf_counter() - t0

    def _stop_profile(self, prof_conf: dict) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        wall = time.perf_counter() - self._prof_t0
        os.makedirs(prof_conf['dir'], exist_ok=True)
        path = os.path.join(prof_conf['dir'],
                            f'trace_step{self.step}.json')
        self._prof.export_chrome_trace(path)
        self._prof = None
        self.profile_trace = path
        logging.info('profiled up to step %d (%.3f s of wall time): %s',
                     self.step, wall, path)

    def train(self, train_step_fn, state, train_data_loader, cv_data_loader,
              cv_step_fn, writer, configs: dict,
              model_dir: Optional[str] = None):
        """One epoch.  configs: log_interval, save_interval, epoch, seed,
        and `profile` (dir, start, steps) for a profiler window.  Returns
        the state; `self.totals` holds the epoch's sums."""
        log_interval = configs.get('log_interval', 100)
        save_interval = configs.get('save_interval', None)
        epoch = configs.get('epoch', 0)
        rng = (configs.get('seed', 777), epoch)
        prof_conf = configs.get('profile')
        if self._timer is None:
            self._timer = (time.perf_counter(), self.step)
        totals = self.totals = dict(steps=0, audio_frames=0, data_wait=0.0,
                                    step_time=0.0, profile_seconds=0.0)
        data_iter = iter(train_data_loader)
        while True:
            t0 = time.perf_counter()
            batch = next(data_iter, None)
            while batch is not None and len(batch['target_lengths']) == 0:
                batch = next(data_iter, None)
            if self.layout is not None:
                batch = self.layout.agree(batch)
            if batch is None:
                break
            wait = time.perf_counter() - t0
            prof_s = self._profile(prof_conf)
            state, metrics = train_step_fn(
                state, to_device_batch(batch, self.device), rng)
            self.step += 1
            if self.step % log_interval == 0 and self.is_main:
                values = {k: float(v) for k, v in metrics.items()}
                logging.info('TRAIN | epoch %d step %d | %s | %.2f steps/s',
                             epoch, self.step,
                             ' '.join(f'{k} {v:.6f}'
                                      for k, v in values.items()),
                             self.steps_per_second())
                if writer is not None:
                    for k, v in values.items():
                        writer.add_scalar(f'train/{k}', v, self.step)
            record = dict(epoch=epoch, step=self.step,
                          batch=int(batch['feats'].shape[0]),
                          frames=int(batch['feats'].shape[1]),
                          audio_frames=int(np.sum(batch['feats_lengths'])),
                          data_wait=wait,
                          step_time=time.perf_counter() - t0 - wait - prof_s)
            for k in ('audio_frames', 'data_wait', 'step_time'):
                totals[k] += record[k]
            totals['steps'] += 1
            totals['profile_seconds'] += prof_s
            if self.on_step is not None:
                self.on_step(record)
            if save_interval and self.step % save_interval == 0:
                loss_dict = self.cv(cv_step_fn, state, cv_data_loader)
                logging.info('CV @step %d: %s', self.step, loss_dict)
                if model_dir is not None:
                    self.save(state.model,
                              os.path.join(model_dir,
                                           f'step_{self.step}.pt'),
                              dict(tag=f'step_{self.step}', step=self.step,
                                   epoch=epoch,
                                   cv_loss=loss_dict.get('loss')))
                if writer is not None:
                    for k, v in loss_dict.items():
                        writer.add_scalar(f'cv/{k}', v, self.step)
        if self._prof is not None:
            # the data ran out inside the window: write what was traced
            t0 = time.perf_counter()
            self._stop_profile(prof_conf)
            totals['profile_seconds'] += time.perf_counter() - t0
        return state

    @property
    def is_main(self) -> bool:
        """The rank that logs and writes."""
        return self.layout is None or self.layout.is_main

    def save(self, model, path: str, infos: dict) -> None:
        """Write `model`'s checkpoint with `infos`: over several ranks each
        gathers its shards and rank 0 writes the full tensors."""
        state = (model if self.layout is None
                 else self.layout.full_state_dict())
        if self.is_main:
            save_checkpoint(state, path, infos)

    def cv(self, cv_step_fn, state, cv_data_loader) -> Dict[str, float]:
        """Utterance-weighted mean of each loss over the cv set."""
        total: Dict[str, float] = {}
        num_seen = 0
        for batch in cv_data_loader:
            if len(batch['target_lengths']) == 0:
                continue
            out, num_utts = cv_step_fn(state,
                                       to_device_batch(batch, self.device))
            num_seen += int(num_utts)
            for k, v in out.items():
                if v is None:
                    continue
                total[k] = total.get(k, 0.0) + float(v) * int(num_utts)
        return {k: v / max(num_seen, 1) for k, v in total.items()}
