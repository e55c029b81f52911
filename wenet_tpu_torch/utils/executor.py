"""Epoch train/cv loops on one device.  Counterpart of
wenet_tpu/utils/executor.py: host orchestration around the train step
(skip empty batches, feed the device, log, step-interval cv and
checkpoint).

Batches are the dicts the JAX package's Dataset yields (numpy feats,
feats_lengths, target IGNORE_ID padded, target_lengths).  The ragged-tail
dummy rows that the JAX executor pads a batch with to shard it evenly
over devices belong to the multi-device path, which is not ported; the
model still excludes zero-length rows from every loss."""

import logging
import os
import time
from typing import Dict, Optional

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

    def __init__(self, global_step: int = 0, device='cuda'):
        self.step = global_step
        self.device = torch.device(device)
        self._timer = None  # (wall time, step) of the last log line

    def steps_per_second(self) -> float:
        now = time.perf_counter()
        last_time, last_step = self._timer
        self._timer = (now, self.step)
        return (self.step - last_step) / max(now - last_time, 1e-9)

    def train(self, train_step_fn, state, train_data_loader, cv_data_loader,
              cv_step_fn, writer, configs: dict,
              model_dir: Optional[str] = None):
        """One epoch.  configs: log_interval, save_interval, epoch, seed.
        Returns the state."""
        log_interval = configs.get('log_interval', 100)
        save_interval = configs.get('save_interval', None)
        epoch = configs.get('epoch', 0)
        rng = (configs.get('seed', 777), epoch)
        if self._timer is None:
            self._timer = (time.perf_counter(), self.step)
        for batch in train_data_loader:
            if len(batch['target_lengths']) == 0:
                continue
            state, metrics = train_step_fn(
                state, to_device_batch(batch, self.device), rng)
            self.step += 1
            if self.step % log_interval == 0:
                values = {k: float(v) for k, v in metrics.items()}
                logging.info('TRAIN | epoch %d step %d | %s | %.2f steps/s',
                             epoch, self.step,
                             ' '.join(f'{k} {v:.6f}'
                                      for k, v in values.items()),
                             self.steps_per_second())
                if writer is not None:
                    for k, v in values.items():
                        writer.add_scalar(f'train/{k}', v, self.step)
            if save_interval and self.step % save_interval == 0:
                loss_dict = self.cv(cv_step_fn, state, cv_data_loader)
                logging.info('CV @step %d: %s', self.step, loss_dict)
                if model_dir is not None:
                    save_checkpoint(
                        state.model,
                        os.path.join(model_dir, f'step_{self.step}.pt'),
                        dict(tag=f'step_{self.step}', step=self.step,
                             epoch=epoch, cv_loss=loss_dict.get('loss')))
                if writer is not None:
                    for k, v in loss_dict.items():
                        writer.add_scalar(f'cv/{k}', v, self.step)
        return state

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
                total[k] = total.get(k, 0.0) + float(v) * int(num_utts)
        return {k: v / max(num_seen, 1) for k, v in total.items()}
