"""Streaming feature pipeline.  Counterpart of
wenet_tpu/runtime/feature_pipeline.py: turns the waveform accepted so far
into kaldi fbank frames with `compute_fbank_np` on the host, keeping the
samples past the last whole frame shift for the next call."""

from typing import Optional

import numpy as np

from wenet_tpu_torch.ops.fbank import compute_fbank_np


class FeaturePipelineConfig:

    def __init__(self, num_mel_bins: int = 80, frame_length: int = 25,
                 frame_shift: int = 10, sample_rate: int = 16000,
                 dither: float = 0.0):
        self.num_mel_bins = num_mel_bins
        self.frame_length = frame_length
        self.frame_shift = frame_shift
        self.sample_rate = sample_rate
        self.dither = dither
        self.frame_length_samples = sample_rate * frame_length // 1000
        self.frame_shift_samples = sample_rate * frame_shift // 1000

    @classmethod
    def from_configs(cls, configs: dict) -> 'FeaturePipelineConfig':
        """From a train.yaml dict (mel bins and frame geometry)."""
        dataset = configs.get('dataset_conf', {})
        fc = dataset.get('fbank_conf', {})
        return cls(
            num_mel_bins=fc.get('num_mel_bins', configs.get('input_dim', 80)),
            frame_length=int(fc.get('frame_length', 25)),
            frame_shift=int(fc.get('frame_shift', 10)),
            sample_rate=dataset.get('resample_conf', {}).get(
                'resample_rate', 16000))


class FeaturePipeline:

    def __init__(self, config: Optional[FeaturePipelineConfig] = None):
        self.config = config or FeaturePipelineConfig()
        self.reset()

    def reset(self):
        self._remained = np.zeros((0,), np.float32)
        self._num_frames = 0
        self.input_finished = False

    @property
    def num_frames(self) -> int:
        return self._num_frames

    def accept_waveform(self, wav: np.ndarray) -> np.ndarray:
        """wav: float32 in [-1, 1] (or int16) -> the new (T, mel) frames."""
        wav = np.asarray(wav)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        wav = np.concatenate([self._remained, wav.astype(np.float32)])
        c = self.config
        if len(wav) < c.frame_length_samples:
            self._remained = wav
            return np.zeros((0, c.num_mel_bins), np.float32)
        feats = compute_fbank_np(
            wav * (1 << 15), num_mel_bins=c.num_mel_bins,
            frame_length_ms=c.frame_length, frame_shift_ms=c.frame_shift,
            sample_rate=c.sample_rate, dither=c.dither)
        n = feats.shape[0]
        self._remained = wav[n * c.frame_shift_samples:]
        self._num_frames += n
        return feats

    def set_input_finished(self):
        self.input_finished = True
