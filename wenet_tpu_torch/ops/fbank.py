"""Kaldi fbank and whisper's log-mel.  Counterpart of
wenet_tpu/ops/fbank.py (`compute_fbank` and whisper's
`compute_log_mel_spectrogram` on device tensors, `compute_fbank_np` and
`compute_log_mel_spectrogram_np` on the host); MFCC is not ported.

Kaldi's pipeline: frames (snip_edges) -> remove DC -> pre-emphasis (x[0]
duplicated) -> povey window -> zero pad to the next power of two ->
|FFT|² without the nyquist bin -> triangular mel bins (1127·ln(1 + f/700),
20 Hz to nyquist) -> log(max(e, eps)).  The waveform is int16-scaled
(the caller multiplies by 1 << 15).  `torch.fft.rfft` stands in for the
JAX package's `jnp.fft.rfft`.  The device path takes its FFT and mel
projection in float64, as numpy's FFT does on the host, and rounds to
float32 after: the card's features then follow the host's
(`compute_fbank_np`) to float32 rounding, and no TF32 setting reaches the
projection.  The JAX package's float32 FFT differs from both by up to
≈ 2.5e-4 in the quietest bins of a log-mel feature."""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=16)
def kaldi_mel_banks(num_bins: int, padded_window: int, sample_rate: int,
                    low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """(padded_window // 2, num_bins) triangular mel weights, kaldi's."""
    num_fft_bins = padded_window // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_rate / padded_window
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_fft_bins, num_bins), np.float32)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        for i in range(num_fft_bins):
            mel = mel_scale(fft_bin_width * i)
            if left < mel < right:
                if mel <= center:
                    bins[i, b] = (mel - left) / (center - left)
                else:
                    bins[i, b] = (right - mel) / (right - center)
    return bins


@lru_cache(maxsize=8)
def povey_window(frame_length: int) -> np.ndarray:
    n = np.arange(frame_length)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (frame_length - 1))
    return (hann**0.85).astype(np.float32)


@lru_cache(maxsize=8)
def hann_window(frame_length: int) -> np.ndarray:
    n = np.arange(frame_length)
    return (0.5 -
            0.5 * np.cos(2 * np.pi * n / frame_length)).astype(np.float32)


def frame_signal(waveform: torch.Tensor, frame_length: int,
                 frame_shift: int) -> torch.Tensor:
    """(..., S) -> (..., T, frame_length) strided view, snip_edges framing
    (T = 0 when S < frame_length)."""
    S = waveform.shape[-1]
    if S < frame_length:
        return waveform.new_zeros(waveform.shape[:-1] + (0, frame_length))
    return waveform.unfold(-1, frame_length, frame_shift)


def _project(power: torch.Tensor, banks: np.ndarray) -> torch.Tensor:
    """float64 power (..., F) @ banks (F, M), rounded to float32."""
    mel = torch.from_numpy(banks).to(power.device, torch.float64)
    return torch.matmul(power, mel).float()


def compute_fbank(waveform: torch.Tensor,
                  num_mel_bins: int = 80,
                  frame_length_ms: float = 25.0,
                  frame_shift_ms: float = 10.0,
                  sample_rate: int = 16000,
                  dither: float = 0.0,
                  preemphasis: float = 0.97,
                  remove_dc_offset: bool = True,
                  generator: torch.Generator = None,
                  log_floor: float = 1.1920928955078125e-07,
                  low_freq: float = 20.0,
                  high_freq: float = 0.0) -> torch.Tensor:
    """Kaldi fbank of an int16-scaled float32 waveform (..., S) ->
    (..., T, num_mel_bins), on the waveform's device.  Dither draws from
    `generator` (a generator of that device)."""
    frame_length = int(sample_rate * frame_length_ms / 1000)
    frame_shift = int(sample_rate * frame_shift_ms / 1000)
    padded = _next_pow2(frame_length)
    frames = frame_signal(waveform.float(), frame_length, frame_shift)
    if frames.shape[-2] == 0:
        return frames.new_zeros(frames.shape[:-1] + (num_mel_bins,))
    if dither != 0.0:
        frames = frames + dither * torch.randn(
            frames.shape, generator=generator, device=frames.device)
    if remove_dc_offset:
        frames = frames - frames.mean(-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], -1)
        frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(povey_window(frame_length)).to(
        frames.device)
    spec = torch.fft.rfft(frames.double(), n=padded, dim=-1)
    power = (spec.real.square() + spec.imag.square())[..., :padded // 2]
    energies = _project(power, kaldi_mel_banks(num_mel_bins, padded,
                                               sample_rate, low_freq,
                                               high_freq))
    return torch.log(energies.clamp(min=log_floor))


@lru_cache(maxsize=8)
def slaney_mel_banks(num_bins: int, n_fft: int,
                     sample_rate: int) -> np.ndarray:
    """librosa's slaney-normalized mel filters, as whisper uses them:
    (1 + n_fft // 2, num_bins)."""
    n_freqs = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(f / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    mels = np.linspace(0.0, hz_to_mel(sample_rate / 2), num_bins + 2)
    mel_f = mel_to_hz(mels)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    weights = np.zeros((num_bins, n_freqs))
    for i in range(num_bins):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:num_bins + 2] - mel_f[:num_bins])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def compute_log_mel_spectrogram(waveform: torch.Tensor,
                                n_fft: int = 400,
                                hop_length: int = 160,
                                num_mel_bins: int = 80,
                                sample_rate: int = 16000,
                                padding: int = 0) -> torch.Tensor:
    """Whisper's log-mel of a [-1, 1] waveform (..., S) -> (..., T, M):
    reflect-padded centred STFT with a hann window, the last frame
    dropped, log10, an 8-unit dynamic range below each utterance's
    maximum, (x + 4) / 4."""
    waveform = waveform.float()
    if padding > 0:
        waveform = F.pad(waveform, (0, padding))
    half = n_fft // 2
    # reflect padding wants an (N, C, S) input
    lead = waveform.shape[:-1]
    wav = F.pad(waveform.reshape(-1, 1, waveform.shape[-1]), (half, half),
                mode='reflect').reshape(lead + (-1,))
    frames = frame_signal(wav, n_fft, hop_length)
    frames = frames * torch.from_numpy(hann_window(n_fft)).to(frames.device)
    spec = torch.fft.rfft(frames.double(), dim=-1)
    power = (spec.real.square() + spec.imag.square())[..., :-1, :]
    melspec = _project(power, slaney_mel_banks(num_mel_bins, n_fft,
                                               sample_rate))
    log_spec = torch.log10(melspec.clamp(min=1e-10))
    top = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, top - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# numpy copies for the host (the streaming feature pipeline)
# ---------------------------------------------------------------------------
def compute_fbank_np(waveform: np.ndarray,
                     num_mel_bins: int = 80,
                     frame_length_ms: float = 25.0,
                     frame_shift_ms: float = 10.0,
                     sample_rate: int = 16000,
                     dither: float = 0.0,
                     preemphasis: float = 0.97,
                     remove_dc_offset: bool = True,
                     rng: np.random.RandomState = None,
                     log_floor: float = 1.1920928955078125e-07,
                     low_freq: float = 20.0,
                     high_freq: float = 0.0) -> np.ndarray:
    """numpy kaldi fbank; the same pipeline as `compute_fbank`."""
    waveform = np.asarray(waveform, np.float32)
    frame_length = int(sample_rate * frame_length_ms / 1000)
    frame_shift = int(sample_rate * frame_shift_ms / 1000)
    padded = _next_pow2(frame_length)
    S = waveform.shape[-1]
    T = 1 + (S - frame_length) // frame_shift if S >= frame_length else 0
    if T <= 0:
        return np.zeros(waveform.shape[:-1] + (0, num_mel_bins),
                        np.float32)
    idx = (np.arange(T)[:, None] * frame_shift +
           np.arange(frame_length)[None, :])
    frames = waveform[..., idx]
    if dither != 0.0:
        rng = rng or np.random
        frames = frames + dither * rng.randn(*frames.shape).astype(
            np.float32)
    if remove_dc_offset:
        frames = frames - frames.mean(-1, keepdims=True)
    if preemphasis != 0.0:
        prev = np.concatenate([frames[..., :1], frames[..., :-1]], -1)
        frames = frames - preemphasis * prev
    frames = frames * povey_window(frame_length)
    spec = np.fft.rfft(frames, n=padded, axis=-1)
    power = (spec.real**2 + spec.imag**2)[..., :padded // 2]
    mel = kaldi_mel_banks(num_mel_bins, padded, sample_rate, low_freq,
                          high_freq)
    energies = power.astype(np.float32) @ mel
    return np.log(np.maximum(energies, log_floor)).astype(np.float32)


def compute_log_mel_spectrogram_np(waveform: np.ndarray,
                                   n_fft: int = 400,
                                   hop_length: int = 160,
                                   num_mel_bins: int = 80,
                                   sample_rate: int = 16000,
                                   padding: int = 0) -> np.ndarray:
    """numpy whisper log-mel; the same pipeline as
    `compute_log_mel_spectrogram`."""
    waveform = np.asarray(waveform, np.float32)
    if padding > 0:
        waveform = np.pad(waveform, [(0, 0)] * (waveform.ndim - 1) +
                          [(0, padding)])
    half = n_fft // 2
    wav = np.pad(waveform, [(0, 0)] * (waveform.ndim - 1) +
                 [(half, half)], mode='reflect')
    S = wav.shape[-1]
    T = 1 + (S - n_fft) // hop_length
    idx = (np.arange(T)[:, None] * hop_length +
           np.arange(n_fft)[None, :])
    frames = wav[..., idx] * hann_window(n_fft)
    spec = np.fft.rfft(frames, axis=-1)
    power = (spec.real**2 + spec.imag**2)[..., :-1, :]
    mel = slaney_mel_banks(num_mel_bins, n_fft, sample_rate)
    melspec = power.astype(np.float32) @ mel
    log_spec = np.log10(np.maximum(melspec, 1e-10))
    log_spec = np.maximum(
        log_spec, log_spec.max(axis=(-2, -1), keepdims=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)
