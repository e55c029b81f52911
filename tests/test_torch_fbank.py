"""The port's front end against the JAX package: kaldi fbank (the torch
version and the numpy one), whisper's log-mel, the mel banks and WAV
reading, on waveforms made from a seed.

Bars: the torch fbank is held to JAX's `compute_fbank` within 1e-3 on
log-mel features of 6-26: the JAX package takes its FFT in float32, the
port in float64 as numpy does, and that alone reads up to ≈ 2.5e-4 in the
quietest bins.  The numpy copies equal the JAX numpy functions to 1e-6,
whisper's log-mel agrees within 1e-4 (the bar of tests/test_fbank.py),
WAV samples and rates are equal."""

import io
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wenet_tpu.dataset import audio as jax_audio
from wenet_tpu.ops import fbank as jax_fbank
from wenet_tpu_torch.dataset import audio
from wenet_tpu_torch.ops import fbank

SR = 16000
FBANK_ATOL = 1e-3


def _waves(seed, B=2, seconds=1.5):
    """Tones over noise, (B, S), in [-1, 1]."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    out = []
    for _ in range(B):
        f1, f2 = rng.uniform(100, 3000, size=2)
        out.append(0.3 * np.sin(2 * np.pi * f1 * t) +
                   0.2 * np.sin(2 * np.pi * f2 * t) +
                   0.05 * rng.randn(len(t)))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize('num_mel_bins', [80, 40])
def test_fbank_matches_jax(num_mel_bins):
    x = _waves(0) * (1 << 15)
    want = np.asarray(jax_fbank.compute_fbank(jnp.asarray(x),
                                              num_mel_bins=num_mel_bins))
    got = fbank.compute_fbank(torch.from_numpy(x), num_mel_bins=num_mel_bins)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FBANK_ATOL, rtol=0)
    got_np = fbank.compute_fbank_np(x, num_mel_bins=num_mel_bins)
    np.testing.assert_allclose(
        got_np, jax_fbank.compute_fbank_np(x, num_mel_bins=num_mel_bins),
        atol=1e-6, rtol=0)
    # the torch version follows the host's numpy one closer than JAX's
    np.testing.assert_allclose(got.numpy(), got_np, atol=2e-4, rtol=0)


def test_fbank_dither_follows_its_generator():
    x = torch.from_numpy(_waves(3, B=1) * (1 << 15))

    def run(seed):
        return fbank.compute_fbank(x, dither=1.0,
                                   generator=torch.Generator().manual_seed(
                                       seed))
    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.allclose(run(0), run(1))
    assert not torch.allclose(run(0), fbank.compute_fbank(x))


def test_fbank_short_input_has_no_frames():
    x = torch.zeros(2, 399)
    assert tuple(fbank.compute_fbank(x).shape) == (2, 0, 80)
    assert fbank.compute_fbank_np(x.numpy()).shape == (2, 0, 80)


def test_mel_banks_and_windows_equal_jax():
    np.testing.assert_array_equal(fbank.kaldi_mel_banks(80, 512, SR),
                                  jax_fbank.kaldi_mel_banks(80, 512, SR))
    np.testing.assert_array_equal(fbank.slaney_mel_banks(128, 400, SR),
                                  jax_fbank.slaney_mel_banks(128, 400, SR))
    np.testing.assert_array_equal(fbank.povey_window(400),
                                  jax_fbank.povey_window(400))


@pytest.mark.parametrize('num_mel_bins,padding', [(80, 0), (128, 480)])
def test_log_mel_matches_jax(num_mel_bins, padding):
    x = _waves(1)
    kw = dict(num_mel_bins=num_mel_bins, padding=padding)
    want = np.asarray(jax_fbank.compute_log_mel_spectrogram(jnp.asarray(x),
                                                            **kw))
    got = fbank.compute_log_mel_spectrogram(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        fbank.compute_log_mel_spectrogram_np(x, **kw),
        jax_fbank.compute_log_mel_spectrogram_np(x, **kw), atol=1e-6, rtol=0)


def _riff(fmt_chunk: bytes, data: bytes, extra: bytes = b'') -> bytes:
    """A RIFF file: fmt, an optional chunk, data, and a trailing LIST."""
    tail = struct.pack('<4sI', b'LIST', 4) + b'INFO'
    body = (b'WAVE' + struct.pack('<4sI', b'fmt ', len(fmt_chunk)) +
            fmt_chunk + extra + struct.pack('<4sI', b'data', len(data)) +
            data + tail)
    return struct.pack('<4sI', b'RIFF', len(body)) + body


def _wav_bytes(kind, rng):
    C, rate, n = (2, 8000, 301) if kind == 'stereo16' else (1, SR, 257)
    x = rng.uniform(-1, 1, size=(n, C))
    if kind in ('mono16', 'stereo16'):
        bits, fmt_tag = 16, 1
        data = (x * 32767).astype('<i2').tobytes()
    elif kind == 'mono24':
        bits, fmt_tag = 24, 1
        ints = (x[:, 0] * 8388607).astype(np.int32)
        data = b''.join(struct.pack('<i', int(v))[:3] for v in ints)
    else:  # float32
        bits, fmt_tag = 32, 3
        data = x.astype('<f4').tobytes()
    fmt = struct.pack('<HHIIHH', fmt_tag, C, rate, rate * C * bits // 8,
                      C * bits // 8, bits)
    extra = struct.pack('<4sI', b'junk', 3) + b'abc\0'  # odd size, padded
    return _riff(fmt, data, extra)


@pytest.mark.parametrize('kind', ['mono16', 'stereo16', 'mono24', 'float32'])
def test_read_wav_matches_jax(kind, tmp_path):
    raw = _wav_bytes(kind, np.random.RandomState(4))
    want, want_rate = jax_audio.read_wav(raw)
    got, rate = audio.read_wav(raw)
    assert rate == want_rate
    np.testing.assert_array_equal(got, want)
    path = tmp_path / 'a.wav'
    path.write_bytes(raw)
    for start, num in ((0, -1), (5, 100), (200, 500)):
        want, _ = jax_audio.read_wav(str(path), start, num)
        got, _ = audio.read_wav(str(path), start, num)
        np.testing.assert_array_equal(got, want)


def test_write_wav_matches_jax(tmp_path):
    x = _waves(2, B=1, seconds=0.1)
    audio.write_wav(tmp_path / 'port.wav', x, SR)
    jax_audio.write_wav(tmp_path / 'jax.wav', x, SR)
    assert ((tmp_path / 'port.wav').read_bytes() ==
            (tmp_path / 'jax.wav').read_bytes())
    got, rate = audio.read_wav(str(tmp_path / 'port.wav'))
    assert rate == SR
    np.testing.assert_allclose(got, x, atol=1 / 32768)


@pytest.mark.parametrize('raw', [b'', b'RIFF', b'RIFF\0\0\0\0WAVX' + b'0' * 8,
                                 _riff(b'', b'')])
def test_read_wav_rejects_what_is_not_a_wav(raw):
    with pytest.raises(ValueError):
        audio.read_wav(io.BytesIO(raw).getvalue())
