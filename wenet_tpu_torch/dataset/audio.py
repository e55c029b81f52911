"""WAV reading and writing with `struct` and numpy.  Counterpart of
`read_wav` and `write_wav` in wenet_tpu/dataset/audio.py (FLAC,
resampling and speed perturbation are not ported)."""

import io
import struct
from typing import Tuple

import numpy as np


def _read_exact(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise ValueError('truncated wav header')
    return data


def read_wav(path_or_bytes, start_frame: int = 0,
             num_frames: int = -1) -> Tuple[np.ndarray, int]:
    """RIFF WAV (a path or its bytes) -> (waveform (channels, S) float32
    in [-1, 1], sample rate).  PCM 8/16/24/32-bit and IEEE float32;
    `start_frame` / `num_frames` (>= 0) read a window of the samples.
    Raises ValueError on anything else."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, 'rb')
    with f:
        riff, _, wave = struct.unpack('<4sI4s', _read_exact(f, 12))
        if riff != b'RIFF' or wave != b'WAVE':
            raise ValueError('not a RIFF wav')
        fmt = data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack('<4sI', hdr)
            if cid == b'fmt ':
                fmt = _read_exact(f, size)
                if size % 2:
                    f.read(1)
            elif cid == b'data':
                if num_frames >= 0 and fmt is not None and len(fmt) >= 16:
                    block_align = struct.unpack('<H', fmt[12:14])[0]
                    skip = min(start_frame * block_align, size)
                    f.seek(skip, 1)
                    # clamp to the data chunk: a trailing LIST chunk is not
                    # samples
                    data = f.read(max(min(num_frames * block_align,
                                          size - skip), 0))
                    break
                data = f.read(size)
            else:
                f.seek(size + (size % 2), 1)
    if fmt is None or data is None or len(fmt) < 16:
        raise ValueError('malformed wav: no fmt or data chunk')
    audio_fmt, channels, rate, _, _, bits = struct.unpack('<HHIIHH',
                                                          fmt[:16])
    if channels == 0:
        raise ValueError('malformed wav: no channels')
    if audio_fmt == 3 or (audio_fmt == 0xFFFE and bits == 32):
        wavf = np.frombuffer(data[:len(data) // 4 * 4], '<f4').astype(
            np.float32)
    elif bits == 16:
        wavf = np.frombuffer(data[:len(data) // 2 * 2],
                             '<i2').astype(np.float32) / 32768.0
    elif bits == 32:
        wavf = np.frombuffer(data[:len(data) // 4 * 4],
                             '<i4').astype(np.float32) / 2147483648.0
    elif bits == 8:
        wavf = (np.frombuffer(data, np.uint8).astype(np.float32) -
                128.0) / 128.0
    elif bits == 24:
        raw = np.frombuffer(data[:len(data) // 3 * 3],
                            np.uint8).reshape(-1, 3)
        ints = (raw[:, 0].astype(np.int32) |
                (raw[:, 1].astype(np.int32) << 8) |
                (raw[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= (1 << 23), ints - (1 << 24), ints)
        wavf = ints.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f'unsupported wav: fmt={audio_fmt} bits={bits}')
    n = (len(wavf) // channels) * channels
    return np.ascontiguousarray(wavf[:n].reshape(-1, channels).T), rate


def write_wav(path, waveform: np.ndarray, rate: int) -> None:
    """float32 (C, S) or (S,) in [-1, 1] -> a 16-bit PCM wav file."""
    wav = np.atleast_2d(np.asarray(waveform))
    pcm = np.clip(wav.T * 32768.0, -32768, 32767).astype('<i2')
    data = pcm.tobytes()
    C = wav.shape[0]
    with open(path, 'wb') as f:
        f.write(struct.pack('<4sI4s', b'RIFF', 36 + len(data), b'WAVE'))
        f.write(struct.pack('<4sIHHIIHH', b'fmt ', 16, 1, C, rate,
                            rate * C * 2, C * 2, 16))
        f.write(struct.pack('<4sI', b'data', len(data)))
        f.write(data)
