"""Audio IO and resampling on the host, with `struct`, numpy and scipy.
Counterpart of wenet_tpu/dataset/audio.py: RIFF wav read and written
here, FLAC through the port's C++ decoder (`csrc/flac_decoder.cc`, built
with g++ at first use by `utils/native.py`), resampling and the speed
perturbation through scipy's `resample_poly`."""

import ctypes
import io
import struct
import threading
from math import gcd
from typing import Optional, Tuple

import numpy as np

from wenet_tpu_torch.utils.native import load_library


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


def wav_info(path) -> Tuple[int, int, int]:
    """(sample rate, frames, channels) of a wav file from its header."""
    with open(path, 'rb') as f:
        f.read(12)
        rate, channels, bits, data_size = 16000, 1, 16, 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = struct.unpack('<4sI', hdr)
            if cid == b'fmt ':
                fmt = f.read(size)
                _, channels, rate, _, _, bits = struct.unpack('<HHIIHH',
                                                              fmt[:16])
                if size % 2:
                    f.read(1)
            elif cid == b'data':
                data_size = size
                break
            else:
                f.seek(size + (size % 2), 1)
    return rate, data_size // (channels * (bits // 8)), channels


_flac_lib: Optional[ctypes.CDLL] = None
_flac_lock = threading.Lock()


def _load_flac() -> ctypes.CDLL:
    """The FLAC decoder, compiled at first use; raises if it cannot be
    built."""
    global _flac_lib
    with _flac_lock:
        if _flac_lib is None:
            lib = load_library('flac_decoder.cc', 'flac_dec')
            c = ctypes
            lib.flac_decode.restype = c.c_int
            lib.flac_decode.argtypes = [
                c.c_char_p, c.c_size_t, c.POINTER(c.POINTER(c.c_int32)),
                c.POINTER(c.c_int64), c.POINTER(c.c_int),
                c.POINTER(c.c_int), c.POINTER(c.c_int)]
            lib.flac_info.restype = c.c_int
            lib.flac_info.argtypes = [
                c.c_char_p, c.c_size_t, c.POINTER(c.c_int64),
                c.POINTER(c.c_int), c.POINTER(c.c_int), c.POINTER(c.c_int)]
            lib.flac_free.argtypes = [c.POINTER(c.c_int32)]
            _flac_lib = lib
        return _flac_lib


def read_flac(path_or_bytes) -> Tuple[np.ndarray, int]:
    """FLAC (a path or its bytes) -> ((channels, S) float32 in [-1, 1],
    sample rate).  Raises ValueError on a stream the decoder refuses."""
    lib = _load_flac()
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, 'rb') as f:
            raw = f.read()
    samples = ctypes.POINTER(ctypes.c_int32)()
    frames, channels = ctypes.c_int64(), ctypes.c_int()
    rate, bps = ctypes.c_int(), ctypes.c_int()
    rc = lib.flac_decode(raw, len(raw), ctypes.byref(samples),
                         ctypes.byref(frames), ctypes.byref(channels),
                         ctypes.byref(rate), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f'flac decode failed rc={rc}')
    try:
        n = frames.value * channels.value
        pcm = np.ctypeslib.as_array(samples, shape=(n,)).copy()
    finally:
        lib.flac_free(samples)
    wav = pcm.astype(np.float32) / float(1 << (bps.value - 1))
    return (np.ascontiguousarray(wav.reshape(-1, channels.value).T),
            rate.value)


def flac_info(path) -> Tuple[int, int, int]:
    """(sample rate, frames, channels) from a FLAC file's STREAMINFO."""
    lib = _load_flac()
    with open(path, 'rb') as f:
        head = f.read(64)
    frames, channels = ctypes.c_int64(), ctypes.c_int()
    rate, bps = ctypes.c_int(), ctypes.c_int()
    rc = lib.flac_info(head, len(head), ctypes.byref(frames),
                       ctypes.byref(channels), ctypes.byref(rate),
                       ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f'flac info failed rc={rc}')
    return rate.value, int(frames.value), channels.value


def read_audio(path_or_bytes) -> Tuple[np.ndarray, int]:
    """A RIFF wav or a FLAC stream, told apart by its first four bytes."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        head = bytes(path_or_bytes[:4])
    else:
        with open(path_or_bytes, 'rb') as f:
            head = f.read(4)
    if head == b'fLaC':
        return read_flac(path_or_bytes)
    return read_wav(path_or_bytes)


def resample(waveform: np.ndarray, orig_rate: int,
             new_rate: int) -> np.ndarray:
    """Polyphase resampling along the last axis (scipy)."""
    if orig_rate == new_rate:
        return waveform
    from scipy.signal import resample_poly
    g = gcd(orig_rate, new_rate)
    return resample_poly(waveform, new_rate // g, orig_rate // g,
                         axis=-1).astype(np.float32)


def speed_perturb(waveform: np.ndarray, rate: int,
                  speed: float) -> np.ndarray:
    """sox's `speed` effect (tempo and pitch): resampling by 1 / speed."""
    if speed == 1.0:
        return waveform
    from scipy.signal import resample_poly
    up, down = int(round(rate / speed)), rate
    g = gcd(up, down)
    return resample_poly(waveform, up // g, down // g,
                         axis=-1).astype(np.float32)
