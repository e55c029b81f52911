"""Kaldi ark/scp matrix and vector IO (binary float).  Counterpart of
wenet_tpu/dataset/kaldi_io.py: binary float and double matrices ('FM' /
'DM') and vectors ('FV' / 'DV'), compressed matrices ('CM', format 1,
decompressed on read), scp indirection ('file.ark:offset') and ark
streams.  Raises ValueError on another format.
"""

import struct
from typing import Iterator, Tuple

import numpy as np


def _read_token(f) -> str:
    tok = b''
    while True:
        c = f.read(1)
        if not c or c == b' ':
            break
        tok += c
    return tok.decode()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _expect_binary(f):
    two = f.read(2)
    _check(two == b'\0B', f'only binary kaldi format supported ({two!r})')


def _read_int32(f) -> int:
    size = f.read(1)
    _check(size == b'\x04', 'expected int32 size marker')
    return struct.unpack('<i', f.read(4))[0]


def _write_int32(f, v: int):
    f.write(b'\x04' + struct.pack('<i', v))


def _read_mat_binary(f) -> np.ndarray:
    tok = _read_token(f)
    if tok == 'CM':
        return _read_compressed_mat(f)
    _check(tok in ('FM', 'DM'), f'unsupported matrix type {tok}')
    dtype = '<f4' if tok == 'FM' else '<f8'
    rows = _read_int32(f)
    cols = _read_int32(f)
    data = f.read(rows * cols * int(dtype[-1]))
    return np.frombuffer(data, dtype).reshape(rows, cols).astype(
        np.float32)


def _read_vec_binary(f) -> np.ndarray:
    tok = _read_token(f)
    _check(tok in ('FV', 'DV'), f'unsupported vector type {tok}')
    dtype = '<f4' if tok == 'FV' else '<f8'
    n = _read_int32(f)
    return np.frombuffer(f.read(n * int(dtype[-1])), dtype).astype(
        np.float32)


def _read_compressed_mat(f) -> np.ndarray:
    """kaldi CompressedMatrix format 1 (per-column 4-point quantizer)."""
    min_value, rnge = struct.unpack('<ff', f.read(8))
    rows, cols = struct.unpack('<ii', f.read(8))
    # per-column headers: 4 uint16 percentile points
    headers = np.frombuffer(f.read(cols * 8), '<u2').reshape(cols, 4)
    data = np.frombuffer(f.read(rows * cols), 'u1').reshape(cols, rows)
    p = min_value + headers.astype(np.float32) * (rnge / 65535.0)
    p0, p25, p75, p100 = (p[:, i][:, None] for i in range(4))
    d = data.astype(np.float32)
    out = np.where(
        d <= 64, p0 + (p25 - p0) * (d / 64.0),
        np.where(d <= 192, p25 + (p75 - p25) * ((d - 64) / 128.0),
                 p75 + (p100 - p75) * ((d - 192) / 63.0)))
    return out.T.copy()


def read_mat(path_or_fd) -> np.ndarray:
    """Read one matrix from 'file.ark:offset' or an open fd."""
    f, own = _open(path_or_fd)
    try:
        _expect_binary(f)
        return _read_mat_binary(f)
    finally:
        if own:
            f.close()


def read_vec_flt(path_or_fd) -> np.ndarray:
    f, own = _open(path_or_fd)
    try:
        _expect_binary(f)
        return _read_vec_binary(f)
    finally:
        if own:
            f.close()


def _open(path_or_fd):
    if hasattr(path_or_fd, 'read'):
        return path_or_fd, False
    path = path_or_fd
    offset = None
    if ':' in path and path.rsplit(':', 1)[1].isdigit():
        path, off = path.rsplit(':', 1)
        offset = int(off)
    f = open(path, 'rb')
    if offset is not None:
        f.seek(offset)
    return f, True


def read_mat_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    with open(scp_path, encoding='utf-8') as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) != 2:
                continue
            yield parts[0], read_mat(parts[1])


def read_mat_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    with open(ark_path, 'rb') as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            _expect_binary(f)
            yield key, _read_mat_binary(f)


def read_vec_flt_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    with open(scp_path, encoding='utf-8') as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                yield parts[0], read_vec_flt(parts[1])


def write_mat(f, mat: np.ndarray, key: str = '') -> int:
    """Write one float matrix; returns the data offset (for scp)."""
    if key:
        f.write((key + ' ').encode())
    offset = f.tell()
    f.write(b'\0B')
    f.write(b'FM ')
    mat = np.asarray(mat, '<f4')
    _write_int32(f, mat.shape[0])
    _write_int32(f, mat.shape[1])
    f.write(mat.tobytes())
    return offset


def write_vec_flt(f, vec: np.ndarray, key: str = '') -> int:
    if key:
        f.write((key + ' ').encode())
    offset = f.tell()
    f.write(b'\0B')
    f.write(b'FV ')
    vec = np.asarray(vec, '<f4')
    _write_int32(f, vec.shape[0])
    f.write(vec.tobytes())
    return offset


def write_ark_scp(ark_path: str,
                  mats,
                  scp_path: str = None) -> int:
    """Convenience: write {key: matrix} (or an iterable of (key, mat)
    pairs) to ark (+ optional scp). Returns the number of matrices."""
    if isinstance(mats, dict):
        mats = mats.items()
    n = 0
    scp = open(scp_path, 'w', encoding='utf-8') if scp_path else None
    with open(ark_path, 'wb') as f:
        for key, mat in mats:
            offset = write_mat(f, mat, key)
            n += 1
            if scp:
                scp.write(f'{key} {ark_path}:{offset}\n')
    if scp:
        scp.close()
    return n
