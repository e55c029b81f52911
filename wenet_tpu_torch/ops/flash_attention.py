"""Fused rel-pos attention forward: the Hopper CUDA kernel and its plain
PyTorch version.

Counterpart of `flash_attention_relpos` in wenet_tpu/ops/flash_attention.py.
The kernel (csrc/relpos_attention.cu) replaces the Pallas TPU kernel
`_relpos_fwd_kernel`: s = (q1·kᵀ + q2·pᵀ)·scale, masked, online softmax
over key tiles, out = softmax·v, never writing the (T1, T2) scores to
device memory.  On an H100 the simple kernel is bound by fp32 FMA issue on
the CUDA cores and the shared-memory reads feeding it, not by device
memory; register tiling (4x4 scores per thread) keeps two FMAs per
shared-memory read.  See the source for the full note.

The kernel is compiled with nvcc for sm_90a at first use into
`wenet_tpu_torch/build/` and loaded with ctypes.  CPU tensors take
`relpos_attention_reference`; CUDA tensors always take the kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1.0e30

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / 'csrc' / 'relpos_attention.cu'
BUILD_DIR = _PKG / 'build'
_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def relpos_attention_reference(q1, q2, k, p, v, mask=None, scale=1.0):
    """Plain PyTorch version of the kernel (mirrors `_relpos_reference`).

    q1, q2: (B, h, T1, d); k, v: (B, h, T2, d); p: (1|B, h, T2, d);
    mask: bool (B, T1|1, T2) or (B, 1, T1|1, T2), True == attend.
    Scores and softmax are fp32; the weights are rounded to v's dtype
    before the last product, as the JAX reference does."""
    s = (torch.matmul(q1.float(), k.float().transpose(-1, -2)) +
         torch.matmul(q2.float(), p.float().transpose(-1, -2))) * scale
    if mask is not None:
        m = mask if mask.dim() == 4 else mask.unsqueeze(1)
        s = s.masked_fill(~m, NEG_INF)
    a = torch.softmax(s, dim=-1)
    if mask is not None:
        a = a.masked_fill(~m, 0.0)
    return torch.matmul(a.to(v.dtype).float(), v.float()).to(v.dtype)


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on '
                           'PATH to build the rel-pos attention kernel')
    return path


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    so = BUILD_DIR / f'librelpos_attention_{hashlib.sha256(src).hexdigest()[:16]}.so'
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
               '-Xptxas=-v', '-o', str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / 'relpos_attention.log').write_text(
            ' '.join(cmd) + '\n' + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed ({res.returncode}):\n'
                               f'{res.stderr[-4000:]}')
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.relpos_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
        ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
    lib.relpos_attention_fwd.restype = ci
    _lib = lib
    return lib


def _check(q1, q2, k, p, v, m):
    """m: the mask as (B|1, 1, T1|1, T2), or None."""
    B, H, T1, D = q1.shape
    T2 = k.shape[2]
    dev = q1.device
    for name, t, shape in (('q2', q2, (B, H, T1, D)),
                           ('k', k, (B, H, T2, D)),
                           ('v', v, (B, H, T2, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {shape}')
    if tuple(p.shape) not in ((1, H, T2, D), (B, H, T2, D)):
        raise ValueError(f'p has shape {tuple(p.shape)}, expected '
                         f'(1|{B}, {H}, {T2}, {D})')
    if D not in _HEAD_DIMS:
        raise ValueError(f'head dim {D} not in {_HEAD_DIMS}')
    if q1.dtype not in _DTYPES:
        raise ValueError(f'dtype {q1.dtype} not supported')
    for name, t in (('q1', q1), ('q2', q2), ('k', k), ('p', p), ('v', v)):
        if t.device != dev or t.dtype != q1.dtype:
            raise ValueError(f'{name} is {t.dtype} on {t.device}, expected '
                             f'{q1.dtype} on {dev}')
        if t.stride(-1) != 1:
            raise ValueError(f'{name} must be unit-stride in its last dim')
    if B * H > 65535:
        raise ValueError(f'B*h = {B * H} exceeds the grid limit')
    if m is not None and (
            m.dtype != torch.bool or m.device != dev or m.dim() != 4
            or m.shape[0] not in (1, B) or m.shape[1] != 1
            or m.shape[2] not in (1, T1) or m.shape[3] != T2):
        raise ValueError(f'mask {m.dtype} {tuple(m.shape)} on {m.device} '
                         f'does not broadcast to ({B}, 1, {T1}, {T2}) bool '
                         f'on {dev}')


def _bht_strides(t):
    return [0 if t.shape[0] == 1 else t.stride(0), t.stride(1), t.stride(2)]


def flash_attention_relpos(q1, q2, k, p, v,
                           mask: Optional[torch.Tensor] = None,
                           scale: float = 1.0) -> torch.Tensor:
    """Rel-pos attention, softmax((q1·kᵀ + q2·pᵀ)·scale) · v.

    Same arguments as the JAX entry: q1, q2 (B, h, T1, d); k, v
    (B, h, T2, d); p (1|B, h, T2, d); mask bool (B, T1|1, T2) or
    (B, 1, T1|1, T2), True == attend.  Tensors may be strided views as
    long as the last dim is unit-stride.  CPU tensors go to the plain
    version; CUDA tensors launch the kernel (float32 or bfloat16, d in
    32/64/128) and raise on anything it does not take."""
    if q1.device.type == 'cpu':
        return relpos_attention_reference(q1, q2, k, p, v, mask, scale)
    if q1.device.type != 'cuda':
        raise ValueError(f'no rel-pos attention for device {q1.device}')
    m = mask.unsqueeze(1) if mask is not None and mask.dim() == 3 else mask
    _check(q1, q2, k, p, v, m)
    B, H, T1, D = q1.shape
    T2 = k.shape[2]
    out = torch.empty(q1.shape, dtype=v.dtype, device=q1.device)
    if out.numel() == 0:
        return out
    strides = (_bht_strides(q1) + _bht_strides(q2) + _bht_strides(k) +
               _bht_strides(p) + _bht_strides(v) + _bht_strides(out))
    mask_ptr = None
    if m is not None:
        strides += [0 if m.shape[0] == 1 else m.stride(0),
                    0 if m.shape[2] == 1 else m.stride(2), m.stride(3)]
        mask_ptr = m.data_ptr()
    else:
        strides += [0, 0, 0]
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    lib = build()
    with torch.cuda.device(q1.device):
        stream = torch.cuda.current_stream(q1.device).cuda_stream
        err = lib.relpos_attention_fwd(
            q1.data_ptr(), q2.data_ptr(), k.data_ptr(), p.data_ptr(),
            v.data_ptr(), mask_ptr, out.data_ptr(), c_strides, B, H, T1,
            T2, D, _DTYPES[q1.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(f'relpos_attention_fwd failed: cudaError {err}')
    flash_attention_relpos.launches += 1
    return out


# launches of the CUDA kernel (the CPU path does not count)
flash_attention_relpos.launches = 0
