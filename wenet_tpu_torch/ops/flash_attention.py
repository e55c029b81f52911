"""Flash attention on Hopper: the CUDA kernels, their plain PyTorch
versions and the autograd Functions around them.

Counterpart of `flash_attention_relpos` and `flash_attention` in
wenet_tpu/ops/flash_attention.py.  Six CUDA kernels replace the Pallas
TPU kernels of that file:

  K1 `relpos_fwd_kernel`       (csrc/relpos_attention.cu)  <- _relpos_fwd_kernel
     s = (q1·kᵀ + q2·pᵀ)·scale, masked, online softmax over key tiles,
     out = softmax·v; the train variant also writes lse and applies the
     attention-weight dropout to the v-accumulator only.
  K2 `relpos_bwd_dq_kernel`    (csrc/relpos_attention_bwd.cu) <- _relpos_bwd_dq_kernel
     dq1, dq2 from ds = P·(D·(do·vᵀ) − delta)·scale, P = exp(s − lse).
  K3 `relpos_bwd_dkpv_kernel`  (csrc/relpos_attention_bwd.cu) <- _relpos_bwd_dkpv_kernel
     dk, dp, dv with the same ds, streaming query tiles.
  K4 `flash_fwd_kernel`        (csrc/flash_attention.cu)   <- _fwd_kernel
     s = (q·kᵀ + bias)·scale, masked, online softmax, out = softmax·v;
     the train variant also writes lse.
  K5 `flash_bwd_dq_kernel`     (csrc/flash_attention_bwd.cu) <- _bwd_dq_kernel
     dq from ds = P·(do·vᵀ − delta)·scale, and ds itself as dbias when
     there is a bias.
  K6 `flash_bwd_dkv_kernel`    (csrc/flash_attention_bwd.cu) <- _bwd_dkv_kernel
     dk = dsᵀ·q, dv = Pᵀ·do, streaming query tiles.

None of them writes the (T1, T2) scores to device memory (K5's dbias is
the gradient of a (T1, T2) input).  The dropout mask D is a counter hash
of (seed, b·h, global query, global key) (`dropout_mult`,
csrc/dropout_hash.cuh), so K1-K3 regenerate the same mask whatever their
tiling; K4-K6 have no dropout, as the JAX package never routes attention
dropout to them.  On an H100 the simple kernels are bound by fp32 FMA
issue on the CUDA cores and the shared-memory reads feeding them; see
the sources for the notes.

The kernels are compiled with nvcc for sm_90a at first use into
`wenet_tpu_torch/build/` (one nvcc per source, run in parallel, keyed by
the hash of all sources) and loaded with ctypes.  CPU tensors take the
plain versions (`relpos_fwd_reference`, `relpos_bwd_dq_reference`,
`relpos_bwd_dkpv_reference`, `flash_fwd_reference`,
`flash_bwd_dq_reference`, `flash_bwd_dkv_reference`); CUDA tensors always
launch the kernels and raise on what they do not take.  `LAUNCHES` counts
the kernel launches.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1.0e30

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
SOURCES = {'relpos_attention': CSRC / 'relpos_attention.cu',
           'relpos_attention_bwd': CSRC / 'relpos_attention_bwd.cu',
           'flash_attention': CSRC / 'flash_attention.cu',
           'flash_attention_bwd': CSRC / 'flash_attention_bwd.cu'}
HEADERS = (CSRC / 'dropout_hash.cuh', CSRC / 'relpos_common.cuh')
BUILD_DIR = _PKG / 'build'
_HEAD_DIMS = (32, 64, 128)
_TRAIN_HEAD_DIMS = (32, 64)  # K3's shared-memory tiles do not fit d=128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_libs: Dict[str, ctypes.CDLL] = {}

# kernel launches on CUDA tensors, by kernel (the CPU path does not count)
LAUNCHES = {'relpos_attention_fwd': 0, 'relpos_attention_fwd_train': 0,
            'relpos_attention_bwd_dq': 0, 'relpos_attention_bwd_dkpv': 0,
            'flash_attention_fwd': 0, 'flash_attention_fwd_train': 0,
            'flash_attention_bwd_dq': 0, 'flash_attention_bwd_dkv': 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the dropout hash (mirrors _dropout_mult bit for bit)
# ---------------------------------------------------------------------------
_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 `a` in [0, 2**32), in two 16-bit halves
    so no int64 product can overflow."""
    high = (((a >> 16) * c) & 0xFFFF) << 16
    return (high + (a & 0xFFFF) * c) & _U32


def dropout_threshold(rate: float) -> int:
    """Keep where hash >= this, computed in double as the JAX package does."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_scale(rate: float) -> float:
    """float32(1 / (1 - rate)), as a Python float."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_mult(seed: int, bh: torch.Tensor, qi: torch.Tensor,
                 ki: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain version of the kernels' dropout multiplier: 0 or
    float32(1/(1-rate)) from the murmur3 fmix32 hash of (seed, b·h, global
    query row, global key column).  bh, qi, ki: non-negative int64 tensors
    that broadcast together; seed: an int in [0, 2**32).  uint32
    arithmetic is done in int64 and masked after every multiply and add,
    so `>>` is a logical shift."""
    u = _mul32(qi, 0x9E3779B1) ^ _mul32(ki, 0x85EBCA77)
    u = (u + ((int(seed) + _mul32(bh, 0x27D4EB2F)) & _U32)) & _U32
    u = u ^ (u >> 16)
    u = _mul32(u, 0x85EBCA6B)
    u = u ^ (u >> 13)
    u = _mul32(u, 0xC2B2AE35)
    u = u ^ (u >> 16)
    keep = u >= dropout_threshold(rate)
    return keep.to(torch.float32) * dropout_keep_scale(rate)


def dense_dropout(B, H, T1, T2, rate, seed, device) -> torch.Tensor:
    """The (B, H, T1, T2) dropout multiplier the kernels apply."""
    def idx(n, shape):
        return torch.arange(n, device=device).view(shape)
    return dropout_mult(seed, idx(B * H, (B, H, 1, 1)), idx(T1, (1, 1, T1, 1)),
                        idx(T2, (1, 1, 1, T2)), rate)


# ---------------------------------------------------------------------------
# plain versions of K1, K2 and K3
# ---------------------------------------------------------------------------
def _mask4(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, T1|1, T2) -> (B, 1, T1|1, T2); 4-d masks pass through."""
    return mask.unsqueeze(1) if mask is not None and mask.dim() == 3 else mask


def _scores(q1, q2, k, p, mask, scale) -> torch.Tensor:
    s = (torch.matmul(q1.float(), k.float().transpose(-1, -2)) +
         torch.matmul(q2.float(), p.float().transpose(-1, -2))) * scale
    if mask is not None:
        s = s.masked_fill(~_mask4(mask), NEG_INF)
    return s


def _probs(s: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """P = exp(s - lse), zero where s <= NEG_INF / 2."""
    return torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None]))


def _dropout_for(q1, k, rate, seed) -> Optional[torch.Tensor]:
    if rate <= 0.0:
        return None
    B, H, T1, _ = q1.shape
    return dense_dropout(B, H, T1, k.shape[2], rate, seed, q1.device)


def relpos_fwd_reference(q1, q2, k, p, v, mask=None, scale=1.0,
                         want_lse: bool = False, dropout_rate: float = 0.0,
                         seed: Optional[int] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K1 (mirrors `_relpos_reference`) -> (out, lse).

    q1, q2: (B, h, T1, d); k, v: (B, h, T2, d); p: (1|B, h, T2, d);
    mask: bool (B, T1|1, T2) or (B, 1, T1|1, T2), True == attend.  Scores
    and softmax are fp32; dropout multiplies the normalized weights, which
    are rounded to v's dtype before the last product, as the JAX reference
    does.  lse: (B, h, T1) fp32, NEG_INF on fully masked rows (None unless
    `want_lse`)."""
    s = _scores(q1, q2, k, p, mask, scale)
    a = torch.softmax(s, dim=-1)
    if mask is not None:
        a = a.masked_fill(~_mask4(mask), 0.0)
    drop = _dropout_for(q1, k, dropout_rate, seed)
    if drop is not None:
        a = a * drop
    out = torch.matmul(a.to(v.dtype).float(), v.float()).to(v.dtype)
    lse = None
    if want_lse:
        valid = (s > NEG_INF * 0.5).any(dim=-1)
        lse = torch.where(valid, torch.logsumexp(s, dim=-1), NEG_INF)
    return out, lse


def relpos_bwd_dq_reference(q1, q2, k, p, v, mask, do, lse, delta,
                            scale=1.0, dropout_rate: float = 0.0,
                            seed: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 -> (dq1, dq2) in q1's and q2's dtypes.

    do: (B, h, T1, d); lse, delta: (B, h, T1) fp32 (delta =
    rowsum(do·out)); the rest as in `relpos_fwd_reference`."""
    P = _probs(_scores(q1, q2, k, p, mask, scale), lse)
    dpv = torch.matmul(do.float(), v.float().transpose(-1, -2))
    drop = _dropout_for(q1, k, dropout_rate, seed)
    if drop is not None:
        dpv = dpv * drop
    ds = P * (dpv - delta[..., None]) * scale
    return (torch.matmul(ds, k.float()).to(q1.dtype),
            torch.matmul(ds, p.float()).to(q2.dtype))


def relpos_bwd_dkpv_reference(q1, q2, k, p, v, mask, do, lse, delta,
                              scale=1.0, dropout_rate: float = 0.0,
                              seed: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of K3 -> (dk, dp, dv): dk in k's dtype, dv in v's,
    dp fp32 per (b, h), shape (B, h, T2, d) even when p is shared by the
    batch (the caller sums it)."""
    P = _probs(_scores(q1, q2, k, p, mask, scale), lse)
    dpv = torch.matmul(do.float(), v.float().transpose(-1, -2))
    drop = _dropout_for(q1, k, dropout_rate, seed)
    pv = P
    if drop is not None:
        pv = P * drop
        dpv = dpv * drop
    ds = (P * (dpv - delta[..., None]) * scale).transpose(-1, -2)
    dv = torch.matmul(pv.transpose(-1, -2), do.float())
    return (torch.matmul(ds, q1.float()).to(k.dtype),
            torch.matmul(ds, q2.float()),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# build and launch
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on '
                           'PATH to build the attention kernels')
    return path


def _declare(libs: Dict[str, ctypes.CDLL]) -> None:
    vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float)
    strides = ctypes.POINTER(ctypes.c_longlong)
    fwd = libs['relpos_attention']
    fwd.relpos_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, strides, ci, ci, ci, ci, ci, ci, cf, vp]
    fwd.relpos_attention_fwd_train.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, strides, ci, ci, ci, ci, ci, ci, cf,
        ci, cu, cu, cf, vp]
    bwd = libs['relpos_attention_bwd']
    bwd.relpos_attention_bwd_dq.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, strides, ci, ci, ci, ci,
        ci, ci, cf, ci, cu, cu, cf, vp]
    bwd.relpos_attention_bwd_dkpv.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, strides, ci, ci, ci,
        ci, ci, ci, cf, ci, cu, cu, cf, vp]
    flash = libs['flash_attention']
    flash.flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, strides, ci, ci, ci, ci, ci, ci, cf, vp]
    flash.flash_attention_fwd_train.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, strides, ci, ci, ci, ci, ci, ci, cf, vp]
    flash_bwd = libs['flash_attention_bwd']
    for fn in (flash_bwd.flash_attention_bwd_dq,
               flash_bwd.flash_attention_bwd_dkv):
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, strides, ci,
                       ci, ci, ci, ci, ci, cf, vp]
    for fn in (fwd.relpos_attention_fwd, fwd.relpos_attention_fwd_train,
               bwd.relpos_attention_bwd_dq, bwd.relpos_attention_bwd_dkpv,
               flash.flash_attention_fwd, flash.flash_attention_fwd_train,
               flash_bwd.flash_attention_bwd_dq,
               flash_bwd.flash_attention_bwd_dkv):
        fn.restype = ci


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (once per hash of all the sources) and load the kernel
    libraries, one nvcc per source, all started together."""
    if _libs:
        return _libs
    digest = hashlib.sha256()
    for path in sorted(list(SOURCES.values()) + list(HEADERS)):
        digest.update(path.name.encode() + b'\0' + path.read_bytes())
    tag = digest.hexdigest()[:16]
    sos = {name: BUILD_DIR / f'lib{name}_{tag}.so' for name in SOURCES}
    jobs = {}
    for name, so in sos.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
               '-Xptxas=-v', '-I', str(CSRC), '-o', str(tmp),
               str(SOURCES[name])]
        jobs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, proc) in jobs.items():
        out, err = proc.communicate()
        (BUILD_DIR / f'{name}.log').write_text(' '.join(cmd) + '\n' + out +
                                               err)
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc failed ({proc.returncode}):\n'
                          f'{err[-4000:]}')
        else:
            os.replace(tmp, sos[name])
    if failed:
        raise RuntimeError('\n'.join(failed))
    libs = {name: ctypes.CDLL(str(so)) for name, so in sos.items()}
    _declare(libs)
    _libs.update(libs)
    return _libs


def _check(q1, q2, k, p, v, m, train: bool = False):
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
    dims = _TRAIN_HEAD_DIMS if train else _HEAD_DIMS
    if D not in dims:
        raise ValueError(f'head dim {D} not in {dims}'
                         f'{" for training" if train else ""}')
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


def _mask_args(m):
    if m is None:
        return [0, 0, 0], None
    return [0 if m.shape[0] == 1 else m.stride(0),
            0 if m.shape[2] == 1 else m.stride(2), m.stride(3)], m.data_ptr()


def _like_heads(t: torch.Tensor, dtype) -> torch.Tensor:
    """An empty (B, h, T, d) tensor laid out as (B, T, h, d), the
    attention module's memory order."""
    B, H, T, D = t.shape
    return torch.empty(B, T, H, D, dtype=dtype,
                       device=t.device).transpose(1, 2)


def _dropout_args(rate: float, seed: Optional[int]):
    if rate <= 0.0:
        return [0, 0, 0, 0.0]
    if seed is None:
        raise ValueError('dropout_rate > 0 needs a dropout seed')
    return [1, int(seed) & _U32, dropout_threshold(rate),
            dropout_keep_scale(rate)]


def _run(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name} failed: cudaError {err}')
    LAUNCHES[name] += 1


def _fwd_cuda(q1, q2, k, p, v, m, scale, want_lse, rate, seed):
    train = want_lse or rate > 0.0
    _check(q1, q2, k, p, v, m, train)
    B, H, T1, D = q1.shape
    T2 = k.shape[2]
    out = _like_heads(q1, v.dtype)
    lse = (torch.empty(B, H, T1, dtype=torch.float32, device=q1.device)
           if train else None)
    if out.numel() == 0:
        if lse is not None:
            lse.fill_(NEG_INF)
        return out, lse
    mstrides, mask_ptr = _mask_args(m)
    strides = (_bht_strides(q1) + _bht_strides(q2) + _bht_strides(k) +
               _bht_strides(p) + _bht_strides(v) + _bht_strides(out) +
               mstrides)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    lib = build()['relpos_attention']
    ptrs = [q1.data_ptr(), q2.data_ptr(), k.data_ptr(), p.data_ptr(),
            v.data_ptr(), mask_ptr, out.data_ptr()]
    dims = [B, H, T1, T2, D, _DTYPES[q1.dtype], float(scale)]
    if train:
        _run('relpos_attention_fwd_train', lib.relpos_attention_fwd_train,
             *ptrs, lse.data_ptr(), c_strides, *dims,
             *_dropout_args(rate, seed), device=q1.device)
    else:
        _run('relpos_attention_fwd', lib.relpos_attention_fwd, *ptrs,
             c_strides, *dims, device=q1.device)
    return out, lse


def _bwd_cuda(which, q1, q2, k, p, v, m, do, lse, delta, scale, rate, seed):
    """Launch K2 (which='dq') or K3 (which='dkpv')."""
    _check(q1, q2, k, p, v, m, train=True)
    if do.dtype != q1.dtype or tuple(do.shape) != tuple(q1.shape):
        raise ValueError(f'do is {do.dtype} {tuple(do.shape)}, expected '
                         f'{q1.dtype} {tuple(q1.shape)}')
    B, H, T1, D = q1.shape
    T2 = k.shape[2]
    if which == 'dq':
        outs = [_like_heads(q1, q1.dtype), _like_heads(q2, q2.dtype)]
    else:
        outs = [_like_heads(k, k.dtype),
                torch.empty(B, H, T2, D, dtype=torch.float32,
                            device=k.device),
                _like_heads(v, v.dtype)]
    if any(t.numel() == 0 for t in outs):
        return tuple(t.zero_() for t in outs)
    for t in (lse, delta):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, T1)
                or not t.is_contiguous()):
            raise ValueError('lse and delta must be contiguous float32 '
                             f'({B}, {H}, {T1})')
    mstrides, mask_ptr = _mask_args(m)
    # stride slots: q1 q2 k p v do | dq1 dq2 | dk dp dv | mask
    grads = (outs + [None] * 3) if which == 'dq' else ([None] * 2 + outs)
    strides = []
    for t in (q1, q2, k, p, v, do, *grads):
        strides += [0, 0, 0] if t is None else _bht_strides(t)
    strides += mstrides
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    lib = build()['relpos_attention_bwd']
    name = f'relpos_attention_bwd_{which}'
    _run(name, getattr(lib, name), q1.data_ptr(), q2.data_ptr(),
         k.data_ptr(), p.data_ptr(), v.data_ptr(), mask_ptr, do.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
         c_strides, B, H, T1, T2, D, _DTYPES[q1.dtype], float(scale),
         *_dropout_args(rate, seed), device=q1.device)
    return tuple(outs)


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no attention kernel for device {t.device}')
    return t.device.type


def relpos_fwd(q1, q2, k, p, v, mask=None, scale=1.0, want_lse=False,
               dropout_rate=0.0, seed=None):
    """K1 on CUDA tensors, its plain version on CPU tensors -> (out, lse)."""
    if _device_kind(q1) == 'cpu':
        return relpos_fwd_reference(q1, q2, k, p, v, mask, scale, want_lse,
                                    dropout_rate, seed)
    return _fwd_cuda(q1, q2, k, p, v, _mask4(mask), scale, want_lse,
                     dropout_rate, seed)


def relpos_bwd_dq(q1, q2, k, p, v, mask, do, lse, delta, scale=1.0,
                  dropout_rate=0.0, seed=None):
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if _device_kind(q1) == 'cpu':
        return relpos_bwd_dq_reference(q1, q2, k, p, v, mask, do, lse,
                                       delta, scale, dropout_rate, seed)
    return _bwd_cuda('dq', q1, q2, k, p, v, _mask4(mask), do, lse, delta,
                     scale, dropout_rate, seed)


def relpos_bwd_dkpv(q1, q2, k, p, v, mask, do, lse, delta, scale=1.0,
                    dropout_rate=0.0, seed=None):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if _device_kind(q1) == 'cpu':
        return relpos_bwd_dkpv_reference(q1, q2, k, p, v, mask, do, lse,
                                         delta, scale, dropout_rate, seed)
    return _bwd_cuda('dkpv', q1, q2, k, p, v, _mask4(mask), do, lse, delta,
                     scale, dropout_rate, seed)


# ---------------------------------------------------------------------------
# the autograd Function (mirrors the custom_vjp of the JAX entry)
# ---------------------------------------------------------------------------
class RelPosAttention(torch.autograd.Function):
    """Forward: K1 with lse (and dropout); backward: delta = rowsum(do·out)
    in plain torch, then K2 and K3, and dp summed over the batch when p
    was shared by it.  The same code runs on both devices: `relpos_*`
    pick the kernel or the plain version by the tensors' device."""

    @staticmethod
    def forward(ctx, q1, q2, k, p, v, mask, scale, dropout_rate, seed):
        out, lse = relpos_fwd(q1, q2, k, p, v, mask, scale, True,
                              dropout_rate, seed)
        ctx.save_for_backward(q1, q2, k, p, v, mask, out, lse)
        ctx.scale, ctx.dropout_rate, ctx.seed = scale, dropout_rate, seed
        return out

    @staticmethod
    def backward(ctx, do):
        q1, q2, k, p, v, mask, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of out.sum()
            do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        args = (q1, q2, k, p, v, mask, do, lse, delta, ctx.scale,
                ctx.dropout_rate, ctx.seed)
        dq1, dq2 = relpos_bwd_dq(*args)
        dk, dp, dv = relpos_bwd_dkpv(*args)
        if p.shape[0] == 1 and dp.shape[0] != 1:
            dp = dp.sum(0, keepdim=True)
        return dq1, dq2, dk, dp.to(p.dtype), dv, None, None, None, None


def flash_attention_relpos(q1, q2, k, p, v,
                           mask: Optional[torch.Tensor] = None,
                           scale: float = 1.0, dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None
                           ) -> torch.Tensor:
    """Rel-pos attention, D·softmax((q1·kᵀ + q2·pᵀ)·scale) · v.

    Same arguments as the JAX entry: q1, q2 (B, h, T1, d); k, v
    (B, h, T2, d); p (1|B, h, T2, d); mask bool (B, T1|1, T2) or
    (B, 1, T1|1, T2), True == attend; dropout_rate with a uint32
    dropout_seed for the in-kernel attention-weight dropout D.  Tensors
    may be strided views as long as the last dim is unit-stride.

    When autograd records (grad enabled and an input requires grad) the
    call goes through `RelPosAttention`, so gradients reach q1, q2, k, p
    and v on either device; otherwise it runs the forward alone.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels
    (float32 or bfloat16; d in 32/64/128 for inference, 32/64 for
    training) and raise on anything they do not take."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError('dropout_rate > 0 needs a dropout_seed')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q1, q2, k, p, v)):
        return RelPosAttention.apply(q1, q2, k, p, v, _mask4(mask), scale,
                                     dropout_rate, dropout_seed)
    return relpos_fwd(q1, q2, k, p, v, mask, scale, False, dropout_rate,
                      dropout_seed)[0]


# ---------------------------------------------------------------------------
# K4, K5, K6: masked flash attention (mask + pre-scale bias)
# ---------------------------------------------------------------------------
def _mask_bias4(q, mask, bias):
    """mask -> bool (B|1, 1|h, 1|T1, T2), bias -> (B|1, 1|h, 1|T1, T2);
    3-d inputs (B|1, T1|1, T2) get the head dim, as `_fwd_call` does."""
    if mask is not None and mask.dim() == 3:
        mask = mask.unsqueeze(1)
    if bias is not None and bias.dim() == 3:
        bias = bias.unsqueeze(1)
    return mask, bias


def _flash_scores(q, k, mask, bias, scale) -> torch.Tensor:
    """s = (q·kᵀ + bias)·scale in fp32, NEG_INF where masked."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    s = s * scale
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_fwd_reference(q, k, v, mask=None, bias=None, scale=1.0,
                        want_lse: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K4 (mirrors `_fwd_kernel`'s arithmetic) ->
    (out, lse).

    q: (B, h, T1, d); k, v: (B, h, T2, d); mask: bool broadcastable to
    (B, h|1, T1|1, T2), True == attend; bias: additive, broadcastable to
    (B, h|1, T1|1, T2), added before the scale.  Scores, softmax and the
    last product are fp32; probabilities are zeroed where
    s <= NEG_INF / 2, so a fully masked row gives 0.  out in v's dtype;
    lse = m + log l, (B, h, T1) fp32, NEG_INF on fully masked rows (None
    unless `want_lse`)."""
    mask, bias = _mask_bias4(q, mask, bias)
    s = _flash_scores(q, k, mask, bias, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.matmul(p, v.float()) / safe_l
    out = torch.where(l > 0, out, 0.0).to(v.dtype)
    lse = None
    if want_lse:
        lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return out, lse


def _flash_ds(q, k, v, mask, bias, do, lse, delta, scale):
    """(P, ds) of the backward kernels: P = exp(s − lse) (0 where
    s <= NEG_INF / 2), ds = P·(do·vᵀ − delta)·scale, both fp32."""
    mask, bias = _mask_bias4(q, mask, bias)
    P = _probs(_flash_scores(q, k, mask, bias, scale), lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return P, P * (dp - delta[..., None]) * scale


def flash_bwd_dq_reference(q, k, v, mask, bias, do, lse, delta, scale=1.0
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K5 -> (dq in q's dtype, dbias).

    do: (B, h, T1, d); lse, delta: (B, h, T1) fp32 (delta =
    rowsum(do·out)); the rest as in `flash_fwd_reference`.  dbias is ds,
    fp32 per (b, h) as (B, h, T1, T2), when there is a bias (the caller
    sums it over the bias's broadcast dims), else None."""
    _, ds = _flash_ds(q, k, v, mask, bias, do, lse, delta, scale)
    return torch.matmul(ds, k.float()).to(q.dtype), (
        None if bias is None else ds)


def flash_bwd_dkv_reference(q, k, v, mask, bias, do, lse, delta, scale=1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6 -> (dk in k's dtype, dv in v's dtype)."""
    P, ds = _flash_ds(q, k, v, mask, bias, do, lse, delta, scale)
    dv = torch.matmul(P.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_check(q, k, v, mask, bias):
    B, H, T1, D = q.shape
    T2 = k.shape[2]
    dev = q.device
    for name, t in (('k', k), ('v', v)):
        if tuple(t.shape) != (B, H, T2, D):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {(B, H, T2, D)}')
    if D not in _HEAD_DIMS:
        raise ValueError(f'head dim {D} not in {_HEAD_DIMS}')
    if q.dtype not in _DTYPES:
        raise ValueError(f'dtype {q.dtype} not supported')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f'{name} is {t.dtype} on {t.device}, expected '
                             f'{q.dtype} on {dev}')
        if t.stride(-1) != 1:
            raise ValueError(f'{name} must be unit-stride in its last dim')
    if B * H > 65535:
        raise ValueError(f'B*h = {B * H} exceeds the grid limit')
    for name, t, dtypes, rows in (('mask', mask, (torch.bool,), (1, T1)),
                                  ('bias', bias, tuple(_DTYPES), (1, T1))):
        if t is None:
            continue
        if (t.dtype not in dtypes or t.device != dev or t.dim() != 4
                or t.shape[0] not in (1, B) or t.shape[1] not in (1, H)
                or t.shape[2] not in rows or t.shape[3] != T2):
            raise ValueError(f'{name} {t.dtype} {tuple(t.shape)} on '
                             f'{t.device} does not broadcast to '
                             f'({B}, {H}, {T1}, {T2}) on {dev}')


def _bcast_strides(t):
    """(batch, head, row, column) element strides, 0 on broadcast dims."""
    if t is None:
        return [0, 0, 0, 0]
    return [0 if t.shape[i] == 1 else t.stride(i) for i in range(4)]


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _flash_cuda(q, k, v, mask, bias, scale, want_lse=False):
    """Launch K4, or its train variant (lse) when `want_lse`."""
    _flash_check(q, k, v, mask, bias)
    B, H, T1, D = q.shape
    T2 = k.shape[2]
    out = _like_heads(q, v.dtype)
    lse = (torch.empty(B, H, T1, dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0 or T2 == 0:
        if lse is not None:
            lse.fill_(NEG_INF)
        return out.zero_(), lse
    if bias is not None:
        bias = bias.float()  # the bias's own shape: no broadcast copied
    strides = (_bht_strides(q) + _bht_strides(k) + _bht_strides(v) +
               _bht_strides(out) + _bcast_strides(mask) +
               _bcast_strides(bias))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    lib = build()['flash_attention']
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            _ptr(bias), out.data_ptr()]
    dims = [B, H, T1, T2, D, _DTYPES[q.dtype], float(scale)]
    if want_lse:
        _run('flash_attention_fwd_train', lib.flash_attention_fwd_train,
             *ptrs, lse.data_ptr(), c_strides, *dims, device=q.device)
    else:
        _run('flash_attention_fwd', lib.flash_attention_fwd, *ptrs,
             c_strides, *dims, device=q.device)
    return out, lse


def _flash_bwd_cuda(which, q, k, v, mask, bias, do, lse, delta, scale):
    """Launch K5 (which='dq') or K6 (which='dkv')."""
    _flash_check(q, k, v, mask, bias)
    if (do.dtype != q.dtype or tuple(do.shape) != tuple(q.shape)
            or do.device != q.device or do.stride(-1) != 1):
        raise ValueError(f'do is {do.dtype} {tuple(do.shape)} on '
                         f'{do.device}, expected {q.dtype} '
                         f'{tuple(q.shape)} on {q.device}, unit-stride')
    B, H, T1, D = q.shape
    T2 = k.shape[2]
    for t in (lse, delta):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, T1)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError('lse and delta must be contiguous float32 '
                             f'({B}, {H}, {T1}) on {q.device}')
    if which == 'dq':
        outs = [_like_heads(q, q.dtype), None]
        dbias = (torch.empty(B, H, T1, T2, dtype=torch.float32,
                             device=q.device) if bias is not None else None)
    else:
        outs = [_like_heads(k, k.dtype), _like_heads(v, v.dtype)]
        dbias = None
    if q.numel() == 0 or k.numel() == 0:
        for t in outs + [dbias]:
            if t is not None:
                t.zero_()
        return (outs[0], dbias) if which == 'dq' else tuple(outs)
    if bias is not None:
        bias = bias.float()
    strides = []
    for t in (q, k, v, do, *outs):
        strides += [0, 0, 0] if t is None else _bht_strides(t)
    strides += _bcast_strides(mask) + _bcast_strides(bias)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    lib = build()['flash_attention_bwd']
    name = f'flash_attention_bwd_{which}'
    g1 = dbias if which == 'dq' else outs[1]
    _run(name, getattr(lib, name), q.data_ptr(), k.data_ptr(), v.data_ptr(),
         _ptr(mask), _ptr(bias), do.data_ptr(), lse.data_ptr(),
         delta.data_ptr(), outs[0].data_ptr(), _ptr(g1), c_strides, B, H,
         T1, T2, D, _DTYPES[q.dtype], float(scale), device=q.device)
    return (outs[0], dbias) if which == 'dq' else tuple(outs)


def flash_fwd(q, k, v, mask=None, bias=None, scale=1.0, want_lse=False):
    """K4 (with `want_lse`, its train variant) on CUDA tensors, its plain
    version on CPU tensors -> (out, lse)."""
    mask, bias = _mask_bias4(q, mask, bias)
    if _device_kind(q) == 'cpu':
        return flash_fwd_reference(q, k, v, mask, bias, scale, want_lse)
    return _flash_cuda(q, k, v, mask, bias, scale, want_lse)


def flash_bwd_dq(q, k, v, mask, bias, do, lse, delta, scale=1.0):
    """K5 on CUDA tensors, its plain version on CPU tensors -> (dq,
    dbias per (b, h) or None)."""
    mask, bias = _mask_bias4(q, mask, bias)
    if _device_kind(q) == 'cpu':
        return flash_bwd_dq_reference(q, k, v, mask, bias, do, lse, delta,
                                      scale)
    return _flash_bwd_cuda('dq', q, k, v, mask, bias, do, lse, delta, scale)


def flash_bwd_dkv(q, k, v, mask, bias, do, lse, delta, scale=1.0):
    """K6 on CUDA tensors, its plain version on CPU tensors -> (dk, dv)."""
    mask, bias = _mask_bias4(q, mask, bias)
    if _device_kind(q) == 'cpu':
        return flash_bwd_dkv_reference(q, k, v, mask, bias, do, lse, delta,
                                       scale)
    return _flash_bwd_cuda('dkv', q, k, v, mask, bias, do, lse, delta, scale)


class FlashAttention(torch.autograd.Function):
    """Forward: K4 with lse; backward: delta = rowsum(do·out) in plain
    torch, then K5 and K6, and dbias summed over the dims the bias
    broadcast over (`_bwd_call` :427-442).  The mask gets no gradient.
    The same code runs on both devices: `flash_*` pick the kernel or the
    plain version by the tensors' device."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, scale):
        out, lse = flash_fwd(q, k, v, mask, bias, scale, True)
        ctx.save_for_backward(q, k, v, mask, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, bias, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of out.sum()
            do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, mask, bias, do, lse, delta, ctx.scale)
        dq, dbias = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        if dbias is not None:
            dims = [i for i in range(4) if bias.shape[i] == 1]
            if dims:
                dbias = dbias.sum(dims, keepdim=True)
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, None, dbias, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    scale: float = 1.0) -> torch.Tensor:
    """softmax((q·kᵀ + bias)·scale, masked) · v: K4 on CUDA tensors, its
    plain version on CPU tensors.

    Same contract as the JAX `flash_attention`: q (B, h, T1, d); k, v
    (B, h, T2, d); mask bool (B|1, T1|1, T2) or (B|1, h|1, T1|1, T2),
    True == attend; bias (B|1, T1, T2) or (B|1, h|1, T1|1, T2), added
    before the scale.  A fully masked row gives 0.  CUDA tensors must be
    float32 or bfloat16 with d in 32/64/128 and a unit-stride last dim
    (strided (B, T, h, d) views are read in place).

    When autograd records (grad enabled and q, k, v or the bias requires
    grad) the call goes through `FlashAttention`, so gradients reach q,
    k, v and the bias on either device (K4 with lse, K5 and K6 on the
    card); otherwise it runs the forward alone."""
    mask, bias = _mask_bias4(q, mask, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return FlashAttention.apply(q, k, v, mask, bias, scale)
    return flash_fwd(q, k, v, mask, bias, scale)[0]
