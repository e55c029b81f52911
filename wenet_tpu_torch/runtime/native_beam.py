"""ctypes wrapper over the port's C++ CTC prefix beam searcher
(`csrc/ctc_prefix_beam_search.cc`).  Counterpart of the searcher class
(`search_topk`, the streaming `reset` and `finalize_search`,
`hypotheses`, `times`, `likelihood`), `batch_search_topk` and
`make_searcher` of wenet_tpu/runtime/native_beam.py.  Context graphs and
the n-gram LM are not ported: `make_searcher` raises for them, and
without them finalizing adds no score and only closes the beam.

The library is compiled with g++ at first use into
`wenet_tpu_torch/build/`, keyed by the hash of the source, and `build()`
raises when the compiler fails: there is no pure-Python fallback."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / 'csrc' / 'ctc_prefix_beam_search.cc'
BUILD_DIR = _PKG / 'build'
_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()

Hyps = Tuple[List[List[int]], List[List[int]], List[float]]


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    lib.ctc_beam_create.restype = vp
    lib.ctc_beam_create.argtypes = [ci, ci]
    lib.ctc_beam_destroy.argtypes = [vp]
    lib.ctc_beam_reset.argtypes = [vp]
    lib.ctc_beam_finalize.argtypes = [vp]
    lib.ctc_beam_search_topk.restype = ci
    lib.ctc_beam_search_topk.argtypes = [vp, fp, ip, ci, ci]
    lib.ctc_beam_num_hyps.restype = ci
    lib.ctc_beam_num_hyps.argtypes = [vp]
    lib.ctc_beam_hyp_len.restype = ci
    lib.ctc_beam_hyp_len.argtypes = [vp, ci]
    lib.ctc_beam_hyp.argtypes = [vp, ci, ip, ip, fp]


def build() -> ctypes.CDLL:
    """Compile (once per hash of the source) and load the library; safe
    to call from several threads."""
    with _build_lock:
        return _build()


def _build() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f'libctc_beam_{tag}.so'
    if not so.exists():
        cxx = shutil.which(os.environ.get('CXX', 'g++'))
        if cxx is None:
            raise RuntimeError('no C++ compiler (g++) to build the CTC '
                               'prefix beam searcher')
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        proc = subprocess.run(
            [cxx, '-O2', '-std=c++17', '-shared', '-fPIC', '-o', str(tmp),
             str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed to build the CTC prefix beam '
                               f'searcher:\n{proc.stderr[-4000:]}')
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


class NativeCtcPrefixBeamSearch:
    """One utterance's incremental prefix beam (a C++ searcher): feed it
    chunk by chunk with `search_topk`, close it with `finalize_search`,
    start the next utterance with `reset`."""

    def __init__(self, beam_size: int = 10, blank_id: int = 0):
        self._lib = build()
        self._h = self._lib.ctc_beam_create(beam_size, blank_id)
        self.beam_size = beam_size
        self.blank_id = blank_id
        self._cache: Optional[Hyps] = None

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.ctc_beam_destroy(self._h)
            self._h = None

    def reset(self) -> None:
        """Back to the empty prefix, for a new utterance."""
        self._lib.ctc_beam_reset(self._h)
        self._cache = None

    def search_topk(self, vals: np.ndarray, ids: np.ndarray) -> None:
        """Advance over per-frame candidates: vals, ids (T, K), the top-k
        of the frame's log-posteriors.  Raises after `finalize_search`."""
        vals = np.ascontiguousarray(vals, np.float32)
        ids = np.ascontiguousarray(ids, np.int32)
        T, K = vals.shape
        if T == 0:
            return
        self._cache = None
        if self._lib.ctc_beam_search_topk(
                self._h, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), T, K):
            raise RuntimeError('search after finalize_search: reset first')

    def finalize_search(self) -> None:
        """End of the utterance.  Without a context graph or an LM there is
        no end-of-utterance score to add: the beam only closes."""
        self._lib.ctc_beam_finalize(self._h)

    @property
    def hypotheses(self) -> List[List[int]]:
        return self.results()[0]

    @property
    def times(self) -> List[List[int]]:
        return self.results()[1]

    @property
    def likelihood(self) -> List[float]:
        return self.results()[2]

    def results(self) -> Hyps:
        """(hyps, times, scores), best first; read from the C++ beam once
        after each search."""
        if self._cache is not None:
            return self._cache
        hyps, times, scores = [], [], []
        for i in range(self._lib.ctc_beam_num_hyps(self._h)):
            n = self._lib.ctc_beam_hyp_len(self._h, i)
            toks = (ctypes.c_int * max(n, 1))()
            tms = (ctypes.c_int * max(n, 1))()
            score = ctypes.c_float()
            self._lib.ctc_beam_hyp(self._h, i, toks, tms,
                                   ctypes.byref(score))
            hyps.append(list(toks[:n]))
            times.append(list(tms[:n]))
            scores.append(float(score.value))
        self._cache = (hyps, times, scores)
        return self._cache


def batch_search_topk(vals: np.ndarray, ids: np.ndarray, lens: np.ndarray,
                      beam_size: int, blank_id: int = 0) -> List[Hyps]:
    """The C++ beam over a batch, one searcher per utterance, in up to 8
    threads (ctypes releases the GIL in the C call).  vals, ids:
    (B, T, K); lens: (B,) valid frames.  Returns (hyps, times, scores) per
    utterance."""

    def one(b):
        s = NativeCtcPrefixBeamSearch(beam_size, blank_id)
        n = int(lens[b])
        s.search_topk(vals[b, :n], ids[b, :n])
        return s.results()

    B = vals.shape[0]
    if B == 1:
        return [one(0)]
    with ThreadPoolExecutor(min(8, B)) as ex:
        return list(ex.map(one, range(B)))


def make_searcher(beam_size: int = 10, blank_id: int = 0,
                  context_graph=None, lm=None) -> NativeCtcPrefixBeamSearch:
    """The streaming searcher.  Context biasing and LM fusion are not
    ported: a context graph or an LM raises NotImplementedError."""
    if context_graph is not None or lm is not None:
        raise NotImplementedError('context biasing and n-gram LM fusion '
                                  'are not ported')
    return NativeCtcPrefixBeamSearch(beam_size, blank_id)
