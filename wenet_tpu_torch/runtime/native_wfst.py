"""ctypes wrapper over the port's C++ lattice WFST decoder
(`csrc/wfst_lattice_decoder.cc`).  Counterpart of
wenet_tpu/runtime/native_wfst.py.

`NativeCtcWfstBeamSearch` has the interface of the plain Python searcher
(runtime/wfst_beam_search.py `CtcWfstBeamSearch`, the version it is held
against): `reset`, `search` on whole (T, V) log-prob rows,
`finalize_search`, `hypotheses`, `likelihood`, `times`.  The decoder keeps
a per-frame lattice of forward links, so its n-best is an exact
best-first enumeration of distinct word sequences over that lattice.

The library is compiled with g++ at first use into
`wenet_tpu_torch/build/`, keyed by the hash of the source
(`utils/native.py`).  `make_wfst_searcher` raises when it does not build
or load: the Python searcher runs only where a caller builds it by
name."""

import ctypes
import os
import tempfile
import threading
from typing import List, Optional

import numpy as np

from wenet_tpu_torch.utils.native import load_library

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


def _declare(lib: ctypes.CDLL) -> None:
    ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    ip = ctypes.POINTER(ci)
    lib.wfst_create.restype = vp
    lib.wfst_create.argtypes = [ctypes.c_char_p, ci, cf, cf, cf, cf, ci, ci]
    lib.wfst_destroy.argtypes = [vp]
    lib.wfst_reset.argtypes = [vp]
    lib.wfst_search.argtypes = [vp, ctypes.POINTER(cf), ci, ci]
    lib.wfst_finalize.argtypes = [vp]
    lib.wfst_num_hyps.restype = ci
    lib.wfst_num_hyps.argtypes = [vp]
    lib.wfst_hyp_words_len.restype = ci
    lib.wfst_hyp_words_len.argtypes = [vp, ci]
    lib.wfst_hyp.argtypes = [vp, ci, ip, ip, ip, ip, ctypes.POINTER(cf)]


def build() -> ctypes.CDLL:
    """Compile (once per hash of the source) and load the library; safe
    to call from several threads.  Raises when g++ fails."""
    global _lib
    with _build_lock:
        if _lib is None:
            lib = load_library('wfst_lattice_decoder.cc', 'wfst')
            _declare(lib)
            _lib = lib
        return _lib


class NativeCtcWfstBeamSearch:
    """The C++ lattice decoder over the TLG at `fst_path` (text form),
    which it parses whole when it is made."""

    def __init__(self, fst_path: str, beam_size: int = 10,
                 max_active: int = 7000,
                 acoustic_scale: float = 1.0,
                 blank_skip_thresh: float = 0.98, blank_scale: float = 1.0,
                 beam: float = 16.0, blank_id: int = 0):
        self._lib = build()
        self._h = self._lib.wfst_create(
            fst_path.encode(), blank_id, acoustic_scale, blank_skip_thresh,
            blank_scale, beam, max_active, beam_size)
        if not self._h:
            raise RuntimeError(f'could not parse the TLG at {fst_path}')
        self._cache = None

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.wfst_destroy(self._h)
            self._h = None

    def reset(self):
        self._lib.wfst_reset(self._h)
        self._cache = None

    def search(self, ctc_log_probs: np.ndarray):
        """Advance over (T, V) log-prob rows."""
        logp = np.ascontiguousarray(ctc_log_probs, np.float32)
        if logp.ndim != 2 or logp.shape[0] == 0:
            return
        self._lib.wfst_search(
            self._h, logp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            logp.shape[0], logp.shape[1])
        self._cache = None

    def finalize_search(self):
        self._lib.wfst_finalize(self._h)
        self._cache = None

    def _collect(self):
        """(words, word times, scores) per hypothesis: the n-best after
        `finalize_search`, the best partial before."""
        if self._cache is not None:
            return self._cache
        lib, h = self._lib, self._h
        hyps, wtimes, scores = [], [], []
        for i in range(lib.wfst_num_hyps(h)):
            n = lib.wfst_hyp_words_len(h, i)
            w = (ctypes.c_int * max(1, n))()
            wt = (ctypes.c_int * max(1, n))()
            sc = (ctypes.c_float * 3)()
            lib.wfst_hyp(h, i, w, wt, None, None, sc)
            hyps.append(list(w[:n]))
            wtimes.append(list(wt[:n]))
            scores.append((float(sc[0]), float(sc[1]), float(sc[2])))
        self._cache = (hyps, wtimes, scores)
        return self._cache

    @property
    def hypotheses(self) -> List[List[int]]:
        return self._collect()[0]

    @property
    def likelihood(self) -> List[float]:
        return [s[0] for s in self._collect()[2]]

    @property
    def times(self) -> List[List[int]]:
        """Word-level times (the Python searcher's convention)."""
        return self._collect()[1]

    def split_costs(self) -> List[tuple]:
        """(graph cost, acoustic cost) per hypothesis."""
        return [(s[1], s[2]) for s in self._collect()[2]]


def make_wfst_searcher(tlg_fst=None, fst_path: Optional[str] = None,
                       **kwargs) -> NativeCtcWfstBeamSearch:
    """The C++ searcher over a TLG given as a path (`fst_path`) or a
    `lm.fst.TextFst` (`tlg_fst`, written to a temporary file that is
    deleted once the decoder has parsed it).  Raises when the library does
    not build: there is no Python fallback."""
    build()
    if fst_path is not None:
        return NativeCtcWfstBeamSearch(fst_path, **kwargs)
    if tlg_fst is None:
        raise ValueError('make_wfst_searcher needs tlg_fst or fst_path')
    from wenet_tpu_torch.lm.build_graph import write_text
    fd, path = tempfile.mkstemp(suffix='.tlg.txt')
    os.close(fd)
    try:
        write_text(tlg_fst, path)
        return NativeCtcWfstBeamSearch(path, **kwargs)
    finally:
        # the decoder holds its own parsed copy; a large TLG's text must
        # not pile up in the temporary directory
        os.unlink(path)
