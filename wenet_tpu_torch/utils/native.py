"""Build and load the port's C++ host libraries (`csrc/*.cc`) with g++.

Each library is compiled at first use into `wenet_tpu_torch/build/`,
keyed by the hash of its source, and loaded with ctypes.  The compiler
writes to a name of its own process and the result is moved into place
with `os.replace`, so processes that build at once never load a
half-written file.  A failed build raises: there is no fallback."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / 'csrc'
BUILD_DIR = PKG / 'build'
_lock = threading.Lock()


def load_library(source: str, stem: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` into `build/lib<stem>_<hash>.so` unless it
    is there, and load it.  Safe to call from several threads."""
    src = CSRC / source
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f'lib{stem}_{tag}.so'
    with _lock:
        if not so.exists():
            cxx = shutil.which(os.environ.get('CXX', 'g++'))
            if cxx is None:
                raise RuntimeError(f'no C++ compiler (g++) to build {source}')
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
            proc = subprocess.run(
                [cxx, '-O2', '-std=c++17', '-shared', '-fPIC', '-o',
                 str(tmp), str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'g++ failed to build {source}:\n'
                                   f'{proc.stderr[-4000:]}')
            os.replace(tmp, so)
        return ctypes.CDLL(str(so))
