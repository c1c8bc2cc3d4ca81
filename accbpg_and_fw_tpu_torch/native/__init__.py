"""The port's native (C++) components, built with ``g++`` and loaded with
``ctypes``.

``native/<name>.cpp`` (the LIBSVM parser, ``libsvm_parser.cpp``) is
compiled at its first use into ``build/native/<name>-<hash>.so`` at the
repository root, beside the CUDA kernels of ``ops/_build.py``, named by a
hash of the source and the flags, so a changed source builds anew and
nothing is written into the package.  As in the JAX package, a host
without a compiler (or a build that fails) gets None, and the callers take
their Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LOADED: dict = {}


def library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds to (a hash of the source and the
    flags)."""
    h = hashlib.sha256((_SRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_native_library(name: str):
    """Build (once) and load ``native/<name>.cpp``: the ``ctypes.CDLL``,
    or None where there is no ``g++`` or the build fails."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        out = library_path(name)
        try:
            if not out.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise OSError("g++ not found")
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # a file of this process's own, moved into place whole
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                                str(_SRC / f"{name}.cpp")],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError):
            lib = None
        _LOADED[name] = lib
        return lib


__all__ = ["library_path", "load_native_library"]
