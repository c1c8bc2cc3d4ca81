"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and may include the shared
``csrc/*.cuh`` headers.  At first use it is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at the
repository root, named by a hash of the sources and the flags, and loaded
with ``ctypes``.  ``build_all`` starts one ``nvcc`` per source at once.  A
failed build or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (hash of the source, the shared
    headers and the flags)."""
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists:
    ``(name, out, tmp, process)``, or None."""
    out = library_path(name)
    if out.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return name, out, tmp, proc


def _finish(started) -> None:
    name, out, tmp, proc = started
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)


def build_all(names) -> None:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; raises on the first failure after every
    compiler has exited."""
    started = [s for s in (_start(n) for n in names) if s is not None]
    errors = []
    for s in started:
        try:
            _finish(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name in _LOADED:
        return _LOADED[name]
    started = _start(name)
    if started is not None:
        _finish(started)
    lib = ctypes.CDLL(str(library_path(name)))
    _LOADED[name] = lib
    return lib
