"""Build and load the port's hand-written CUDA kernels.

The JAX package compiles its Pallas kernels inside ``pl.pallas_call``; the
port's kernels are CUDA C++ sources in this directory, compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes``. The build runs at first use, from the sources in the
checkout only, into ``build/kernels/`` at the repository root (listed in
``.gitignore``). The library's file name carries a hash of the source and
the flags, so an edited source rebuilds and a stale library is never
loaded. Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).with_name("window_attn.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas registers/spills) of this process's build
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the window-attention "
        "kernels are built from source at first use on a CUDA machine"
    )


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"window_attn_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; returns its path."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load once per process with typed signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.window_attn_forward.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.window_attn_forward.restype = i
        lib.window_attn_backward.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p,
        ]
        lib.window_attn_backward.restype = i
        lib.window_attn_error_string.argtypes = [i]
        lib.window_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch was refused (bad config, too much shared memory)."""
    if code != 0:
        msg = lib.window_attn_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
