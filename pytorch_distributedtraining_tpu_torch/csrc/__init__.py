"""Build and load the port's hand-written CUDA kernels.

The JAX package compiles its Pallas kernels inside ``pl.pallas_call``; the
port's kernels are CUDA C++ sources in this directory, one library each:
``nvcc`` compiles every ``<name>.cu`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, from the sources in the checkout only, into ``build/kernels/``
at the repository root (listed in ``.gitignore``). A library's file name
carries a hash of its own source and the flags, so an edited source
rebuilds and a stale library is never loaded. :func:`build_all` starts one
``nvcc`` per source at once. Nothing here runs at import: the CPU tests
import every module.
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

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# each library's C functions: name -> argtypes (every one returns an int,
# a cudaError_t code), plus ``<library>_error_string``
SIGNATURES = {
    "window_attn": {
        "window_attn_forward": [_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _p],
        "window_attn_backward": [
            _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _p,
        ],
    },
    "flash_attn": {
        "flash_attn_forward": [
            _i, _p, _p, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _i, _f, _p,
        ],
        "flash_attn_dq": [
            _i, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _i, _f, _p,
        ],
        "flash_attn_dkv": [
            _i, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _i, _f, _p,
        ],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # nvcc's output (ptxas registers/spills) of this process's builds
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's kernels are "
        "built from source at first use on a CUDA machine"
    )


def source(name: str) -> Path:
    if name not in SIGNATURES:
        raise KeyError(f"no kernel library {name!r}; have {sorted(SIGNATURES)}")
    return HERE / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every library that is not built yet, one ``nvcc`` per source,
    all started together; returns each library's path."""
    names = list(SIGNATURES) if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(n))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        build_log[n] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {n}.cu ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile one library unless its current build exists; returns its path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load once per process with typed signatures."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.error_string = err
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch was refused (bad config, too much shared memory),
    with the message of the library's own error-string function."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
