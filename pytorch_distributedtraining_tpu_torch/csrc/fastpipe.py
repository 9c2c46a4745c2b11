"""The host collate and normalisation kernels (``fastpipe.cpp``) and their
plain numpy versions.

Counterpart of ``pytorch_distributedtraining_tpu/csrc/__init__.py``:
``fast_stack``, ``fast_stack_strided`` and ``normalize_u8`` with the same
signatures and results. ``g++`` builds ``fastpipe.cpp`` at first use into
``build/host/`` at the repository root (``.gitignore`` lists ``build/``),
not beside the source; the library's file name carries a hash of the source
and the flags, so an edited source rebuilds. Nothing builds at import.

A failed build raises, on the card's path and everywhere else: nothing
falls back to numpy. The ``plain_*`` functions are the numpy versions of
the three kernels, which the tests hold the library against;
``plain_normalize_u8`` computes ``x * s + b`` with ``s = 1 / (255 std)`` and
``b = -mean / std`` in f32, as the C++ does, so the two agree bit for bit.
As in the JAX package, ``fast_stack`` leaves one sample, object arrays and
samples under 4 KiB to ``np.stack`` (marshalling the pointers costs more
than the copies there), and ``fast_stack_strided`` leaves arrays whose rows
are not contiguous, or whose leading pitches differ, to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "host"
SOURCE = HERE / "fastpipe.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"fastpipe_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``fastpipe.cpp`` unless its current build exists; raises with
    the compiler's output when ``g++`` fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        run = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ could not run to build {SOURCE.name}: {e}") from e
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({run.returncode}):\n{run.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


def load() -> ctypes.CDLL:
    """Build if needed, then load once per process with typed signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.fp_stack.argtypes = [ctypes.POINTER(p), i64, i64, p, ctypes.c_int]
        lib.fp_stack.restype = None
        lib.fp_normalize_u8.argtypes = [p, p, i64, i64, fptr, fptr, ctypes.c_int]
        lib.fp_normalize_u8.restype = None
        lib.fp_stack_strided.argtypes = [ctypes.POINTER(p), i64, i64, i64, i64, p, ctypes.c_int]
        lib.fp_stack_strided.restype = None
        lib.fp_version.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _threads(n_threads: int | None) -> int:
    return n_threads or min(8, os.cpu_count() or 1)


def fast_stack(arrays, n_threads: int | None = None) -> np.ndarray:
    """``np.stack(arrays)`` by parallel memcpy; all arrays share shape and
    dtype (the collate's hot path)."""
    first = np.asarray(arrays[0])
    if len(arrays) < 2 or first.dtype == object or first.nbytes < 4096:
        return np.stack([np.asarray(a) for a in arrays])
    arrs = [np.ascontiguousarray(a) for a in arrays]
    if any(a.shape != first.shape or a.dtype != first.dtype for a in arrs):
        raise ValueError("fast_stack takes arrays of one shape and dtype")
    lib = load()
    out = np.empty((len(arrs),) + first.shape, first.dtype)
    ptrs = (ctypes.c_void_p * len(arrs))(*(a.ctypes.data for a in arrs))
    lib.fp_stack(ptrs, len(arrs), first.nbytes, out.ctypes.data, _threads(n_threads))
    return out


def fast_stack_strided(arrays, n_threads: int | None = None) -> np.ndarray:
    """Stack row-strided views (crops of larger images) into one contiguous
    batch without a per-sample copy. Each array shares shape and dtype, is
    C-contiguous within a row, and only the leading pitch may exceed a
    row; other layouts go to ``np.stack``."""
    first = np.asarray(arrays[0])
    row_shape = first.shape[1:]
    row_bytes = int(np.prod(row_shape, dtype=np.int64)) * first.itemsize
    c_row_strides = np.zeros(row_shape, first.dtype).strides

    def qualifies(a):
        return (a.shape == first.shape and a.dtype == first.dtype
                and a.strides[1:] == c_row_strides and a.strides[0] >= row_bytes)

    arrs = [np.asarray(a) for a in arrays]
    if first.ndim < 2 or not all(qualifies(a) for a in arrs):
        return np.stack(arrs)
    pitches = {a.strides[0] for a in arrs}
    if len(pitches) != 1:
        return np.stack(arrs)
    lib = load()
    out = np.empty((len(arrs),) + first.shape, first.dtype)
    ptrs = (ctypes.c_void_p * len(arrs))(*(a.ctypes.data for a in arrs))
    lib.fp_stack_strided(ptrs, len(arrs), first.shape[0], row_bytes, pitches.pop(),
                         out.ctypes.data, _threads(n_threads))
    return out


def _mean_std(c: int, mean, std) -> tuple[np.ndarray, np.ndarray]:
    mean = np.asarray(mean, np.float32).reshape(-1)
    std = np.asarray(std, np.float32).reshape(-1)
    if mean.size == 1:
        mean, std = np.repeat(mean, c), np.repeat(std, c)
    if mean.size != c or std.size != c:
        raise ValueError(f"mean/std size {mean.size} != channels {c}")
    return mean, std


def normalize_u8(batch: np.ndarray, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 n_threads: int | None = None) -> np.ndarray:
    """``(u8 [..., C] / 255 - mean) / std`` -> f32, fused and threaded."""
    batch = np.ascontiguousarray(batch, dtype=np.uint8)
    c = batch.shape[-1]
    mean, std = _mean_std(c, mean, std)
    lib = load()
    out = np.empty(batch.shape, np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.fp_normalize_u8(batch.ctypes.data, out.ctypes.data, batch.size // c, c,
                        mean.ctypes.data_as(fptr), std.ctypes.data_as(fptr),
                        _threads(n_threads))
    return out


def plain_stack(arrays) -> np.ndarray:
    """What ``fast_stack`` and ``fast_stack_strided`` compute, in numpy."""
    return np.stack([np.asarray(a) for a in arrays])


def plain_normalize_u8(batch: np.ndarray, mean=(0.485, 0.456, 0.406),
                       std=(0.229, 0.224, 0.225)) -> np.ndarray:
    """What ``normalize_u8`` computes, in numpy, with the C++'s roundings."""
    batch = np.asarray(batch, dtype=np.uint8)
    mean, std = _mean_std(batch.shape[-1], mean, std)
    s = np.float32(1.0) / (np.float32(255.0) * std)
    b = -mean / std
    return batch.astype(np.float32) * s + b


__all__ = ["available", "fast_stack", "fast_stack_strided", "normalize_u8",
           "plain_normalize_u8", "plain_stack"]
