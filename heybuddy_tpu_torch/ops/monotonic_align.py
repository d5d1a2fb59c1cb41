"""
Monotonic alignment search (the maximum path) for VITS training.

The DP is sequential over mel frames with O(t_x) work a step, so it runs on
the host between device steps, as VITS's own Cython extension does. Two
implementations with identical results:

* ``maximum_path``: the C++ source in ``ops/native/monotonic_align.cpp`` (the
  port's copy of the JAX package's), built with ``g++ -O3`` at first use into
  ``heybuddy_tpu_torch/_build/`` under a name that hashes the source, and
  called through ``ctypes``. A missing compiler or a failed build raises:
  unlike the JAX package, there is no quiet numpy fallback.
* ``maximum_path_plain``: the numpy DP, the plain version the tests hold the
  library to, run only when a caller asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["maximum_path", "maximum_path_plain", "library_path"]

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "monotonic_align.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"monotonic_align_{digest}.so")


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.exists(path):
            compiler = shutil.which("g++")
            if compiler is None:
                raise RuntimeError("g++ not found: the monotonic alignment library needs a C++ compiler")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            result = subprocess.run([compiler, *_FLAGS, "-o", tmp, _SOURCE], capture_output=True, text=True)
            if result.returncode != 0:
                raise RuntimeError(f"building {os.path.basename(_SOURCE)} failed:\n{result.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        ptr_f = ctypes.POINTER(ctypes.c_float)
        ptr_i = ctypes.POINTER(ctypes.c_int32)
        lib.maximum_path_batch.argtypes = [ptr_f, ptr_i, ptr_i, ptr_i, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.maximum_path_batch.restype = None
        _LIB = lib
        return lib


def _prepare(value: np.ndarray, mask: np.ndarray):
    value = np.ascontiguousarray(np.asarray(value, dtype=np.float32) * mask)
    t_xs = mask[:, :, 0].sum(axis=1).astype(np.int32)
    t_ys = mask[:, 0, :].sum(axis=1).astype(np.int32)
    return value, t_xs, t_ys


def maximum_path(value: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """
    Batched monotonic maximum path: (batch, t_x, t_y) float32
    log-likelihoods and a 0/1 mask that encodes each row's lengths ->
    int32 (batch, t_x, t_y) 0/1 paths.
    """
    value, t_xs, t_ys = _prepare(value, mask)
    batch, max_tx, max_ty = value.shape
    paths = np.zeros((batch, max_tx, max_ty), dtype=np.int32)
    _library().maximum_path_batch(
        value.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        batch, max_tx, max_ty,
    )
    return paths * mask.astype(np.int32)


def _maximum_path_single(value: np.ndarray, t_x: int, t_y: int) -> np.ndarray:
    """The DP for one (t_x, t_y) matrix."""
    neg_inf = -np.inf
    dp = value.copy()
    for y in range(t_y):
        for x in range(max(y + t_x - t_y, 0), min(y + 1, t_x)):
            if y == 0:
                best = 0.0 if x == 0 else neg_inf
            else:
                stay = dp[x, y - 1] if x < t_x else neg_inf
                step = dp[x - 1, y - 1] if x > 0 else neg_inf
                best = max(stay, step)
            dp[x, y] += best
    path = np.zeros_like(value, dtype=np.int32)
    index = t_x - 1
    for y in range(t_y - 1, -1, -1):
        path[index, y] = 1
        if index != 0 and (y == index or dp[index - 1, y - 1] >= dp[index, y - 1]):
            index -= 1
    return path


def maximum_path_plain(value: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``maximum_path`` in numpy, row by row."""
    value, t_xs, t_ys = _prepare(value, mask)
    paths = np.zeros(value.shape, dtype=np.int32)
    for b in range(value.shape[0]):
        tx, ty = int(t_xs[b]), int(t_ys[b])
        paths[b, :tx, :ty] = _maximum_path_single(value[b, :tx, :ty], tx, ty)
    return paths * mask.astype(np.int32)
