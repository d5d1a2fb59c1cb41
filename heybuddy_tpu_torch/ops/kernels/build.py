"""
Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled on its own by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``heybuddy_tpu_torch/_build``
(listed in ``.gitignore``), then loaded with ``ctypes``. The library name
carries a hash of the source and the flags, so a changed source is rebuilt at
its first use and an unchanged one is loaded as it is. ``build_all`` starts one
``nvcc`` per source, all at once.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check`` raises
if it is not 0. A missing ``nvcc`` or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["SOURCES", "NVCC_FLAGS", "library", "build_all", "check", "BuildError"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "_build"
)
SOURCES = ("mel_patches", "embedding_pool")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of this process's builds
BUILD_LOGS: Dict[str, str] = {}


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start nvcc for ``name`` unless its library is already built."""
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, tmp, out


def _finish(name: str, job: Tuple[subprocess.Popen, str, str]) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise BuildError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build every named kernel library in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {name: _start(name) for name in names}
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(name, job)
            except BuildError as exc:
                errors.append(str(exc))
        if errors:
            raise BuildError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(_target(name)[1])
                _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
