"""
Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled on its own by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``heybuddy_tpu_torch/_build``
(listed in ``.gitignore``), then loaded with ``ctypes``. The library name
carries a hash of the flags, the source and every shared header
(``csrc/*.cuh``), so a changed source or header is rebuilt at its first use
and an unchanged one is loaded as it is. ``build_all`` starts one ``nvcc``
per source, all at once.

Every C entry ``<entry>_launch(pointers..., ints..., stream)`` returns
``cudaGetLastError()`` after its launch; ``launch`` raises if it is not 0 and
otherwise adds one to ``LAUNCHES[entry]``, the count a run reads to show which
kernels it went through. A library's main entry has its name; a variant
(``mel_patches_bf16`` in ``mel_patches``) has an entry of its own.
``<name>_smem_bytes()`` gives the dynamic shared memory of its kernels. A
missing ``nvcc`` or a failed build raises: there is no fallback. ``library_from`` points a kernel's launches at another build
of its source for a while, so that one process can time two versions of a
kernel through the same wrapper.

A build may carry preprocessor ``defines`` (K2's stage stand-ins
``HB_ABLATE_<STAGE>`` and its pooling group ``HB_K2_GROUP=<n>``): the
library's hash then covers them too, and its launches count under its own
``label``, ``<entry>[<defines>]``, never under the production entry's. With
no defines the command, the library's name and the label are the
production build's.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "SOURCES", "NVCC_FLAGS", "LAUNCHES", "library", "library_path", "build_all", "launch",
    "library_from", "nvcc_command", "smem_bytes", "BuildError", "label",
]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "_build"
)
SOURCES = ("mel_patches", "mel_patches_fat", "mel_spectrogram", "embedding_pool", "featurize", "formant_voiced")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches of each kernel in this process, by entry (``label`` for a build with defines)
LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # by label
# compiler output (ptxas register / shared-memory report) of this process's builds, by label
BUILD_LOGS: Dict[str, str] = {}

Defines = Tuple[str, ...]


def label(name: str, defines: Defines = ()) -> str:
    """The name of a build: ``name``, or ``name[define define ...]`` for a build with defines."""
    return f"{name}[{' '.join(defines)}]" if defines else name


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


def nvcc_command(src: str, out: str, defines: Defines = ()) -> List[str]:
    """The command that builds the kernel source ``src`` with ``defines`` into the library ``out``."""
    return [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", out, src]


def _target(name: str, defines: Defines = ()) -> Tuple[str, str]:
    """(source path, library path); the name hashes the flags, the defines, source and headers."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    if defines:
        h.update(" ".join(f"-D{d}" for d in defines).encode())
    headers: List[str] = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in (src, *headers):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where this checkout's build of kernel source ``name`` lives."""
    return _target(name)[1]


def _start(name: str, defines: Defines) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start nvcc for ``name`` with ``defines`` unless its library is already built."""
    src, out = _target(name, defines)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        nvcc_command(src, tmp, defines) if defines else nvcc_command(src, tmp),
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


def build_all(names: Iterable[str] = SOURCES, defines: Iterable[Defines] = ((),)) -> float:
    """
    Build every named kernel library with each set of ``defines`` (default:
    none), one nvcc each, all at once; returns the seconds taken.
    """
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {label(name, d): _start(name, d) for name in names for d in defines}
        errors = []
        for key, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(key, job)
            except BuildError as exc:
                errors.append(str(exc))
        if errors:
            raise BuildError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built with ``defines``), built first if needed."""
    key = label(name, defines)
    lib = _LIBS.get(key)
    if lib is None:
        build_all([name], [defines])
        with _LOCK:
            lib = _LIBS.get(key)
            if lib is None:
                lib = ctypes.CDLL(_target(name, defines)[1])
                _LIBS[key] = lib
    return lib


@functools.lru_cache(maxsize=None)
def _entry(name: str, entry: str, n_pointers: int, n_ints: int, defines: Defines = ()):
    fn = getattr(library(name, defines), f"{entry}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(
    name: str,
    device: torch.device,
    pointers: Sequence[int],
    ints: Sequence[int],
    entry: Optional[str] = None,
    defines: Defines = (),
) -> None:
    """
    Launch kernel ``entry`` (default ``name``) of library ``name``, built
    with ``defines``, on ``device``'s current stream with the given device
    pointers (``tensor.data_ptr()``) and ints; raise if CUDA refused the
    launch, else count it under ``label(entry, defines)``. The caller keeps
    the tensors alive.
    """
    entry = entry or name
    fn = _entry(name, entry, len(pointers), len(ints), tuple(defines))
    with torch.cuda.device(device):
        status = fn(*pointers, *ints, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"{label(entry, defines)}: CUDA error {status} at launch")
    LAUNCHES[label(entry, defines)] += 1


def smem_bytes(name: str) -> int:
    """Dynamic shared memory per block of library ``name``'s kernels."""
    fn = getattr(library(name), f"{name}_smem_bytes")
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return int(fn())


@contextlib.contextmanager
def library_from(name: str, path: str) -> Iterator[None]:
    """
    Inside the block, launches of kernel ``name`` go to the library at
    ``path``: another build of its source with the same C entry.
    """
    other = ctypes.CDLL(path)
    with _LOCK:
        saved = _LIBS.get(name)
        _LIBS[name] = other
    _entry.cache_clear()
    try:
        yield
    finally:
        with _LOCK:
            if saved is None:
                _LIBS.pop(name, None)
            else:
                _LIBS[name] = saved
        _entry.cache_clear()
