"""
K1, the mel-patch kernel: audio -> scaled log-mel in the padded patch layout.

Counterpart of the JAX package's ``ops/pallas/melspec_kernel.py::
mel_patches_pallas`` (``dft_mode="chunked"``). ``mel_patches`` takes a
(b, t) float32 int16-range batch and returns ``(patches, num_patches)``:
patches (b, p_pad, 128) where patch p holds frames 4p..4p+3 (32 mel bins
each), ``num_patches = frames // 4`` and ``p_pad`` rounds it up to 8; rows
``num_patches..p_pad-1`` are exact zeros. Unlike the Pallas kernel the batch
is not padded.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/mel_patches.cu``; its header says what bounds it and how it is laid
out); on a CPU tensor it runs ``mel_patches_plain``, the same arithmetic in
plain PyTorch, which the tests and the chip check compare against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    MEL_BINS,
    MEL_HOP_LENGTH,
    MEL_LOG_EPS,
    MEL_N_FFT,
    MEL_SCALE_ADD,
    MEL_SCALE_DIV,
    MEL_WIN_LENGTH,
)
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.melspec import dft_basis, mel_band_freqs, mel_filterbank, num_frames

__all__ = ["mel_patches", "mel_patches_plain", "patch_geometry", "PATCH_FRAMES"]

PATCH_FRAMES = 4
N_FREQ_PAD = 128  # DFT bins kept: the mel band (124 bins) padded to 128
TAP0 = (MEL_N_FFT - MEL_WIN_LENGTH) // 2  # 56: the Hann window's first row
TAPS = MEL_WIN_LENGTH  # 400 rows of the basis are non-zero


def patch_geometry(t: int) -> Tuple[int, int, int]:
    """(usable frames, num_patches, p_pad) of a clip of ``t`` samples."""
    num_patches = num_frames(t) // PATCH_FRAMES
    p_pad = -(-num_patches // 8) * 8
    return num_patches * PATCH_FRAMES, num_patches, p_pad


@functools.lru_cache(maxsize=None)
def _numpy_constants() -> Tuple[np.ndarray, np.ndarray]:
    """(basis (400, 256): the window's non-zero rows, 128 cos + 128 sin bins;
    filterbank (128, 32))."""
    assert N_FREQ_PAD >= mel_band_freqs(), "N_FREQ_PAD no longer covers the mel band"
    full = dft_basis(MEL_N_FFT, MEL_WIN_LENGTH, None)  # (512, 2*257)
    bins = MEL_N_FFT // 2 + 1
    basis = np.concatenate([full[:, :N_FREQ_PAD], full[:, bins : bins + N_FREQ_PAD]], axis=1)
    # rows outside the window are exactly zero, so dropping them is exact
    assert not basis[:TAP0].any() and not basis[TAP0 + TAPS :].any()
    fb = mel_filterbank()[:N_FREQ_PAD]
    return np.ascontiguousarray(basis[TAP0 : TAP0 + TAPS]), np.ascontiguousarray(fb)


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    basis, fb = _numpy_constants()
    return torch.from_numpy(basis).to(device), torch.from_numpy(fb).to(device)


def mel_patches_plain(audio: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The kernel's arithmetic in plain PyTorch (fp32 throughout)."""
    b, t = audio.shape
    usable, num_patches, p_pad = patch_geometry(t)
    basis, fb = _device_constants(audio.device)
    frames = audio.unfold(-1, MEL_N_FFT, MEL_HOP_LENGTH)[:, :usable, TAP0 : TAP0 + TAPS]
    spectrum = torch.matmul(frames, basis)  # (b, usable, 256)
    re, im = spectrum[..., :N_FREQ_PAD], spectrum[..., N_FREQ_PAD:]
    mel = torch.matmul(re * re + im * im, fb)
    logmel = torch.log(mel + MEL_LOG_EPS) / MEL_SCALE_DIV + MEL_SCALE_ADD
    out = audio.new_zeros((b, p_pad, PATCH_FRAMES * MEL_BINS))
    out[:, :num_patches] = logmel.reshape(b, num_patches, PATCH_FRAMES * MEL_BINS)
    return out, num_patches


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = build.library("mel_patches").mel_patches_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mel_patches(audio: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """
    (b, t) float32 int16-range audio -> ((b, p_pad, 128) patches, num_patches).
    Launches the CUDA kernel for a CUDA tensor, the plain version for a CPU one.
    """
    if not isinstance(audio, torch.Tensor) or audio.dtype != torch.float32 or audio.ndim != 2:
        raise ValueError("mel_patches takes a 2-D float32 tensor (batch, samples)")
    if not audio.is_contiguous():
        raise ValueError("mel_patches needs a contiguous audio tensor")
    b, t = audio.shape
    usable, num_patches, p_pad = patch_geometry(t)
    if num_patches < 1 or b < 1:
        raise ValueError(f"audio of shape {tuple(audio.shape)} holds no whole patch")
    if audio.device.type == "cpu":
        return mel_patches_plain(audio)
    if audio.device.type != "cuda":
        raise ValueError(f"mel_patches: unsupported device {audio.device}")
    basis, fb = _device_constants(audio.device)
    out = torch.empty((b, p_pad, PATCH_FRAMES * MEL_BINS), device=audio.device, dtype=torch.float32)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _launcher()(
            audio.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
            b, t, usable, p_pad, stream,
        )
    build.check(status, "mel_patches")
    mel_patches.launches += 1
    return out, num_patches


mel_patches.launches = 0
