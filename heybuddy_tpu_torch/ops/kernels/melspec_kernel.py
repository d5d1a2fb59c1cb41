"""
The mel kernels: audio -> scaled log-mel, in patch or spectrogram layout.

Counterparts of the JAX package's ``ops/pallas/melspec_kernel.py``:

* ``mel_patches(audio, dft_mode="chunked")`` is K1 (``mel_patches_pallas``):
  a (b, t) float32 int16-range batch -> ``(patches, num_patches)``, patches
  (b, p_pad, 128) where patch p holds frames 4p..4p+3 (32 mel bins each),
  ``num_patches = frames // 4`` and ``p_pad`` rounds it up to 8; rows
  ``num_patches..p_pad-1`` are exact zeros. ``dft_mode="fat"`` is K1b, the
  same function computed as one product of the clip's hop rows against the
  three hop-aligned basis blocks side by side, then shifted sums.
* ``mel_spectrogram(audio)`` is K3 (``mel_spectrogram_pallas``): (b, t) ->
  (b, frames, 32), every frame, the contract of the JAX package's XLA
  ``ops/melspec.py::mel_spectrogram``.

Unlike the Pallas kernels nothing pads the batch. On a CUDA tensor each
wrapper launches its hand-written kernel (``csrc/mel_patches.cu``,
``mel_patches_fat.cu``, ``mel_spectrogram.cu``; their headers say what bounds
them and how they are laid out); on a CPU tensor it runs the plain version
beside it, the same arithmetic in plain PyTorch, which the tests and the chip
check compare against.
"""

from __future__ import annotations

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

__all__ = [
    "mel_patches",
    "mel_patches_plain",
    "mel_spectrogram",
    "mel_spectrogram_plain",
    "patch_geometry",
    "DFT_MODES",
    "PATCH_FRAMES",
]

PATCH_FRAMES = 4
N_FREQ_PAD = 128  # DFT bins kept: the mel band (124 bins) padded to 128
TAP0 = (MEL_N_FFT - MEL_WIN_LENGTH) // 2  # 56: the Hann window's first row
TAPS = MEL_WIN_LENGTH  # 400 rows of the basis are non-zero
HOP_BLOCKS = 3  # hop-aligned basis blocks with a non-zero row (rows 0..479)
DFT_MODES = ("chunked", "fat")


def patch_geometry(t: int) -> Tuple[int, int, int]:
    """(usable frames, num_patches, p_pad) of a clip of ``t`` samples."""
    num_patches = num_frames(t) // PATCH_FRAMES
    p_pad = -(-num_patches // 8) * 8
    return num_patches * PATCH_FRAMES, num_patches, p_pad


@functools.lru_cache(maxsize=None)
def _numpy_constants() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    (taps (400, 256): the window's non-zero basis rows, 128 cos + 128 sin bins;
    hop blocks (160, 3 * 256): basis rows 160 j .. 160 j + 159 for j = 0, 1, 2
    side by side; filterbank (128, 32)).
    """
    assert N_FREQ_PAD >= mel_band_freqs(), "N_FREQ_PAD no longer covers the mel band"
    full = dft_basis(MEL_N_FFT, MEL_WIN_LENGTH, None)  # (512, 2*257)
    bins = MEL_N_FFT // 2 + 1
    basis = np.concatenate([full[:, :N_FREQ_PAD], full[:, bins : bins + N_FREQ_PAD]], axis=1)
    # rows outside the window are exactly zero, so dropping them is exact
    assert not basis[:TAP0].any() and not basis[TAP0 + TAPS :].any()
    assert not basis[HOP_BLOCKS * MEL_HOP_LENGTH :].any()
    blocks = np.concatenate(
        [basis[j * MEL_HOP_LENGTH : (j + 1) * MEL_HOP_LENGTH] for j in range(HOP_BLOCKS)], axis=1
    )
    fb = mel_filterbank()[:N_FREQ_PAD]
    return (
        np.ascontiguousarray(basis[TAP0 : TAP0 + TAPS]),
        np.ascontiguousarray(blocks),
        np.ascontiguousarray(fb),
    )


@functools.lru_cache(maxsize=None)
def mel_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (taps, hop blocks, filterbank) constants the mel kernels read, on ``device``."""
    return tuple(torch.from_numpy(c).to(device) for c in _numpy_constants())


def _mel_tail(spectrum: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(..., 256) cos|sin spectrum -> power -> mel -> scaled log."""
    re, im = spectrum[..., :N_FREQ_PAD], spectrum[..., N_FREQ_PAD:]
    mel = torch.matmul(re * re + im * im, fb)
    return torch.log(mel + MEL_LOG_EPS) / MEL_SCALE_DIV + MEL_SCALE_ADD


def _logmel_taps(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """The first ``n_frames`` frames by the 400-tap DFT of K1, K3 and K4."""
    taps, _, fb = mel_constants(audio.device)
    frames = audio.unfold(-1, MEL_N_FFT, MEL_HOP_LENGTH)[:, :n_frames, TAP0 : TAP0 + TAPS]
    return _mel_tail(torch.matmul(frames, taps), fb)


def _logmel_hop_blocks(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """The first ``n_frames`` frames by K1b's hop-block product and shifted sums."""
    _, blocks, fb = mel_constants(audio.device)
    b = audio.shape[0]
    n_hops = n_frames + HOP_BLOCKS - 1  # frame f reads hops f, f+1, f+2
    hops = audio[:, : n_hops * MEL_HOP_LENGTH].reshape(b, n_hops, MEL_HOP_LENGTH)
    z = torch.matmul(hops, blocks)  # (b, n_hops, 3 * 256)
    width = 2 * N_FREQ_PAD
    spectrum = z[:, :n_frames, :width]
    for j in range(1, HOP_BLOCKS):
        spectrum = spectrum + z[:, j : j + n_frames, j * width : (j + 1) * width]
    return _mel_tail(spectrum, fb)


def mel_patches_plain(audio: torch.Tensor, dft_mode: str = "chunked") -> Tuple[torch.Tensor, int]:
    """The kernel's arithmetic in plain PyTorch (fp32 throughout)."""
    b, t = audio.shape
    usable, num_patches, p_pad = patch_geometry(t)
    logmel_fn = _logmel_hop_blocks if dft_mode == "fat" else _logmel_taps
    logmel = logmel_fn(audio, usable)
    out = audio.new_zeros((b, p_pad, PATCH_FRAMES * MEL_BINS))
    out[:, :num_patches] = logmel.reshape(b, num_patches, PATCH_FRAMES * MEL_BINS)
    return out, num_patches


def mel_spectrogram_plain(audio: torch.Tensor) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch (fp32 throughout): (b, frames, 32)."""
    return _logmel_taps(audio, num_frames(audio.shape[1]))


def check_audio(audio: torch.Tensor, what: str) -> None:
    """Raise unless ``audio`` is what the audio kernels take: 2-D float32, contiguous, CPU or CUDA."""
    if not isinstance(audio, torch.Tensor) or audio.dtype != torch.float32 or audio.ndim != 2:
        raise ValueError(f"{what} takes a 2-D float32 tensor (batch, samples)")
    if not audio.is_contiguous():
        raise ValueError(f"{what} needs a contiguous audio tensor")
    if audio.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {audio.device}")


def mel_patches(audio: torch.Tensor, dft_mode: str = "chunked") -> Tuple[torch.Tensor, int]:
    """
    (b, t) float32 int16-range audio -> ((b, p_pad, 128) patches, num_patches).
    ``dft_mode`` "chunked" is K1, "fat" K1b. Launches the CUDA kernel for a
    CUDA tensor, the plain version for a CPU one.
    """
    if dft_mode not in DFT_MODES:
        raise ValueError(f"unknown dft_mode {dft_mode!r}; expected one of {DFT_MODES}")
    check_audio(audio, "mel_patches")
    b, t = audio.shape
    usable, num_patches, p_pad = patch_geometry(t)
    if num_patches < 1 or b < 1:
        raise ValueError(f"audio of shape {tuple(audio.shape)} holds no whole patch")
    if audio.device.type == "cpu":
        return mel_patches_plain(audio, dft_mode)
    taps, blocks, fb = mel_constants(audio.device)
    basis = blocks if dft_mode == "fat" else taps
    out = torch.empty((b, p_pad, PATCH_FRAMES * MEL_BINS), device=audio.device, dtype=torch.float32)
    build.launch(
        "mel_patches_fat" if dft_mode == "fat" else "mel_patches",
        audio.device,
        [audio.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr()],
        [b, t, usable, p_pad],
    )
    return out, num_patches


def mel_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """
    (b, t) float32 int16-range audio -> (b, frames, 32) scaled log-mel, K3.
    Launches the CUDA kernel for a CUDA tensor, the plain version for a CPU one.
    """
    check_audio(audio, "mel_spectrogram")
    b, t = audio.shape
    frames = num_frames(t)
    if frames < 1 or b < 1:
        raise ValueError(f"audio of shape {tuple(audio.shape)} holds no whole frame")
    if audio.device.type == "cpu":
        return mel_spectrogram_plain(audio)
    taps, _, fb = mel_constants(audio.device)
    out = torch.empty((b, frames, MEL_BINS), device=audio.device, dtype=torch.float32)
    build.launch(
        "mel_spectrogram",
        audio.device,
        [audio.data_ptr(), taps.data_ptr(), fb.data_ptr(), out.data_ptr()],
        [b, t, frames],
    )
    return out
