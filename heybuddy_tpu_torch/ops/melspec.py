"""
Log-mel spectrogram constants (numpy).

Copies of the JAX package's ``ops/melspec.py`` helpers (``num_frames``,
``mel_filterbank``, ``dft_basis``, ``mel_band_freqs``), held equal to them
element for element by the tests. The spectrogram is a matmul DFT: frames
(hop 160, 512 samples, center=False) times a Hann-windowed real-DFT basis,
power, the HTK mel filterbank, then ``log(x + 1e-6)/10 + 2``; the mel kernels
and their plain versions (``ops/kernels/melspec_kernel.py``) compute it.
``frame_audio`` is the framing as a strided view (torch).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    MEL_BINS,
    MEL_F_MAX,
    MEL_F_MIN,
    MEL_HOP_LENGTH,
    MEL_N_FFT,
    MEL_WIN_LENGTH,
    SAMPLE_RATE,
)

__all__ = [
    "num_frames",
    "mel_filterbank",
    "dft_basis",
    "mel_band_freqs",
    "frame_audio",
]


def num_frames(num_samples: int, n_fft: int = MEL_N_FFT, hop: int = MEL_HOP_LENGTH) -> int:
    """Frame count for center=False framing: ``(t - 512)//160 + 1``."""
    if num_samples < n_fft:
        return 0
    return (num_samples - n_fft) // hop + 1


def _hz_to_mel(hz: np.ndarray) -> np.ndarray:
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_mels: int = MEL_BINS,
    n_fft: int = MEL_N_FFT,
    sample_rate: int = SAMPLE_RATE,
    f_min: float = MEL_F_MIN,
    f_max: float = MEL_F_MAX,
) -> np.ndarray:
    """Triangular HTK mel filterbank, shape (n_fft//2 + 1, n_mels), float32."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(np.array(f_min)), _hz_to_mel(np.array(f_max)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_freqs, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lower, center, upper = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lower) / max(center - lower, 1e-12)
        down = (upper - freqs) / max(upper - center, 1e-12)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_basis(
    n_fft: int = MEL_N_FFT,
    win_length: int = MEL_WIN_LENGTH,
    n_freqs: Optional[int] = None,
) -> np.ndarray:
    """
    Windowed real-DFT basis, shape (n_fft, 2*n_freqs): columns [0, n_freqs)
    are the cosine part, [n_freqs, 2*n_freqs) the (negated) sine part, each
    multiplied by a periodic Hann window of ``win_length`` centred in the
    n_fft frame.
    """
    if n_freqs is None:
        n_freqs = n_fft // 2 + 1
    window = np.hanning(win_length + 1)[:win_length]  # periodic hann
    padded = np.zeros(n_fft)
    left = (n_fft - win_length) // 2
    padded[left : left + win_length] = window
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (padded[:, None] * basis).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_band_freqs(
    n_fft: int = MEL_N_FFT,
    sample_rate: int = SAMPLE_RATE,
    f_max: float = MEL_F_MAX,
) -> int:
    """
    Number of DFT bins the mel filterbank covers (bins above ``f_max`` carry
    zero mel weight and are dropped exactly), rounded up to a multiple of 8.
    """
    bins = int(np.ceil(f_max / (sample_rate / 2) * (n_fft // 2))) + 2
    return min(((bins + 7) // 8) * 8, n_fft // 2 + 1)


def frame_audio(audio: torch.Tensor, n_fft: int = MEL_N_FFT, hop: int = MEL_HOP_LENGTH) -> torch.Tensor:
    """Overlapping frames as a view: (batch, t) -> (batch, n_frames, n_fft)."""
    return audio.unfold(-1, n_fft, hop)
