"""Log-mel spectrogram: 512-point frames 160 apart (no centring), a periodic
Hann window of 400 taps centred in the frame, power, an HTK mel filterbank of
32 bands over 60-3800 Hz, then ``log(x + 1e-6) / 10 + 2``."""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 512
WIN_LENGTH = 400
HOP = 160
MEL_BINS = 32
F_MIN = 60.0
F_MAX = 3800.0
LOG_EPS = 1e-6
SCALE_DIV = 10.0
SCALE_ADD = 2.0


@functools.lru_cache(maxsize=None)
def _basis() -> np.ndarray:
    """(512, 2 * 257) float64: the windowed cosine and negated sine of each bin."""
    window = np.hanning(WIN_LENGTH + 1)[:WIN_LENGTH]
    padded = np.zeros(N_FFT)
    left = (N_FFT - WIN_LENGTH) // 2
    padded[left : left + WIN_LENGTH] = window
    n = np.arange(N_FFT)[:, None]
    k = np.arange(N_FFT // 2 + 1)[None, :]
    angle = 2.0 * np.pi * n * k / N_FFT
    return padded[:, None] * np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)


@functools.lru_cache(maxsize=None)
def _filterbank() -> np.ndarray:
    """(257, 32) float64 triangular filters, equally spaced on the HTK mel scale."""

    def hz_to_mel(hz: np.ndarray) -> np.ndarray:
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    mel_pts = np.linspace(hz_to_mel(np.array(F_MIN)), hz_to_mel(np.array(F_MAX)), MEL_BINS + 2)
    hz = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    fb = np.zeros((N_FFT // 2 + 1, MEL_BINS))
    for m in range(MEL_BINS):
        up = (freqs - hz[m]) / max(hz[m + 1] - hz[m], 1e-12)
        down = (hz[m + 2] - freqs) / max(hz[m + 2] - hz[m + 1], 1e-12)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    # the filters are float32 constants of the published model
    return fb.astype(np.float32).astype(np.float64)


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """(b, t) int16-range audio -> (b, frames, 32) float32, computed in float64."""
    x = audio.to(torch.float64)
    frames = x.unfold(-1, N_FFT, HOP)
    spec = torch.matmul(frames, torch.from_numpy(_basis()).to(x.device))
    half = N_FFT // 2 + 1
    power = spec[..., :half] ** 2 + spec[..., half:] ** 2
    mel = torch.matmul(power, torch.from_numpy(_filterbank()).to(x.device))
    return (torch.log(mel + LOG_EPS) / SCALE_DIV + SCALE_ADD).to(torch.float32)
