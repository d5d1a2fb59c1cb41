"""
Embedding-window plan of the featurizer.

The audio-window stride (1920 samples) is exactly 12 spectrogram hops, so the
per-audio-window spectrograms are overlapping views of ONE full-clip
spectrogram: window starts ``12*k + j`` (k = audio window, j in
{0, 8, 16, 24}) reproduce the reference's window order, overlap duplicates
included. The order is not monotonic: (0, 8, 16, 24, 12, 20, ...).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    AUDIO_WINDOW_SIZE,
    AUDIO_WINDOW_STRIDE,
    EMBEDDING_WINDOW_SIZE,
    EMBEDDING_WINDOW_STRIDE,
    MEL_HOP_LENGTH,
)
from heybuddy_tpu_torch.ops.melspec import num_frames

__all__ = ["embedding_window_starts", "num_embedding_windows", "extract_windows"]


@functools.lru_cache(maxsize=None)
def embedding_window_starts(
    num_samples: int,
    audio_window_size: int = AUDIO_WINDOW_SIZE,
    audio_window_stride: int = AUDIO_WINDOW_STRIDE,
    window_size: int = EMBEDDING_WINDOW_SIZE,
    window_stride: int = EMBEDDING_WINDOW_STRIDE,
) -> Tuple[int, ...]:
    """
    Frame indices (into the full-clip spectrogram) where each embedding window
    starts, in emission order. 23040 samples give 16 starts:
    (0, 8, 16, 24, 12, 20, 28, 36, 24, 32, 40, 48, 36, 44, 52, 60).
    """
    if audio_window_stride % MEL_HOP_LENGTH:
        raise ValueError("audio window stride must be a whole number of spectrogram hops")
    hops_per_audio_stride = audio_window_stride // MEL_HOP_LENGTH
    frames_per_audio_window = num_frames(audio_window_size)
    starts: List[int] = []
    for k, _sample in enumerate(range(0, num_samples - audio_window_size + 1, audio_window_stride)):
        for j in range(0, frames_per_audio_window - window_size + 1, window_stride):
            starts.append(k * hops_per_audio_stride + j)
    if not starts:
        raise ValueError(
            f"Audio too short for featurization: {num_samples} < {audio_window_size} samples"
        )
    assert max(starts) + window_size <= num_frames(num_samples)
    return tuple(starts)


def num_embedding_windows(num_samples: int) -> int:
    """Number of (16 -> 96) embedding rows produced for a clip of this length."""
    return len(embedding_window_starts(num_samples))


def extract_windows(
    spectrogram: torch.Tensor,
    starts: Tuple[int, ...],
    window_size: int = EMBEDDING_WINDOW_SIZE,
) -> torch.Tensor:
    """Gather embedding windows: (batch, frames, mel) -> (batch, n_windows, window_size, mel)."""
    idx = np.asarray(starts, dtype=np.int64)[:, None] + np.arange(window_size, dtype=np.int64)
    return spectrogram[:, torch.as_tensor(idx, device=spectrogram.device)]
