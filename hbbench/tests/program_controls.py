"""The program's own lower-precision paths, switched on for a control run:
``bf16_mel`` runs the featurizer's log-mel (K1) with its bf16 DFT, the step
below the configuration's float32 mel."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def bf16_mel() -> Iterator[None]:
    from heybuddy_tpu_torch.models import featurizer

    original = featurizer.mel_patches

    def lowered(audio: torch.Tensor, dft_mode: str = "chunked", dft_dtype: torch.dtype = torch.float32):
        return original(audio, dft_mode, torch.bfloat16)

    featurizer.mel_patches = lowered
    try:
        yield
    finally:
        featurizer.mel_patches = original
