"""
Device resolution and numeric settings for the port.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a CUDA
device that default raises: the port never falls back to the CPU quietly. A
caller that wants the CPU (the tests) passes ``device="cpu"`` and then gets
the plain PyTorch versions of the kernels.

TF32 is switched off for both matmuls and cuDNN when this module is imported.
The mel DFT multiplies int16-range audio, and TF32 (one product of 10-bit
mantissas, about three decimal digits) would move the log-mel far outside
the tolerance the port is held to. The float32 mel kernels compute a real
FFT on the CUDA cores (``csrc/mel_fft.cuh``), and the hop-block one a split
product of fp16 pairs on the tensor cores (three fp16 products that keep 22
significant bits of each operand, ``csrc/mel_patches_fat.cu``), neither in
TF32; the plain float32 versions they are checked against, and the
wake-word head (float32 in the JAX reference too), must not fall to TF32
either.
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device", "DeviceLike"]

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev
