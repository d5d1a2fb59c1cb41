"""
K4, the one-kernel featurizer: audio -> log-mel patches -> trunk -> banded
window pooling -> head, the log-mel never in device memory.

Counterpart of the JAX package's ``ops/pallas/featurize_kernel.py::
fused_featurize`` (``featurize_batch(pooling="mega")``). ``fused_featurize``
takes a (b, t) float32 int16-range batch and the window starts and returns
(b, W, 96) float32 embeddings: the function of K1 (``mel_patches``) followed
by K2 (``fused_embedding_from_patches``), with the same arithmetic.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/featurize.cu``; its header says what bounds it and how it is laid
out), compiled for the default ``EmbeddingNetConfig``; on a CPU tensor it runs
``fused_featurize_plain``, K1's plain version followed by K2's, which the
tests and the chip check compare against.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from heybuddy_tpu_torch.models.embedding_net import EmbeddingNet
from heybuddy_tpu_torch.ops.kernels.embedding_kernel import (
    check_window_starts,
    fused_embedding_plain,
    launch_trunk,
)
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import (
    check_audio,
    kernel_constants,
    mel_patches_plain,
    patch_geometry,
)

__all__ = ["fused_featurize", "fused_featurize_plain"]


def fused_featurize_plain(
    net: EmbeddingNet, audio: torch.Tensor, window_starts: Tuple[int, ...]
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: K1's plain version, then K2's."""
    patches, num_patches = mel_patches_plain(audio)
    return fused_embedding_plain(net, patches, tuple(window_starts), num_patches)


def fused_featurize(
    net: EmbeddingNet, audio: torch.Tensor, window_starts: Sequence[int]
) -> torch.Tensor:
    """
    (b, t) float32 int16-range audio + window starts -> (b, W, 96) float32.
    Launches the CUDA kernel for a CUDA tensor, the plain version for a CPU one.
    """
    check_audio(audio, "fused_featurize")
    b, t = audio.shape
    _, num_patches, p_pad = patch_geometry(t)
    if num_patches < 1 or b < 1:
        raise ValueError(f"audio of shape {tuple(audio.shape)} holds no whole patch")
    starts = check_window_starts(net.config, window_starts, num_patches)
    if net.pos.device != audio.device:
        raise ValueError(f"net on {net.pos.device}, audio on {audio.device}")
    if audio.device.type == "cpu":
        return fused_featurize_plain(net, audio, starts)
    taps, _, fb = kernel_constants(audio.device)
    return launch_trunk(
        "featurize", net, [audio.data_ptr(), taps.data_ptr(), fb.data_ptr()], [b, t],
        b, p_pad, num_patches, starts,
    )
