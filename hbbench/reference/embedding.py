"""The trunk-pool speech embedding: log-mel -> (windows, 96).

The spectrogram is cut into 4-frame patches (4 x 32 values). Each patch goes
through a centred RMS norm, ``patch_proj`` and residual blocks of [RMS, up,
exact-erf GELU, down]. Each 76-frame window takes its 19 patch features plus
a learned positional code and pools them per head with a softmax over the
window; the heads' pooled vectors are concatenated (head-major), RMS-normed
and projected to 96.

``operand`` rounds every product's operands: the identity for the reference
(float32 products, TF32 off), ``fp8`` for the lower-precision control.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

Operand = Callable[[torch.Tensor], torch.Tensor]
PATCH_FRAMES = 4
WINDOW_FRAMES = 76
WINDOW_STRIDE = 8
AUDIO_WINDOW = 17280
AUDIO_STRIDE = 1920


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Operands rounded to float8 e4m3, the step below bfloat16."""
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def window_starts(t: int) -> Sequence[int]:
    """Frame starts of the embedding windows of a ``t``-sample clip, in order:
    the 76-frame windows 8 frames apart inside each 1.08 s audio window,
    audio windows 0.12 s (12 hops) apart."""
    frames_per_audio = (AUDIO_WINDOW - 512) // 160 + 1
    hops = AUDIO_STRIDE // 160
    starts = []
    for k, _ in enumerate(range(0, t - AUDIO_WINDOW + 1, AUDIO_STRIDE)):
        for j in range(0, frames_per_audio - WINDOW_FRAMES + 1, WINDOW_STRIDE):
            starts.append(k * hops + j)
    return starts


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    c = x - x.mean(dim=-1, keepdim=True)
    return c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, operand: Operand) -> torch.Tensor:
    return torch.matmul(operand(x), operand(w)) + b


def embed(spec: torch.Tensor, params: Dict[str, torch.Tensor], starts: Sequence[int],
          operand: Operand = exact) -> torch.Tensor:
    """(b, frames, 32) log-mel + window starts -> (b, W, 96) float32.
    ``params`` holds float32 tensors under the flat names ``patch_proj/w``,
    ``trunk/<i>/up/w``, ..., ``pos``, ``pool_query``, ``head/w``."""
    b, frames, mels = spec.shape
    n_patch = frames // PATCH_FRAMES
    patches = spec[:, : n_patch * PATCH_FRAMES].reshape(b, n_patch, PATCH_FRAMES * mels).float()
    x = _dense(_rms(patches), params["patch_proj/w"], params["patch_proj/b"], operand)
    blocks = sum(1 for k in params if k.startswith("trunk/") and k.endswith("/up/w"))
    for i in range(blocks):
        p = f"trunk/{i}/"
        h = torch.nn.functional.gelu(_dense(_rms(x), params[p + "up/w"], params[p + "up/b"], operand))
        x = x + _dense(h, params[p + "down/w"], params[p + "down/b"], operand)
    per_window = params["pos"].shape[0]
    idx = torch.as_tensor(np.asarray(starts)[:, None] // PATCH_FRAMES + np.arange(per_window)[None, :],
                          device=spec.device)
    xw = x[:, idx] + params["pos"]  # (b, W, 19, D)
    scores = torch.matmul(operand(xw), operand(params["pool_query"]))  # (b, W, 19, H)
    weights = torch.softmax(scores, dim=2)
    pooled = torch.einsum("bwph,bwpd->bwhd", operand(weights), operand(xw))
    pooled = pooled.reshape(b, len(starts), -1)
    return _dense(_rms(pooled), params["head/w"], params["head/b"], operand)
