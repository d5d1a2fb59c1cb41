"""Helpers the traffic kinds share: the seeded embedding on the program's
shared featurizer, gaps, and freeing the program's state before a check."""

from __future__ import annotations

import gc
import math
from typing import Any, Dict, Tuple

import torch

from hbbench import weights


def shared_featurizer(ctx: Any, params: Dict[str, torch.Tensor]) -> Any:
    """The program's shared featurizer of the device, built on the seeded
    weights (every program path that featurizes takes this one)."""
    from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings

    emb = get_speech_embeddings(device=ctx.device, params=weights.to_numpy(params))
    held = emb.net.patch_proj.w.detach().to(ctx.device)
    if not torch.equal(held, params["patch_proj/w"]):
        raise RuntimeError("the shared featurizer was built before with other weights")
    return emb


def finite(value: float) -> float:
    """A gap as a JSON number: a non-finite one (a NaN output) reads as 1e30."""
    return float(value) if math.isfinite(value) else 1e30


def max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b|; infinite where either holds a non-finite value."""
    d = (a.float() - b.float()).abs()
    return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")


def mel_gap(program: Tuple[torch.Tensor, int], spec: torch.Tensor, patch_frames: int = 4) -> float:
    """The largest gap between the program's log-mel patches (``mel_patches``'
    (b, p_pad, frames x bins) output and its patch count) and the reference's
    (b, frames, bins) log-mel cut into the same patches."""
    patches, n = program
    b, frames, bins = spec.shape
    if frames // patch_frames != n or patches.shape[0] != b:
        return float("inf")
    return max_gap(patches[:, :n], spec[:, : n * patch_frames].reshape(b, n, patch_frames * bins))


def free(ctx: Any, *keys: str) -> None:
    for key in keys:
        ctx.extra.pop(key, None)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()


def check(ctx: Any, name: str, value: float) -> None:
    ctx.checks[name] = {"value": finite(value), "limit": float(ctx.cell["limits"][name])}
