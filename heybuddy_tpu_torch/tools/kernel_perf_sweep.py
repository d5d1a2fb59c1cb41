"""
K2's cost attribution by stage stand-ins, and its pooling tile sweep.

    python -m heybuddy_tpu_torch.tools.kernel_perf_sweep [--out PATH] [--batch 2048]
        [--skip-ablations] [--passes 8] [--tiles 1,2,3] [--device cpu]

The counterpart of the JAX package's ``scripts/kernel_perf_sweep.py``, with
its arguments, its variants and its JSONL rows (``label``, ``ms_per_batch``,
``clips_per_s``, ``ablate`` or ``clip_tile``), plus the card as
``nvidia-smi`` gives it (``device``), then its summary:

1. **Stage stand-ins.** K2 rebuilt with each of the JAX sweep's ablation
   sets (``ABLATION_SETS``): a build of ``csrc/embedding_pool.cu`` with
   ``-DHB_ABLATE_<STAGE>`` for each member, which replaces that stage by the
   JAX kernel's stand-in of the same shape (``embedding_kernel.ABLATIONS``).
   The difference from the baseline is the stage's cost.
2. **Tile sweep.** JAX's ``clip_tile`` (clips a grid step) is the pooling
   kernel's ``GROUP`` here: the 16-window chunks a block pools, one chunk a
   clip at 23040 samples. ``--tiles`` takes values of ``GROUP``, each a
   build with ``-DHB_K2_GROUP=<n>``; the default is the production value
   (4) and the others that build (1-3: a block's consumer threads hold one
   (window, head) row each, so no more than four chunks fit).

Every variant is built at once (one nvcc each), then held against its check
before any timing: a stand-in against the plain version with the same
stand-ins on the same card, by K2's rule (max |d| within max(0.05, 3x the
plain version's float32-vs-float64 spread), and mean |d| within max(5e-3,
3x its mean) where the grouped RMS keeps the outputs at the production's
size); a tile bit for bit against the baseline (a different ``GROUP``
changes the schedule, not the arithmetic). The input is a seeded
(batch, 23040) noise batch through K3 (``mel_spectrogram``), laid out once
as K2's patches; each variant times K2 alone on it. Timing: ``--passes``
interleaved round-robin passes, in each the CUDA-event median of each
variant (``cuda_ms``), and per variant the minimum over the passes.

On the card by default (no card: it raises). ``--device cpu`` rehearses it
on the plain versions (a tile is the plain version, which has no blocks)
with host-clock times, and labels the rows ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.constants import CLIP_SAMPLES
from heybuddy_tpu_torch.device import resolve_device
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.windows import embedding_window_starts

__all__ = ["ABLATION_SETS", "PRODUCTION_GROUP", "FITTING_GROUPS", "Variant", "variants", "tile_defines",
           "parse_tiles", "check_variants", "time_variants", "main"]

BATCH = 2048
SEED = 0
PRODUCTION_GROUP = 4  # trunk_pool.cuh's GROUP
FITTING_GROUPS = (1, 2, 3)  # the other values of GROUP that build
# the JAX sweep's ablation sets, in its order
ABLATION_SETS: List[Tuple[str, frozenset]] = [
    *((f"ablate_{stage}", frozenset({stage})) for stage in (
        "softmax", "pool_rms", "trunk_rms", "gelu", "posp", "trunk", "pool_mm", "head_mm", "noop")),
    ("ablate_all_vpu", frozenset({"softmax", "pool_rms", "trunk_rms", "gelu"})),
    ("ablate_all_mm_but_trunk", frozenset({"softmax", "pool_mm", "posp", "head_mm"})),
]
# K2's check against its plain version (chip_smoke.py's BF16_ATOL, BF16_SPREAD, BF16_MEAN)
ATOL, SPREAD, MEAN = 5e-2, 3.0, 5e-3


def tile_defines(group: int) -> Tuple[str, ...]:
    """The defines of K2's build with ``group`` pooling chunks a block (none for the production value)."""
    return () if group == PRODUCTION_GROUP else (f"HB_K2_GROUP={group}",)


def parse_tiles(text: Optional[str]) -> List[int]:
    """``--tiles`` as values of GROUP, the production value first (default: it and the others that build)."""
    values = [PRODUCTION_GROUP, *FITTING_GROUPS] if text is None else [int(x) for x in text.split(",") if x]
    return [PRODUCTION_GROUP] + [g for i, g in enumerate(values) if g != PRODUCTION_GROUP and g not in values[:i]]


class Variant:
    """One build of K2: a label, its stand-ins and its GROUP; ``run`` launches it (or its plain version)."""

    def __init__(self, label: str, ablate: frozenset = frozenset(), group: int = PRODUCTION_GROUP):
        self.label, self.ablate, self.group = label, ablate, group

    @property
    def defines(self) -> Tuple[str, ...]:
        return ek.ablation_defines(self.ablate) + tile_defines(self.group)

    def record(self) -> Dict:
        if self.ablate:
            return {"ablate": sorted(self.ablate)}
        return {"clip_tile": self.group} if self.group != PRODUCTION_GROUP else {}

    def run(self, net, patches: torch.Tensor, starts: Tuple[int, ...], n: int) -> torch.Tensor:
        if self.group == PRODUCTION_GROUP or patches.device.type == "cpu":
            return ek.fused_embedding_from_patches(net, patches, starts, n, self.ablate)
        b, p_pad, _ = patches.shape
        return ek.launch_trunk("embedding_pool", net, [patches.data_ptr()], [b], b, p_pad, n, starts,
                               self.defines)


def variants(tiles: Sequence[int], skip_ablations: bool) -> List[Variant]:
    """The baseline, the stand-in sets unless skipped, then each tile but the production one."""
    out = [Variant(f"baseline_t{PRODUCTION_GROUP}")]
    if not skip_ablations:
        out += [Variant(label, ablate) for label, ablate in ABLATION_SETS]
    out += [Variant(f"tile_{g}", group=g) for g in tiles if g != PRODUCTION_GROUP]
    return out


def inputs(batch: int, dev: torch.device):
    """The bundled net, and K3's spectrogram of seeded noise clips laid out as K2's patches."""
    from heybuddy_tpu_torch.convert import embedding_params_from_numpy
    from heybuddy_tpu_torch.models import embedding_net

    net = embedding_params_from_numpy(embedding_net.default_params()).to(dev).eval()
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy(rng.normal(0.0, 1000.0, (batch, CLIP_SAMPLES)).astype(np.float32)).to(dev)
    spec = mk.mel_spectrogram(audio)
    patches, n = ek.spectrogram_patches(net.config, spec)
    return net, patches, embedding_window_starts(CLIP_SAMPLES), n


@torch.no_grad()
def check_variants(vs: Sequence[Variant], net, patches: torch.Tensor, starts: Tuple[int, ...], n: int,
                   emit: Callable[[str], None] = print) -> Dict[str, Dict]:
    """
    Each variant against its check (module docstring); raises on the first
    that fails. Returns each one's max and mean |d| and their limits.
    """
    base = vs[0].run(net, patches, starts, n)
    results = {}
    for v in vs:
        got = v.run(net, patches, starts, n)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{v.label}: output not finite")
        if v.group != PRODUCTION_GROUP:
            d = (got - base).abs()
            r = {"max_abs_diff": d.max().item(), "mean_abs_diff": d.mean().item(), "limit": 0.0}
            emit(f"check {v.label}: against the baseline max |d| {r['max_abs_diff']:.3e} (bit-equal expected)")
            if not torch.equal(got, base):
                raise AssertionError(f"{v.label} differs from the baseline: max |d| {r['max_abs_diff']:.3e}")
        else:
            ref = ek.fused_embedding_plain(net, patches, starts, n, ablate=v.ablate)
            ref64 = ek.fused_embedding_plain(net, patches, starts, n, accumulate=torch.float64, ablate=v.ablate)
            d, spread = (got - ref).abs(), (ref - ref64).abs()
            # K2's mean floor holds outputs of the production's size: without the
            # grouped RMS they are about ten times larger, and only the max rule holds
            normalised = "pool_rms" not in v.ablate
            r = {"max_abs_diff": d.max().item(), "mean_abs_diff": d.mean().item(),
                 "limit": max(ATOL, SPREAD * spread.max().item()),
                 "mean_limit": max(MEAN, SPREAD * spread.mean().item()) if normalised else None}
            emit(f"check {v.label}: against its plain version max |d| {r['max_abs_diff']:.3e}, mean "
                 f"{r['mean_abs_diff']:.3e} (limits {r['limit']:.3e}, "
                 f"{'none' if r['mean_limit'] is None else format(r['mean_limit'], '.3e')}); plain f32 vs f64 "
                 f"max {spread.max().item():.3e}, mean {spread.mean().item():.3e}; mean |ref| "
                 f"{ref.abs().mean().item():.3e}")
            if r["max_abs_diff"] > r["limit"] or (normalised and r["mean_abs_diff"] > r["mean_limit"]):
                raise AssertionError(f"{v.label} disagrees with its plain version: {r}")
        results[v.label] = r
    return results


def ptxas_report(log: str) -> List[str]:
    """Each kernel's registers and spills from a build's ``ptxas -v`` log, and any serialised wgmma."""
    out, kernel = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((n for n in ("embedding_trunk_kernel", "embedding_pool_kernel") if n in line), line)
        elif "Used" in line and "registers" in line:
            out.append(f"{kernel} {line.split(':', 1)[-1].strip()}")
        elif "spill" in line and ("stores" in line or "loads" in line) and not line.strip().endswith(
                "0 bytes spill stores, 0 bytes spill loads"):
            out.append(f"{kernel} {line.split(':', 1)[-1].strip()}")
        elif "wgmma" in line and "serialized" in line:
            out.append(f"{kernel} SERIALISED: {line.strip()}")
    return out or ["(built earlier: no log in this process)"]


def _ms(fn: Callable[[], object], dev: torch.device) -> float:
    if dev.type == "cuda":
        from heybuddy_tpu_torch.utils.cuda_timing import cuda_ms

        return cuda_ms(fn)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def time_variants(vs: Sequence[Variant], net, patches: torch.Tensor, starts: Tuple[int, ...], n: int,
                  passes: int, emit: Callable[[str], None] = print) -> Dict[str, float]:
    """Each variant's least ms over ``passes`` interleaved round-robin passes."""
    dev = patches.device
    best = {v.label: float("inf") for v in vs}
    for p in range(passes):
        for v in vs:
            best[v.label] = min(best[v.label], _ms(lambda: v.run(net, patches, starts, n), dev))
        emit(f"pass {p + 1}/{passes}: " + ", ".join(f"{v.label}={best[v.label]:.4f}" for v in vs[:3]))
    return best


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "kernel_sweep.jsonl"))
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--skip-ablations", action="store_true")
    p.add_argument("--passes", type=int, default=8)
    p.add_argument("--tiles", default=None, help="values of GROUP, comma-separated (default: 4 and 1,2,3)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from heybuddy_tpu_torch.utils.cuda_timing import nvidia_smi_line

        card = nvidia_smi_line()
    else:
        card = "cpu"
    vs = variants(parse_tiles(args.tiles), args.skip_ablations)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        build.build_all(["embedding_pool"], [v.defines for v in vs])
        print(f"built {len(vs)} variants of embedding_pool in {time.perf_counter() - t0:.1f}s")
        for v in vs:
            print(f"  {v.label}: " + "; ".join(ptxas_report(build.BUILD_LOGS.get(build.label("embedding_pool", v.defines), ""))))
    net, patches, starts, n = inputs(args.batch, dev)
    print(f"patches: {tuple(patches.shape)} ({n} real) on {card}")
    check_variants(vs, net, patches, starts, n)
    best = time_variants(vs, net, patches, starts, n, args.passes)

    results = []
    with open(args.out, "a") as f:
        for v in vs:
            row = {"label": v.label, "ms_per_batch": best[v.label], "clips_per_s": args.batch / best[v.label] * 1e3,
                   **v.record(), "device": card}
            results.append(row)
            f.write(json.dumps(row) + "\n")

    base_ms = results[0]["ms_per_batch"]
    print("\n=== summary (min over interleaved passes) ===")
    for r in sorted(results, key=lambda r: r["ms_per_batch"]):
        print(f"{r['label']:>24}: {r['ms_per_batch']:7.4f} ms  {r['clips_per_s']:9.0f} clips/s  "
              f"(delta {base_ms - r['ms_per_batch']:+.4f})")
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
