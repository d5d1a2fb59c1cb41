"""
Time this checkout's K1, K3 (each with its bf16-DFT entry), K1b (both
entries), K2 and K4 against other versions' builds of the same sources on one
card, in alternating pairs.

    python -m heybuddy_tpu_torch.ops.kernels.compare_builds OTHER [OTHER ...]

Each OTHER is the root of another checkout of the repo (for example the
parent commit, unpacked with ``git archive``, or a copy of the sources with
one phase of a kernel deleted). Its ``mel_patches.cu``,
``mel_spectrogram.cu``, ``mel_patches_fat.cu``, ``embedding_pool.cu`` and
``featurize.cu``, with whatever headers sit beside them, are built with this
checkout's flags into ``heybuddy_tpu_torch/_build/other-<hash>/`` and
launched through this checkout's wrappers (``build.library_from``): both
versions get the same inputs and the same launch code, so their C entries
must match (a K1 build from before its row-stride argument is launched
without it); an entry the other build lacks is skipped. Both get this
checkout's constants (``mel_constants``): a build that reads less of a
buffer, such as one from before the FFT table behind the taps' operands,
ignores the rest. On 2048 seeded clips of 23040 samples, as
``chip_smoke.py`` times them, each of 10 pairs times both versions by CUDA
events (the median of 11 runs after 3 warm-ups), this checkout first in
even pairs and the other first in odd ones. For each OTHER it prints the two
versions' largest output difference, every pair's times, the medians, the
per-pair ratio of other to this, the card's name and power limit, and one
JSON line of the same. ``--kernels`` times only the named libraries' entries
(a copy with one phase of K2 deleted needs only ``embedding_pool``). First
it prints the trunk's four products alone as bf16 ``torch.matmul`` at K2's
shapes, the yardstick of the products' share of K2's time.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from heybuddy_tpu_torch.constants import MEL_BINS
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
from heybuddy_tpu_torch.ops.kernels import featurize_kernel as fk
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.utils.cuda_timing import cuda_ms, nvidia_smi_line

KERNELS = ("mel_patches", "mel_spectrogram", "mel_patches_fat", "embedding_pool", "featurize")
BATCH = 2048
CLIP = 23040
PAIRS = 10  # the fewest pairs that can show a difference (9 of 10 wins)
SEED = 20261016


def build_other(root: str, names: Sequence[str]) -> Dict[str, str]:
    """Build ``names`` from the checkout at ``root``, in parallel; returns library paths."""
    csrc = os.path.join(root, "heybuddy_tpu_torch", "ops", "kernels", "csrc")
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for entry in sorted(os.listdir(csrc)):
        h.update(entry.encode())
        with open(os.path.join(csrc, entry), "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(build.BUILD_DIR, f"other-{h.hexdigest()[:16]}")
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"lib{name}.so") for name in names}
    jobs = {
        name: subprocess.Popen(
            build.nvcc_command(os.path.join(csrc, f"{name}.cu"), libs[name]),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in names
        if not os.path.exists(libs[name])
    }
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise build.BuildError(f"nvcc failed for {root}'s {name}.cu:\n{log}")
    return libs


def compare(fn: Callable[[], torch.Tensor], name: str, other_lib: str, pairs: int) -> Dict:
    """Both versions' output difference and their times in alternating pairs."""
    mine = fn()
    with build.library_from(name, other_lib):
        theirs = fn()
    torch.cuda.synchronize()
    times: Dict[str, List[float]] = {"this": [], "other": []}
    for i in range(pairs):
        for which in ("this", "other") if i % 2 == 0 else ("other", "this"):
            if which == "this":
                times["this"].append(cuda_ms(fn))
            else:
                with build.library_from(name, other_lib):
                    times["other"].append(cuda_ms(fn))
    ratios = [o / t for t, o in zip(times["this"], times["other"])]
    return {
        "max_abs_diff": (mine - theirs).abs().max().item(),
        "this_ms": times["this"], "other_ms": times["other"],
        "this_median_ms": statistics.median(times["this"]),
        "other_median_ms": statistics.median(times["other"]),
        "other_over_this": ratios,
        "median_ratio": statistics.median(ratios),
        "this_faster_pairs": sum(r > 1.0 for r in ratios),
    }


# the library of each timed entry that is not its library's main one
ENTRY_LIBRARY = {
    "mel_patches_bf16": "mel_patches",
    "mel_spectrogram_bf16": "mel_spectrogram",
    "mel_patches_fat_bf16": "mel_patches_fat",
}


def _k1(audio: torch.Tensor, dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1 (or its bf16 entry) on dense ``audio`` through whichever build of
    ``mel_patches`` is loaded: one without the row-stride argument (its
    ``mel_patches_row_stride`` symbol) is launched with the ints it takes."""
    if hasattr(build.library("mel_patches"), "mel_patches_row_stride"):
        return mk.mel_patches(audio, dft_dtype=dft_dtype)[0]
    b, t = audio.shape
    usable, _, p_pad = mk.patch_geometry(t)
    taps, _, fb = mk.kernel_constants(audio.device)
    out = torch.empty((b, p_pad, mk.PATCH_FRAMES * MEL_BINS), device=audio.device, dtype=torch.float32)
    entry = "mel_patches_bf16" if dft_dtype == torch.bfloat16 else "mel_patches"
    build.launch("mel_patches", audio.device, [audio.data_ptr(), taps.data_ptr(), fb.data_ptr(), out.data_ptr()],
                 [b, t, usable, p_pad], entry=entry)
    return out


def kernel_runs(dev: torch.device) -> Dict[str, Callable[[], torch.Tensor]]:
    """One launch of each timed entry on the seeded 2048-clip batch that chip_smoke.py times."""
    net = SpeechEmbeddings(device=dev).net
    rng = np.random.default_rng(SEED)
    clips = np.clip(rng.normal(0.0, 0.05, (BATCH, CLIP)), -1.0, 1.0).astype(np.float32)
    audio = torch.from_numpy(clips * 32767.0).to(dev)
    starts = embedding_window_starts(CLIP)
    patches, n = mk.mel_patches(audio)
    return {
        "mel_patches": lambda: _k1(audio),
        "mel_patches_bf16": lambda: _k1(audio, torch.bfloat16),
        "mel_spectrogram": lambda: mk.mel_spectrogram(audio),
        "mel_spectrogram_bf16": lambda: mk.mel_spectrogram(audio, torch.bfloat16),
        "mel_patches_fat": lambda: mk.mel_patches(audio, "fat")[0],
        "mel_patches_fat_bf16": lambda: mk.mel_patches(audio, "fat", torch.bfloat16)[0],
        "embedding_pool": lambda: ek.fused_embedding_from_patches(net, patches, starts, n),
        "featurize": lambda: fk.fused_featurize(net, audio, starts),
    }


def trunk_products_ms(dev: torch.device) -> Dict[str, float]:
    """
    The trunk's products alone as bf16 ``torch.matmul`` at K2's shapes on the
    timed batch (2048 clips x 35 patch rows): a yardstick for the products'
    share of K2's time, which the port never calls.
    """
    net = SpeechEmbeddings(device=dev).net
    w = ek._kernel_weights(net)
    rows = BATCH * mk.patch_geometry(CLIP)[1]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(cols: int) -> torch.Tensor:
        return torch.randn(rows, cols, device=dev, generator=gen).to(torch.bfloat16)

    x, h, u = rand(w["wp"].shape[0]), rand(w["upw"].shape[1]), rand(w["dnw"].shape[1])
    times = {
        "patch_proj": cuda_ms(lambda: x @ w["wp"]),
        "up": cuda_ms(lambda: h @ w["upw"][0]),
        "down": cuda_ms(lambda: u @ w["dnw"][0]),
    }
    times["all"] = times["patch_proj"] + len(net.trunk) * (times["up"] + times["down"])
    times["rows"] = rows
    return times


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0].strip())
    parser.add_argument("other", nargs="+", help="root of another checkout")
    parser.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                        help="time only these libraries' entries (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_builds needs a CUDA device")
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda")
    build.build_all(args.kernels)
    products = trunk_products_ms(dev)
    print(f"the trunk's products alone as bf16 torch.matmul at {products['rows']} rows: patch_proj "
          f"{products['patch_proj']:.4f} ms, up {products['up']:.4f}, down {products['down']:.4f} (a block's "
          f"each); all of them {products['all']:.4f} ms")
    runs = kernel_runs(dev)
    for root in args.other:
        others = build_other(root, args.kernels)
        results = {}
        for entry, fn in runs.items():
            library = ENTRY_LIBRARY.get(entry, entry)
            if library not in others:
                continue
            if not hasattr(ctypes.CDLL(others[library]), f"{entry}_launch"):
                print(f"{root}: {entry}: no such entry in its build, skipped")
                continue
            r = compare(fn, library, others[library], PAIRS)
            results[entry] = r
            print(f"{root}: {entry} at {BATCH} x {CLIP}, {PAIRS} pairs in alternating order: this "
                  f"{[round(v, 4) for v in r['this_ms']]} ms, other {[round(v, 4) for v in r['other_ms']]} "
                  f"ms; medians this {r['this_median_ms']:.4f}, other {r['other_median_ms']:.4f} ms; "
                  f"other / this per pair {[round(v, 4) for v in r['other_over_this']]}, median "
                  f"{r['median_ratio']:.4f}; this faster in {r['this_faster_pairs']} of {PAIRS}; "
                  f"outputs max |d| {r['max_abs_diff']:.3e}")
        print(smi)
        print(json.dumps({"device": smi, "other": root, "batch": BATCH, "pairs": PAIRS,
                          "kernels": results, "trunk_products_matmul_ms": products}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
