"""
Probe: what does a bf16-input DFT cost in accuracy, and what does it buy in
speed, on the card?

    python -m heybuddy_tpu_torch.tools.mel_precision_probe [--skip-accuracy] [--skip-timing]
        [--batch 2048] [--iters 10] [--passes 6] [--device cpu | --cpu]

The counterpart of the JAX package's ``scripts/mel_precision_probe.py``, with
its arguments and its records (one JSON object a line, the same ``probe``
names and keys, so the two outputs diff line for line), plus a ``kernel``
field naming what ran:

Accuracy: 16 realistic clips (formant speech + a noise floor, full int16
range) -> scaled log-mel by the exact float64 reference (``f64_logmel``, the
kernels' own basis and filterbank), against

* ``xla_melspec``: the plain float32 mel (``mel_spectrogram_plain``),
* ``pallas_f32`` / ``pallas_bf16``: K3 (``mel_spectrogram``) with the
  float32 (split fp16-pair) and the bf16 DFT,

and the (16, 96) feature deltas through K1 (float32 and bf16 DFT) -> K2
against ``featurize_batch(pooling="banded", compute_dtype=torch.float32)``.

Timing: interleaved passes, the minimum per variant, by CUDA events (host
clock on the CPU): ``mel_patches_f32`` / ``mel_patches_bf16`` (K1 and its
bf16 entry), ``emb_from_patches`` (K2), ``full_f32`` / ``full_bf16`` (K1
-> K2) at ``--batch`` clips of 23040. The ``devices`` line and every timing
record carry ``nvidia-smi``'s card name and power limit.

Everything runs on ``cuda`` unless ``--device cpu`` (or ``--cpu``) is given;
on the CPU the kernels' plain versions run.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    CLIP_SAMPLES,
    MEL_HOP_LENGTH,
    MEL_LOG_EPS,
    MEL_N_FFT,
    MEL_SCALE_ADD,
    MEL_SCALE_DIV,
)
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.melspec import num_frames

__all__ = ["realistic_clips", "f64_logmel", "mel_arrays", "feature_arrays", "accuracy", "timing", "card",
           "ACCURACY_KERNELS", "main"]

# what each accuracy record ran, in the port's kernel names
ACCURACY_KERNELS = {
    "xla_melspec": "plain",
    "pallas_f32": "K3",
    "pallas_bf16": "K3-bf16",
    "features_fused_f32_vs_banded_f32": "K1 -> K2 vs K3 -> banded f32",
    "features_fused_bf16dft_vs_banded_f32": "K1-bf16 -> K2 vs K3 -> banded f32",
    "features_bf16dft_vs_f32dft": "K1-bf16 -> K2 vs K1 -> K2",
}
TIMING_KERNELS = {
    "mel_patches_f32": "K1",
    "mel_patches_bf16": "K1-bf16",
    "emb_from_patches": "K2",
    "full_f32": "K1 -> K2",
    "full_bf16": "K1-bf16 -> K2",
}


def realistic_clips(n: int) -> np.ndarray:
    """(n, 23040) float32: formant renders of one sentence (12 speakers in
    turn) plus a seeded noise floor, scaled to full int16 range."""
    from heybuddy_tpu_torch.models.formant import FormantSynthesizer

    synth = FormantSynthesizer()
    rng = np.random.default_rng(7)
    out = np.zeros((n, CLIP_SAMPLES), np.float32)
    for i in range(n):
        clip = synth.synthesize("hey buddy what is the weather", speaker=i % 12)
        k = min(len(clip), CLIP_SAMPLES)
        out[i, :k] = clip[:k]
        out[i] += rng.normal(0, 200.0, CLIP_SAMPLES)  # int16-range noise floor
    out *= 32768.0 / max(1.0, np.abs(out).max())  # full int16 range
    return out


def f64_logmel(audio: np.ndarray) -> np.ndarray:
    """The exact float64 scaled log-mel of the kernels' own math: the
    window's 400 non-zero basis rows and the (128, 32) filterbank of
    ``melspec_kernel._numpy_constants``; (b, frames, 32)."""
    taps, _, fb = mk._numpy_constants()
    frames = num_frames(audio.shape[1])
    view = np.lib.stride_tricks.sliding_window_view(audio.astype(np.float64), MEL_N_FFT, axis=1)
    windows = view[:, ::MEL_HOP_LENGTH][:, :frames, mk.TAP0 : mk.TAP0 + mk.TAPS]
    spec = windows @ taps.astype(np.float64)
    half = spec.shape[2] // 2
    power = spec[:, :, :half] ** 2 + spec[:, :, half:] ** 2
    mel = power @ fb.astype(np.float64)
    return np.log(mel + MEL_LOG_EPS) / MEL_SCALE_DIV + MEL_SCALE_ADD


def mel_arrays(audio: torch.Tensor, plain: bool = False) -> Dict[str, torch.Tensor]:
    """The three mel records' (b, frames, 32) arrays of int16-range ``audio``:
    the plain float32 mel, K3 and K3's bf16 DFT (``plain``: their plain versions)."""
    k3 = mk.mel_spectrogram_plain if plain else mk.mel_spectrogram
    return {
        "xla_melspec": mk.mel_spectrogram_plain(audio),
        "pallas_f32": k3(audio),
        "pallas_bf16": k3(audio, dft_dtype=torch.bfloat16),
    }


def feature_arrays(net, audio: torch.Tensor, plain: bool = False) -> Dict[str, torch.Tensor]:
    """(b, 16, 96) features of ``audio``: ``banded_f32`` (K3 -> the banded
    formulation in float32), ``f32`` / ``bf16`` (K1 with the float32 / bf16
    DFT -> K2); ``plain``: the kernels' plain versions."""
    from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
    from heybuddy_tpu_torch.ops.windows import embedding_window_starts

    starts = embedding_window_starts(audio.shape[1])
    mel = mk.mel_spectrogram_plain if plain else mk.mel_spectrogram
    patches_fn = mk.mel_patches_plain if plain else mk.mel_patches
    embed = ek.fused_embedding_plain if plain else ek.fused_embedding_from_patches
    banded = net.apply_spectrogram_banded(mel(audio), starts, compute_dtype=torch.float32)

    def fused(dft_dtype: torch.dtype) -> torch.Tensor:
        patches, n = patches_fn(audio, dft_dtype=dft_dtype)
        return embed(net, patches, starts, n)

    return {"banded_f32": banded, "f32": fused(torch.float32), "bf16": fused(torch.bfloat16)}


def _net(device: torch.device):
    from heybuddy_tpu_torch.convert import embedding_params_from_numpy
    from heybuddy_tpu_torch.models import embedding_net

    return embedding_params_from_numpy(embedding_net.default_params()).to(device).eval()


@torch.no_grad()
def accuracy(device: DeviceLike = "cuda", clips: int = 16, emit: Callable[[str], None] = print) -> List[Dict]:
    """The six accuracy records of ``clips`` realistic clips on ``device``,
    each emitted as a JSON line and returned."""
    dev = resolve_device(device)
    audio_np = realistic_clips(clips)
    audio = torch.from_numpy(audio_np).to(dev)
    ref = f64_logmel(audio_np)
    frames = ref.shape[1]
    records = []

    def record(rec: Dict) -> None:
        emit(json.dumps(rec))
        records.append(rec)

    for label, x in mel_arrays(audio).items():
        d = np.abs(x.cpu().numpy().astype(np.float64)[:, :frames] - ref)
        record({"probe": label, "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                "p999_abs_err": float(np.quantile(d, 0.999)), "kernel": ACCURACY_KERNELS[label]})
    feats = {k: v.cpu().numpy() for k, v in feature_arrays(_net(dev), audio).items()}
    for label, a, b in (("features_fused_f32_vs_banded_f32", feats["f32"], feats["banded_f32"]),
                        ("features_fused_bf16dft_vs_banded_f32", feats["bf16"], feats["banded_f32"])):
        record({"probe": label, "max_abs": float(np.abs(a - b).max()), "kernel": ACCURACY_KERNELS[label]})
    d = np.abs(feats["bf16"] - feats["f32"])
    record({"probe": "features_bf16dft_vs_f32dft", "max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "kernel": ACCURACY_KERNELS["features_bf16dft_vs_f32dft"]})
    return records


def card(device: torch.device) -> str:
    """``nvidia-smi``'s "name, power limit" of a CUDA device; "cpu" otherwise."""
    if device.type != "cuda":
        return "cpu"
    from heybuddy_tpu_torch.utils.cuda_timing import nvidia_smi_line

    return nvidia_smi_line()


def _elapsed_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Milliseconds of ``iters`` calls of ``fn``: CUDA events on a card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def timing(batch: int, iters: int, passes: int, device: DeviceLike = "cuda",
           emit: Callable[[str], None] = print) -> List[Dict]:
    """The five variants at ``batch`` x 23040 noise clips, timed in
    ``passes`` interleaved passes of ``iters`` calls; one record a variant
    with the fastest pass's ms per batch and clips/s."""
    from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
    from heybuddy_tpu_torch.ops.windows import embedding_window_starts

    dev = resolve_device(device)
    name = card(dev)
    net = _net(dev)
    starts = embedding_window_starts(CLIP_SAMPLES)
    gen = torch.Generator(device=dev).manual_seed(0)
    audio = torch.randn((batch, CLIP_SAMPLES), generator=gen, device=dev) * 1000.0
    patches0, n = mk.mel_patches(audio)
    bf16 = torch.bfloat16
    variants: List[Tuple[str, Callable[[], object]]] = [
        ("mel_patches_f32", lambda: mk.mel_patches(audio)),
        ("mel_patches_bf16", lambda: mk.mel_patches(audio, dft_dtype=bf16)),
        ("emb_from_patches", lambda: ek.fused_embedding_from_patches(net, patches0, starts, n)),
        ("full_f32", lambda: ek.fused_embedding_from_patches(net, mk.mel_patches(audio)[0], starts, n)),
        ("full_bf16", lambda: ek.fused_embedding_from_patches(net, mk.mel_patches(audio, dft_dtype=bf16)[0],
                                                              starts, n)),
    ]
    for label, fn in variants:  # the first call builds the kernel's library
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        emit(f"warmed up {label} in {time.perf_counter() - t0:.1f}s")
    best = {label: float("inf") for label, _ in variants}
    for p in range(passes):
        for label, fn in variants:
            best[label] = min(best[label], _elapsed_ms(fn, iters, dev) / iters)
        emit(f"pass {p + 1}/{passes}: " + ", ".join(f"{k}={v:.4f}ms" for k, v in best.items()))
    records = []
    for label, ms in best.items():
        rec = {"probe": label, "ms_per_batch": round(ms, 3), "clips_per_s": round(batch / (ms / 1e3), 0),
               "kernel": TIMING_KERNELS[label], "card": name, "batch": batch}
        emit(json.dumps(rec))
        records.append(rec)
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--skip-accuracy", action="store_true")
    p.add_argument("--skip-timing", action="store_true")
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--passes", type=int, default=6)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)
    names = [torch.cuda.get_device_name(dev)] if dev.type == "cuda" else ["cpu"]
    print(json.dumps({"devices": names, "card": card(dev)}))
    if not args.skip_accuracy:
        accuracy(dev)
    if not args.skip_timing:
        timing(args.batch, args.iters, args.passes, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
