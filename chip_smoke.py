"""
Chip check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``heybuddy_tpu_torch/ops/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the serving
path at full width (2048 clips through ``SpeechEmbeddings``, then
``predict`` through the CLI entry with the shipped head), shows through the
launch counters that the path ran the kernels, times kernels and plain
versions with CUDA events, and ends with one JSON line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero; it also fails without a CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings, featurize_batch
from heybuddy_tpu_torch.models.wakeword import load_model
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.utils.audio_io import write_wav

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "reports", "quality-v26-embedv8.npz")
SEED = 20261016
BATCH = 2048
CLIP = 23040

# H100 SXM data-sheet peaks (dense): memory 3.35 TB/s, fp32 on the CUDA cores
# 67 TFLOP/s, bf16 on the tensor cores 989 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

# Tolerances, each with its reason:
# K1: fp32 DFT on int16-range audio, summed in another order than the plain
#     version: 5e-3 absolute + 1e-4 relative on log-mel values of about -1..4
#     (the JAX suite's bound between its Pallas and XLA mel paths).
K1_ATOL, K1_RTOL = 5e-3, 1e-4
# K2: the bf16 rounding points (RMS outputs, feats, GELU, softmax weights)
#     turn any change of float32 summation order into one-ulp bf16 flips that
#     the trunk carries on to the output. The plain version summed in float32
#     and in float64 already differ by 0.02-0.03 at the worst element (printed
#     as "plain f32 vs f64"); the kernel sums in yet another order, so its
#     worst element may differ from the plain version's by 0.05 (the bound the
#     JAX suite holds its Pallas kernel to against the float32 reference) or
#     by three times that float32-vs-float64 spread, whichever is larger, and
#     its mean deviation must stay under 5e-3.
K2_ATOL, K2_SPREAD, K2_MEAN = 5e-2, 3.0, 5e-3
# the whole path against the plain path, and predict's scores
PATH_ATOL = 0.05
SCORE_ATOL = 0.02


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 11) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_k1(audio: torch.Tensor, expect_patches: int) -> tuple:
    got, n = mk.mel_patches(audio)
    ref, n_ref = mk.mel_patches_plain(audio)
    torch.cuda.synchronize()
    check(n == n_ref == expect_patches, f"K1 num_patches {n}/{n_ref} != {expect_patches}")
    real, real_ref = got[:, :n], ref[:, :n]
    err = (real - real_ref).abs()
    bound = K1_ATOL + K1_RTOL * real_ref.abs()
    check(bool(torch.isfinite(got).all()), "K1 output not finite")
    check(bool((err <= bound).all()), f"K1 disagrees: max |d| {err.max().item():.3e}")
    check(bool((got[:, n:] == 0).all()), "K1 pad rows are not exactly zero")
    return got, n, err.max().item()


def check_k2(net, patches: torch.Tensor, n: int, t: int) -> float:
    starts = embedding_window_starts(t)
    got = ek.fused_embedding_from_patches(net, patches, starts, n)
    ref = ek.fused_embedding_plain(net, patches, starts, n)
    ref64 = ek.fused_embedding_plain(net, patches, starts, n, accumulate=torch.float64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K2 output not finite")
    spec = patches[:, :n].reshape(patches.shape[0], 4 * n, 32)
    exact = net.apply_spectrogram(spec, starts, compute_dtype=torch.float32)
    err = (got - ref).abs()
    cond = (ref - ref64).abs()
    print(f"K2 t={t} b={patches.shape[0]}: max |d| {err.max().item():.3e}, "
          f"mean |d| {err.mean().item():.3e}; plain f32 vs f64: max {cond.max().item():.3e}, "
          f"mean {cond.mean().item():.3e}; vs the float32 reference: kernel max "
          f"{(got - exact).abs().max().item():.3e}, plain max {(ref - exact).abs().max().item():.3e}")
    limit = max(K2_ATOL, K2_SPREAD * cond.max().item())
    check(err.max().item() <= limit and err.mean().item() <= K2_MEAN,
          f"K2 disagrees: max |d| {err.max().item():.3e} (limit {limit:.3e}), "
          f"mean {err.mean().item():.3e}")
    return err.max().item()


def reset_counts() -> None:
    mk.mel_patches.launches = 0
    ek.fused_embedding_from_patches.launches = 0


def read_counts() -> tuple:
    return mk.mel_patches.launches, ek.fused_embedding_from_patches.launches


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- build -------------------------------------------------------------------
    seconds = build.build_all()
    print(f"build: {seconds:.1f} s for {', '.join(build.SOURCES)}")
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    featurizer = SpeechEmbeddings(device=dev)
    net = featurizer.net

    # ---- K1 and K2 against their plain versions ------------------------------------
    k1_err = k2_err = 0.0
    for b, t, expect in ((64, 23040, 35), (3, 17280, 26), (2, 32000, 49)):
        audio = torch.from_numpy(rng.normal(0.0, 1000.0, (b, t)).astype(np.float32)).to(dev)
        patches, n, err = check_k1(audio, expect)
        print(f"K1 t={t} b={b}: num_patches {n}, max |d| {err:.3e}")
        k1_err = max(k1_err, err)
        k2_err = max(k2_err, check_k2(net, patches, n, t))

    # ---- the full path at full width -------------------------------------------------
    clips = np.clip(rng.normal(0.0, 0.05, (BATCH, CLIP)), -1.0, 1.0).astype(np.float32)
    reset_counts()
    emb = featurizer(clips)
    launches_featurize = read_counts()
    check(emb.shape == (BATCH, 16, 96), f"embeddings shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "embeddings not finite")
    check(min(launches_featurize) > 0, f"featurization launched {launches_featurize}")
    mono = torch.from_numpy(clips[:16] * 32767.0).to(dev)
    patches, n = mk.mel_patches_plain(mono)
    plain = ek.fused_embedding_plain(net, patches, embedding_window_starts(CLIP), n).cpu().numpy()
    path_err = float(np.abs(emb[:16] - plain).max())
    print(f"featurize {BATCH} x {CLIP}: launches K1/K2 {launches_featurize}, "
          f"first 16 rows vs plain path max |d| {path_err:.3e}")
    check(path_err <= PATH_ATOL, "featurization disagrees with the plain path")

    # ---- predict through the CLI entry -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "speech.wav")
        t_axis = np.arange(int(3.5 * 16000)) / 16000.0
        tone = 0.3 * np.sin(2 * np.pi * (220.0 + 180.0 * t_axis) * t_axis)
        write_wav(wav, (tone + rng.normal(0.0, 0.02, t_axis.shape)).astype(np.float32))
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["predict", CHECKPOINT, wav])
        predict_s = time.perf_counter() - t0
        launches_predict = read_counts()
        print(f"predict (cli, 3.5 s wav, host clock incl. model load): {predict_s * 1e3:.1f} ms, "
              f"rc {rc}, launches K1/K2 {launches_predict}: {out.getvalue().strip()!r}")
        check(rc == 0, "predict failed")
        check(min(launches_predict) > 0, f"predict launched {launches_predict}")
        windows = load_model(CHECKPOINT, device="cpu").timecode_windows(wav)
        s_gpu = np.array(load_model(CHECKPOINT, device=dev).predict(windows, return_scores=True))
        s_cpu = np.array(load_model(CHECKPOINT, device="cpu").predict(windows, return_scores=True))
    score_err = float(np.abs(s_gpu - s_cpu).max())
    print(f"predict scores card {np.round(s_gpu, 4).tolist()} vs plain path "
          f"{np.round(s_cpu, 4).tolist()}: max |d| {score_err:.3e}")
    check(score_err <= SCORE_ATOL, "predict scores disagree with the plain path")

    # ---- times at batch 2048 -------------------------------------------------------------
    audio = torch.from_numpy(clips * 32767.0).to(dev)
    starts = embedding_window_starts(CLIP)
    patches, n = mk.mel_patches(audio)
    ref_patches, _ = mk.mel_patches_plain(audio)
    torch.cuda.synchronize()
    k1_err = max(k1_err, (patches[:, :n] - ref_patches[:, :n]).abs().max().item())
    check(k1_err <= K1_ATOL + K1_RTOL * 4.0, f"K1 at batch {BATCH}: max |d| {k1_err:.3e}")
    del ref_patches
    k2_err = max(k2_err, check_k2(net, patches, n, CLIP))

    k1_ms = cuda_ms(lambda: mk.mel_patches(audio))
    k1_plain_ms = cuda_ms(lambda: mk.mel_patches_plain(audio))
    k2_ms = cuda_ms(lambda: ek.fused_embedding_from_patches(net, patches, starts, n))
    k2_plain_ms = cuda_ms(lambda: ek.fused_embedding_plain(net, patches, starts, n))
    path_ms = cuda_ms(lambda: featurize_batch(net, audio))
    t0 = time.perf_counter()
    featurizer(clips)  # numpy in, numpy out: host loading, copies both ways, K1, K2
    call_ms = (time.perf_counter() - t0) * 1e3

    usable, _, p_pad = mk.patch_geometry(CLIP)
    k1_ops = BATCH * usable * (mk.TAPS * 2 * mk.N_FREQ_PAD * 2 + mk.N_FREQ_PAD * 32 * 2)
    k1_bytes = BATCH * CLIP * 4 + BATCH * p_pad * 128 * 4 + (mk.TAPS * 256 + 128 * 32) * 4
    cfg = net.config
    n_windows = len(starts)
    k2_ops = BATCH * (
        n * (cfg.patch_dim * cfg.hidden_dim
             + cfg.trunk_blocks * 2 * cfg.hidden_dim * cfg.trunk_hidden_dim
             + cfg.hidden_dim * cfg.pool_heads) * 2
        + n_windows * cfg.pool_heads * cfg.window_patches * cfg.hidden_dim * 2 * 2
        + n_windows * cfg.pool_heads * cfg.hidden_dim * cfg.embedding_dim * 2
    )
    weight_bytes = sum(p.numel() for p in net.parameters()) * 2
    k2_bytes = BATCH * n * 128 * 4 + BATCH * n_windows * 96 * 4 + weight_bytes

    def bound(ops: float, rate: float, nbytes: float) -> tuple:
        t_ops, t_bytes = ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    k1_bound, k1_by = bound(k1_ops, PEAK_FP32, k1_bytes)
    k2_bound, k2_by = bound(k2_ops, PEAK_BF16, k2_bytes)
    print(f"K1 mel_patches     kernel_ms {k1_ms:.4f} plain_ms {k1_plain_ms:.4f} "
          f"bound_ms {k1_bound:.4f} ({k1_by}, {k1_ops / 1e9:.2f} GFLOP fp32)")
    print(f"K2 embedding_pool  kernel_ms {k2_ms:.4f} plain_ms {k2_plain_ms:.4f} "
          f"bound_ms {k2_bound:.4f} ({k2_by}, {k2_ops / 1e9:.2f} GFLOP bf16)")
    print(f"featurize_batch K1+K2 at {BATCH} x {CLIP}: {path_ms:.4f} ms, "
          f"{BATCH / path_ms * 1e3:.0f} clips/s; SpeechEmbeddings call (host clock) {call_ms:.1f} ms")

    kernels = [
        {
            "name": "mel_patches", "route": "cuda",
            "source": "heybuddy_tpu_torch/ops/kernels/csrc/mel_patches.cu",
            "replaces": "heybuddy_tpu/ops/pallas/melspec_kernel.py:199",
            "launches": launches_featurize[0], "launches_predict": launches_predict[0],
            "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
        },
        {
            "name": "embedding_pool", "route": "cuda",
            "source": "heybuddy_tpu_torch/ops/kernels/csrc/embedding_pool.cu",
            "replaces": "heybuddy_tpu/ops/pallas/embedding_kernel.py:309",
            "launches": launches_featurize[1], "launches_predict": launches_predict[1],
            "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
        },
    ]
    print(smi)
    print(json.dumps({"kernels": kernels, "featurize_ms": path_ms,
                      "clips_per_s": BATCH / path_ms * 1e3, "call_ms": call_ms,
                      "predict_ms": predict_s * 1e3, "batch": BATCH}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
