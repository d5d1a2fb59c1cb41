"""
Chip check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the five hand-written kernel libraries from ``heybuddy_tpu_torch/ops/
kernels/csrc`` (K1 mel patches, K1b its hop-block form, K2 fused embedding,
K3 mel spectrogram, K4 one-kernel featurizer; K1 and K3 with their bf16-DFT
variants), prints each library's registers, shared memory and tensor-core
(HMMA) instruction count from ``cuobjdump``, holds each kernel against its
plain PyTorch version on the card, on noise and on a tonal input, then
drives every path a user calls at full width,
each with the launch counters set to 0 just before it and read just after:
``featurize_batch`` in each pooling formulation on 2048 clips (``SpeechEmbeddings``
for "fused", with ``return_spectrograms`` too), the hop-block mel path, the
spectrogram-layout embedding entry, ``extract`` and ``predict`` through the CLI
entry. It checks what each path returns, times kernels and plain versions
with CUDA events, prints one JSON line of kernel numbers and ends with one
JSON line ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero; it also fails without a CUDA device.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.constants import MEL_N_FFT
from heybuddy_tpu_torch.data.extract import LabeledFeatureExtractor
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings, featurize_batch, get_speech_embeddings
from heybuddy_tpu_torch.models.wakeword import load_model
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
from heybuddy_tpu_torch.ops.kernels import featurize_kernel as fk
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.melspec import mel_filterbank, num_frames
from heybuddy_tpu_torch.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.text.tokens import BERTTokenizer
from heybuddy_tpu_torch.utils.audio_io import write_wav
from heybuddy_tpu_torch.utils.codecs import read_wav_any
from heybuddy_tpu_torch.utils.cuda_timing import cuda_ms, nvidia_smi_line

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "reports", "quality-v26-embedv8.npz")
SEED = 20261016
BATCH = 2048
CLIP = 23040
EXTRACT_FILES = 16
EXTRACT_SECONDS = 60
EXTRACT_RUNS = 3  # extract through the CLI, timed apart: the spread of its host-clock time
E2E_PAIRS = 10  # fused-vs-mega pairs: a difference of about 1% needs more than one pair

# H100 SXM data-sheet peaks (dense): memory 3.35 TB/s, fp32 on the CUDA cores
# 67 TFLOP/s, bf16 on the tensor cores 989 TFLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

# Tolerances, each with its reason:
# K1, K1b, K3: a DFT of int16-range audio against the plain float32 version:
#     5e-3 absolute + 1e-4 relative on log-mel values of about -1..4 (the JAX
#     suite's bound between its Pallas and XLA mel paths). K1b sums float32
#     products in another order; K1 and K3 compute a split product of fp16
#     pairs (22 significant bits of each operand, the x_lo b_lo term of about
#     2^-22 dropped), as close to the float32 mel as float32's own rounding.
MEL_ATOL, MEL_RTOL = 5e-3, 1e-4
# K1, K3 also: the split's precision. fp16 pairs stay within 6.1e-5 of the
#     plain version on the tonal input and 1e-6 on noise; bf16 pairs (16
#     significant bits) reach 2.3e-3 on the tone, inside MEL_ATOL but enough
#     to move K4's embeddings a mean 1.2e-2. This bound, between the two,
#     fails a return to the lower precision.
SPLIT_ATOL = 5e-4
# the bf16-DFT variants against their plain version (bf16-rounded operands,
#     float32 products): the JAX suite's bound between the bf16 and float32
#     DFT (tests/test_melspec.py)
BF16_DFT_ATOL = 1e-2
# the libraries whose kernels must run on the tensor cores (HMMA in their SASS)
TENSOR_CORE_LIBS = ("mel_patches", "embedding_pool", "mel_spectrogram", "featurize")
# K2, K4: the bf16 rounding points (RMS outputs, feats, GELU, softmax weights)
#     turn any change of float32 summation order into one-ulp bf16 flips that
#     the trunk carries on to the output. The plain version computed in float32
#     and in float64 (K4: the mel as well as the trunk) already differ by
#     0.02-0.03 at the worst element on noise (printed as "plain f32 vs f64");
#     the kernel sums in yet another order, so its worst element may differ
#     from the plain version's by 0.05 (the bound the JAX suite holds its
#     Pallas kernel to against the float32 reference) or by three times that
#     float32-vs-float64 spread, whichever is larger, and its mean deviation by
#     5e-3 or three times the spread's mean, whichever is larger. On noise the
#     fixed bounds hold; on the tonal input the float32 mel alone moves the
#     plain version's embeddings by a mean of about 5e-3 (the quiet bins' log
#     is that sensitive), so there the spread sets the bound.
BF16_ATOL, BF16_SPREAD, BF16_MEAN = 5e-2, 3.0, 5e-3
# predict's scores, card against the plain path on the CPU
SCORE_ATOL = 0.02
# "banded" / "gather": plain PyTorch in bf16 emulation that rounds the log-mel
#     input itself to bf16, so K3's fp32 rounding differences (about 5e-7)
#     flip input roundings and every bf16 rounding point after them carries
#     the flip on: the worst element moves by more than in K2 (which rounds
#     no input), the mean barely. Against the same formulation fed K3's
#     plain version: max 0.25, mean 5e-3 (printed beside the measured values).
XLA_FORM_ATOL, XLA_FORM_MEAN = 0.25, 5e-3
# extract against SpeechEmbeddings on the same windows: every kernel block
#     computes one clip (K1 one chunk of one clip), so a clip's features do
#     not depend on the batch around it and must be equal bit for bit.
EXTRACT_ATOL = 0.0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def tonal_audio(rng: np.random.Generator, b: int, t: int) -> np.ndarray:
    """
    (b, t) int16-range clips: a 220 -> 400 Hz linear sweep at 0.3 of full
    scale, a random phase per clip, plus white noise 60 dB below the tone.
    Far from the tone the bins hold only the noise, so a DFT's error relative
    to the whole frame shows there: the worse-conditioned input.
    """
    time_s = np.arange(t) / 16000.0
    phase = 2 * np.pi * (220.0 * time_s + 90.0 * time_s**2 / time_s[-1])
    amp = 0.3 * 32767.0
    tone = amp * np.sin(phase[None, :] + rng.uniform(0, 2 * np.pi, (b, 1)))
    noise = rng.normal(0.0, amp / np.sqrt(2) * 1e-3, (b, t))
    return (tone + noise).astype(np.float32)


def resource_report() -> None:
    """Per library: registers and static shared memory of each kernel, its dynamic
    shared memory and the number of HMMA (tensor-core) instructions in its SASS."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in build.SOURCES:
        path = build.library_path(name)
        res = subprocess.run([tool, "-res-usage", path], capture_output=True, text=True, check=True,
                             timeout=120).stdout
        sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                              timeout=120).stdout
        kernels, fn = [], "?"
        for line in res.splitlines():
            m = re.match(r"\s*Function (\S+):", line)
            if m:
                fn = m.group(1)
            elif "REG:" in line:
                usage = dict(re.findall(r"(REG|SHARED|LOCAL):(\d+)", line))
                kernels.append(f"{'bf16 DFT' if 'ILi1E' in fn else 'kernel'}: {usage.get('REG')} "
                               f"registers, {usage.get('SHARED')} B static shared, "
                               f"{usage.get('LOCAL')} B local")
        hmma = len(re.findall(r"\bHMMA\.", sass))
        print(f"  {name}: {'; '.join(kernels)}; dynamic shared {build.smem_bytes(name)} B per "
              f"block; HMMA instructions {hmma}")
        if name in TENSOR_CORE_LIBS:
            check(hmma > 0, f"{name}: no tensor-core instruction in its SASS")


def check_mel(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float = MEL_ATOL,
              rtol: float = MEL_RTOL) -> float:
    """A mel kernel's real rows against its plain version's; returns max |d|."""
    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()), f"{name} output not finite")
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"{name} disagrees: max |d| {err.max().item():.3e} (limit {atol} + {rtol} |ref|)")
    return err.max().item()


def check_split(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """A split-DFT kernel (K1, K3) against its plain version: MEL_ATOL, then SPLIT_ATOL."""
    err = check_mel(name, got, ref)
    check(err <= SPLIT_ATOL, f"{name}: max |d| {err:.3e} exceeds the split's limit {SPLIT_ATOL}")
    return err


def check_k1(audio: torch.Tensor, expect_patches: int, dft_mode: str,
             dft_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, int, float]:
    name = "K1b" if dft_mode == "fat" else "K1" if dft_dtype == torch.float32 else "K1-bf16"
    got, n = mk.mel_patches(audio, dft_mode, dft_dtype)
    ref, n_ref = mk.mel_patches_plain(audio, dft_mode, dft_dtype)
    torch.cuda.synchronize()
    check(n == n_ref == expect_patches, f"{name} num_patches {n}/{n_ref} != {expect_patches}")
    if dft_mode == "chunked" and dft_dtype == torch.float32:
        err = check_split(name, got[:, :n], ref[:, :n])
    elif dft_dtype == torch.float32:
        err = check_mel(name, got[:, :n], ref[:, :n])
    else:
        err = check_mel(name, got[:, :n], ref[:, :n], BF16_DFT_ATOL, 0.0)
    check(bool((got[:, n:] == 0).all()), f"{name} pad rows are not exactly zero")
    return got, n, err


def check_bf16(
    name: str, got: torch.Tensor, ref: torch.Tensor, ref64: torch.Tensor
) -> Tuple[float, float]:
    """K2's recipe for a bf16 kernel against its plain version; returns max |d| and its limit."""
    check(bool(torch.isfinite(got).all()), f"{name} output not finite")
    err = (got - ref).abs()
    cond = (ref - ref64).abs()
    limit = max(BF16_ATOL, BF16_SPREAD * cond.max().item())
    mean_limit = max(BF16_MEAN, BF16_SPREAD * cond.mean().item())
    print(f"  {name}: max |d| {err.max().item():.3e}, mean |d| {err.mean().item():.3e} (limits "
          f"{limit:.3e}, {mean_limit:.3e}); plain f32 vs f64: max {cond.max().item():.3e}, mean "
          f"{cond.mean().item():.3e}")
    check(err.max().item() <= limit and err.mean().item() <= mean_limit,
          f"{name} disagrees: max |d| {err.max().item():.3e} (limit {limit:.3e}), "
          f"mean {err.mean().item():.3e} (limit {mean_limit:.3e})")
    return err.max().item(), limit


def check_path(name: str, got: torch.Tensor, ref: torch.Tensor, limit: float) -> None:
    """A bf16 path against another that differs only in summation order or fp32 mel rounding."""
    err = (got - ref).abs()
    print(f"  {name}: max |d| {err.max().item():.3e}, mean |d| {err.mean().item():.3e} "
          f"(limits {limit:.3e}, {BF16_MEAN})")
    check(bool(torch.isfinite(got).all()), f"{name}: not finite")
    check(err.max().item() <= limit and err.mean().item() <= BF16_MEAN, f"{name}: disagree")


def check_k2(net, patches: torch.Tensor, n: int, t: int) -> Tuple[float, float]:
    starts = embedding_window_starts(t)
    got = ek.fused_embedding_from_patches(net, patches, starts, n)
    ref = ek.fused_embedding_plain(net, patches, starts, n)
    ref64 = ek.fused_embedding_plain(net, patches, starts, n, accumulate=torch.float64)
    torch.cuda.synchronize()
    spec = patches[:, :n].reshape(patches.shape[0], 4 * n, 32)
    exact = net.apply_spectrogram(spec, starts, compute_dtype=torch.float32)
    print(f"K2 t={t} b={patches.shape[0]}: vs the float32 reference: kernel max "
          f"{(got - exact).abs().max().item():.3e}, plain max {(ref - exact).abs().max().item():.3e}")
    return check_bf16("K2", got, ref, ref64)


def check_k4(net, audio: torch.Tensor, t: int) -> Tuple[float, float]:
    starts = embedding_window_starts(t)
    got = fk.fused_featurize(net, audio, starts)
    patches, n = mk.mel_patches_plain(audio)
    ref = ek.fused_embedding_plain(net, patches, starts, n)
    patches64, _ = mk.mel_patches_plain(audio, accumulate=torch.float64)
    ref64 = ek.fused_embedding_plain(net, patches64, starts, n, accumulate=torch.float64)
    k1_patches, _ = mk.mel_patches(audio)
    two_kernels = ek.fused_embedding_from_patches(net, k1_patches, starts, n)
    torch.cuda.synchronize()
    same = (got - two_kernels).abs().max().item()
    print(f"K4 t={t} b={audio.shape[0]}: vs K1 -> K2 on the same audio max |d| "
          f"{same:.3e} (the same arithmetic: 0 expected)")
    check(same == 0.0, "K4 differs from K1 -> K2")
    return check_bf16("K4", got, ref, ref64)


def run_path(name: str, fn: Callable, kernels: Tuple[str, ...]) -> Tuple[object, Dict[str, int]]:
    """
    Run one path with the launch counters from 0; returns its result and the
    counts, and fails unless exactly ``kernels`` were launched.
    """
    build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in build.LAUNCHES.items() if v}
    check(sorted(counts) == sorted(kernels), f"path {name} launched {counts}, expected {kernels}")
    return out, counts


def extract_phase(featurizer: SpeechEmbeddings, rng: np.random.Generator, tmp: str) -> Dict:
    """``extract`` through the CLI entry on generated wavs; checks the shards."""
    wav_dir = os.path.join(tmp, "wavs")
    n = EXTRACT_SECONDS * 16000
    t_axis = np.arange(n) / 16000.0
    texts = []
    for i in range(EXTRACT_FILES):
        tone = 0.2 * np.sin(2 * np.pi * (150.0 + 40.0 * i) * t_axis)
        write_wav(os.path.join(wav_dir, f"speech{i:02d}.wav"),
                  (tone + rng.normal(0.0, 0.05, n)).astype(np.float32))
        texts.append(f"sample {i} says hello number {i * 7}")
        with open(os.path.join(wav_dir, f"speech{i:02d}.txt"), "w") as f:
            f.write(texts[-1])
    # The timed window holds the CLI's whole run: argument parsing, listing the
    # wavs, reading them, windowing, tokenizing, featurizing (the loader, both
    # copies, K1 and K2 in batches of 100) and writing the shards. The shared
    # featurizer is built before it. Runs 2.. show the spread.
    walls, runs = [], []
    for k in range(EXTRACT_RUNS):
        out_dir = os.path.join(tmp, f"shards{k}")
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc, counts = run_path("extract", lambda: cli_main(
                ["extract", "noise", os.path.join(wav_dir, "*.wav"), "--local-files",
                 "--directory", out_dir]), ("mel_patches", "embedding_pool"))
        walls.append(time.perf_counter() - t0)
        check(rc == 0, "extract failed")
        shards = sorted(glob.glob(os.path.join(out_dir, "noise-*.npy")))
        check(stdout.getvalue().startswith(f"Wrote {len(shards)} shard(s):"), "extract's report")
        runs.append(np.concatenate([np.load(p) for p in shards]))
        if k == 0:
            launches = counts
            print(f"path extract: launches {counts}; {stdout.getvalue().strip()!r}")
    data = runs[0]
    check(all(np.array_equal(r, data) for r in runs), "extract runs wrote different shards")

    windows, token_rows = [], []
    extractor = LabeledFeatureExtractor(tmp, "reference", device="cuda")
    tokenizer = BERTTokenizer()
    for i, text in enumerate(texts):
        audio, _ = read_wav_any(os.path.join(wav_dir, f"speech{i:02d}.wav"))
        for window in extractor.windows(audio.mean(axis=0)):
            windows.append(window)
            token_rows.append(tokenizer(text).astype(np.float32))
    check(data.shape == (len(windows), 17, 96), f"extract shards {data.shape}")
    check(bool(np.array_equal(data[:, 16], np.stack(token_rows))), "extract token rows")
    ref = featurizer(np.stack(windows))
    err = float(np.abs(data[:, :16] - ref).max())
    wall = statistics.median(walls)
    print(f"extract {EXTRACT_FILES} wavs x {EXTRACT_SECONDS} s -> {data.shape[0]} clips in "
          f"{len(shards)} shard(s), {EXTRACT_RUNS} runs of the CLI (host clock, featurizer built "
          f"before): {[round(w, 4) for w in walls]} s, median {wall:.4f} s = "
          f"{data.shape[0] / wall:.1f} clips/s (range {data.shape[0] / max(walls):.1f}-"
          f"{data.shape[0] / min(walls):.1f}); features vs SpeechEmbeddings on the same windows "
          f"max |d| {err:.3e} (bound {EXTRACT_ATOL})")
    check(err <= EXTRACT_ATOL, "extract features disagree with SpeechEmbeddings")
    return {"extract_s": walls, "extract_clips": int(data.shape[0]),
            "extract_clips_per_s": data.shape[0] / wall, "launches": launches}


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
            if "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")
    resource_report()

    rng = np.random.default_rng(SEED)
    # the shared featurizer, which extract and predict reach too: built here, out of their timing
    featurizer = get_speech_embeddings(device=dev)
    net = featurizer.net

    # ---- each kernel against its plain version ------------------------------------------
    errs = {k: 0.0 for k in ("K1", "K1b", "K2", "K3", "K4", "K1-bf16", "K3-bf16")}
    bf16 = torch.bfloat16
    cases = [("noise", rng.normal(0.0, 1000.0, (b, t)), b, t, expect)
             for b, t, expect in ((64, 23040, 35), (3, 17280, 26), (2, 32000, 49), (3, 20001, 30),
                                  (2, 160000, 249))]  # a 10 s clip: K2 / K4 walk it in chunks
    cases.append(("tonal", tonal_audio(rng, 8, 23040), 8, 23040, 35))
    for kind, clips_np, b, t, expect in cases:
        audio = torch.from_numpy(clips_np.astype(np.float32)).to(dev)
        patches, n, err = check_k1(audio, expect, "chunked")
        errs["K1"] = max(errs["K1"], err)
        fat, _, err = check_k1(audio, expect, "fat")
        errs["K1b"] = max(errs["K1b"], err)
        fat_vs_k1 = check_mel("K1b vs K1", fat[:, :n], patches[:, :n])
        spec = mk.mel_spectrogram(audio)
        k3_err = check_split("K3", spec, mk.mel_spectrogram_plain(audio))
        errs["K3"] = max(errs["K3"], k3_err)
        layout = (patches[:, :n].reshape(b, 4 * n, 32) - spec[:, : 4 * n]).abs().max().item()
        p16, _, err16 = check_k1(audio, expect, "chunked", bf16)
        errs["K1-bf16"] = max(errs["K1-bf16"], err16)
        s16 = mk.mel_spectrogram(audio, dft_dtype=bf16)
        errs["K3-bf16"] = max(errs["K3-bf16"], check_mel(
            "K3-bf16", s16, mk.mel_spectrogram_plain(audio, bf16), BF16_DFT_ATOL, 0.0))
        k1_err = (patches[:, :n] - mk.mel_patches_plain(audio)[0][:, :n]).abs().max().item()
        print(f"K1/K1b/K3 {kind} t={t} b={b}: num_patches {n}, frames {spec.shape[1]}; max |d| vs "
              f"plain K1 {k1_err:.3e} K3 {k3_err:.3e} (limits {MEL_ATOL} + {MEL_RTOL} |ref| and "
              f"{SPLIT_ATOL}) K1b "
              f"{err:.3e}; K1b vs K1 {fat_vs_k1:.3e} (limit {MEL_ATOL} + {MEL_RTOL} |ref|); "
              f"K3 vs K1 layout {layout:.3e} (one mel body: 0 expected); bf16 DFT vs its plain "
              f"K1 {err16:.3e} K3 {errs['K3-bf16']:.3e} (limit {BF16_DFT_ATOL}), vs K1 "
              f"{(p16[:, :n] - patches[:, :n]).abs().max().item():.3e}")
        check(layout == 0.0, "K3 differs from K1's layout")
        err, limit = check_k2(net, patches, n, t)
        errs["K2"] = max(errs["K2"], err)
        starts = embedding_window_starts(t)
        windows = ek.fused_embedding_windows(net, spec, starts)
        direct = ek.fused_embedding_from_patches(net, patches, starts, n)
        torch.cuda.synchronize()
        check_path("fused_embedding_windows(K3) vs K2 on K1's patches", windows, direct, limit)
        errs["K4"] = max(errs["K4"], check_k4(net, audio, t)[0])

    clips = np.clip(rng.normal(0.0, 0.05, (BATCH, CLIP)), -1.0, 1.0).astype(np.float32)
    audio = torch.from_numpy(clips * 32767.0).to(dev)
    starts = embedding_window_starts(CLIP)
    # ---- the kernels at batch 2048 against their plain versions --------------------------------
    patches, n = mk.mel_patches(audio)
    errs["K1"] = max(errs["K1"], check_split("K1", patches[:, :n], mk.mel_patches_plain(audio)[0][:, :n]))
    fat, _ = mk.mel_patches(audio, "fat")
    errs["K1b"] = max(errs["K1b"], check_mel("K1b", fat[:, :n], mk.mel_patches_plain(audio, "fat")[0][:, :n]))
    spec = mk.mel_spectrogram(audio)
    errs["K3"] = max(errs["K3"], check_split("K3", spec, mk.mel_spectrogram_plain(audio)))
    errs["K1-bf16"] = max(errs["K1-bf16"], check_k1(audio, n, "chunked", bf16)[2])
    errs["K3-bf16"] = max(errs["K3-bf16"], check_mel(
        "K3-bf16", mk.mel_spectrogram(audio, dft_dtype=bf16), mk.mel_spectrogram_plain(audio, bf16),
        BF16_DFT_ATOL, 0.0))
    print(f"kernels at {BATCH} x {CLIP}: max |d| vs plain K1 {errs['K1']:.3e} K1b {errs['K1b']:.3e} "
          f"K3 {errs['K3']:.3e} K1-bf16 {errs['K1-bf16']:.3e} K3-bf16 {errs['K3-bf16']:.3e} "
          f"(maxima over every shape so far)")
    del fat, spec
    err, path_limit = check_k2(net, patches, n, CLIP)  # the limit of every bf16 path below
    errs["K2"] = max(errs["K2"], err)
    errs["K4"] = max(errs["K4"], check_k4(net, audio, CLIP)[0])


    # ---- the paths at full width, each with the counters from 0 -------------------------------
    paths: Dict[str, Dict[str, int]] = {}
    emb, paths["fused"] = run_path("fused", lambda: featurizer(clips), ("mel_patches", "embedding_pool"))
    check(emb.shape == (BATCH, 16, 96) and bool(np.isfinite(emb).all()), f"embeddings {emb.shape}")
    emb_dev = torch.from_numpy(emb).to(dev)
    print(f"path fused (SpeechEmbeddings): launches {paths['fused']}")
    check_path("fused vs the plain path", emb_dev, fk.fused_featurize_plain(net, audio, starts),
               path_limit)

    mega, paths["mega"] = run_path(
        "mega", lambda: featurize_batch(net, audio, pooling="mega"), ("featurize",))
    print(f"path mega: launches {paths['mega']}")
    check_path("mega vs fused (the same arithmetic: 0 expected)", mega, emb_dev, path_limit)
    check(bool(torch.equal(mega, emb_dev)), "mega differs from fused")

    spec_plain = mk.mel_spectrogram_plain(audio)
    for pooling, form in (("banded", net.apply_spectrogram_banded), ("gather", net.apply_spectrogram)):
        out, paths[pooling] = run_path(
            pooling, lambda: featurize_batch(net, audio, pooling=pooling), ("mel_spectrogram",))
        ref = form(spec_plain, starts, compute_dtype=torch.bfloat16)
        err = (out - ref).abs()
        print(f"path {pooling}: launches {paths[pooling]}; vs the same formulation on K3's plain "
              f"version: max |d| {err.max().item():.3e}, mean {err.mean().item():.3e}")
        check(out.shape == (BATCH, 16, 96) and bool(torch.isfinite(out).all()), f"{pooling} output")
        check(err.max().item() <= XLA_FORM_ATOL and err.mean().item() <= XLA_FORM_MEAN,
              f"{pooling} disagrees with its plain-mel version")
    del spec_plain

    (emb_s, spec), paths["spectrograms"] = run_path(
        "spectrograms", lambda: featurizer(clips, return_spectrograms=True),
        ("mel_patches", "embedding_pool", "mel_spectrogram"))
    print(f"path spectrograms (SpeechEmbeddings, return_spectrograms): launches "
          f"{paths['spectrograms']}; spectrograms {spec.shape}")
    check(spec.shape == (BATCH, 420, 32) and bool(np.isfinite(spec).all()), f"spectrograms {spec.shape}")
    check(bool(np.array_equal(emb_s, emb)), "return_spectrograms changed the embeddings")

    def bf16_dft_path():
        patches16, n16 = mk.mel_patches(audio, dft_dtype=bf16)
        return ek.fused_embedding_from_patches(net, patches16, starts, n16)

    out16, paths["bf16_dft"] = run_path("bf16_dft", bf16_dft_path, ("mel_patches_bf16", "embedding_pool"))
    plain16, n16 = mk.mel_patches_plain(audio, dft_dtype=bf16)
    print(f"path bf16_dft (bf16-DFT mel -> K2): launches {paths['bf16_dft']}; vs fused max |d| "
          f"{(out16 - emb_dev).abs().max().item():.3e}")
    check_path("bf16_dft vs K2 on the bf16-DFT plain mel", out16,
               ek.fused_embedding_from_patches(net, plain16, starts, n16), path_limit)
    spec16, paths["bf16_spectrogram"] = run_path(
        "bf16_spectrogram", lambda: mk.mel_spectrogram(audio, dft_dtype=bf16), ("mel_spectrogram_bf16",))
    print(f"path bf16_spectrogram: launches {paths['bf16_spectrogram']}")
    check(spec16.shape == (BATCH, 141, 32) and bool(torch.isfinite(spec16).all()), "bf16 spectrogram")
    del out16, plain16, spec16

    def fat_path():
        fat_patches, n_fat = mk.mel_patches(audio, dft_mode="fat")
        return ek.fused_embedding_from_patches(net, fat_patches, starts, n_fat)

    fat_out, paths["fat"] = run_path("fat", fat_path, ("mel_patches_fat", "embedding_pool"))
    print(f"path fat (hop-block mel -> K2): launches {paths['fat']}")
    check_path("fat vs fused", fat_out, emb_dev, path_limit)

    win_out, paths["windows"] = run_path(
        "windows", lambda: ek.fused_embedding_windows(net, mk.mel_spectrogram(audio), starts),
        ("mel_spectrogram", "embedding_pool"))
    print(f"path windows (K3 -> fused_embedding_windows): launches {paths['windows']}")
    check_path("windows vs fused (one mel body: 0 expected)", win_out, emb_dev, path_limit)

    with tempfile.TemporaryDirectory() as tmp:
        extract = extract_phase(featurizer, rng, tmp)
        paths["extract"] = extract.pop("launches")

        # ---- predict through the CLI entry -------------------------------------------------
        wav = os.path.join(tmp, "speech.wav")
        t_axis = np.arange(int(3.5 * 16000)) / 16000.0
        tone = 0.3 * np.sin(2 * np.pi * (220.0 + 180.0 * t_axis) * t_axis)
        write_wav(wav, (tone + rng.normal(0.0, 0.02, t_axis.shape)).astype(np.float32))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, paths["predict"] = run_path(
                "predict", lambda: cli_main(["predict", CHECKPOINT, wav]),
                ("mel_patches", "embedding_pool"))
        predict_s = time.perf_counter() - t0
        print(f"path predict (cli, 3.5 s wav): launches {paths['predict']}; host clock incl. loading "
              f"the head (the shared featurizer already built) {predict_s * 1e3:.1f} ms, rc {rc}: {out.getvalue().strip()!r}")
        check(rc == 0, "predict failed")
        windows = load_model(CHECKPOINT, device="cpu").timecode_windows(wav)
        s_gpu = np.array(load_model(CHECKPOINT, device=dev).predict(windows, return_scores=True))
        s_cpu = np.array(load_model(CHECKPOINT, device="cpu").predict(windows, return_scores=True))
    score_err = float(np.abs(s_gpu - s_cpu).max())
    print(f"predict scores card {np.round(s_gpu, 4).tolist()} vs plain path "
          f"{np.round(s_cpu, 4).tolist()}: max |d| {score_err:.3e}")
    check(score_err <= SCORE_ATOL, "predict scores disagree with the plain path")

    # ---- times -----------------------------------------------------------------------
    times = {
        "K1": (cuda_ms(lambda: mk.mel_patches(audio)), cuda_ms(lambda: mk.mel_patches_plain(audio))),
        "K1b": (cuda_ms(lambda: mk.mel_patches(audio, "fat")),
                cuda_ms(lambda: mk.mel_patches_plain(audio, "fat"))),
        "K3": (cuda_ms(lambda: mk.mel_spectrogram(audio)), cuda_ms(lambda: mk.mel_spectrogram_plain(audio))),
        "K2": (cuda_ms(lambda: ek.fused_embedding_from_patches(net, patches, starts, n)),
               cuda_ms(lambda: ek.fused_embedding_plain(net, patches, starts, n))),
        "K4": (cuda_ms(lambda: fk.fused_featurize(net, audio, starts)),
               cuda_ms(lambda: fk.fused_featurize_plain(net, audio, starts))),
        "K1-bf16": (cuda_ms(lambda: mk.mel_patches(audio, dft_dtype=bf16)),
                    cuda_ms(lambda: mk.mel_patches_plain(audio, dft_dtype=bf16))),
        "K3-bf16": (cuda_ms(lambda: mk.mel_spectrogram(audio, dft_dtype=bf16)),
                    cuda_ms(lambda: mk.mel_spectrogram_plain(audio, bf16))),
    }
    # end to end: E2E_PAIRS pairs of fused and mega, each pair in the other order
    e2e = {"fused": [], "mega": []}
    for i in range(E2E_PAIRS):
        for pooling in ("fused", "mega") if i % 2 == 0 else ("mega", "fused"):
            e2e[pooling].append(cuda_ms(lambda: featurize_batch(net, audio, pooling=pooling)))
    fused_ms, mega_ms = statistics.median(e2e["fused"]), statistics.median(e2e["mega"])
    mega_wins = sum(m < f for f, m in zip(e2e["fused"], e2e["mega"]))
    t0 = time.perf_counter()
    featurizer(clips)  # numpy in, numpy out: host loading, copies both ways, K1, K2
    call_ms = (time.perf_counter() - t0) * 1e3

    # Bounds: the least work of each function, not of the kernel's own method.
    # A mel frame needs at least: the Hann window on its 400 taps; a real
    # 512-point FFT, 2.5 N log2 N FLOP (the kernels compute a direct DFT
    # instead, 400 x 256 FMAs: both counts are printed); the power of the bins that
    # any mel filter reads; the filterbank's non-zero products (the triangular
    # filters overlap by one, so 231 of its 128 x 32 entries); and log + scale
    # per mel bin. The trunk of K2 is dense and counted as it is.
    usable, _, p_pad = mk.patch_geometry(CLIP)
    frames = num_frames(CLIP)  # 141: K3 computes every frame, K1 the 140 of whole patches
    fbank = mel_filterbank()
    per_frame = (mk.TAPS + 2.5 * MEL_N_FFT * np.log2(MEL_N_FFT)
                 + 3 * int((fbank != 0).any(axis=1).sum()) + 2 * int(np.count_nonzero(fbank))
                 + 3 * fbank.shape[1])
    consts = (mk.TAPS * 256 + 128 * 32) * 4
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
    audio_bytes = BATCH * CLIP * 4
    out_bytes = BATCH * n_windows * 96 * 4
    k1_ops = BATCH * usable * per_frame
    print(f"bounds: {per_frame:.0f} FLOP per mel frame (the kernels' direct DFT does "
          f"{mk.TAPS * 2 * mk.N_FREQ_PAD * 2 + mk.N_FREQ_PAD * 32 * 2}); K1 {k1_ops / 1e9:.3f} GFLOP, "
          f"K2 {k2_ops / 1e9:.3f} GFLOP at batch {BATCH}")
    work = {  # (seconds of operations at their peak rate, bytes, what the operations are)
        "K1": (k1_ops / PEAK_FP32, audio_bytes + BATCH * p_pad * 128 * 4 + consts, "fp32"),
        "K3": (BATCH * frames * per_frame / PEAK_FP32,
               audio_bytes + BATCH * frames * 32 * 4 + consts, "fp32"),
        "K2": (k2_ops / PEAK_BF16, BATCH * n * 128 * 4 + out_bytes + weight_bytes, "bf16"),
        "K4": (k1_ops / PEAK_FP32 + k2_ops / PEAK_BF16,
               audio_bytes + out_bytes + weight_bytes + consts, "fp32 mel + bf16 trunk"),
    }
    work["K1b"] = work["K1"]  # the same function: its extra zero-row work is distance from the bound
    work["K1-bf16"], work["K3-bf16"] = work["K1"], work["K3"]  # the same least work

    def bound(name: str) -> Tuple[float, str]:
        t_ops, nbytes, _ = work[name]
        t_bytes = nbytes / PEAK_BYTES
        return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")

    # Floors of each kernel's own method: the direct DFT (400 x 256 products a
    # frame) as 3 bf16 tensor-core products (split), 1 (bf16 DFT) or float32
    # FMAs over 480 hop-block rows (K1b), plus the float32 tail (power,
    # filterbank); K2's trunk is the function's own work. The larger of those
    # operations at their peak and the function's bytes.
    dft_flop = mk.TAPS * 2 * mk.N_FREQ_PAD * 2
    tail_s = (2 * mk.N_FREQ_PAD + 2 * mk.N_FREQ_PAD * 32) / PEAK_FP32
    frame_s = {"K1": 3 * dft_flop / PEAK_BF16 + tail_s, "K3": 3 * dft_flop / PEAK_BF16 + tail_s,
               "K1-bf16": dft_flop / PEAK_BF16 + tail_s, "K3-bf16": dft_flop / PEAK_BF16 + tail_s,
               "K1b": 3 * 160 * 2 * mk.N_FREQ_PAD * 2 / PEAK_FP32 + tail_s}
    method_s = {k: BATCH * (frames if k.startswith("K3") else usable) * v for k, v in frame_s.items()}
    method_s["K2"] = k2_ops / PEAK_BF16
    method_s["K4"] = method_s["K1"] + method_s["K2"]

    def floor(name: str) -> float:
        return max(method_s[name], work[name][1] / PEAK_BYTES) * 1e3

    meta = {
        "K1": ("mel_patches", "mel_patches.cu", "melspec_kernel.py:199", "fused"),
        "K1b": ("mel_patches_fat", "mel_patches_fat.cu", "melspec_kernel.py:346", "fat"),
        "K2": ("embedding_pool", "embedding_pool.cu", "embedding_kernel.py:309", "fused"),
        "K3": ("mel_spectrogram", "mel_spectrogram.cu", "melspec_kernel.py:96", "spectrograms"),
        "K4": ("featurize", "featurize.cu", "featurize_kernel.py:105", "mega"),
        "K1-bf16": ("mel_patches_bf16", "mel_patches.cu", "melspec_kernel.py:204", "bf16_dft"),
        "K3-bf16": ("mel_spectrogram_bf16", "mel_spectrogram.cu", "melspec_kernel.py:101",
                    "bf16_spectrogram"),
    }
    kernels = []
    for kid, (name, src, replaces, path) in meta.items():
        bound_ms, bound_by = bound(kid)
        print(f"{kid} {name:20s} kernel_ms {times[kid][0]:.4f} plain_ms {times[kid][1]:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}, {work[kid][2]}) floor of its method "
              f"{floor(kid):.4f} ms max_abs_err {errs[kid]:.3e} launches on path {path}: "
              f"{paths[path][name]}")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"heybuddy_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": f"heybuddy_tpu/ops/pallas/{replaces}",
            "launches": paths[path][name], "path": path,
            "max_abs_err": errs[kid], "ms": times[kid][0], "plain_ms": times[kid][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(f"featurize_batch at {BATCH} x {CLIP}, {E2E_PAIRS} pairs in alternating order: fused "
          f"{[round(v, 4) for v in e2e['fused']]} ms, mega {[round(v, 4) for v in e2e['mega']]} ms; "
          f"medians fused {fused_ms:.4f} ms ({BATCH / fused_ms * 1e3:.0f} clips/s), mega "
          f"{mega_ms:.4f} ms ({BATCH / mega_ms * 1e3:.0f} clips/s); mega faster in {mega_wins} of "
          f"{E2E_PAIRS} pairs; SpeechEmbeddings call (host clock) {call_ms:.1f} ms")
    print(smi)
    print(json.dumps({"kernels": kernels, "paths": paths, "featurize_ms": fused_ms,
                      "mega_ms": mega_ms, "mega_wins": mega_wins, "clips_per_s": BATCH / fused_ms * 1e3,
                      "call_ms": call_ms, "predict_ms": predict_s * 1e3, "batch": BATCH,
                      **extract}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
