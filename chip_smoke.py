"""
Chip check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the five hand-written kernel libraries from ``heybuddy_tpu_torch/ops/
kernels/csrc`` (K1 mel patches, K1b its hop-block form, K2 fused embedding,
K3 mel spectrogram, K4 one-kernel featurizer; K1, K1b and K3 with their
bf16-DFT variants), prints each kernel's registers, shared memory and
tensor-core instruction counts (HMMA for mma.sync, HGMMA for wgmma) from
``cuobjdump`` and fails unless the libraries on wgmma (K1b, K2, K4) hold
HGMMA and ptxas serialised none of their wgmmas, holds each kernel against its
plain PyTorch version on the card, on noise and on a tonal input, then
drives every path a user calls at full width,
each with the launch counters set to 0 just before it and read just after:
``featurize_batch`` in each pooling formulation on 2048 clips (``SpeechEmbeddings``
for "fused", with ``return_spectrograms`` too), the hop-block mel path and its
bf16-DFT form, the
spectrogram-layout embedding entry, ``extract`` and ``predict`` through the CLI
entry, and the training path: feature caches built on the card through
``featurize_batch`` ("fused", K1 -> K2) from seeded synthetic clips, ``train``
through the CLI entry (the default head at full width, then a short
``--transformer`` run), a short trajectory of each head on the card against
the CPU (and once more with TF32 on, which the limits must reject), one
fired transformer step on the card against the CPU, ``convert`` run by the numpy ONNX runner against the card, and ``predict``
with the new checkpoint; then feature generation: one 512-clip batch's
render, augmentation and pad-only features on the card against the CPU with
the same draws, timed stage by stage, and ``train`` from an empty dataset
directory on the fused ``formant-device`` route (K1 -> K2 once per batch of
512) and on the host ``formant`` route, with both heads scored on the
generated held-out caches; then the stream path: stream-window caches of each
kind (speech, near-collision and collision-salad streams synthesised on the
host, and speech on the ``formant-device`` route), one K1 and one K2 per
1024-window segment, K1 on the segment's row-strided window view against K1
on the materialised windows bit for bit, a top-up against the whole, and
``train`` with the three stream options from an empty directory; then
``listen --input-wav`` through the CLI entry with the head that run wrote
and its ONNX export, without and with ``--vad``, on the card against the CPU
(detections, chunk scores, one K1 and one K2 per head and scored chunk), and
``SileroStyleVAD`` on the card against the CPU; then embedding pretraining:
one pretrain step (gather, augment, K3 on both views, the embedding's
forward and backward) on the card against the CPU from the bundled npz with
the same indices and draws (and once with TF32 on, which the limits must
reject), ``pretrain-embedding`` through the CLI entry (K3 twice a step), 20
profiled steps, the new npz in a fresh ``SpeechEmbeddings`` (K1 -> K2 against
the plain path), the browser bundle exported from it and run by the numpy
runner against the card, and the neural G2P trained and decoding on the
card; then the ONNX importer: the bundled ``speech-embedding.onnx`` as
``SpeechEmbeddings``' "onnx" backend (K3 once a call, then the graph on
every window) against the card's float32 trunk-pool features, the graph on
the card against the CPU, ``mel-spectrogram.onnx`` against K3 and the plain
mel, and a Silero-layout graph through ``SileroOnnxVAD`` card against CPU;
then the VITS TTS at full width from seeded weights: a Piper ``.pt``
through ``import_torch_checkpoint`` bit for bit, ``infer`` card against CPU
(and with TF32 on, which the limit must reject), ``infer`` at batch 64,
``train --tts-backend vits`` from an empty directory (K1 -> K2 per embed
batch), one full-width ``training_forward`` step card against CPU (with a
TF32 control) and 20 timed and profiled Adam steps, and the tiny voice of
``tools/train_tiny_voice``; last the mesh (``heybuddy_tpu_torch.parallel``):
(a) one rank on NCCL, ``WakeWordTrainer(mesh=...)`` for 30 steps of the
default head and ``SpeechEmbeddings(mesh=...)`` on 2048 clips bit for bit
against no mesh; (b) two ranks on gloo sharing the card, each a process of
its own (``chip_smoke.py mesh-rank ...``): the distributed smoke against one
process's step, ``SpeechEmbeddings(mesh)`` and ``extract --mesh`` bit for bit
against one rank, 30 trainer steps on an unseeded hosted set (every rank on
the seed rank 0 drew) within the trajectory limits of one rank given that
seed, one float32
pretrain step at batch 64 within (a3)'s limits (and the step's gradient
without the division by W outside them), the dryrun's three parts, each
rank's K1 / K2 / K3 launches, steps/s at one and two ranks and the ms of an
``all_reduce`` of the flat gradient; then the quality harness
(``tools/quality_eval``): (a) ``--eval-only`` of the shipped
``browser/models/hey-buddy.onnx`` on 64 held-out clips a set and two
5-minute speech streams with one calibration stream (K1 and K2 once a
1024-window segment and once a held-out set), the first 1024 windows of a
stream scored on the card against the CPU, the JSON's key set against the
JAX report's; (b) a ``--quick`` training run (the loss falls, a mining round
harvests and retrains); last the tools, each through its ``main(argv)``:
the mel precision probe (accuracy of K3, K3-bf16, K1 / K1-bf16 -> K2 on 16
realistic clips against the plain path on the card, timing at batch 2048),
the stream false-positive diagnosis of a 1-minute stream card vs CPU, the
embedding separation probe clean and ``--augment`` (card vs CPU), a 300-step
neural-G2P training, and the API walkthrough at a toy size. It checks what each path returns, times kernels and
plain versions with CUDA events, prints one JSON line of kernel numbers and
ends with one JSON line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero; it also fails without a CUDA device.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.constants import (
    DEFAULT_ACTIVATION_THRESHOLD,
    DEFAULT_FEATURE_BATCH_SIZE,
    DEFAULT_ADVERSARIAL_BATCH_SIZE,
    DEFAULT_NEGATIVE_BATCH_SIZE,
    DEFAULT_POSITIVE_BATCH_SIZE,
    MEL_N_FFT,
    RUNTIME_WINDOW_STRIDE,
)
from heybuddy_tpu_torch.convert import wakeword_params_to_numpy
from heybuddy_tpu_torch.data.augmented import AugmentedAudioGenerator, NoiseProvider
from heybuddy_tpu_torch.data.extract import LabeledFeatureExtractor
from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator, autoconfigure_batch_sizes
from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator
from heybuddy_tpu_torch.data.space import active_space, write_space_sidecar
from heybuddy_tpu_torch.data.streams import stream_window_clips, stream_window_count, synth_speech_stream
from heybuddy_tpu_torch.data.training import WakeWordTrainingDatasetIterator
from heybuddy_tpu_torch.data.tts_generator import SpeechSampleGenerator
from heybuddy_tpu_torch.export.onnx_numpy import OnnxRunner
from heybuddy_tpu_torch.models import formant_device as fd
from heybuddy_tpu_torch.export.onnx_to_torch import OnnxTorchFunction
from heybuddy_tpu_torch.models.embedding_net import load_from_onnx
from heybuddy_tpu_torch.models.featurizer import (
    STREAM_SEGMENT_WINDOWS,
    SpeechEmbeddings,
    featurize_batch,
    featurize_batch_per_window,
    get_speech_embeddings,
)
from heybuddy_tpu_torch.models.tts import VitsTTS, get_tts_model
from heybuddy_tpu_torch.models.vad import SileroOnnxVAD, SileroStyleVAD, get_vad_model
from heybuddy_tpu_torch.models.vits import Vits, VitsConfig, import_torch_checkpoint
from heybuddy_tpu_torch.models.vits import init_params as vits_init_params
from heybuddy_tpu_torch.models.vits.training import (
    ALIGN_SECONDS,
    PosteriorEncoder,
    posterior_encoder_init,
    sdp_posterior_init,
    training_forward,
)
from heybuddy_tpu_torch.parallel.mesh import broadcast_seed
from heybuddy_tpu_torch.runtime.onnx_model import WakeWordONNXModel
from heybuddy_tpu_torch.models.wakeword import (
    WakeWordMLPModel,
    WakeWordTransformerModel,
    load_model,
    read_checkpoint,
)
from heybuddy_tpu_torch.training.trainer import WakeWordTrainer
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import embedding_kernel as ek
from heybuddy_tpu_torch.ops.kernels import featurize_kernel as fk
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.augment import AugmentConfig, augment_batch, draw_augment, seeded_generator
from heybuddy_tpu_torch.ops.melspec import mel_filterbank, num_frames
from heybuddy_tpu_torch.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.text.tokens import BERTTokenizer
from heybuddy_tpu_torch.tools import quality_eval as qe
from heybuddy_tpu_torch.tools.train_tiny_voice import train as train_tiny_voice
from heybuddy_tpu_torch.utils.audio_io import write_wav
from heybuddy_tpu_torch.utils.codecs import read_wav_any
from heybuddy_tpu_torch.utils.cuda_timing import cuda_ms, nvidia_smi_line
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_fixtures import perturbed_vits, silero_v4_graph  # noqa: E402  (the port's tests' fixtures)

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
#     suite's bound between its Pallas and XLA mel paths). K1, K1b and K3
#     compute a split product of fp16 pairs (22 significant bits of each
#     operand, the x_lo b_lo term of about 2^-22 dropped), as close to the
#     float32 mel as float32's own rounding; K1b on wgmma, the others on
#     mma.sync.
MEL_ATOL, MEL_RTOL = 5e-3, 1e-4
# K1, K1b, K3 also: the split's precision. fp16 pairs stay within 6.1e-5 of the
#     plain version on the tonal input and 1e-6 on noise; bf16 pairs (16
#     significant bits) reach 2.3e-3 on the tone, inside MEL_ATOL but enough
#     to move K4's embeddings a mean 1.2e-2. This bound, between the two,
#     fails a return to the lower precision.
SPLIT_ATOL = 5e-4
# the bf16-DFT variants against their plain version (bf16-rounded operands,
#     float32 products): the JAX suite's bound between the bf16 and float32
#     DFT (tests/test_melspec.py)
BF16_DFT_ATOL = 1e-2
# the libraries whose kernels must run on the tensor cores: HMMA (mma.sync) or
# HGMMA (wgmma) in their SASS; those redesigned for Hopper must hold HGMMA, and
# ptxas must not have serialised their wgmmas (its C7510-C7520 warnings)
TENSOR_CORE_LIBS = ("mel_patches", "mel_patches_fat", "embedding_pool", "mel_spectrogram", "featurize")
WGMMA_LIBS = ("mel_patches_fat", "embedding_pool", "featurize")
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

# The train phase. Caches: the default composition's sources at a size that
# builds in seconds (the defaults ask for 100,000 positives and adversarials
# and a hosted 25 GB negative set); batches 50 / 50 / 1000, accumulation 128
# and 3 stages as the defaults; the steps cut from 5,000 to TRAIN_STEPS (the
# stages run 1x, 2x and 4x that); no testing sets.
TRAIN_PHRASE = "hey buddy"
TRAIN_CACHES = {  # name: (rows, kind, labeled)
    "hey-buddy": (4096, "positive", False),
    "hey-buddy-adversarial": (4096, "adversarial", False),
    "training-medium": (65536, "negative", True),
    "hey-buddy-testing-validation": (1024, "positive", False),
    "validation": (8192, "negative", True),
}
TRAIN_STEPS = 1000
TRANSFORMER_STEPS = 1000
TRAJECTORY_STEPS = 30
PROFILE_STEPS = 100  # train steps traced for the device's busy share
# the perceptron's trajectory on the card against the CPU's (float32 both,
# TF32 off; the same initial parameters and index draws): each limit lies
# between the sound run and the same run with TF32 on, which fails all four
# (PERF.md: loss 3.9e-7 and 3.7e-4, rates 0 and 9.5e-4, parameters
# 1.3e-7 and 1.5e-4 at most, 100% and 89.9% within 1e-5 + 1e-4 |x|): the
# loss to 1e-5 relative; recall, false-positive and hard-example rates to
# 5e-4 (no prediction of the ~1000 each counts crosses a threshold in one and
# not the other); the parameters 99% within 1e-5 + 1e-4 |x| and every one
# within 5e-6
TRAJ_LOSS_RTOL, TRAJ_RATE_ATOL, TRAJ_PARAM_SHARE, TRAJ_PARAM_MAX = 1e-5, 5e-4, 0.99, 5e-6
# the transformer's trajectory: its fired steps and its loss only (its
# parameters move as far from 1e-7 of rounding in the initial ones)
TRAJ_T_LOSS_RTOL = 1e-3
# one fired step of the transformer from the seed's initial trunk with a
# seeded random final layer: the loss (relative) and the gradient
# (|g_card - g_cpu| / |g_cpu|). Over 16 final-layer seeds the sound step
# reads loss <= 1.1e-7 and gradient 8.4e-7 - 3.1e-6 (bit-equal when run
# twice), the step with TF32 on loss 1.0e-6 - 1.6e-5 and gradient 5.8e-3 -
# 6.2e-2 (PERF.md): the gradient's limit lies 32x above the one and
# 58x below the other
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-6, 1e-4
# the transformer's trained checkpoint, scored on the card against the CPU
SCORE_TRAINED_ATOL = 1e-5
# convert's ONNX head run by the numpy runner against the model on the card
ONNX_ATOL = 1e-5

# The generate phase: `train` from an empty dataset directory, generating its
# caches on the card. The fused route (`--tts-backend formant-device`: host
# plans, then render -> augment -> K1 -> K2 on the card in batches of 512) at
# the widths of the path (the v8 embedding, 48000-sample renders of 100
# harmonics, 23040-sample clips, the default augmentation); the counts cut
# from 100,000 / 100,000 / 25,000 / 25,000 / 25,000 to these, one stage of
# 1,000 steps. The default host `formant` route smaller still.
GEN_PHRASE = "hey buddy"
GEN_FUSED_ROWS = {"hey-buddy": 2048, "hey-buddy-adversarial": 2048, "hey-buddy-testing-validation": 512,
                  "hey-buddy-testing": 512, "hey-buddy-adversarial-testing": 512}
GEN_HOST_ROWS = {"hey-buddy": 256, "hey-buddy-adversarial": 256, "hey-buddy-testing-validation": 64}
GEN_BATCH = 512  # the fused route's batch: the augment batch size (128), at least 512
GEN_STEPS, GEN_HOST_STEPS = 1000, 250
GEN_ADVERSARIAL_PHRASES = 250  # train's default
GEN_PROFILE_ROWS = 1024  # clips generated under torch.profiler for the device's busy share
# Renders held against the CPU: the first RENDER_CHECK of the 512 (each clip
# renders alone, and the CPU takes about 0.1 s a clip), at 3x the CPU
# render's own float32 error (against float64) and at most 1e-3 of the 0.7
# peak, the CPU tests' bound against JAX's render
RENDER_CHECK = 32
RENDER_SPREAD, RENDER_CAP = 3.0, 1e-3 * 0.7
# augment_batch on the card against the CPU with the same draws, on [-1, 1]
# audio: the CPU tests' bound against JAX's chain (measured there: 8.9e-7)
AUGMENT_ATOL = 1e-4


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
    shared memory and the numbers of HMMA and HGMMA (tensor-core) instructions in its SASS."""
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
                label = re.search(r"[A-Za-z_]+_kernel", fn)
                kernels.append(f"{label.group(0) if label else fn}{' (bf16 DFT)' if 'ILi1E' in fn else ''}: "
                               f"{usage.get('REG')} registers, {usage.get('SHARED')} B static shared, "
                               f"{usage.get('LOCAL')} B local")
        hmma = len(re.findall(r"\bHMMA\.", sass))
        hgmma = len(re.findall(r"\bHGMMA\.", sass))
        print(f"  {name}: {'; '.join(kernels)}; dynamic shared {build.smem_bytes(name)} B per "
              f"block; HMMA instructions {hmma}, HGMMA {hgmma}")
        if name in TENSOR_CORE_LIBS:
            check(hmma + hgmma > 0, f"{name}: no tensor-core instruction in its SASS")
        if name in WGMMA_LIBS:
            check(hgmma > 0, f"{name}: no wgmma (HGMMA) in its SASS")
            serialised = [line for line in build.BUILD_LOGS.get(name, "").splitlines()
                          if "wgmma" in line and "serialized" in line]
            check(not serialised, f"{name}: ptxas serialised its wgmmas: {serialised}")


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
    name = ("K1b" if dft_mode == "fat" else "K1") + ("" if dft_dtype == torch.float32 else "-bf16")
    got, n = mk.mel_patches(audio, dft_mode, dft_dtype)
    ref, n_ref = mk.mel_patches_plain(audio, dft_mode, dft_dtype)
    torch.cuda.synchronize()
    check(n == n_ref == expect_patches, f"{name} num_patches {n}/{n_ref} != {expect_patches}")
    if dft_dtype == torch.float32:
        err = check_split(name, got[:, :n], ref[:, :n])
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


def synth_clips(kind: str, n: int, gen: torch.Generator, dev: torch.device, samples: int = CLIP,
                start_s: Tuple[float, float] = (0.1, 0.7)) -> torch.Tensor:
    """
    (n, samples) seeded synthetic clips in [-1, 1], made on ``dev``. A
    "positive" is a 600 Hz tone of 0.25 s, then after 0.05 s a 900 -> 1300 Hz
    chirp of 0.35 s, at a random start, level and pitch (+-3%) over faint noise;
    an "adversarial" is the same with the chirp reversed (1300 -> 900 Hz); a
    "negative" is white-to-brown noise at a random level, half of them with a
    steady tone of random pitch.
    """
    t = torch.arange(samples, device=dev, dtype=torch.float32) / 16000.0

    def u(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, 1, generator=gen, device=dev)

    white = torch.randn(n, samples, generator=gen, device=dev)
    if kind == "negative":
        brown = torch.cumsum(white, dim=1)
        brown = (brown - brown.mean(1, keepdim=True)) / brown.std(1, keepdim=True)
        mix = u(0.0, 1.0)
        tone = torch.sin(2 * np.pi * u(100.0, 2000.0) * t + u(0.0, 6.3)) * u(0.05, 0.4)
        has_tone = (torch.rand(n, 1, generator=gen, device=dev) < 0.5).float()
        return ((mix * white + (1 - mix) * brown) * u(0.01, 0.3) + has_tone * tone).clamp(-1, 1)
    pitch = u(0.97, 1.03)
    start = u(*start_s)
    tau1, tau2 = t - start, t - start - 0.3
    f2a, f2b = (900.0, 1300.0) if kind == "positive" else (1300.0, 900.0)
    first = torch.sin(2 * np.pi * 600.0 * pitch * tau1) * ((tau1 >= 0) & (tau1 < 0.25))
    chirp = torch.sin(2 * np.pi * pitch * (f2a * tau2 + (f2b - f2a) * tau2 ** 2 / 0.7))
    second = chirp * ((tau2 >= 0) & (tau2 < 0.35))
    return (u(0.15, 0.5) * (first + second) + white * u(0.002, 0.02)).clamp(-1, 1)


def build_caches(net, dev: torch.device, directory: str, gen: torch.Generator) -> Dict[str, np.ndarray]:
    """Every cache of TRAIN_CACHES featurized on the card (K1 -> K2) with its
    space sidecar; labeled caches get a token row of a random text, one text
    in 16 holding the phrase's "hey" (the exclude filter drops those rows)."""
    tokenizer = BERTTokenizer()
    words = ["alpha", "river", "stone", "quiet", "morning", "paper", "green", "window", "table", "seven"]
    texts = [" ".join(words[(i * 7 + k) % len(words)] for k in range(3)) for i in range(15)] + ["hey there"]
    token_table = np.stack([tokenizer(text) for text in texts]).astype(np.float32)
    space = active_space(device=dev)
    out = {}
    for name, (rows, kind, labeled) in TRAIN_CACHES.items():
        feats = np.empty((rows, 17 if labeled else 16, 96), np.float32)
        for i in range(0, rows, BATCH):
            n = min(BATCH, rows - i)
            audio = synth_clips(kind, n, gen, dev) * 32767.0
            feats[i : i + n, :16] = featurize_batch(net, audio).cpu().numpy()
        if labeled:
            pick = torch.randint(0, len(texts), (rows,), generator=gen, device=dev).cpu().numpy()
            feats[:, 16] = token_table[pick]
        check(bool(np.isfinite(feats).all()), f"cache {name} not finite")
        path = os.path.join(directory, f"{name}.npy")
        np.save(path, feats)
        write_space_sidecar(path, space)
        out[name] = feats
    return out


def trajectory_iterator(directory: str, negative_seed: Optional[int] = 3) -> WakeWordTrainingDatasetIterator:
    """The default composition over the caches, with fixed seeds (the hosted
    set's own iterator draws an unseeded shuffle); ``negative_seed=None``
    leaves the hosted set's cache unseeded, as ``train`` builds it."""
    def cache(name: str, seed: Optional[int], **kw) -> PrecalculatedDatasetIterator:
        return PrecalculatedDatasetIterator(name, directory=directory, seed=seed, **kw)

    return WakeWordTrainingDatasetIterator(
        num_batch_threads=1,
        positive=[(cache("hey-buddy", 1), 50)],
        negative=[(cache("hey-buddy-adversarial", 2), 50),
                  (cache("training-medium", negative_seed, labeled=True, exclude_phrase=TRAIN_PHRASE), 1000)],
    )


def trajectory_run(architecture: str, device: torch.device, directory: str, ckpt_dir: str,
                   tf32: bool = False, perturb: bool = False, params=None, steps: int = TRAJECTORY_STEPS,
                   mesh=None, dropout: float = 0.0, negative_seed: Optional[int] = 3) -> Dict:
    """``steps`` steps of ``architecture``, dropout 0 (or ``dropout``), on the default
    composition, from ``params`` or else the seed's initial parameters (the
    model is initialised on the host, then moved), over ``mesh`` if given;
    ``tf32`` lets the matmuls run in TF32; ``perturb`` scales every initial
    parameter by 1 + 1e-7 n (n standard normal, seeded). With
    ``negative_seed=None`` over a mesh, the hosted set takes the seed rank 0
    draws (``broadcast_seed``, as ``train --mesh`` does). Returns
    the history, the flat parameter buffer before and after, the gradient of
    the first fired step (Adam's first moment over 1 - b1 after one step),
    the fired-step count, the trainer with its iterator, and the seed drawn."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        trainer = WakeWordTrainer(checkpoint_dir=ckpt_dir, device=device, architecture=architecture,
                                  seed=SEED, dropout=dropout, params=params, mesh=mesh)
        flat = trainer._adam.flat
        init = flat.cpu().numpy().copy()
        if perturb:
            noise = np.random.default_rng(SEED).standard_normal(flat.numel()).astype(np.float32)
            flat.mul_(torch.from_numpy(1 + 1e-7 * noise).to(device))
        seed = broadcast_seed(mesh) if mesh is not None and negative_seed is None else None
        iterator = trajectory_iterator(directory, negative_seed if seed is None else seed)
        history = trainer.train_epoch(iterator, num_steps=steps, validation_steps=10 ** 6, checkpoint_steps=10 ** 6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return {"history": history, "init": init, "params": flat.cpu().numpy(),
            "grad": trainer._adam.mu.cpu().numpy() / (1 - trainer._adam.b1),
            "fired": int(trainer._adam.count.item()), "trainer": trainer, "iterator": iterator, "seed": seed}


def trajectory_gap(run: Dict, ref: Dict) -> Dict:
    """How far one trajectory ended from another: the loss (relative), the
    rates, the parameters (max and the share within 1e-5 + 1e-4 |x|), the
    fired-step counts."""
    got, want = run["history"], ref["history"]
    perr = np.abs(run["params"] - ref["params"])
    return {
        "loss_rel": float(np.max(np.abs(got["loss"] - want["loss"]) / np.abs(want["loss"]))),
        "rate_err": max(float(np.max(np.abs(got[k] - want[k])))
                        for k in ("recall", "false_positive_rate", "high_loss_rate")),
        "param_max": float(perr.max()),
        "param_share": float(np.mean(perr <= 1e-5 + 1e-4 * np.abs(ref["params"]))),
        "fired": [run["fired"], ref["fired"]],
    }


def trajectory_within(gap: Dict) -> bool:
    return (gap["loss_rel"] <= TRAJ_LOSS_RTOL and gap["rate_err"] <= TRAJ_RATE_ATOL
            and gap["param_max"] <= TRAJ_PARAM_MAX and gap["param_share"] >= TRAJ_PARAM_SHARE
            and gap["fired"][0] == gap["fired"][1] > 0)


def step_gap(run: Dict, ref: Dict) -> Dict:
    """One fired step from one state: the loss (relative) and the gradient
    (the norm of the difference over the reference's norm)."""
    return {
        "loss_rel": float(abs(run["history"]["loss"][0] - ref["history"]["loss"][0]) / ref["history"]["loss"][0]),
        "grad_rel": float(np.linalg.norm(run["grad"] - ref["grad"]) / np.linalg.norm(ref["grad"])),
        "fired": [run["fired"], ref["fired"]],
    }


def step_within(gap: Dict) -> bool:
    return gap["loss_rel"] <= STEP_LOSS_RTOL and gap["grad_rel"] <= STEP_GRAD_RTOL and gap["fired"] == [1, 1]


class StageLog(logging.Handler):
    """The trainer's own log records of one ``train`` run: each stage's step
    count, its seconds from the stage's header to its "finished" record, and
    the loss at every logged step."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.starts: List[Tuple[float, int]] = []
        self.ends: List[float] = []
        self.losses: List[float] = []

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if m := re.match(r"=== Stage \d+/\d+: (\d+) steps", msg):
            self.starts.append((record.created, int(m[1])))
        elif re.match(r"Training Stage \d+ finished", msg):
            self.ends.append(record.created)
        elif m := re.match(r"Training Stage \d+ step \d+/\d+: loss=(\S+) ", msg):
            self.losses.append(float(m[1]))

    def steps(self) -> List[int]:
        return [n for _, n in self.starts]

    def seconds(self) -> List[float]:
        return [end - start for (start, _), end in zip(self.starts, self.ends)]


def train_phase(net, dev: torch.device, tmp: str) -> Dict:
    """Caches on the card, ``train`` (default head, then --transformer) through
    the CLI entry, the trajectory on the card against the CPU, ``convert`` ->
    the numpy runner against the card, and ``predict`` with the checkpoint."""
    data_dir = os.path.join(tmp, "train-data")
    os.makedirs(data_dir)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    caches, launches = run_path("train_cache", lambda: build_caches(net, dev, data_dir, gen),
                                ("mel_patches", "embedding_pool"))
    build_s = time.perf_counter() - t0
    n_clips = sum(rows for rows, _, _ in TRAIN_CACHES.values())
    print(f"train caches: {n_clips} clips featurized on the card in {build_s:.2f} s (host clock, "
          f"synthesis and writing included); launches {launches}; "
          f"{', '.join(f'{k} {v.shape}' for k, v in caches.items())}")
    expected = sum(-(-rows // BATCH) for rows, _, _ in TRAIN_CACHES.values())
    check(launches == {"mel_patches": expected, "embedding_pool": expected},
          f"cache build launched {launches}, expected {expected} of K1 and of K2")

    saved_env = {k: os.environ.get(k) for k in ("HEYBUDDY_DATASET_DIR", "HEYBUDDY_OFFLINE")}
    os.environ["HEYBUDDY_DATASET_DIR"] = data_dir
    os.environ["HEYBUDDY_OFFLINE"] = "1"  # the hosted names are local files: never download
    rows = {name: str(n) for name, (n, _, _) in TRAIN_CACHES.items()}
    common = ["--positive-samples", rows["hey-buddy"], "--adversarial-samples", rows["hey-buddy-adversarial"],
              "--validation-samples", rows["hey-buddy-testing-validation"],
              "--testing-positive-samples", "0", "--testing-adversarial-samples", "0",
              "--num-batch-threads", "1", "--device", dev.type]
    ckpt, ckpt_t = os.path.join(tmp, "ckpt"), os.path.join(tmp, "ckpt-transformer")
    logs = {"perceptron": StageLog(), "transformer": StageLog()}
    try:
        for label, argv in (
            ("perceptron", ["--steps", str(TRAIN_STEPS), "--checkpoint-steps", "1000", "--checkpoint-dir", ckpt]),
            ("transformer", ["--transformer", "--steps", str(TRANSFORMER_STEPS), "--stages", "1",
                             "--checkpoint-dir", ckpt_t]),
        ):
            out = io.StringIO()
            logger.addHandler(logs[label])
            try:
                with contextlib.redirect_stdout(out):
                    rc, _ = run_path(f"train_{label}", lambda: cli_main(["train", TRAIN_PHRASE, *common, *argv]), ())
            finally:
                logger.removeHandler(logs[label])
            check(rc == 0, f"train ({label}) failed")
            print(f"path train (cli, {label}): no kernel launches (cached features); {out.getvalue().strip()!r}")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    expected_steps = [TRAIN_STEPS]
    for _ in range(2):  # the trainer's rule: x2 per stage, at least the validation interval
        expected_steps.append(max(250, expected_steps[-1] * 2))
    for label, steps in (("perceptron", expected_steps), ("transformer", [TRANSFORMER_STEPS])):
        check(logs[label].steps() == steps and len(logs[label].seconds()) == len(steps),
              f"{label} stages {logs[label].steps()}, expected {steps}, all finished")
    # the loss logged every 1/20 of a stage: the perceptron's falls to under
    # half; the transformer (its final layer zero-initialised, softmax scale
    # 1.0) learns slowly in a short run: its loss must fall, by any margin
    for label, ratio in (("perceptron", 0.5), ("transformer", 1.0)):
        series = np.array(logs[label].losses)
        head, tail = float(series[:3].mean()), float(series[-3:].mean())
        print(f"train {label}: loss logged at {len(series)} steps, mean of the first 3 {head:.5f}, of "
              f"the last 3 {tail:.5f} (must be under {ratio} x the first)")
        check(np.isfinite(series).all() and tail < ratio * head, f"{label} loss did not fall")
    stage_s = logs["perceptron"].seconds() + logs["transformer"].seconds()
    rows = DEFAULT_POSITIVE_BATCH_SIZE + DEFAULT_ADVERSARIAL_BATCH_SIZE + DEFAULT_NEGATIVE_BATCH_SIZE
    steps_per_s = TRAIN_STEPS / stage_s[0]
    print(f"train stage 1 (perceptron, {rows} rows a step, device-resident, its "
          f"{TRAIN_STEPS // 250} evals included; host clock, from the trainer's log records): "
          f"{stage_s[0]:.3f} s for {TRAIN_STEPS} steps = {steps_per_s:.1f} steps/s, "
          f"{steps_per_s * rows:.0f} examples/s; stages {[round(s, 3) for s in stage_s]} s")

    final = os.path.join(ckpt, "hey-buddy_final.npz")
    model = load_model(final, device=dev)
    model_t = load_model(os.path.join(ckpt_t, "hey-buddy_final.npz"), device=dev)
    check(isinstance(model, WakeWordMLPModel) and isinstance(model_t, WakeWordTransformerModel),
          "final checkpoints")
    held_pos, held_neg = caches["hey-buddy-testing-validation"][:512], caches["validation"][:512, :16]
    held = np.concatenate([held_pos, held_neg])
    # the perceptron must separate held-out positives from negatives. The
    # transformer scores every clip of these caches alike (JAX's head does
    # too: tests/test_torch_transformer_head.py, run as a script), so its
    # trained checkpoint is held to the CPU's scores instead
    for label, m in (("perceptron", model), ("transformer", model_t)):
        pos, neg = m.scores(held_pos), m.scores(held_neg)
        print(f"train {label}: held-out positives scored {pos.mean():.4f} (recall {np.mean(pos > 0.5):.4f}), "
              f"negatives {neg.mean():.4f} (false accepts {np.mean(neg > 0.5):.4f}); all scores "
              f"{np.concatenate([pos, neg]).min():.6f}-{np.concatenate([pos, neg]).max():.6f}")
        check(bool(np.isfinite(pos).all() and np.isfinite(neg).all()), f"{label} scores not finite")
    check(model.scores(held_pos).mean() > model.scores(held_neg).mean() + 0.5,
          "perceptron does not separate held-out positives from negatives")
    t_err = float(np.abs(model_t.scores(held) - load_model(os.path.join(ckpt_t, "hey-buddy_final.npz"),
                                                          device="cpu").scores(held)).max())
    print(f"train transformer: its checkpoint's scores on the card vs the CPU, {len(held)} held-out rows: "
          f"max |d| {t_err:.3e} (limit {SCORE_TRAINED_ATOL})")
    check(t_err <= SCORE_TRAINED_ATOL, "the transformer's scores on the card disagree with the CPU's")

    # Each head's trajectory on the card against the CPU, from one initial
    # parameter set and one index stream, then the card's once more with TF32
    # on, and the CPU's from initial parameters perturbed by 1e-7 relative (a
    # control: how far float32 rounding alone carries the trajectory). The
    # transformer's control moves its parameters as far as the card does: its
    # final layer starts at zero and stays near it, so the max over its 96
    # channels picks among near-equal logits, and rounding decides which
    # channel the gradient flows back through. Its forward and backward are
    # held on one fired step instead, from the seed's initial trunk with a
    # seeded random final layer, with TF32 on as the control there too. Not
    # from the trained trunk: `train` shuffles its caches without a seed (as
    # JAX's does), so that trunk differs from run to run, and with it how far
    # rounding carries its gradient (1.2e-5 - 9.1e-4 over three trunks of one
    # run, PERF.md). The checks come after convert and predict.
    gaps: Dict[str, Dict] = {}
    cpu = torch.device("cpu")
    trained = read_checkpoint(os.path.join(ckpt_t, "hey-buddy_final.npz"))[1]
    print(f"train transformer: its final layer after {TRANSFORMER_STEPS} steps: |w| at most "
          f"{np.abs(trained['final']['fc']['w']).max():.3e}, bias {float(trained['final']['fc']['b'][0]):.5f}")
    stepped = wakeword_params_to_numpy(WakeWordTrainer(
        checkpoint_dir=os.path.join(tmp, "traj-init"), device=cpu, architecture="transformer", seed=SEED,
        dropout=0.0).model)
    fc = stepped["final"]["fc"]
    fc["w"] = np.random.default_rng(SEED).normal(0.0, 0.1, fc["w"].shape).astype(np.float32)
    for arch, params, steps, keys in (
        ("perceptron", None, TRAJECTORY_STEPS, ("card", "card_tf32", "cpu_perturbed")),
        ("transformer", None, TRAJECTORY_STEPS, ("card", "card_tf32", "cpu_perturbed")),
        ("transformer_trained", trained, 1, ("card",)),  # printed, not held: the near-tied max
        ("transformer_step", stepped, 1, ("card", "card_tf32")),
    ):
        runs = {key: trajectory_run(arch.split("_")[0], dev if key.startswith("card") else cpu, data_dir,
                                    os.path.join(tmp, f"traj-{arch}-{key}"), tf32=key == "card_tf32",
                                    perturb=key == "cpu_perturbed", params=params, steps=steps)
                for key in ("cpu",) + keys}
        check(all(np.array_equal(r["init"], runs["cpu"]["init"]) for r in runs.values()),
              f"{arch}: the runs start from different parameters")
        for key in keys:
            if steps == 1:
                gap = gaps[f"{arch}_{key}"] = step_gap(runs[key], runs["cpu"])
                start = "the trained checkpoint" if params is trained else "the initial trunk, a random final layer"
                print(f"train step {arch} {key} vs CPU, one fired step from {start}, dropout 0: loss rel "
                      f"{gap['loss_rel']:.3e} (limit {STEP_LOSS_RTOL}); gradient |d| / |g| {gap['grad_rel']:.3e} "
                      f"(limit {STEP_GRAD_RTOL}); fired {gap['fired']}; within the limits: {step_within(gap)}")
                continue
            gap = gaps[f"{arch}_{key}"] = trajectory_gap(runs[key], runs["cpu"])
            print(f"trajectory {arch} {key} vs CPU, {steps} steps, dropout 0: loss max rel "
                  f"{gap['loss_rel']:.3e} (limit {TRAJ_LOSS_RTOL}); rates max |d| {gap['rate_err']:.3e} (limit "
                  f"{TRAJ_RATE_ATOL}); params max |d| {gap['param_max']:.3e} (limit {TRAJ_PARAM_MAX}), "
                  f"{gap['param_share']:.4f} within 1e-5 + 1e-4 |x| (limit {TRAJ_PARAM_SHARE}); fired steps "
                  f"{gap['fired']}; loss {runs['cpu']['history']['loss'][0]:.5f} -> "
                  f"{runs['cpu']['history']['loss'][-1]:.5f}; within the limits: {trajectory_within(gap)}")
        if arch == "perceptron":
            card = runs["card"]
            busy = device_busy(lambda: card["trainer"].train_epoch(
                card["iterator"], num_steps=PROFILE_STEPS, validation_steps=10 ** 6, checkpoint_steps=10 ** 6))
    share_txt = "not measured (no device events in the trace)" if busy["busy_ms"] is None else (
        f"{busy['busy_ms']:.2f} ms of kernels ({busy['kernels']}, {busy['kernels'] / PROFILE_STEPS:.0f} a step) in "
        f"{busy['wall_ms']:.2f} ms: device busy {busy['busy_ms'] / busy['wall_ms']:.4f}")
    print(f"train steps under torch.profiler ({PROFILE_STEPS} device-resident steps of {rows} rows, default "
          f"head): {share_txt}")

    # convert -> the numpy ONNX runner, against the model on the card
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli_main(["convert", final]) == 0, "convert failed")
    onnx_path = os.path.splitext(final)[0] + ".onnx"
    x = np.concatenate([held_pos[:128], held_neg[:128]])
    onnx_scores = OnnxRunner.from_file(onnx_path)(input=x)["output"].reshape(-1)
    onnx_err = float(np.abs(onnx_scores - model.scores(x)).max())
    print(f"convert: {out.getvalue().strip()!r}; numpy runner vs the card on 256 rows max |d| "
          f"{onnx_err:.3e} (limit {ONNX_ATOL})")
    check(onnx_err <= ONNX_ATOL, "the ONNX head disagrees with the model on the card")

    # predict with the new checkpoint: the positive pattern fires
    wav_gen = torch.Generator().manual_seed(SEED + 1)
    wav = os.path.join(tmp, "positive.wav")
    write_wav(wav, synth_clips("positive", 1, wav_gen, torch.device("cpu"), 56000, (1.2, 1.2))[0].numpy())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, predict_launches = run_path("train_predict", lambda: cli_main(["predict", final, wav, "--device", dev.type]),
                                        ("mel_patches", "embedding_pool"))
    said = out.getvalue().strip()
    print(f"path predict (cli, the new checkpoint, 3.5 s positive-pattern wav): launches {predict_launches}; "
          f"{said!r}")
    check(rc == 0 and "Wake word detected at" in said, "predict did not fire on the positive pattern")
    noise_wav = os.path.join(tmp, "negative.wav")
    write_wav(noise_wav, synth_clips("negative", 1, wav_gen, torch.device("cpu"), 56000)[0].numpy())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["predict", final, noise_wav, "--device", dev.type])
    print(f"predict on a negative-pattern wav (not checked): {out.getvalue().strip()!r}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["predict", os.path.join(ckpt_t, "hey-buddy_final.npz"), wav, "--device", dev.type])
    print(f"predict with the transformer checkpoint on the positive-pattern wav: {out.getvalue().strip()!r}")
    check(rc == 0, "predict with the transformer checkpoint failed")

    check(trajectory_within(gaps["perceptron_card"]), "perceptron trajectory card vs CPU")
    check(not trajectory_within(gaps["perceptron_card_tf32"]),
          "perceptron: the trajectory with TF32 on passes the limits, which then cannot tell the precision")
    t_gap = gaps["transformer_card"]
    check(t_gap["fired"][0] == t_gap["fired"][1] > 0 and t_gap["loss_rel"] <= TRAJ_T_LOSS_RTOL,
          "transformer trajectory card vs CPU: fired steps or loss")
    check(step_within(gaps["transformer_step_card"]), "transformer step card vs CPU")
    check(not step_within(gaps["transformer_step_card_tf32"]),
          "transformer: the step with TF32 on passes the limits, which then cannot tell the precision")
    return {"train_cache": launches, "train_predict": predict_launches,
            "summary": {"cache_clips": n_clips, "cache_s": build_s, "stage1_steps_per_s": steps_per_s,
                        "stage1_examples_per_s": steps_per_s * rows, "stage_s": stage_s,
                        "trajectory": gaps, "transformer_score_err": t_err,
                        "profiled_steps": PROFILE_STEPS, **{f"profiled_{k}": v for k, v in busy.items()},
                        "onnx_err": onnx_err}}


class GenLog(StageLog):
    """``StageLog`` of a ``train`` run that generates its caches, plus the
    generator's own records: per cache the fused batches, host-fallback
    clips and classic featurize calls."""

    def __init__(self) -> None:
        super().__init__()
        self.fused: Dict[str, Tuple[int, int]] = {}
        self.classic: Dict[str, int] = {}

    def emit(self, record: logging.LogRecord) -> None:
        super().emit(record)
        msg = record.getMessage()
        if m := re.match(r"Fused \d+ clips into (\S+)\.npy in (\d+) batch\(es\) of up to \d+; (\d+) host", msg):
            self.fused[m[1]] = (int(m[2]), int(m[3]))
        elif m := re.match(r"Featurized \d+ clips into (\S+)\.npy in (\d+) featurize call", msg):
            self.classic[m[1]] = self.classic.get(m[1], 0) + int(m[2])


def generate_route(label: str, backend: str, rows: Dict[str, int], steps: int, dev: torch.device,
                   tmp: str) -> Dict:
    """``train`` through the CLI entry from an empty dataset directory on the
    ``backend`` route; checks the caches, the launch counts the batch sizes
    give, and that the loss falls."""
    data_dir = os.path.join(tmp, f"gen-{label}")
    os.makedirs(data_dir)
    argv = ["train", GEN_PHRASE, "--tts-backend", backend, "--positive-samples", str(rows["hey-buddy"]),
            "--adversarial-samples", str(rows["hey-buddy-adversarial"]),
            "--validation-samples", str(rows["hey-buddy-testing-validation"]),
            "--testing-positive-samples", str(rows.get("hey-buddy-testing", 0)),
            "--testing-adversarial-samples", str(rows.get("hey-buddy-adversarial-testing", 0)),
            "--stages", "1", "--steps", str(steps), "--training-no-default-dataset",
            "--checkpoint-dir", os.path.join(tmp, f"gen-{label}-ckpt"), "--device", dev.type]
    saved = os.environ.get("HEYBUDDY_DATASET_DIR")
    os.environ["HEYBUDDY_DATASET_DIR"] = data_dir
    log, out = GenLog(), io.StringIO()
    logger.addHandler(log)
    try:
        with contextlib.redirect_stdout(out):
            t0 = time.time()
            rc, launches = run_path(f"generate_{label}", lambda: cli_main(argv), ("mel_patches", "embedding_pool"))
            total_s = time.time() - t0
    finally:
        logger.removeHandler(log)
        if saved is None:
            os.environ.pop("HEYBUDDY_DATASET_DIR", None)
        else:
            os.environ["HEYBUDDY_DATASET_DIR"] = saved
    check(rc == 0 and "Training complete" in out.getvalue(), f"generate {label}: train failed")
    check(log.steps() == [steps], f"generate {label}: stages {log.steps()}, expected [{steps}]")
    gen_s = log.starts[0][0] - t0
    clips = sum(rows.values())
    shapes = {}
    for name, n in rows.items():
        data = np.load(os.path.join(data_dir, f"{name}.npy"))
        shapes[name] = list(data.shape)
        check(data.shape == (n, 16, 96) and bool(np.isfinite(data).all()),
              f"generate {label}: cache {name} {data.shape}, expected ({n}, 16, 96), finite")
    # the featurize calls the batch sizes give: per cache, the fused batches
    # of its plans and one classic call per embed batch of host-fallback clips
    embed = autoconfigure_batch_sizes(dev)["embed_batch_size"]
    expected = 0
    for name, n in rows.items():
        batches, fallback = log.fused.get(name, (0, n))
        want_batches = -(-(n - fallback) // GEN_BATCH) if backend == "formant-device" else 0
        want_classic = -(-fallback // embed)
        check(batches == want_batches and log.classic.get(name, 0) == want_classic,
              f"generate {label}: {name} made {batches} fused batches and {log.classic.get(name, 0)} classic "
              f"calls, expected {want_batches} and {want_classic} ({fallback} fallback clips)")
        expected += want_batches + want_classic
    check(launches == {"mel_patches": expected, "embedding_pool": expected},
          f"generate {label}: launched {launches}, expected {expected} of K1 and of K2")
    # the loss logged every 1/20 of the stage, from the trainer's own records
    loss = np.array(log.losses)
    head, tail = float(loss[:3].mean()), float(loss[-3:].mean())
    check(bool(np.isfinite(loss).all()) and tail < head, f"generate {label}: the loss did not fall")
    fallbacks = sum(f for _, f in log.fused.values())
    print(f"generate {label} (train --tts-backend {backend}, empty dataset dir, {steps} steps): {clips} clips "
          f"generated in {gen_s:.3f} s (host clock, from the command's start to its training's first stage) = "
          f"{clips / gen_s:.1f} clips/s; whole command {total_s:.3f} s; caches {shapes}; launches {launches} "
          f"(expected {expected}: fused batches {dict(sorted(log.fused.items()))}, classic calls "
          f"{dict(sorted(log.classic.items()))}, {fallbacks} host-fallback clips); loss logged at {len(loss)} "
          f"steps, mean of the first 3 {head:.5f}, of the last 3 {tail:.5f}")
    print(f"generate {label}: logged losses {np.round(loss, 5).tolist()}")
    return {"launches": launches, "data_dir": data_dir, "summary": {
        "clips": clips, "generate_s": gen_s, "clips_per_s": clips / gen_s, "command_s": total_s,
        "caches": shapes, "expected_launches": expected, "fallback_clips": fallbacks,
        "loss_first3": head, "loss_last3": tail}}


def heldout_phase(data_dir: str, dev: torch.device, tmp: str) -> Dict[str, Dict[str, float]]:
    """Both heads on the fused route's generated caches: the default head
    ``generate_route`` trained, and ``--transformer`` trained here on the same
    caches; each scored on the held-out testing caches (positives against
    their adversaries, the second pool of texts). Printed, not held: how far
    the heads separate generated speech is a finding, not a check."""
    ckpt_t = os.path.join(tmp, "gen-fused-transformer")
    saved = os.environ.get("HEYBUDDY_DATASET_DIR")
    os.environ["HEYBUDDY_DATASET_DIR"] = data_dir
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc, _ = run_path("generate_transformer", lambda: cli_main(
                ["train", GEN_PHRASE, "--transformer", "--tts-backend", "formant-device",
                 "--positive-samples", str(GEN_FUSED_ROWS["hey-buddy"]),
                 "--adversarial-samples", str(GEN_FUSED_ROWS["hey-buddy-adversarial"]),
                 "--validation-samples", str(GEN_FUSED_ROWS["hey-buddy-testing-validation"]),
                 "--testing-positive-samples", "0", "--testing-adversarial-samples", "0", "--stages", "1",
                 "--steps", str(GEN_STEPS), "--training-no-default-dataset", "--checkpoint-dir", ckpt_t,
                 "--device", dev.type]), ())
    finally:
        if saved is None:
            os.environ.pop("HEYBUDDY_DATASET_DIR", None)
        else:
            os.environ["HEYBUDDY_DATASET_DIR"] = saved
    check(rc == 0, "train --transformer on the generated caches failed")
    pos = np.load(os.path.join(data_dir, "hey-buddy-testing.npy"))
    neg = np.load(os.path.join(data_dir, "hey-buddy-adversarial-testing.npy"))
    out = {}
    for label, ckpt in (("perceptron", os.path.join(tmp, "gen-fused-ckpt")), ("transformer", ckpt_t)):
        model = load_model(os.path.join(ckpt, "hey-buddy_final.npz"), device=dev)
        s_pos, s_neg = model.scores(pos), model.scores(neg)
        check(bool(np.isfinite(s_pos).all() and np.isfinite(s_neg).all()), f"{label}: held-out scores")
        out[label] = {"pos_mean": float(s_pos.mean()), "recall": float(np.mean(s_pos > 0.5)),
                      "neg_mean": float(s_neg.mean()), "false_accepts": float(np.mean(s_neg > 0.5)),
                      "spread": float(np.ptp(np.concatenate([s_pos, s_neg])))}
        print(f"generate held-out ({len(pos)} testing positives, {len(neg)} testing adversaries, other seeds "
              f"and texts than training) {label}: positives {out[label]['pos_mean']:.4f} (recall "
              f"{out[label]['recall']:.4f}), adversaries {out[label]['neg_mean']:.4f} (false accepts "
              f"{out[label]['false_accepts']:.4f}); all scores within {out[label]['spread']:.3e}")
    return out


def plain_pad_only(plans: List, breath: torch.Tensor, white: torch.Tensor, net, dtype: torch.dtype) -> torch.Tensor:
    """The pad-only fused path's plain version on the CPU: the render, centring
    and K1 -> K2 in ``dtype`` (float64: render, mel and trunk sums in double)."""
    t = {k: torch.from_numpy(v) for k, v in fd.pack_plans(plans, fd.DEFAULT_MAX_SAMPLES).items()}
    audio = fd.render(t["tracks"], t["table"], t["scale"], t["noise_scale"], t["length"], breath, white,
                      l_max=fd.DEFAULT_MAX_SAMPLES, dtype=dtype)
    staged = fd.center_place(audio[:, :CLIP] * (1.0 / 0.7), torch.clamp(t["length"], max=CLIP), CLIP)
    patches, n = mk.mel_patches_plain((staged * 32767.0).float().contiguous(), accumulate=dtype)
    return ek.fused_embedding_plain(net, patches, embedding_window_starts(CLIP), n, accumulate=dtype)


def generate_phase(net, dev: torch.device, tmp: str) -> Dict:
    """One 512-clip batch of each stage on the card against the CPU with the
    same draws and timed; then ``train`` from an empty dataset directory on
    the fused and on the host route; the device's busy share while
    generating."""
    cpu = torch.device("cpu")
    cfg = AugmentConfig()
    tts = get_tts_model("formant-device", device=dev)
    # ---- one fused batch, stage by stage -----------------------------------------
    speech = SpeechSampleGenerator(GEN_PHRASE, adversarial=True, num_adversarial_texts=GEN_ADVERSARIAL_PHRASES,
                                   batch_size=128, seed=SEED, tts_backend="formant-device", device=dev)
    t0 = time.perf_counter()
    samples = list(speech(GEN_BATCH + 64, yield_plans=True))
    plan_s = time.perf_counter() - t0
    plans = [s["plan"] for s in samples if "plan" in s][:GEN_BATCH]
    check(len(plans) == GEN_BATCH, f"{len(plans)} plans of {GEN_BATCH + 64} clips")
    packed = fd.pack_plans(plans, fd.DEFAULT_MAX_SAMPLES)
    t = {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
    breath, white = fd.clip_noise(packed["seeds"], fd.DEFAULT_MAX_SAMPLES, dev)

    def render_card() -> torch.Tensor:
        return fd.render(t["tracks"], t["table"], t["scale"], t["noise_scale"], t["length"], breath, white,
                         l_max=fd.DEFAULT_MAX_SAMPLES, harmonics=tts.harmonics)

    audio = render_card()
    provider = NoiseProvider(seed=SEED)
    noise_bank = torch.from_numpy(provider.noise_batch(GEN_BATCH, CLIP)).to(dev)
    impulse_bank = torch.from_numpy(provider.impulse_batch(GEN_BATCH)).to(dev)
    gen = seeded_generator(dev, SEED, 777, 0)
    draws = draw_augment(gen, GEN_BATCH, CLIP, cfg, dev)
    rows_n = torch.randint(0, GEN_BATCH, (GEN_BATCH,), generator=gen, device=dev)
    rows_i = torch.randint(0, GEN_BATCH, (GEN_BATCH,), generator=gen, device=dev)
    clip = (audio[:, :CLIP] * (1.0 / 0.7)).contiguous()
    lengths = torch.clamp(t["length"], max=CLIP)
    noise_rows, impulse_rows = noise_bank[rows_n], impulse_bank[rows_i]
    staged = augment_batch(clip, lengths, noise_rows, impulse_rows, cfg, draws=draws)
    pad_only = fd.fused_features_batch(plans, net, None, noise_bank, impulse_bank, cfg, pad_only=True,
                                       noise=(breath, white))[0]
    torch.cuda.synchronize()

    # (a) the render: the first RENDER_CHECK clips against the CPU's, same draws
    cpu_net = get_speech_embeddings(device="cpu").net
    sub = {k: v[:RENDER_CHECK].cpu() for k, v in t.items()}
    b_cpu, w_cpu = breath[:RENDER_CHECK].cpu(), white[:RENDER_CHECK].cpu()
    cpu32, cpu64 = (fd.render(sub["tracks"], sub["table"], sub["scale"], sub["noise_scale"], sub["length"], b_cpu,
                              w_cpu, l_max=fd.DEFAULT_MAX_SAMPLES, dtype=dt) for dt in (torch.float32, torch.float64))
    spread = float((cpu32.double() - cpu64).abs().max())
    render_limit = min(RENDER_SPREAD * spread, RENDER_CAP)
    render_err = float((audio[:RENDER_CHECK].cpu() - cpu32).abs().max())
    peaks = audio.abs().amax(dim=1)
    print(f"generate render: {GEN_BATCH} plans x {fd.DEFAULT_MAX_SAMPLES} samples, {tts.harmonics} harmonics; the "
          f"first {RENDER_CHECK} card vs CPU max |d| {render_err:.3e} (limit {render_limit:.3e}: {RENDER_SPREAD}x the "
          f"CPU's float32-vs-float64 {spread:.3e}, at most {RENDER_CAP:.1e}); peaks {float(peaks.min()):.6f}-"
          f"{float(peaks.max()):.6f}")
    check(bool(torch.isfinite(audio).all()) and float((peaks - 0.7).abs().max()) < 1e-5, "render output")
    check(render_err <= render_limit, "the render on the card disagrees with the CPU")
    # (b) augment_batch at (512, 23040) against the CPU with the same draws and inputs
    cpu_aug = augment_batch(clip.cpu(), lengths.cpu(), noise_rows.cpu(), impulse_rows.cpu(), cfg,
                            draws={k: v.cpu() for k, v in draws.items()})
    augment_err = float((staged.cpu() - cpu_aug).abs().max())
    applied = {k: int(v.sum()) for k, v in draws.items() if k.endswith("_apply")}
    print(f"generate augment_batch: ({GEN_BATCH}, {CLIP}) card vs CPU, same draws: max |d| {augment_err:.3e} "
          f"(limit {AUGMENT_ATOL}); stages applied {applied}")
    check(bool(torch.isfinite(staged).all()) and float(staged.abs().max()) <= 1.0, "augment output")
    check(augment_err <= AUGMENT_ATOL, "augment_batch on the card disagrees with the CPU")
    # (c) pad-only fused_features_batch against its plain version on the CPU (K2's rule)
    ref = plain_pad_only(plans[:RENDER_CHECK], b_cpu, w_cpu, cpu_net, torch.float32)
    ref64 = plain_pad_only(plans[:RENDER_CHECK], b_cpu, w_cpu, cpu_net, torch.float64)
    pad_err, pad_limit = check_bf16("generate fused pad-only (card vs the CPU's render -> centring -> K1 -> K2, "
                                    "plain f32 vs f64 throughout)", pad_only[:RENDER_CHECK].cpu(), ref, ref64)
    check(pad_only.shape == (GEN_BATCH, 16, 96) and bool(torch.isfinite(pad_only).all()), "pad-only features")

    # ---- stage times of one 512-clip batch ----------------------------------------
    stage_ms = {
        "noise_draws": cuda_ms(lambda: fd.clip_noise(packed["seeds"], fd.DEFAULT_MAX_SAMPLES, dev), 1, 5),
        "render": cuda_ms(render_card, 1, 5),
        "augment": cuda_ms(lambda: augment_batch(clip, lengths, noise_rows, impulse_rows, cfg, draws=draws), 2, 7),
        "featurize": cuda_ms(lambda: featurize_batch(net, staged * 32767.0), 2, 7),
        "fused_features_batch": cuda_ms(lambda: fd.fused_features_batch(
            plans, net, seeded_generator(dev, SEED, 777, 1), noise_bank, impulse_bank, cfg), 1, 5),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = fd.fused_features_batch(plans, net, seeded_generator(dev, SEED, 777, 2), noise_bank, impulse_bank,
                                    cfg)[0].cpu()
    batch_s = time.perf_counter() - t0
    check(bool(torch.isfinite(feats).all()), "fused features")
    # The render's least work: per sample and harmonic the expression tree's
    # 38 float32 operations (the harmonic's frequency, three formant
    # Lorentzians, the nasal zero and murmur, the Nyquist gate, the
    # accumulation and the sin recurrence), at the float32 peak; its bytes:
    # the tracks, the noise table and the two noise draws read once, the
    # audio written once.
    render_ops = GEN_BATCH * fd.DEFAULT_MAX_SAMPLES * tts.harmonics * 38
    render_bytes = (sum(v.numel() * v.element_size() for v in t.values()) + breath.numel() * 4
                    + white.numel() * 4 + audio.numel() * 4)
    render_bound = max(render_ops / PEAK_FP32, render_bytes / PEAK_BYTES) * 1e3
    print(f"generate render bound: {render_ops / 1e9:.2f} GFLOP float32 -> {render_ops / PEAK_FP32 * 1e3:.3f} ms, "
          f"{render_bytes / 1e6:.1f} MB -> {render_bytes / PEAK_BYTES * 1e3:.3f} ms; the eager render "
          f"{stage_ms['render']:.3f} ms = {stage_ms['render'] / render_bound:.1f}x its bound")
    print(f"generate stages of one {GEN_BATCH}-clip batch: host planning {plan_s:.3f} s for {len(samples)} clips "
          f"(host clock, {len(samples) / plan_s:.1f} clips/s, one thread); CUDA events (median): "
          f"{', '.join(f'{k} {v:.3f} ms' for k, v in stage_ms.items())}; one fused_features_batch to host features "
          f"{batch_s * 1e3:.1f} ms (host clock)")

    # ---- the host route's stages, one augment batch of 128 clips (host clock) ----
    host_tts = get_tts_model("formant", device=dev)
    texts = [s["phrase"] for s in samples[:128]]
    speakers = [(i // 904, i % 904) for i in range(128)]
    t0 = time.perf_counter()
    host_audio = host_tts.synthesize_batch(texts, speakers, 0.25, 1.0, 0.667, 0.8, seed=SEED)
    host_ms = {"tts": (time.perf_counter() - t0) * 1e3}
    augmenter = AugmentedAudioGenerator(iter([]), config=cfg, batch_size=128, noise_provider=provider, seed=SEED,
                                        device=dev)
    clips = [augmenter._prepare_clip({"audio": {"array": a, "sampling_rate": 16000}}) for a in host_audio]
    t0 = time.perf_counter()
    provider.noise_batch(128, CLIP), provider.impulse_batch(128)
    host_ms["noise_and_impulses"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    augmented = augmenter.execute_augment_batch(clips)
    host_ms["augment_with_noise_and_copies"] = (time.perf_counter() - t0) * 1e3
    embeddings = get_speech_embeddings(device=dev)
    t0 = time.perf_counter()
    host_feats = embeddings.featurize_device(augmented)[0].cpu()
    host_ms["featurize_with_copies"] = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(host_feats).all()), "host-route features")
    print(f"generate host-route stages of one 128-clip batch (host clock): "
          f"{', '.join(f'{k} {v:.1f} ms' for k, v in host_ms.items())}; the formant render on "
          f"{os.environ.get('HEYBUDDY_TTS_THREADS') or min(os.cpu_count() or 1, 8)} threads, "
          f"{128 / host_ms['tts'] * 1e3:.1f} clips/s")

    # ---- train from an empty dataset directory, fused and host routes ------------
    fused = generate_route("fused", "formant-device", GEN_FUSED_ROWS, GEN_STEPS, dev, tmp)
    heldout = heldout_phase(fused["data_dir"], dev, tmp)
    host = generate_route("formant", "formant", GEN_HOST_ROWS, GEN_HOST_STEPS, dev, tmp)
    # the adversarial pools recorded beside the caches equal the CPU generator's
    cpu_gen = TrainingFeaturesGenerator(GEN_PHRASE, directory=os.path.join(tmp, "gen-cpu"), device=cpu)
    for route in (fused, host):
        for testing in (False, True):
            sidecar = os.path.join(route["data_dir"], f"hey-buddy-adversarial{'-testing' if testing else ''}.texts.json")
            if not os.path.exists(sidecar.replace(".texts.json", ".npy")):
                continue
            with open(sidecar) as f:
                recorded = json.load(f)
            want = sorted(set(cpu_gen.adversarial_texts(testing=testing, adversarial_phrases=GEN_ADVERSARIAL_PHRASES)))
            check(recorded == want, f"{sidecar}: {len(recorded)} texts, the CPU generator's {len(want)}")
    print(f"generate: the adversarial texts sidecars equal the CPU generator's pools "
          f"({len(recorded)} texts, e.g. {recorded[:3]})")

    # ---- the device's busy share while the fused route generates ----------------
    prof_gen = TrainingFeaturesGenerator(GEN_PHRASE, directory=os.path.join(tmp, "gen-profile"), device=dev,
                                         tts_backend="formant-device")
    busy = device_busy(lambda: prof_gen.get_training_features(GEN_PROFILE_ROWS))
    share = "not measured (no device events in the trace)" if busy["busy_ms"] is None else (
        f"{busy['busy_ms']:.2f} ms of kernels ({busy['kernels']}) in {busy['wall_ms']:.2f} ms: device busy "
        f"{busy['busy_ms'] / busy['wall_ms']:.4f}")
    print(f"generate under torch.profiler ({GEN_PROFILE_ROWS} clips, fused route, planning included): {share}")
    return {"generate_fused": fused["launches"], "generate_formant": host["launches"], "summary": {
        "plan_s": plan_s, "plan_clips": len(samples), "stage_ms": stage_ms, "batch_s": batch_s, "host_ms": host_ms,
        "render_bound_ms": render_bound,
        "render_err": render_err, "render_limit": render_limit, "augment_err": augment_err,
        "pad_only_err": pad_err, "pad_only_limit": pad_limit, "fused": fused["summary"], "heldout": heldout,
        "formant": host["summary"], **{f"profiled_{k}": v for k, v in busy.items()}}}


# The stream phase: stream-window caches generated on the card from the
# host-synthesised streams (data/streams.py), each segment of 1024 windows
# uploaded once and read by K1 as a row-strided view; then `train` with all
# three stream options from an empty directory. STREAM_ROWS is two segments
# per kind, so the double buffer runs; the train counts are cut to one
# segment each (the defaults are 0: users ask for tens of thousands).
STREAM_ROWS = 2048
STREAM_SEED = 0  # train's feature seed
STREAM_KINDS = (  # (label, backend, get_stream_window_features options)
    ("speech", "formant", {}),
    ("adversarial", "formant", {"adversarial": True}),
    ("collision", "formant", {"collision": True}),
    ("speech-device", "formant-device", {}),
)
STREAM_TRAIN_ROWS = 512
STREAM_TRAIN_STEPS = 300
# The listen phase: a 10 s wav (two "hey buddy" and one other phrase over
# ambient noise) through `listen`, with the stream phase's head and its ONNX
# export, chunks of the default 4096 samples. SileroStyleVAD card vs CPU over
# LISTEN_VAD_FRAMES 20 ms frames, state carried: its CPU tests' bound against JAX.
LISTEN_SECONDS = 10
LISTEN_VAD_FRAMES = 50
SILERO_ATOL = 1e-5


@contextlib.contextmanager
def dataset_dir(path: str):
    """``HEYBUDDY_DATASET_DIR`` set to ``path`` inside the block."""
    saved = os.environ.get("HEYBUDDY_DATASET_DIR")
    os.environ["HEYBUDDY_DATASET_DIR"] = path
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("HEYBUDDY_DATASET_DIR", None)
        else:
            os.environ["HEYBUDDY_DATASET_DIR"] = saved


class StreamLog(GenLog):
    """``GenLog`` plus the stream-window caches' segments, per cache."""

    def __init__(self) -> None:
        super().__init__()
        self.segments: Dict[str, int] = {}

    def emit(self, record: logging.LogRecord) -> None:
        super().emit(record)
        if m := re.match(r"Featurized \d+ stream windows into (\S+)\.npy in (\d+) segment", record.getMessage()):
            self.segments[m[1]] = self.segments.get(m[1], 0) + int(m[2])


def stream_phase(net, dev: torch.device, tmp: str) -> Dict:
    """Each stream kind's cache generated on the card, its launches and rows
    checked; the first segment held to the materialised windows; a top-up
    held to the whole; K1 + K2 timed on a segment; `train` with the three
    stream options from an empty directory."""
    seg_windows = STREAM_SEGMENT_WINDOWS
    segments = -(-STREAM_ROWS // seg_windows)
    out: Dict = {"launches": {}, "summary": {}}
    caches = {}
    for label, backend, kwargs in STREAM_KINDS:
        gen = TrainingFeaturesGenerator(GEN_PHRASE, directory=os.path.join(tmp, f"stream-{label}"), device=dev,
                                        tts_backend=backend, seed=STREAM_SEED)
        t0 = time.perf_counter()
        it, launches = run_path(f"stream_{label}", lambda: gen.get_stream_window_features(STREAM_ROWS, **kwargs),
                                ("mel_patches", "embedding_pool"))
        seconds = time.perf_counter() - t0
        rows = np.load(os.path.join(tmp, f"stream-{label}", f"{it.name}.npy"))
        caches[label] = rows
        check(rows.shape == (STREAM_ROWS, 16, 96) and bool(np.isfinite(rows).all()),
              f"stream {label}: rows {rows.shape}, expected ({STREAM_ROWS}, 16, 96), finite")
        check(launches == {"mel_patches": segments, "embedding_pool": segments},
              f"stream {label}: launched {launches}, expected {segments} of K1 and of K2 (one per segment)")
        out["launches"][label] = launches
        out["summary"][label] = {"windows_per_s": STREAM_ROWS / seconds, "seconds": seconds, "segments": segments}
        print(f"stream {label} ({backend} route): {STREAM_ROWS} windows of {it.name} in {seconds:.3f} s (host clock, "
              f"synthesis included) = {STREAM_ROWS / seconds:.1f} windows/s; launches {launches}")
    # the first segment of the speech stream, synthesised again from its seed
    seg_seconds = (seg_windows * RUNTIME_WINDOW_STRIDE + CLIP) / 16000.0
    stream = synth_speech_stream(seg_seconds / 60.0, STREAM_SEED, exclude_phrase=GEN_PHRASE, tts_backend="formant",
                                 device=dev)
    clips = stream_window_clips(stream)[:seg_windows]
    windows = torch.from_numpy(clips * 32767.0).to(dev)
    direct = featurize_batch(net, windows).cpu().numpy()
    err = float(np.abs(caches["speech"][:seg_windows] - direct).max())
    print(f"stream speech: the first segment's rows vs featurize_batch on its {seg_windows} materialised windows: "
          f"max |d| {err:.3e} (the same kernels on the same samples: 0 expected)")
    check(err == 0.0, "stream rows differ from featurize_batch on the materialised windows")
    seg = np.zeros((seg_windows - 1) * RUNTIME_WINDOW_STRIDE + CLIP, np.float32)
    seg[: min(len(stream), len(seg))] = stream[: len(seg)]
    segment = torch.from_numpy(seg).to(dev).mul_(32767.0)
    view = segment.as_strided((seg_windows, CLIP), (RUNTIME_WINDOW_STRIDE, 1))
    for dtype in (torch.float32, torch.bfloat16):
        a, n = mk.mel_patches(view, dft_dtype=dtype)
        b, _ = mk.mel_patches(view.contiguous(), dft_dtype=dtype)
        torch.cuda.synchronize()
        print(f"stream K1 ({dtype}) on the row-strided view ({seg_windows} rows {RUNTIME_WINDOW_STRIDE} apart) vs on "
              f"its contiguous copy: equal {bool(torch.equal(a, b))}, max |d| {(a - b).abs().max().item():.3e}")
        check(bool(torch.equal(a, b)), f"K1 ({dtype}) on the strided view differs from K1 on the materialised windows")
    # a top-up of a half cache equals the cache generated whole
    topup = TrainingFeaturesGenerator(GEN_PHRASE, directory=os.path.join(tmp, "stream-topup"), device=dev,
                                      tts_backend="formant", seed=STREAM_SEED)
    topup.get_stream_window_features(seg_windows)
    it = topup.get_stream_window_features(STREAM_ROWS)
    grown = np.load(os.path.join(tmp, "stream-topup", f"{it.name}.npy"))
    check(bool(np.array_equal(grown, caches["speech"])),
          f"a {seg_windows} -> {STREAM_ROWS} top-up differs from the whole")
    print(f"stream speech: a {seg_windows} -> {STREAM_ROWS} top-up equals the cache generated whole")
    # K1 + K2 of one segment by CUDA events, and what the segment upload costs
    k1k2_ms = cuda_ms(lambda: featurize_batch(net, view))
    upload_ms = cuda_ms(lambda: torch.from_numpy(seg).to(dev))
    stream_ms = cuda_ms(lambda: get_speech_embeddings(device=dev).featurize_stream_device(
        stream, seg_windows, RUNTIME_WINDOW_STRIDE)[0].cpu())
    window_bytes = seg_windows * CLIP * 4
    print(f"stream segment of {seg_windows} windows, CUDA events (median): K1 + K2 on the strided view "
          f"{k1k2_ms:.4f} ms; the upload of the segment {upload_ms:.4f} ms; featurize_stream_device (upload, "
          f"scale, K1, K2) and the rows' copy back {stream_ms:.4f} ms; bytes uploaded {seg.nbytes} (the "
          f"materialised windows would be {window_bytes}, {window_bytes / seg.nbytes:.2f}x)")
    # the device's share of a segment, bounded from above: all of the
    # segment's device work (featurize_stream_device and the rows' copy back,
    # timed end to end) over the host-route segment's wall time
    # (torch.profiler's trace of one segment held no device event in this
    # long process, though a fresh process sees its five)
    segment_ms = out["summary"]["speech"]["seconds"] / segments * 1e3
    share = stream_ms / segment_ms
    out["summary"]["segment"] = {"k1_k2_ms": k1k2_ms, "upload_ms": upload_ms, "featurize_stream_device_ms": stream_ms,
                                 "bytes_uploaded": seg.nbytes, "materialised_bytes": window_bytes,
                                 "host_ms": segment_ms, "device_share_at_most": share}
    print(f"stream: a host-route segment takes {segment_ms:.1f} ms (host clock); the card's share of it is at most "
          f"its device work's {stream_ms:.4f} ms: {share:.6f}")
    out.update(stream_train(dev, tmp))
    return out


def stream_train(dev: torch.device, tmp: str) -> Dict:
    """``train`` through the CLI from an empty dataset directory with the three
    stream options on the host route: the caches, the launch counts (one K1
    and one K2 per featurize call and per stream segment) and a falling loss."""
    data_dir = os.path.join(tmp, "stream-train")
    os.makedirs(data_dir)
    ckpt = os.path.join(tmp, "stream-train-ckpt")
    rows = GEN_HOST_ROWS
    argv = ["train", GEN_PHRASE, "--tts-backend", "formant", "--positive-samples", str(rows["hey-buddy"]),
            "--adversarial-samples", str(rows["hey-buddy-adversarial"]),
            "--validation-samples", str(rows["hey-buddy-testing-validation"]),
            "--testing-positive-samples", "0", "--testing-adversarial-samples", "0",
            "--stream-negative-samples", str(STREAM_TRAIN_ROWS), "--collision-negative-samples",
            str(STREAM_TRAIN_ROWS), "--validation-stream-negative-samples", str(STREAM_TRAIN_ROWS),
            "--stages", "1", "--steps", str(STREAM_TRAIN_STEPS), "--training-no-default-dataset",
            "--checkpoint-dir", ckpt, "--device", dev.type]
    log, stdout = StreamLog(), io.StringIO()
    logger.addHandler(log)
    try:
        with dataset_dir(data_dir), contextlib.redirect_stdout(stdout):
            t0 = time.time()
            rc, launches = run_path("stream_train", lambda: cli_main(argv), ("mel_patches", "embedding_pool"))
            total_s = time.time() - t0
    finally:
        logger.removeHandler(log)
    check(rc == 0 and "Training complete" in stdout.getvalue(), "train with the stream options failed")
    check(len(log.segments) == 4, f"stream caches generated: {sorted(log.segments)}, expected 4")
    for name in log.segments:
        data = np.load(os.path.join(data_dir, f"{name}.npy"))
        check(bool(np.isfinite(data).all()) and data.shape[1:] == (16, 96), f"stream cache {name} {data.shape}")
    expected = sum(log.classic.values()) + sum(log.segments.values())
    check(launches == {"mel_patches": expected, "embedding_pool": expected},
          f"stream train: launched {launches}, expected {expected} (featurize calls {log.classic}, segments "
          f"{log.segments})")
    loss = np.array(log.losses)
    head, tail = float(loss[:3].mean()), float(loss[-3:].mean())
    check(bool(np.isfinite(loss).all()) and tail < head, "stream train: the loss did not fall")
    print(f"stream train (train --stream-negative-samples / --collision-negative-samples / "
          f"--validation-stream-negative-samples {STREAM_TRAIN_ROWS}, empty dataset dir, {STREAM_TRAIN_STEPS} steps): "
          f"whole command {total_s:.3f} s (host clock); stream caches {log.segments} segments; featurize calls "
          f"{log.classic}; launches {launches}; loss mean of the first 3 {head:.5f}, of the last 3 {tail:.5f}")
    return {"train_launches": launches, "head": os.path.join(ckpt, "hey-buddy_final.npz"),
            "train": {"command_s": total_s, "segments": log.segments, "loss_first3": head, "loss_last3": tail}}


class ChunkLog(logging.Handler):
    """The per-chunk debug records of ``run_listen``: scores and wall ms of the
    scored chunks, wall ms of the skipped ones."""

    def __init__(self) -> None:
        super().__init__(logging.DEBUG)
        self.scores: List[List[float]] = []
        self.ms: List[float] = []
        self.skipped = 0

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if m := re.match(r"listen chunk \d+: scores \[(.*)\] in (\S+) ms", msg):
            self.scores.append([float(v) for v in m[1].split(",")])
            self.ms.append(float(m[2]))
        elif re.match(r"listen chunk \d+: skipped", msg):
            self.skipped += 1


def listen_wav(path: str) -> None:
    """LISTEN_SECONDS of ambient noise with two "hey buddy" and one other phrase
    rendered by the host formant TTS, written as a wav."""
    rng = np.random.default_rng(SEED)
    audio = rng.normal(0.0, 3e-4, LISTEN_SECONDS * 16000).astype(np.float32)
    tts = get_tts_model("formant")
    for text, at in (("hey buddy", 1.0), ("what time is it", 4.0), ("hey buddy", 7.0)):
        (_, pcm), = tts([text], num_samples=1, seed=SEED)
        clip = 0.5 * pcm.astype(np.float32) / 32768.0
        start = int(at * 16000)
        audio[start : start + len(clip)] += clip[: len(audio) - start]
    write_wav(path, audio)


def run_listen_cli(heads: List[str], wav: str, device: torch.device, threshold: float,
                   vad: bool) -> Tuple[List[str], ChunkLog, Dict[str, int]]:
    """``listen`` through the CLI entry with --debug: its detection lines, its
    chunk records and the launches it made."""
    get_vad_model(device=device).reset()
    log, stdout = ChunkLog(), io.StringIO()
    logger.addHandler(log)
    level = logger.level
    try:
        with contextlib.redirect_stdout(stdout):
            build.LAUNCHES.clear()
            rc = cli_main(["listen", *heads, "--input-wav", wav, "--threshold", repr(threshold), "--device",
                           device.type, "--debug", "--vad" if vad else "--no-vad"])
            if device.type == "cuda":
                torch.cuda.synchronize()
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    check(rc == 0, f"listen on {device} failed")
    return stdout.getvalue().strip().splitlines(), log, launches


def listen_phase(dev: torch.device, tmp: str, head: str) -> Dict:
    """``listen --input-wav`` with the stream phase's head and its ONNX export,
    without and with --vad, on the card against the CPU: detections, chunk
    scores and launches; SileroStyleVAD card vs CPU with state carried."""
    cpu = torch.device("cpu")
    onnx = os.path.join(tmp, "listen-head.onnx")
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli_main(["convert", head, onnx]) == 0, "convert of the stream head failed")
    heads = [head, onnx]
    wav = os.path.join(tmp, "listen.wav")
    listen_wav(wav)
    # the threshold: the gap between the CPU's chunk scores nearest 0.5 that
    # is at least 2 SCORE_ATOL wide, so that no score within SCORE_ATOL of the
    # CPU's can land on the other side of it
    _, probe, _ = run_listen_cli(heads, wav, cpu, DEFAULT_ACTIVATION_THRESHOLD, False)
    pooled = np.sort(np.unique(np.concatenate(probe.scores)))
    candidates = [(abs((a + b) / 2 - 0.5), (a + b) / 2) for a, b in zip(pooled[:-1], pooled[1:])
                  if b - a >= 2 * SCORE_ATOL]
    check(bool(candidates), f"no gap of {2 * SCORE_ATOL} between the CPU's chunk scores {pooled.tolist()}")
    threshold = float(min(candidates)[1])
    out: Dict = {"threshold": threshold}
    for vad in (False, True):
        label = "listen_vad" if vad else "listen"
        want, cpu_log, _ = run_listen_cli(heads, wav, cpu, threshold, vad)
        got, card_log, launches = run_listen_cli(heads, wav, dev, threshold, vad)
        scored = len(card_log.scores)
        stamps = [line.split(" score=")[0] for line in got]
        check(stamps == [line.split(" score=")[0] for line in want] and bool(got),
              f"{label}: detections {got} on the card, {want} on the CPU")
        check(scored == len(cpu_log.scores) and card_log.skipped == cpu_log.skipped,
              f"{label}: {scored} scored / {card_log.skipped} skipped chunks on the card, "
              f"{len(cpu_log.scores)} / {cpu_log.skipped} on the CPU")
        score_err = float(np.abs(np.array(card_log.scores) - np.array(cpu_log.scores)).max())
        check(score_err <= SCORE_ATOL, f"{label}: chunk scores card vs CPU max |d| {score_err}")
        check(launches == {"mel_patches": len(heads) * scored, "embedding_pool": len(heads) * scored},
              f"{label}: launched {launches}, expected one K1 and one K2 per head and scored chunk "
              f"({len(heads)} x {scored})")
        check(vad == (card_log.skipped > 0), f"{label}: {card_log.skipped} chunks skipped")
        ms = np.array(card_log.ms)
        out[label] = {"detections": got, "scored": scored, "skipped": card_log.skipped, "score_err": score_err,
                      "launches": launches, "chunk_ms_median": float(np.median(ms)),
                      "chunk_ms_p95": float(np.percentile(ms, 95))}
        print(f"path {label} (cli listen --input-wav, {LISTEN_SECONDS} s wav, heads npz + onnx, threshold "
              f"{threshold:.4f}{', --vad' if vad else ''}): {len(got)} detections, the CPU's (first {got[:4]}); "
              f"{scored} chunks scored, "
              f"{card_log.skipped} skipped; chunk scores card vs CPU max |d| {score_err:.3e} (limit {SCORE_ATOL}); "
              f"launches {launches}; per scored chunk wall ms (host clock, both heads) median "
              f"{out[label]['chunk_ms_median']:.3f}, p95 {out[label]['chunk_ms_p95']:.3f}")
    busy = device_busy(lambda: run_listen_cli(heads, wav, dev, threshold, False))
    out["profiled"] = busy
    print("listen under torch.profiler (the run without --vad): " + (
        "not measured (no device events in the trace)" if busy["busy_ms"] is None else
        f"{busy['busy_ms']:.3f} ms of kernels ({busy['kernels']}) in {busy['wall_ms']:.1f} ms: device busy "
        f"{busy['busy_ms'] / busy['wall_ms']:.4f}"))
    # SileroStyleVAD on the card against the CPU, state carried over 20 ms frames
    audio = read_wav_any(wav)[0].mean(axis=0)
    card, host = SileroStyleVAD(seed=SEED, device=dev), SileroStyleVAD(seed=SEED, device=cpu)
    gaps, frame_ms = [], []
    for i in range(LISTEN_VAD_FRAMES):
        frame = audio[16000 + 320 * i : 16000 + 320 * (i + 1)]
        t0 = time.perf_counter()
        p = card(frame)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        gaps.append(max(abs(p - host(frame)), float((card.h.cpu() - host.h).abs().max()),
                        float((card.c.cpu() - host.c).abs().max())))
    vad_err = max(gaps)
    check(vad_err <= SILERO_ATOL, f"SileroStyleVAD card vs CPU max |d| {vad_err}")
    out["silero"] = {"max_abs_err": vad_err, "frame_ms_median": float(np.median(frame_ms))}
    print(f"SileroStyleVAD card vs CPU over {LISTEN_VAD_FRAMES} frames of 320 samples, state carried: probability, "
          f"h and c max |d| {vad_err:.3e} (limit {SILERO_ATOL}); per frame (host clock, a call returns the "
          f"probability) median {out['silero']['frame_ms_median']:.3f} ms")
    return out


# The pretrain phase: embedding pretraining (K3 on both views' mels, autograd
# through the embedding), the new npz in the featurizer and the browser
# bundle, and the neural G2P on the card. The CLI run takes JAX's defaults
# (512 texts x 4 speakers, batch 64, lr 1e-3, temperature 0.1, seed 0) with
# the fused TTS route, a quarter of the pool in phonetic-neighbour clusters and
# "hey buddy"'s focus cluster; its steps are cut from 1,000 to PRETRAIN_STEPS.
PRETRAIN_PHRASE = "hey buddy"
PRETRAIN_STEPS = 300
PRETRAIN_LOG_EVERY = 50  # the CLI's (JAX's) default
PRETRAIN_PROFILE_STEPS = 20
# (a)'s pool: enough texts for one batch of 64 with the focus cluster, two
# renderings each, on the fused route
PRETRAIN_CHECK_TEXTS, PRETRAIN_CHECK_SPEAKERS = 128, 2
# (a) one step card vs CPU from the bundled npz, the same indices and draws.
# The log-mel is ill-conditioned where a view is near silence (log(power +
# 1e-6) of int16-range audio): a sample exactly 0 on one device and not on the
# other, or the 22-bit operands of K3's split DFT against float32's 24, move a
# frame's quiet bins far, and the whole step's loss by 0.3-0.5% and its
# gradient by 5-6% of its norm (PERF.md). So the step is held in parts:
# (a1) the views: the augment bound of the generate phase (AUGMENT_ATOL);
# (a2) K3 on the views against the float64 mel: max(MEL_ATOL, this x the plain
#     float32 mel's own distance from float64). The split keeps 22 of
#     float32's 24 significant bits and the tensor cores accumulate in their
#     own float32, so on these frames K3 reads 5-6.7x the plain version's
#     distance (1.06e-2 / 1.22e-2 against 2.1e-3 / 1.8e-3 on an H100). K3's
#     bf16-DFT entry (8-bit operands) must fail the same limit;
K3_SPLIT_SPREAD = 10.0
# (a3) the step after the mel (embedding forward, losses, backward) on the same
#     spectrograms: loss (relative) and gradient (max |d| over its norm).
#     float32 compute: each limit between the sound step (3.3e-7, 3.5e-7) and
#     the same step on the card with TF32 on (5.3e-5, 6.2e-4), which must fail.
#     bf16 compute (the path's): float32 summation order flips bf16 roundings,
#     so the sound step reads 9.1e-5 / 1.5e-3 and TF32 on, whose operands the
#     rounding to bf16 has already made exact in TF32, 7.9e-6 / 4.6e-4: TF32 is
#     not separable there, and the limits sit 10x / 6.5x above the sound step
#     (PERF.md);
PRETRAIN_LOSS_RTOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
PRETRAIN_GRAD_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
# (a4) the whole step on each device from its own views and mels: printed, with
#     how far the CPU's own step moves on the card's views; finite.
# (d) the exported browser pipeline in the numpy runner against the card's
# float32 featurizer: the bound of JAX's test_browser_pipeline_end_to_end
BROWSER_ATOL = 1e-3
# (e) the neural G2P: 300 steps on the rule engine's table over the wordlist;
# the card's torch forward against the numpy forward on the same parameters
G2P_STEPS, G2P_LR = 300, 1e-3
G2P_FORWARD_ATOL = 1e-5
G2P_WORDS = ("hey", "buddy", "hello", "world", "computer", "lights", "kitchen", "please", "zephyr", "quokka",
             "thermostat", "alexa", "jarvis", "banana", "wednesday", "rhythm")


class PretrainLog(logging.Handler):
    """The pretrainer's and the G2P trainer's logged losses."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.rows: List[Tuple[int, float, float, float]] = []  # step, loss, nt-xent, hard-pair
        self.g2p: List[Tuple[int, float]] = []
        self.clips = 0

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if m := re.match(r"Synthesizing clip pool: (\d+) texts x (\d+) speakers", msg):
            self.clips = int(m[1]) * int(m[2])
        elif m := re.match(r"pretrain step (\d+)/\d+: loss (\S+) \(nt-xent (\S+), hard-pair (\S+)\)", msg):
            self.rows.append((int(m[1]), float(m[2]), float(m[3]), float(m[4])))
        elif m := re.match(r"neural-g2p step (\d+)/\d+: loss=(\S+)", msg):
            self.g2p.append((int(m[1]), float(m[2])))


def step_grads(pre, batch, draws, dtype: torch.dtype) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """One pretrain step's (loss, nt-xent, hard-pair) and gradient, without the update."""
    pre.net.zero_grad(set_to_none=True)
    return backward(pre, *pre.loss(batch, 0, draws=draws, compute_dtype=dtype))


def spec_step(pre, specs, pair_mask: torch.Tensor, dtype: torch.dtype) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """``step_grads`` from the two views' spectrograms on: the embedding, the losses, the gradient."""
    from heybuddy_tpu_torch.training.embedding_pretrain import contrastive_loss

    pre.net.zero_grad(set_to_none=True)
    starts = embedding_window_starts(CLIP)
    z1, z2 = (pre.net.apply_spectrogram(sp, starts, compute_dtype=dtype).mean(dim=1) for sp in specs)
    return backward(pre, *contrastive_loss(z1, z2, pair_mask, pre.temperature, pre.hard_pair_margin,
                                           pre.hard_pair_weight))


def backward(pre, loss: torch.Tensor, base: torch.Tensor, hard: torch.Tensor
             ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The losses and the gradient of ``loss`` in ``pre.net``'s parameters, in float64 on the host."""
    loss.backward()
    grads = {k: p.grad.detach().double().cpu().numpy() for k, p in pre.net.named_parameters()}
    return torch.stack([loss, base, hard]).detach().double().cpu().numpy(), grads


def rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """|got - ref| / |ref| of the total loss."""
    return float(abs(got[0] - ref[0]) / abs(ref[0]))


def grad_gap(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """max |got - ref| over every parameter, as a fraction of ref's norm."""
    norm = np.sqrt(sum(float(np.sum(v ** 2)) for v in ref.values()))
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / norm


def pretrain_phase(dev: torch.device, tmp: str) -> Dict:
    """(a) one pretrain step card vs CPU (and TF32 on, which must fail); (b)
    ``pretrain-embedding`` through the CLI entry, its stage times and 20
    profiled steps; (c) its npz in a fresh featurizer (space id, K1 -> K2 vs
    plain); (d) the browser bundle exported from it (and from the bundled npz,
    bytes against browser/models) run by the numpy runner; (e) the neural G2P
    trained and run on the card."""
    from heybuddy_tpu_torch.export.onnx_export import export_embedding_net, export_mel_spectrogram
    from heybuddy_tpu_torch.models import embedding_net
    from heybuddy_tpu_torch.text.neural_g2p import NeuralG2P, NeuralPhonemizer, encode_word, train_neural_g2p
    from heybuddy_tpu_torch.text.phonemizer import SimplePhonemizer
    from heybuddy_tpu_torch.text.wordlist import WORDS
    from heybuddy_tpu_torch.training.embedding_pretrain import DRAW_NAMESPACE, EmbeddingPretrainer, pretrain_views

    cpu = torch.device("cpu")
    bundled = embedding_net.bundled_weights_path()
    summary: Dict = {}
    launches: Dict[str, Dict[str, int]] = {}
    # ---- (a) one step, card vs CPU ------------------------------------------------------
    kwargs = dict(num_texts=PRETRAIN_CHECK_TEXTS, speakers_per_text=PRETRAIN_CHECK_SPEAKERS,
                  adversarial_fraction=0.25, focus_phrase=PRETRAIN_PHRASE, tts_backend="formant-device",
                  init_weights=bundled)
    card = EmbeddingPretrainer(device=dev, **kwargs)
    card.build_clip_pool()
    host = EmbeddingPretrainer(device=cpu, **kwargs)
    host._pool, host._pool_lengths = card._pool, card._pool_lengths
    res = card.resident()
    batch = card.sample_step(card._cluster_members(), res["pool"].shape[0], res["pool"].shape[1])
    check(bool(batch.pair_mask.any()), "(a)'s batch holds no phonetic-neighbour pair")
    cfg = card.augment_config
    draws_cpu = tuple(draw_augment(seeded_generator(cpu, card.seed, DRAW_NAMESPACE, 0, v), card.batch_size, CLIP,
                                   cfg, cpu) for v in range(2))
    draws_dev = tuple({k: t.to(dev) for k, t in d.items()} for d in draws_cpu)
    # (a1) the views
    views_card = [v.cpu() for v in pretrain_views(card.resident(), card.upload(batch), cfg, draws=draws_dev)]
    views_host = pretrain_views(host.resident(), host.upload(batch), cfg, draws=draws_cpu)
    view_err = max(float((a - b).abs().max()) for a, b in zip(views_card, views_host))
    zero_flips = sum(int(((a == 0) != (b == 0)).sum()) for a, b in zip(views_card, views_host))
    mel_jump = max(float((mk.mel_spectrogram_plain(a * 32767.0) - mk.mel_spectrogram_plain(b * 32767.0)).abs().max())
                   for a, b in zip(views_card, views_host))
    print(f"pretrain (a1) the two views card vs CPU, same draws: max |d| {view_err:.3e} (limit {AUGMENT_ATOL}); "
          f"{zero_flips} samples exactly 0 on one device only; the plain mel (CPU) of the card's views vs of the "
          f"CPU's: max |d| {mel_jump:.3e}")
    check(view_err <= AUGMENT_ATOL, "the pretrain views disagree")
    # (a2) K3 on the card's views against the plain mel in float32 and float64
    k3_err, k3_bf16_err, k3_limit = 0.0, 0.0, 0.0
    for view in views_card:
        audio = view.to(dev) * 32767.0
        k3 = mk.mel_spectrogram(audio)
        ref64 = mk._logmel_taps(audio, k3.shape[1], torch.float32, torch.float64)
        spread = float((mk.mel_spectrogram_plain(audio) - ref64).abs().max())
        err = float((k3 - ref64).abs().max())
        err16 = float((mk.mel_spectrogram(audio, dft_dtype=torch.bfloat16) - ref64).abs().max())
        k3_err, k3_bf16_err = max(k3_err, err), max(k3_bf16_err, err16)
        k3_limit = max(k3_limit, MEL_ATOL, K3_SPLIT_SPREAD * spread)
        print(f"pretrain (a2) K3 on a view: vs the float64 mel max |d| {err:.3e}, mean "
              f"{float((k3 - ref64).abs().mean()):.3e}; the plain float32 mel vs float64 {spread:.3e}; K3's "
              f"bf16-DFT entry {err16:.3e}")
    print(f"pretrain (a2) K3 on the views: {k3_err:.3e} (limit {k3_limit:.3e}); its bf16-DFT entry {k3_bf16_err:.3e} "
          f"(must exceed it)")
    check(k3_err <= k3_limit, f"K3 on the pretrain views: {k3_err:.3e} from the float64 mel (limit {k3_limit:.3e})")
    check(k3_bf16_err > k3_limit, "the K3 limit on the pretrain views passes the bf16 DFT")
    # (a3) the step from K3 on: the CPU's plain mel of the CPU's views on both devices
    specs_host = [mk.mel_spectrogram_plain(v * 32767.0) for v in views_host]
    specs_card = [sp.to(dev) for sp in specs_host]
    mask = torch.from_numpy(batch.pair_mask)
    step_report: Dict = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        ref_loss, ref_grads = spec_step(host, specs_host, mask, dtype)
        got_loss, got_grads = spec_step(card, specs_card, mask.to(dev), dtype)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_loss, tf32_grads = spec_step(card, specs_card, mask.to(dev), dtype)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        gaps = {"loss": rel_gap(got_loss, ref_loss), "grad": grad_gap(got_grads, ref_grads),
                "tf32_loss": rel_gap(tf32_loss, ref_loss), "tf32_grad": grad_gap(tf32_grads, ref_grads)}
        # (a4) the whole step (views, K3, the rest) on each device, and the CPU's step on the card's views
        (whole_loss, whole_grads), counts = run_path(
            f"pretrain step {name}", lambda: step_grads(card, batch, draws_dev, dtype), ("mel_spectrogram",))
        cpu_loss, cpu_grads = step_grads(host, batch, draws_cpu, dtype)
        cv_loss, cv_grads = spec_step(host, [mk.mel_spectrogram_plain(v * 32767.0) for v in views_card], mask, dtype)
        gaps.update({"whole_loss": rel_gap(whole_loss, cpu_loss), "whole_grad": grad_gap(whole_grads, cpu_grads),
                     "views_loss": rel_gap(cv_loss, cpu_loss), "views_grad": grad_gap(cv_grads, cpu_grads)})
        step_report[name] = {"loss_cpu": cpu_loss.tolist(), "loss_card": whole_loss.tolist(), **gaps,
                             "launches": counts}
        print(f"pretrain (a3) one step {name} at batch {card.batch_size} from the same spectrograms, card vs CPU: "
              f"loss relative {gaps['loss']:.3e} (limit {PRETRAIN_LOSS_RTOL[dtype]:.0e}, TF32 on "
              f"{gaps['tf32_loss']:.3e}); gradient max |d| / norm {gaps['grad']:.3e} (limit "
              f"{PRETRAIN_GRAD_TOL[dtype]:.0e}, TF32 on {gaps['tf32_grad']:.3e})")
        print(f"pretrain (a4) the whole step {name} card vs CPU (their own views and mels): loss {whole_loss.tolist()} "
              f"vs {cpu_loss.tolist()}, relative {gaps['whole_loss']:.3e}, gradient {gaps['whole_grad']:.3e}; the "
              f"CPU's step on the card's views instead of its own: {gaps['views_loss']:.3e} / {gaps['views_grad']:.3e}; "
              f"launches {counts}")
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        gaps = step_report[name]
        check(gaps["loss"] <= PRETRAIN_LOSS_RTOL[dtype] and gaps["grad"] <= PRETRAIN_GRAD_TOL[dtype],
              f"pretrain step {name}: the card disagrees with the CPU")
        if dtype == torch.float32:  # in bf16 TF32 is not separable (the limits' comment)
            check(gaps["tf32_loss"] > PRETRAIN_LOSS_RTOL[dtype] or gaps["tf32_grad"] > PRETRAIN_GRAD_TOL[dtype],
                  f"pretrain step {name}: the limits pass a step with TF32 on")
        check(gaps["launches"] == {"mel_spectrogram": 2}, "a pretrain step launched K3 other than twice")
        check(bool(np.isfinite(gaps["loss_card"]).all()), "the whole step's loss is not finite")
    summary["step"] = {"views_max_abs_err": view_err, "zero_flips": zero_flips, "mel_jump": mel_jump,
                       "k3_vs_f64": k3_err,
                       "k3_bf16_vs_f64": k3_bf16_err, "k3_limit": k3_limit, **step_report}
    del host

    # ---- (b) pretrain-embedding through the CLI entry ---------------------------------------
    npz = os.path.join(tmp, "embedding-pretrained.npz")
    profiling.GLOBAL_STAGE_TIMES = profiling.StageTimes()
    log = PretrainLog()
    logger.addHandler(log)
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, launches["pretrain"] = run_path(
                "pretrain", lambda: cli_main(["pretrain-embedding", "-o", npz, "--tts-backend", "formant-device",
                                              "--adversarial-fraction", "0.25", "--focus-phrase", PRETRAIN_PHRASE,
                                              "--steps", str(PRETRAIN_STEPS)]),
                ("mel_spectrogram",))
        cli_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    times = profiling.GLOBAL_STAGE_TIMES
    check(rc == 0 and out.getvalue().strip() == f"Wrote {npz}; set HEYBUDDY_EMBEDDING_WEIGHTS={npz} to use it.",
          f"pretrain-embedding: rc {rc}, {out.getvalue()!r}")
    check(launches["pretrain"]["mel_spectrogram"] == 2 * PRETRAIN_STEPS, f"K3 launches {launches['pretrain']}")
    rows = log.rows
    check(len(rows) >= 6 and rows[0][0] == 0 and rows[-1][0] == PRETRAIN_STEPS - 1, f"logged rows {rows}")
    first, last = float(np.mean([r[1] for r in rows[:3]])), float(np.mean([r[1] for r in rows[-3:]]))
    n_clips = log.clips
    summary["cli"] = {
        "wall_s": cli_s, "logged": rows, "first3": first, "last3": last,
        "pool_s": times.total["pretrain/clip_pool"], "pool_clips_per_s": n_clips / times.total["pretrain/clip_pool"],
        "steps_s": times.total["pretrain/steps"], "steps_per_s": PRETRAIN_STEPS / times.total["pretrain/steps"],
        "stages": {k: {"total_s": times.total[k], "count": times.count[k]} for k in times.total},
    }
    print(f"pretrain (b) pretrain-embedding --steps {PRETRAIN_STEPS} (cli): {cli_s:.1f} s, launches "
          f"{launches['pretrain']}; clip pool {n_clips} clips in {times.total['pretrain/clip_pool']:.2f} s "
          f"({summary['cli']['pool_clips_per_s']:.1f} clips/s); {PRETRAIN_STEPS} steps in "
          f"{times.total['pretrain/steps']:.2f} s ({summary['cli']['steps_per_s']:.2f} steps/s); logged "
          f"(step, loss, nt-xent, hard-pair) {rows}; mean loss of the first 3 logged {first:.4f}, last 3 {last:.4f}")
    print("  stage times:\n    " + times.summary().replace("\n", "\n    "))
    check(rows[0][3] > 0.0, "the hard-pair term is 0 at step 0")
    check(last < first, "the pretrain loss did not fall")
    # 20 steps of (a)'s pretrainer under the profiler: the busy share of the step
    card.train(steps=2, log_every=2)  # warm
    busy = device_busy(lambda: card.train(steps=PRETRAIN_PROFILE_STEPS, log_every=PRETRAIN_PROFILE_STEPS))
    summary["profile"] = {**busy, "steps": PRETRAIN_PROFILE_STEPS,
                          "steps_per_s": PRETRAIN_PROFILE_STEPS / busy["wall_ms"] * 1e3,
                          "busy_share": None if busy["busy_ms"] is None else busy["busy_ms"] / busy["wall_ms"]}
    print(f"pretrain {PRETRAIN_PROFILE_STEPS} profiled steps: wall {busy['wall_ms']:.1f} ms "
          f"({summary['profile']['steps_per_s']:.2f} steps/s), kernels {busy['kernels']}, device busy "
          f"{busy['busy_ms']} ms = {summary['profile']['busy_share']}")
    del card, res

    # ---- (c) the new npz in the featurizer ---------------------------------------------------
    params = embedding_net.load_params(npz)
    space = embedding_net.embedding_space_id(params)
    os.environ["HEYBUDDY_EMBEDDING_WEIGHTS"] = npz
    try:
        fresh = SpeechEmbeddings(device=dev)
        check(fresh.space_id == space != embedding_net.embedding_space_id(embedding_net.load_params(bundled)),
              f"the featurizer's space {fresh.space_id} is not the npz's {space}")
        rng = np.random.default_rng(SEED + 8)
        clips = np.clip(rng.normal(0.0, 0.05, (BATCH, CLIP)), -1.0, 1.0).astype(np.float32)
        audio = torch.from_numpy(clips * 32767.0).to(dev)
        feats, launches["pretrain_features"] = run_path(
            "pretrain_features", lambda: fresh(clips), ("mel_patches", "embedding_pool"))
        patches, n = mk.mel_patches(audio)
        k2_err, k2_limit = check_k2(fresh.net, patches, n, CLIP)
        check_path("the new npz's fused features vs the plain path", torch.from_numpy(feats).to(dev),
                   fk.fused_featurize_plain(fresh.net, audio, embedding_window_starts(CLIP)), k2_limit)
    finally:
        del os.environ["HEYBUDDY_EMBEDDING_WEIGHTS"]
    summary["features"] = {"space_id": space, "k2_max_abs_err": k2_err, "k2_limit": k2_limit}
    print(f"pretrain (c) the new npz (space {space}) in a fresh SpeechEmbeddings: {BATCH} clips, launches "
          f"{launches['pretrain_features']}, K2 vs plain {k2_err:.3e} (limit {k2_limit:.3e})")

    # ---- (d) the browser bundle ---------------------------------------------------------------
    bundle = {}
    for label, tree in (("bundled", None), ("pretrained", params)):
        mel_path, emb_path = os.path.join(tmp, f"{label}-mel.onnx"), os.path.join(tmp, f"{label}-emb.onnx")
        export_mel_spectrogram(mel_path)
        export_embedding_net(emb_path, params=tree if tree is not None else embedding_net.load_params(bundled))
        bundle[label] = (mel_path, emb_path)
    for path, shipped in zip(bundle["bundled"], ("mel-spectrogram.onnx", "speech-embedding.onnx")):
        with open(path, "rb") as a, open(os.path.join(ROOT, "browser", "models", shipped), "rb") as b:
            check(a.read() == b.read(), f"{shipped} exported from the bundled npz differs from browser/models")
    audio = np.random.default_rng(SEED + 9).normal(0, 1000.0, (1, 17280)).astype(np.float32)
    spec = OnnxRunner.from_file(bundle["pretrained"][0])(input=audio)["output"][0]
    n_win = (spec.shape[0] - 76) // 8 + 1
    windows = np.stack([spec[i * 8: i * 8 + 76] for i in range(n_win)]).astype(np.float32)
    browser = OnnxRunner.from_file(bundle["pretrained"][1])(input=windows)["output"]
    native = SpeechEmbeddings(params=params, device=dev, compute_dtype=torch.float32)(audio / 32767.0)
    browser_err = float(np.abs(browser[None] - native).max())
    summary["browser"] = {"max_abs_err": browser_err, "windows": n_win}
    print(f"pretrain (d) browser bundle from the new npz: numpy runner (mel -> {n_win} windows -> embedding) vs "
          f"the card's float32 featurizer max |d| {browser_err:.3e} (limit {BROWSER_ATOL}); the bundled npz's "
          f"export equals browser/models byte for byte")
    check(browser.shape == (n_win, 96) and browser_err <= BROWSER_ATOL, "the browser bundle disagrees with the card")

    # ---- (e) the neural G2P on the card ---------------------------------------------------------
    rule = SimplePhonemizer(use_cmudict=False)
    table = {w: re.findall(r"\[([A-Z]+)\]", rule(w)) for w in sorted(set(WORDS))}
    log = PretrainLog()
    logger.addHandler(log)
    try:
        t0 = time.perf_counter()
        model, g2p_params = train_neural_g2p(table, steps=G2P_STEPS, lr=G2P_LR, log_every=G2P_STEPS // 3, device=dev)
        torch.cuda.synchronize()
        g2p_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    losses = log.g2p
    words = sorted(table)
    chars = np.stack([encode_word(w, model.max_word) for w in words])
    with torch.no_grad():
        card_logits = model.apply_torch(g2p_params, chars).double().cpu().numpy()
    fwd_err = float(np.abs(card_logits - model.apply_np(g2p_params, chars)).max())
    bundled_model, bundled_params = NeuralG2P.load(os.path.join(ROOT, "heybuddy_tpu", "assets", "g2p-neural.npz"))
    card_words = bundled_model.to(dev).decode(bundled_params, list(G2P_WORDS))
    phonemizer = NeuralPhonemizer()
    host_words = [phonemizer.word_phones(w) for w in G2P_WORDS]
    summary["g2p"] = {"table_words": len(table), "steps": G2P_STEPS, "seconds": g2p_s, "losses": losses,
                      "forward_max_abs_err": fwd_err}
    print(f"pretrain (e) neural G2P: {len(table)} words, {G2P_STEPS} steps on the card in {g2p_s:.2f} s, logged "
          f"losses {losses}; torch forward on the card vs apply_np max |d| {fwd_err:.3e} (limit "
          f"{G2P_FORWARD_ATOL}); the bundled checkpoint on the card phonemizes {len(G2P_WORDS)} words as the "
          f"numpy NeuralPhonemizer: {card_words == host_words}")
    check(len(losses) >= 2 and losses[-1][1] < losses[0][1], f"the G2P loss did not fall: {losses}")
    check(fwd_err <= G2P_FORWARD_ATOL, "the G2P torch forward on the card disagrees with apply_np")
    check(card_words == host_words, f"the G2P on the card decodes {card_words} where the host gives {host_words}")
    return {"summary": summary, "launches": launches}


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for matmuls and cuDNN inside the block (off outside it, as device.py sets it)."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


# The onnx phase: the bundled browser graphs through the port's ONNX importer.
# The embedding graph as SpeechEmbeddings' "onnx" backend (K3, then the graph
# on every window) on the BATCH clips, held to the card's float32 trunk-pool
# features at JAX's browser bound; the graph on the card against the same
# graph on the CPU on ONNX_CPU_CLIPS clips' windows, and both against the
# graph's float64 run on the CPU; the mel graph against K3
# and the plain float32 mel; a Silero-v4-layout graph through SileroOnnxVAD,
# card against CPU over SILERO_ONNX_CHUNKS chunks with the state carried.
SPEECH_EMBEDDING_ONNX = os.path.join(ROOT, "browser", "models", "speech-embedding.onnx")
MEL_SPECTROGRAM_ONNX = os.path.join(ROOT, "browser", "models", "mel-spectrogram.onnx")
ONNX_FEATURE_ATOL = BROWSER_ATOL
# one float32 graph, the card's kernels against the CPU's. The embedding
# graph's outputs reach ~5 and its float32 run on the CPU lies ~2e-5 from its
# float64 run (3.8e-6 of the largest output on 256 clips of this noise), so
# the limit is relative to the largest output: card against CPU, and each
# against float64; the card with TF32 on must fail it. The VAD's probability
# and state are held absolutely.
ONNX_GRAPH_RTOL = 1e-5
ONNX_DEVICE_ATOL = 1e-5
ONNX_CPU_CLIPS = 256
SILERO_ONNX_CHUNKS = 20


def onnx_phase(net, dev: torch.device, clips: np.ndarray, audio: torch.Tensor, tmp: str) -> Dict:
    cpu = torch.device("cpu")
    summary: Dict = {}
    emb = SpeechEmbeddings(onnx_path=SPEECH_EMBEDDING_ONNX, device=dev)
    feats, launches = run_path("onnx", lambda: emb(clips), ("mel_spectrogram",))
    check(launches == {"mel_spectrogram": 1}, f"onnx: launched {launches}, expected K3 once a featurize call")
    check(feats.shape == (BATCH, 16, 96) and bool(np.isfinite(feats).all()), f"onnx features {feats.shape}")
    native = featurize_batch(net, audio, compute_dtype=torch.float32).cpu().numpy()
    feat_err = float(np.abs(feats - native).max())
    print(f"path onnx (SpeechEmbeddings(onnx_path=speech-embedding.onnx), {BATCH} x {CLIP}): launches {launches}; "
          f"vs the card's float32 trunk-pool features max |d| {feat_err:.3e} (limit {ONNX_FEATURE_ATOL}); space "
          f"{emb.space_id} (trunkpool {get_speech_embeddings(device=dev).space_id})")
    check(feat_err <= ONNX_FEATURE_ATOL, "the ONNX embedding disagrees with the float32 trunk-pool features")

    sub = audio[:ONNX_CPU_CLIPS]
    spec = mk.mel_spectrogram(sub)
    starts = np.asarray(embedding_window_starts(CLIP))
    idx = torch.as_tensor(starts[:, None] + np.arange(76)[None, :], device=dev)
    windows = spec[:, idx].reshape(-1, 76, 32)
    graph64 = OnnxTorchFunction.from_file(SPEECH_EMBEDDING_ONNX, cpu)
    with torch.no_grad():
        card = emb.onnx_net.apply(windows).cpu()
        with tf32(True):
            card32 = emb.onnx_net.apply(windows).cpu()
        host = load_from_onnx(SPEECH_EMBEDDING_ONNX, cpu).apply(windows.cpu())
        exact = graph64({k: v.double() for k, v in graph64.params.items()}, windows.cpu().double())
    scale = float(exact.abs().max())

    def gap(got: torch.Tensor, ref: torch.Tensor) -> float:
        return float((got.double() - ref.double()).abs().max()) / scale

    graph_err, graph_err32 = gap(card, host), gap(card32, host)
    card64, host64 = gap(card, exact), gap(host, exact)
    print(f"onnx: the embedding graph on {windows.shape[0]} windows, max |d| over the largest output {scale:.4f}: "
          f"card vs CPU {graph_err:.3e} ({graph_err * scale:.3e} absolute), TF32 on {graph_err32:.3e}; against the "
          f"CPU's float64 run: card {card64:.3e} ({card64 * scale:.3e}), CPU {host64:.3e} ({host64 * scale:.3e}) "
          f"(limit {ONNX_GRAPH_RTOL} of the largest output)")
    check(max(graph_err, card64, host64) <= ONNX_GRAPH_RTOL,
          "the imported embedding graph disagrees between card, CPU and float64")
    check(graph_err32 > ONNX_GRAPH_RTOL, "TF32 on passes the embedding graph's card-vs-CPU limit")

    x = audio[:1, :17280].contiguous()
    mel_fn = OnnxTorchFunction.from_file(MEL_SPECTROGRAM_ONNX, dev)
    with torch.no_grad():
        mel = mel_fn(mel_fn.params, x)
    k3, plain = mk.mel_spectrogram(x), mk.mel_spectrogram_plain(x)
    check(tuple(mel.shape) == (1, 105, 32) == tuple(k3.shape), f"mel graph {tuple(mel.shape)}, K3 {tuple(k3.shape)}")
    mel_k3, mel_plain = check_mel("mel-spectrogram.onnx vs K3", mel, k3), check_mel(
        "mel-spectrogram.onnx vs the plain mel", mel, plain)
    print(f"onnx: mel-spectrogram.onnx on the card (1, 17280) vs K3 max |d| {mel_k3:.3e}, vs the plain float32 "
          f"mel {mel_plain:.3e} (limit {MEL_ATOL} + {MEL_RTOL} |ref|)")

    path, _ = silero_v4_graph(os.path.join(tmp, "silero-v4.onnx"), seed=SEED % 1000)
    card_vad, host_vad = SileroOnnxVAD(path, device=dev), SileroOnnxVAD(path, device=cpu)
    signal = tonal_audio(np.random.default_rng(SEED + 11), 1, 512 * SILERO_ONNX_CHUNKS)[0] / 32767.0
    gaps, chunk_ms = [], []
    for i in range(SILERO_ONNX_CHUNKS):
        chunk = signal[512 * i: 512 * (i + 1)]
        t0 = time.perf_counter()
        p = card_vad(chunk)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        gaps.append(max([abs(p - host_vad(chunk))] + [float((a.cpu() - b).abs().max())
                                                    for a, b in zip(card_vad._state, host_vad._state)]))
    vad_err = max(gaps)
    print(f"onnx: SileroOnnxVAD (a v4-layout graph with its If, written by the port's writer) card vs CPU over "
          f"{SILERO_ONNX_CHUNKS} chunks of 512, state carried: probability and state max |d| {vad_err:.3e} "
          f"(limit {ONNX_DEVICE_ATOL}); per chunk (host clock) median {np.median(chunk_ms):.3f} ms")
    check(vad_err <= ONNX_DEVICE_ATOL, "SileroOnnxVAD disagrees between card and CPU")

    onnx_ms = cuda_ms(lambda: featurize_batch_per_window(emb.onnx_net.apply, audio))
    fused_ms = cuda_ms(lambda: featurize_batch(net, audio))
    n_windows = BATCH * len(starts)
    print(f"onnx vs fused in one call, {BATCH} x {CLIP} (CUDA events, median of 11): onnx {onnx_ms:.4f} ms = "
          f"{BATCH / onnx_ms * 1e3:.0f} clips/s, {n_windows / onnx_ms * 1e3:.0f} windows/s; fused {fused_ms:.4f} ms = "
          f"{BATCH / fused_ms * 1e3:.0f} clips/s, {n_windows / fused_ms * 1e3:.0f} windows/s")
    summary.update(feature_err=feat_err, graph_rel_err=graph_err, graph_rel_err_tf32=graph_err32,
                   graph_rel_err_card_f64=card64, graph_rel_err_cpu_f64=host64, mel_vs_k3=mel_k3,
                   mel_vs_plain=mel_plain, silero_err=vad_err, silero_chunk_ms=float(np.median(chunk_ms)), onnx_ms=onnx_ms,
                   fused_ms=fused_ms, onnx_clips_per_s=BATCH / onnx_ms * 1e3,
                   fused_clips_per_s=BATCH / fused_ms * 1e3)
    return {"summary": summary, "launches": launches}


# The vits phase: the VITS TTS at the full piper-libritts-en-r-medium width
# (VitsConfig()) from seeded weights, the flows' zero-initialised layers made
# non-zero as the tests make them, written as a Piper .pt. (b) infer card vs
# CPU on the same weights and draws; the audio's limit lies between the sound
# run and the same run with TF32 on, which must fail it. (c) infer
# throughput. (d) train from an empty directory on the vits route, small
# counts. (e) one training_forward step at full width (posterior 513 -> 16 WN
# layers), card vs CPU: the alignment equal, the loss 1e-5 relative, the
# gradient's norm gap between the sound step and TF32 on; then
# VITS_TRAIN_STEPS Adam steps timed and profiled. (f) the tiny voice.
VITS_TEXTS = ("hey buddy", "what time is it", "turn on the lights", "good morning to you",
              "play some music please", "set a timer for ten minutes", "hello there", "stop the alarm")
VITS_INFER_BATCH = 4
VITS_THROUGHPUT_BATCH = 64
# limits between the sound run and the same run with TF32 on (PERF.md, section 2):
# infer's audio (seeded weights; the run prints its peak), the step's loss relative
# to it, the step's gradient as the norm of the gap over the gradient's norm
VITS_AUDIO_ATOL = 1e-6
VITS_LOSS_RTOL = 1e-5
VITS_GRAD_RTOL = 1e-4
VITS_STEP_FRAMES = (120, 100, 90, 110)
VITS_TRAIN_STEPS = 20
VITS_GEN_ROWS = {"hey-buddy": 128, "hey-buddy-adversarial": 128, "hey-buddy-testing-validation": 32}
VITS_GEN_STEPS = 100


def vits_infer(model, ids, lengths, spk, max_frames, noise_dur, noise_prior):
    dev = next(model.parameters()).device
    with torch.no_grad():
        audio, n = model.infer(torch.from_numpy(ids).long().to(dev), torch.from_numpy(lengths).to(dev),
                               torch.from_numpy(spk).to(dev), max_frames=max_frames, noise_dur=noise_dur.to(dev),
                               noise_prior=noise_prior.to(dev))
    return audio.cpu(), n.cpu()


def vits_step(model, posterior, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
    """One training_forward + backward (the tiny voice's loss without its reconstruction term):
    (loss, alignment, the gradients as one vector), all on the CPU."""
    dev = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    posterior.zero_grad(set_to_none=True)
    b = {k: v.to(dev) for k, v in batch.items()}
    out = training_forward(model, posterior, b["ids"], b["id_len"], b["spec"], b["spec_len"],
                           model.emb_g.weight[b["speakers"]], segment_size=32,
                           draws={k: v.to(dev) for k, v in draws.items()})
    loss = out["kl_loss"] + out["duration_loss"] + out["audio_segment"].square().mean()
    loss.backward()
    grads = torch.cat([p.grad.reshape(-1) for m in (model, posterior) for p in m.parameters() if p.grad is not None])
    return float(loss), out["attn"].cpu(), grads.cpu()


def vits_phase(dev: torch.device, tmp: str) -> Dict:
    cpu = torch.device("cpu")
    cfg = VitsConfig()
    summary: Dict = {}
    # ---- (a) a seeded full-width voice as a Piper .pt, through the importer -------------------
    gen = torch.Generator().manual_seed(SEED)
    tree = perturbed_vits(vits_init_params(gen, cfg), SEED % 1000)  # every flow non-trivial
    model = Vits.from_jax_params(tree, cfg, device=dev).eval()
    ckpt = os.path.join(tmp, "vits-seeded.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    loaded = import_torch_checkpoint(ckpt, cfg, dev)
    same = all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), model.state_dict().values()))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vits (a): VitsConfig() seeded, {n_params} parameters, {os.path.getsize(ckpt)} bytes as a Piper .pt; "
          f"import_torch_checkpoint equals the module bit for bit: {same}")
    check(same and list(loaded.state_dict()) == list(model.state_dict()), "the imported checkpoint differs")

    # ---- (b) infer card vs CPU, the same weights and draws -------------------------------------
    tts = VitsTTS(checkpoint_path=ckpt, device=dev)
    host = import_torch_checkpoint(ckpt, cfg, cpu).eval()
    texts = list(VITS_TEXTS[:VITS_INFER_BATCH])
    speakers = [(i, i + 1) for i in range(VITS_INFER_BATCH)]
    ids, lengths, spk, max_frames = tts.batch_inputs(texts, speakers, 0.5, 1.0)
    draw = torch.Generator().manual_seed(SEED + 3)
    noise_dur = torch.randn((VITS_INFER_BATCH, 2, ids.shape[1]), generator=draw)
    noise_prior = torch.randn((VITS_INFER_BATCH, cfg.inter_channels, max_frames), generator=draw)
    want, want_n = vits_infer(host, ids, lengths, spk, max_frames, noise_dur, noise_prior)
    got, got_n = vits_infer(tts.model, ids, lengths, spk, max_frames, noise_dur, noise_prior)
    with tf32(True):
        got32, got32_n = vits_infer(tts.model, ids, lengths, spk, max_frames, noise_dur, noise_prior)
    err, err32 = float((got - want).abs().max()), float((got32 - want).abs().max())
    print(f"vits (b) infer, batch {VITS_INFER_BATCH}, t_x {ids.shape[1]}, max_frames {max_frames}: lengths card "
          f"{got_n.tolist()} CPU {want_n.tolist()} (TF32 on: {got32_n.tolist()}); audio max |d| card vs CPU "
          f"{err:.3e}, TF32 on {err32:.3e} (limit {VITS_AUDIO_ATOL}; the peak {float(want.abs().max()):.3f})")
    check(torch.equal(got_n, want_n), f"infer lengths differ between card and CPU (a ceil(w) flip): "
          f"{got_n.tolist()} vs {want_n.tolist()}")
    check(err <= VITS_AUDIO_ATOL, "infer audio disagrees between card and CPU")
    check(err32 > VITS_AUDIO_ATOL or not torch.equal(got32_n, want_n), "TF32 on passes the infer limit")
    summary["infer"] = {"max_abs_err": err, "tf32_max_abs_err": err32, "lengths": got_n.tolist()}

    # ---- (c) infer throughput at batch VITS_THROUGHPUT_BATCH ---------------------------------
    n = VITS_THROUGHPUT_BATCH
    texts = [VITS_TEXTS[i % len(VITS_TEXTS)] for i in range(n)]
    ids, lengths, spk, max_frames = tts.batch_inputs(texts, [(i % 904, (i + 7) % 904) for i in range(n)], 0.5, 1.0)
    args = [torch.from_numpy(a).to(dev) for a in (ids.astype(np.int64), lengths, spk)]
    infer_gen = torch.Generator(device=dev).manual_seed(SEED)

    def infer_batch():
        with torch.no_grad():
            return tts.model.infer(*args, max_frames=max_frames, generator=infer_gen)

    infer_ms = cuda_ms(infer_batch)
    audio_s = n * max_frames * cfg.hop_samples / cfg.sample_rate
    print(f"vits (c) infer throughput, batch {n}, t_x {ids.shape[1]}, max_frames {max_frames} ({audio_s:.1f} s of "
          f"22.05 kHz audio a call): {infer_ms:.3f} ms (CUDA events, median of 11) = {n / infer_ms * 1e3:.1f} clips/s")
    summary["throughput"] = {"batch": n, "ms": infer_ms, "clips_per_s": n / infer_ms * 1e3, "max_frames": max_frames}

    # ---- (d) train from an empty directory on the vits route ----------------------------------
    saved = os.environ.get("HEYBUDDY_TTS_CHECKPOINT")
    os.environ["HEYBUDDY_TTS_CHECKPOINT"] = ckpt
    try:
        route = generate_route("vits", "vits", VITS_GEN_ROWS, VITS_GEN_STEPS, dev, tmp)
    finally:
        if saved is None:
            os.environ.pop("HEYBUDDY_TTS_CHECKPOINT", None)
        else:
            os.environ["HEYBUDDY_TTS_CHECKPOINT"] = saved
    summary["generate"] = route["summary"]

    # ---- (e) one training step at full width, card vs CPU, then Adam steps -------------------
    post_tree = posterior_encoder_init(gen, in_channels=513, out_channels=cfg.inter_channels,
                                       hidden_channels=cfg.hidden_channels, n_layers=16,
                                       gin_channels=cfg.gin_channels)
    sdp_post = sdp_posterior_init(gen, cfg.hidden_channels)
    modules = {d: (Vits.from_jax_params(tree, cfg, sdp_posterior=sdp_post, device=d),
                   PosteriorEncoder.from_jax_params(post_tree, device=d)) for d in (dev, cpu)}
    rng = np.random.default_rng(SEED + 5)
    b = len(VITS_STEP_FRAMES)
    ids, lengths, _, _ = tts.batch_inputs(list(VITS_TEXTS[:b]), [(0, 1)] * b, 0.5, 1.0)
    t_y = max(VITS_STEP_FRAMES)
    batch = {"ids": torch.from_numpy(ids.astype(np.int64)), "id_len": torch.from_numpy(lengths.astype(np.int64)),
             "spec": torch.from_numpy(rng.normal(0, 1, (b, 513, t_y)).astype(np.float32)),
             "spec_len": torch.tensor(VITS_STEP_FRAMES), "speakers": torch.arange(b)}
    draw = torch.Generator().manual_seed(SEED + 6)
    draws = {"post": torch.randn((b, cfg.inter_channels, t_y), generator=draw),
             "slice": torch.rand((b,), generator=draw), "dur": torch.randn((b, 2, ids.shape[1]), generator=draw)}
    loss_cpu, attn_cpu, grad_cpu = vits_step(*modules[cpu], batch, draws)
    loss_card, attn_card, grad_card = vits_step(*modules[dev], batch, draws)
    with tf32(True):
        loss32, attn32, grad32 = vits_step(*modules[dev], batch, draws)
    norm = float(grad_cpu.norm())
    loss_gap, loss_gap32 = abs(loss_card - loss_cpu) / abs(loss_cpu), abs(loss32 - loss_cpu) / abs(loss_cpu)
    grad_gap, grad_gap32 = float((grad_card - grad_cpu).norm()) / norm, float((grad32 - grad_cpu).norm()) / norm
    aligned, aligned32 = torch.equal(attn_card, attn_cpu), torch.equal(attn32, attn_cpu)
    print(f"vits (e) training_forward at full width (batch {b}, t_x {ids.shape[1]}, t_y {t_y}, posterior 513 -> 16 "
          f"WN layers), card vs CPU: alignment equal {aligned} (TF32 on: {aligned32}); loss {loss_cpu:.6f}, "
          f"relative gap {loss_gap:.3e} (TF32 on {loss_gap32:.3e}; limit {VITS_LOSS_RTOL}); gradient norm gap "
          f"{grad_gap:.3e} of its norm {norm:.4e} (TF32 on {grad_gap32:.3e}; limit {VITS_GRAD_RTOL})")
    check(aligned, "the alignment differs between card and CPU")
    check(loss_gap <= VITS_LOSS_RTOL and grad_gap <= VITS_GRAD_RTOL, "the VITS step disagrees between card and CPU")
    check(not aligned32 or loss_gap32 > VITS_LOSS_RTOL or grad_gap32 > VITS_GRAD_RTOL,
          "TF32 on passes the VITS step's limits")
    model_t, posterior_t = modules[dev]
    optimizer = torch.optim.Adam(list(model_t.parameters()) + list(posterior_t.parameters()), lr=2e-4)
    step_gen = torch.Generator(device=dev).manual_seed(SEED)
    dev_batch = {k: v.to(dev) for k, v in batch.items()}

    def adam_steps(steps: int) -> None:
        for _ in range(steps):
            out = training_forward(model_t, posterior_t, dev_batch["ids"], dev_batch["id_len"], dev_batch["spec"],
                                   dev_batch["spec_len"], model_t.emb_g.weight[dev_batch["speakers"]],
                                   segment_size=32, generator=step_gen)
            loss = out["kl_loss"] + out["duration_loss"] + out["audio_segment"].square().mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()

    adam_steps(2)  # warm-up: cuDNN's algorithm choice, Adam's state
    torch.cuda.synchronize()
    ALIGN_SECONDS[0] = 0.0
    t0 = time.perf_counter()
    adam_steps(VITS_TRAIN_STEPS)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / VITS_TRAIN_STEPS
    align_ms = ALIGN_SECONDS[0] / VITS_TRAIN_STEPS * 1e3
    busy = device_busy(lambda: adam_steps(VITS_TRAIN_STEPS))
    kernels = busy["kernels"] / VITS_TRAIN_STEPS
    share = "not measured" if busy["busy_ms"] is None else f"{busy['busy_ms'] / busy['wall_ms']:.4f}"
    print(f"vits (e) {VITS_TRAIN_STEPS} Adam steps at full width: {1 / step_s:.2f} steps/s (host clock), the host "
          f"alignment (copy off the card, C++ DP, copy back) {align_ms:.3f} ms a step; under torch.profiler "
          f"{kernels:.0f} kernels a step, device busy {share}")
    summary["step"] = {"aligned": aligned, "loss_gap": loss_gap, "grad_gap": grad_gap, "tf32_loss_gap": loss_gap32,
                       "tf32_grad_gap": grad_gap32, "steps_per_s": 1 / step_s, "align_ms": align_ms,
                       "kernels_per_step": kernels, "busy": busy}
    del modules, model_t, posterior_t, optimizer

    # ---- (f) the tiny voice ------------------------------------------------------------------
    t0 = time.perf_counter()
    metrics = train_tiny_voice(device=dev)["metrics"]
    print(f"vits (f) tools/train_tiny_voice, {metrics['steps']} steps on the card in {time.perf_counter() - t0:.1f} "
          f"s: {json.dumps(metrics)}")
    check(metrics["loss_last20"] < metrics["loss_first20"], "the tiny voice's loss did not fall")
    check(metrics["envelope_distance_trained"] < metrics["envelope_distance_init"],
          "the tiny voice's envelope distance did not fall")
    summary["tiny_voice"] = metrics
    return {"summary": summary, "launches": route["launches"]}


MESH_RANKS = 2  # ranks of (b), on gloo, sharing one card
MESH_TIMED_STEPS = 100  # trainer steps timed for steps/s at 1 and at MESH_RANKS ranks
MESH_ALLREDUCE_RUNS = 50  # all_reduce calls of the flat gradient timed
MESH_PRETRAIN_BATCH = 64
MESH_PRETRAIN_TEXTS = 128
MESH_TIMEOUT = 600  # seconds for the ranks of (b)
# a launch per rank: K1 and K2 once per featurize call and extract batch, K3
# twice per pretrain step
MESH_EXPECT = {"featurize": ("mel_patches", "embedding_pool"), "extract": ("mel_patches", "embedding_pool"),
               "pretrain": ("mel_spectrogram",), "train": (), "smoke": ()}


def speech_pool(n_texts: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(texts, 2, CLIP) seeded speech-like clips in [-1, 1] (a gliding tone
    under an envelope, over noise) and their lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(9000, CLIP, (n_texts, 2)).astype(np.int32)
    pool = np.zeros((n_texts, 2, CLIP), np.float32)
    for i in range(n_texts):
        for j in range(2):
            n = lengths[i, j]
            t = np.arange(n) / 16000.0
            env = np.sin(np.pi * np.arange(n) / n) ** 2
            f0 = 100 + 7 * i + 40 * j
            pool[i, j, :n] = 0.5 * env * np.sin(2 * np.pi * f0 * t * (1 + 0.3 * t)) + 0.02 * rng.standard_normal(n)
    return pool, lengths


def mesh_pretrainer(device: torch.device, workdir: str, mesh=None):
    """The pretrainer of the mesh phase: the bundled npz, the pool and the batch of pretrain-pool.npz."""
    from heybuddy_tpu_torch.models import embedding_net
    from heybuddy_tpu_torch.training.embedding_pretrain import EmbeddingPretrainer, PretrainBatch

    data = np.load(os.path.join(workdir, "pretrain-pool.npz"))
    pre = EmbeddingPretrainer(texts=[f"text {i}" for i in range(data["pool"].shape[0])], speakers_per_text=2,
                              batch_size=len(data["text_idx"]), seed=SEED, device=device, mesh=mesh,
                              init_weights=embedding_net.bundled_weights_path())
    pre._pool, pre._pool_lengths = data["pool"], data["lengths"]
    batch = PretrainBatch(*(data[k] for k in ("text_idx", "spk_idx", "noise_idx", "imp_idx", "pair_mask")))
    return pre, batch


def pretrain_f32_step(pre, batch) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """One float32 step's losses and its (reduced, on a mesh) gradient, without the update."""
    losses = pre.backward(batch, 0, compute_dtype=torch.float32)
    grads = {k: p.grad.detach().double().cpu().numpy() for k, p in pre.net.named_parameters()}
    return torch.stack(losses).detach().double().cpu().numpy(), grads


def allreduce_ms(numel: int, mesh, device: torch.device) -> float:
    """ms per ``all_reduce`` of a float32 vector of ``numel`` (the flat gradient), over MESH_ALLREDUCE_RUNS."""
    from heybuddy_tpu_torch.parallel.mesh import all_reduce_sum

    flat = torch.ones(numel, device=device)
    for _ in range(5):
        all_reduce_sum(flat, mesh)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(MESH_ALLREDUCE_RUNS):
        all_reduce_sum(flat, mesh)
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / MESH_ALLREDUCE_RUNS


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed_steps(run: Dict, device: torch.device) -> float:
    """Steps per second of MESH_TIMED_STEPS more steps of a trajectory run's trainer (host clock, synchronised)."""
    sync(device)
    t0 = time.perf_counter()
    run["trainer"].train_epoch(run["iterator"], num_steps=MESH_TIMED_STEPS, validation_steps=10 ** 6,
                               checkpoint_steps=10 ** 6)
    sync(device)
    return MESH_TIMED_STEPS / (time.perf_counter() - t0)


# the collectives the port uses (parallel/mesh.py), and two it does not
MESH_COLLECTIVES_USED = ("all_reduce", "all_gather", "broadcast", "barrier")


def probe_collectives(mesh, device: torch.device) -> Dict[str, str]:
    """Which collectives the group's backend runs on tensors of ``device``:
    "ok" or the error each raises (a measurement, nothing falls back)."""
    import torch.distributed as dist

    def ones() -> torch.Tensor:
        return torch.ones(4, device=device)

    calls = {
        "all_reduce": lambda: dist.all_reduce(ones(), group=mesh.group),
        "all_gather": lambda: dist.all_gather([ones() for _ in range(mesh.size)], ones(), group=mesh.group),
        "broadcast": lambda: dist.broadcast(ones(), 0, group=mesh.group),
        "barrier": lambda: dist.barrier(group=mesh.group),
        "reduce_scatter": lambda: dist.reduce_scatter(ones(), [ones() for _ in range(mesh.size)], group=mesh.group),
        "all_to_all": lambda: dist.all_to_all([ones() for _ in range(mesh.size)], [ones() for _ in range(mesh.size)],
                                              group=mesh.group),
    }
    result = {}
    for name, call in calls.items():
        try:
            call()
            sync(device)
            result[name] = "ok"
        except RuntimeError as exc:
            result[name] = str(exc).splitlines()[0][:100]
    return result


def mesh_rank_main(argv: List[str]) -> int:
    """One rank of the mesh phase's (b): ``chip_smoke.py mesh-rank RANK WORLD WORKDIR DEVICE``.
    Joins the gloo group through a file in WORKDIR, runs each part with the
    launch counters from 0 and writes ``rank<RANK>.npz``."""
    from heybuddy_tpu_torch.parallel import distributed_smoke, dryrun
    from heybuddy_tpu_torch.parallel.mesh import all_reduce_sum, barrier, distributed_init, get_mesh, shard_batch

    rank, world, workdir, device = int(argv[0]), int(argv[1]), argv[2], torch.device(argv[3])
    os.environ["HEYBUDDY_OFFLINE"] = "1"
    distributed_init(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank, backend="gloo", device=device)
    mesh = get_mesh(device=device)
    out: Dict[str, object] = {"collectives": json.dumps(probe_collectives(mesh, device))}
    launches: Dict[str, Dict[str, int]] = {}
    seconds: Dict[str, float] = {}

    def part(name: str, fn: Callable[[], object]) -> object:
        barrier(mesh)
        sync(device)
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: v for k, v in build.LAUNCHES.items() if v}
        return result

    x, y = distributed_smoke.local_batch(rank)
    model, loss, gsum = part("smoke", lambda: distributed_smoke.smoke_step(
        shard_batch(x, mesh, process_local=True), shard_batch(y, mesh, process_local=True), mesh, device))
    out.update(smoke_x=x, smoke_y=y, smoke_loss=loss, smoke_gsum=gsum,
               smoke_params=torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy())

    clips = np.load(os.path.join(workdir, "clips.npy"))
    featurizer = SpeechEmbeddings(mesh=mesh)
    out["featurize"] = part("featurize", lambda: featurizer(clips))
    shards = os.path.join(workdir, "shards")
    with contextlib.redirect_stdout(io.StringIO()):
        out["extract_rc"] = part("extract", lambda: cli_main(
            ["extract", "noise", os.path.join(workdir, "wavs", "*.wav"), "--local-files", "--directory", shards,
             "--mesh", "--device", str(device)]))

    # the hosted set unseeded, as train builds it: every rank takes rank 0's seed
    run = part("train", lambda: trajectory_run("perceptron", device, os.path.join(workdir, "train-data"),
                                               os.path.join(workdir, f"ckpt{rank}"), mesh=mesh, negative_seed=None))
    out.update(train_seed=run["seed"], train_loss=run["history"]["loss"], train_recall=run["history"]["recall"],
               train_fp=run["history"]["false_positive_rate"], train_rate=run["history"]["high_loss_rate"],
               train_params=run["params"].copy(), train_fired=run["fired"])  # before the timed steps move them
    out["steps_per_s"] = timed_steps(run, device)
    out["allreduce_ms"] = allreduce_ms(run["trainer"]._adam.flat.numel() + 1, mesh, device)

    pre, batch = mesh_pretrainer(device, workdir, mesh)
    pre.resident()
    losses, grads = part("pretrain", lambda: pretrain_f32_step(pre, batch))
    out.update(pretrain_loss=losses, **{f"pretrain_grad/{k}": v for k, v in grads.items()})
    # the control: the same step without the division by W of the gathers' summed backward
    pre.optimizer.zero_grad(set_to_none=True)
    pre.loss(batch, 0, compute_dtype=torch.float32)[0].backward()
    flat = torch.cat([p.grad.reshape(-1) for p in pre.net.parameters()])
    out["pretrain_grad_unscaled"] = all_reduce_sum(flat, mesh).double().cpu().numpy()

    part("dryrun", lambda: dryrun.run(world, rank, os.path.join(workdir, "dryrun"), str(device), "gloo"))
    out["launches"] = json.dumps(launches)
    out["seconds"] = json.dumps(seconds)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    barrier(mesh)
    return 0


def mesh_phase(dev: torch.device, tmp: str, clips: np.ndarray, emb: np.ndarray, extract_dir: str) -> Dict:
    """(a) the mesh over one rank on NCCL (gloo on the CPU) against no mesh, bit
    for bit; (b) MESH_RANKS ranks on gloo sharing the card, spawned as
    processes: the distributed smoke, SpeechEmbeddings(mesh), extract --mesh,
    the trainer's trajectory, one float32 pretrain step and the dryrun,
    against one rank."""
    from heybuddy_tpu_torch.parallel import distributed_smoke
    from heybuddy_tpu_torch.parallel.mesh import get_mesh

    data_dir = os.path.join(tmp, "train-data")
    summary: Dict = {}
    paths: Dict[str, Dict[str, int]] = {}
    # ---- (a) one rank -------------------------------------------------------------------
    mesh = get_mesh(device=dev)
    backend = torch.distributed.get_backend(mesh.group)
    runs = {}
    for label, m in (("none", None), ("mesh", mesh)):  # the default head: dropout as configured
        runs[label] = trajectory_run("perceptron", dev, data_dir, os.path.join(tmp, f"mesh-a-{label}"), mesh=m,
                                     dropout=0.1)
    same = all(np.array_equal(runs["mesh"]["history"][k], runs["none"]["history"][k]) for k in runs["none"]["history"])
    same_params = bool(np.array_equal(runs["mesh"]["params"], runs["none"]["params"]))
    featurizer = SpeechEmbeddings(mesh=mesh)
    got, paths["mesh_one_rank"] = run_path("mesh_one_rank", lambda: featurizer(clips),
                                           ("mel_patches", "embedding_pool"))
    one_ms = allreduce_ms(runs["mesh"]["trainer"]._adam.flat.numel() + 1, mesh, dev)
    print(f"mesh (a) one rank on {backend}: {TRAJECTORY_STEPS} steps of the default head (dropout 0.1) with the "
          f"mesh vs without: history equal {same}, parameters equal {same_params}, fired "
          f"{runs['mesh']['fired']}; SpeechEmbeddings(mesh) on {clips.shape[0]} clips equal to the fused path "
          f"{bool(np.array_equal(got, emb))}, launches {paths['mesh_one_rank']}; all_reduce of the flat gradient "
          f"{one_ms:.4f} ms")
    check(same and same_params, "mesh (a): the one-rank mesh trainer differs from no mesh")
    check(bool(np.array_equal(got, emb)), "mesh (a): SpeechEmbeddings(mesh) differs from the fused path")
    summary["one_rank"] = {"backend": backend, "allreduce_ms": one_ms}

    # ---- (b) MESH_RANKS ranks on gloo sharing the card ------------------------------------------
    workdir = os.path.join(tmp, "mesh-b")
    os.makedirs(workdir)
    np.save(os.path.join(workdir, "clips.npy"), clips)
    os.symlink(os.path.join(tmp, "wavs"), os.path.join(workdir, "wavs"))
    os.symlink(data_dir, os.path.join(workdir, "train-data"))
    rng = np.random.default_rng(SEED + 2)
    pool, lengths = speech_pool(MESH_PRETRAIN_TEXTS, SEED)
    b = MESH_PRETRAIN_BATCH
    pair_mask = np.zeros((b, b), bool)
    for i in range(0, min(8, b), 2):  # four phonetic-neighbour pairs
        pair_mask[i, i + 1] = pair_mask[i + 1, i] = True
    np.savez(os.path.join(workdir, "pretrain-pool.npz"), pool=pool, lengths=lengths,
             text_idx=rng.choice(MESH_PRETRAIN_TEXTS, b, replace=False),
             spk_idx=np.stack([rng.permutation(2) for _ in range(b)]), noise_idx=rng.integers(0, 256, (2, b)),
             imp_idx=rng.integers(0, 64, (2, b)), pair_mask=pair_mask)
    env = {**os.environ, "HEYBUDDY_OFFLINE": "1"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "mesh-rank", str(r), str(MESH_RANKS),
                               workdir, str(dev) if dev.type == "cpu" else "cuda:0"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
             for r in range(MESH_RANKS)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=MESH_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks_s = time.perf_counter() - t0
    for r, (proc, out) in enumerate(zip(procs, outputs)):
        if proc.returncode != 0:
            print(out[-6000:])
        check(proc.returncode == 0, f"mesh rank {r} failed (rc {proc.returncode})")
    ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(MESH_RANKS)]
    check("dryrun(2): OK" in outputs[0], "mesh (b): the dryrun did not finish")

    # the distributed smoke: the ranks agree, and agree with one process's step on the concatenated batch
    x = torch.from_numpy(np.concatenate([r["smoke_x"] for r in ranks])).to(dev)
    y = torch.from_numpy(np.concatenate([r["smoke_y"] for r in ranks])).to(dev)
    model, loss, _ = distributed_smoke.smoke_step(x, y, None, dev)
    one = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy()
    smoke_same = all(np.array_equal(r["smoke_params"], ranks[0]["smoke_params"]) for r in ranks)
    perr = np.abs(ranks[0]["smoke_params"] - one)
    smoke_share = float(np.mean(perr <= 1e-5 + 1e-4 * np.abs(one)))
    print(f"mesh (b) distributed smoke: ranks' parameters equal {smoke_same}; loss {float(ranks[0]['smoke_loss']):.6f} "
          f"vs one process on the concatenated batch {loss:.6f}; parameters max |d| {perr.max():.3e}, "
          f"{smoke_share:.4f} within 1e-5 + 1e-4 |x|")
    check(smoke_same and smoke_share >= TRAJ_PARAM_SHARE and perr.max() <= 2e-4, "mesh (b): the distributed smoke")

    # SpeechEmbeddings(mesh) and extract --mesh: bit for bit
    feat_same = [bool(np.array_equal(r["featurize"], emb)) for r in ranks]
    ref_shards = sorted(glob.glob(os.path.join(extract_dir, "noise-*.npy")))
    got_shards = sorted(glob.glob(os.path.join(workdir, "shards", "noise-*.npy")))
    shard_same = [os.path.basename(p) for p in got_shards] == [os.path.basename(p) for p in ref_shards] and all(
        open(a, "rb").read() == open(b_, "rb").read() for a, b_ in zip(got_shards, ref_shards))
    print(f"mesh (b) SpeechEmbeddings(mesh) on {clips.shape[0]} clips at {MESH_RANKS} ranks vs one: equal "
          f"{feat_same}; extract --mesh: {len(got_shards)} shard(s), bytes equal to the one-rank run's "
          f"{shard_same}")
    check(all(feat_same), "mesh (b): SpeechEmbeddings(mesh) differs from one rank")
    check(shard_same and all(int(r["extract_rc"]) == 0 for r in ranks), "mesh (b): extract --mesh shards differ")

    # the trainer: MESH_RANKS ranks on an unseeded hosted set against one given rank 0's seed, dropout 0
    seeds = [int(r["train_seed"]) for r in ranks]
    check(len(set(seeds)) == 1, f"mesh (b): the ranks trained on other seeds {seeds}")
    ref = trajectory_run("perceptron", dev, data_dir, os.path.join(tmp, "mesh-b-one"), negative_seed=seeds[0])
    ref["params"] = ref["params"].copy()  # before the timed steps move them
    one_steps = timed_steps(ref, dev)
    run = {"history": {"loss": ranks[0]["train_loss"], "recall": ranks[0]["train_recall"],
                       "false_positive_rate": ranks[0]["train_fp"],
                       "high_loss_rate": ranks[0]["train_rate"]}, "params": ranks[0]["train_params"],
           "fired": int(ranks[0]["train_fired"])}
    gap = trajectory_gap(run, ref)
    train_same = all(np.array_equal(r["train_params"], ranks[0]["train_params"]) for r in ranks)
    print(f"mesh (b) trainer {TRAJECTORY_STEPS} steps at {MESH_RANKS} ranks on an unseeded hosted set (rank 0's "
          f"seed {seeds[0]} on every rank) vs one rank given that seed on the card: loss relative "
          f"{gap['loss_rel']:.3e} (limit {TRAJ_LOSS_RTOL}); rates {gap['rate_err']:.3e} (limit {TRAJ_RATE_ATOL}); "
          f"params max |d| {gap['param_max']:.3e} (limit {TRAJ_PARAM_MAX}), share {gap['param_share']:.4f}; fired "
          f"{gap['fired']}; ranks equal {train_same}; steps/s one rank {one_steps:.1f}, {MESH_RANKS} ranks "
          f"{float(ranks[0]['steps_per_s']):.1f} (gloo, {MESH_TIMED_STEPS} steps); all_reduce of the flat gradient "
          f"{float(ranks[0]['allreduce_ms']):.4f} ms (gloo, host-staged)")
    check(trajectory_within(gap) and train_same, "mesh (b): the trainer at 2 ranks leaves the trajectory limits")

    # one float32 pretrain step at batch 64: MESH_RANKS ranks against one on the same views
    pre, batch = mesh_pretrainer(dev, workdir)
    pre.resident()
    ref_loss, ref_grads = pretrain_f32_step(pre, batch)
    got_grads = {k[len("pretrain_grad/"):]: v for k, v in ranks[0].items() if k.startswith("pretrain_grad/")}
    p_loss, p_grad = rel_gap(ranks[0]["pretrain_loss"], ref_loss), grad_gap(got_grads, ref_grads)
    flat_ref = np.concatenate([ref_grads[k].ravel() for k, _ in pre.net.named_parameters()])
    control = float(np.abs(ranks[0]["pretrain_grad_unscaled"] - flat_ref).max() / np.linalg.norm(flat_ref))
    print(f"mesh (b) pretrain step float32 at batch {b}, {MESH_RANKS} ranks vs one: loss relative {p_loss:.3e} "
          f"(limit {PRETRAIN_LOSS_RTOL[torch.float32]:.0e}); gradient {p_grad:.3e} (limit "
          f"{PRETRAIN_GRAD_TOL[torch.float32]:.0e}); without the division by W {control:.3e} (must exceed it)")
    check(p_loss <= PRETRAIN_LOSS_RTOL[torch.float32] and p_grad <= PRETRAIN_GRAD_TOL[torch.float32],
          "mesh (b): the pretrain step at 2 ranks disagrees with one rank")
    check(control > PRETRAIN_GRAD_TOL[torch.float32], "mesh (b): the pretrain limit passes a W-times gradient")

    collectives = json.loads(str(ranks[0]["collectives"]))
    print(f"mesh (b) gloo on {dev.type} tensors: {collectives}")
    check(all(collectives[name] == "ok" for name in MESH_COLLECTIVES_USED),
          "mesh (b): gloo does not run a collective the port uses")
    summary["gloo_collectives"] = collectives
    launches = [json.loads(str(r["launches"])) for r in ranks]
    for r, counts in enumerate(launches):
        for name, kernels in MESH_EXPECT.items():
            check(sorted(counts[name]) == sorted(kernels), f"mesh rank {r} part {name} launched {counts[name]}")
            if kernels:
                paths[f"mesh_{name}_rank{r}"] = counts[name]
        paths[f"mesh_dryrun_rank{r}"] = counts["dryrun"]
    print(f"mesh (b) launches per rank: {launches}; part seconds (rank 0): {ranks[0]['seconds']}; "
          f"{MESH_RANKS} ranks in {ranks_s:.1f} s (host clock, start-up included)")
    summary.update({"ranks": MESH_RANKS, "backend_b": "gloo", "steps_per_s_one": one_steps,
                    "steps_per_s_ranks": float(ranks[0]["steps_per_s"]),
                    "allreduce_ms_gloo": float(ranks[0]["allreduce_ms"]), "trainer_gap": gap,
                    "pretrain_loss_rel": p_loss, "pretrain_grad": p_grad, "pretrain_control": control,
                    "launches_per_rank": launches, "ranks_s": ranks_s})
    return {"paths": paths, "summary": summary}


# the quality harness: (a) a cut --eval-only of the shipped head, (b) --quick training
QUALITY_HEAD = os.path.join(ROOT, "browser", "models", "hey-buddy.onnx")
QUALITY_PHRASE = "hey buddy"  # the harness's default phrase
QUALITY_HELDOUT = 64  # clips of each of the five held-out sets
QUALITY_STREAM_MINUTES = 5.0
QUALITY_STREAM_SEEDS = 2
QUALITY_CALIBRATION_SEEDS = 1
QUALITY_SLIDING_CLIPS = 20  # the harness's default: 20 renderings of the phrase, 6 of each of 10 near-collisions
QUALITY_CHECK_WINDOWS = 1024  # a stream's first windows scored on the card and on the CPU
QUALITY_SCORE_ATOL = SCORE_ATOL  # predict's bound
# the key sets of reports/quality-shipped-v26-evalonly.json (the JAX harness's JSON)
QUALITY_KEYS = {
    "": ("phrase", "threshold", "embedding", "train_samples", "partial_samples", "adversarial_phrases",
         "hard_pair_boost", "prefix_negatives", "collision_negatives", "collision_swap_depth",
         "mine_adversarial_clips", "reverb_positives", "steps", "layers", "layer_dim", "fixed_negative_weight", "frr",
         "frr_clean", "frr_clean_offset", "far_adversarial", "far_speech", "stream_minutes", "stream_seeds",
         "stream_hours_total", "stream_detections", "fp_per_hour", "fp_per_hour_runs",
         "fp_per_hour_runs_consecutive2", "mine_rounds", "mined_negatives", "select_runs", "selection",
         "operating_threshold", "operating_fp_per_hour", "operating_frr", "operating_frr_clean",
         "operating_frr_clean_offset", "fp_per_hour_consecutive2", "operating_warnings", "threshold_curve",
         "threshold_curve_all_targets", "operating_threshold_consecutive2", "operating_frr_consecutive2",
         "operating_frr_clean_consecutive2", "operating_frr_clean_offset_consecutive2", "score_stats",
         "clean_positive_stats", "clean_offset_stats", "sliding_max_scores", "sliding_consecutive2_fire_rate",
         "sliding_recall_c2", "sliding_clips", "targets_met", "all_targets_met", "intervals", "calibrated",
         "far_attribution", "frr_by_snr", "far_by_snr", "checkpoint", "wall_s"),
    "intervals": ("far_adversarial", "far_speech", "frr_clean", "frr_clean_offset", "sliding_recall_c2",
                  "fp_per_hour_consecutive2", "n", "basis"),
    "intervals.n": ("adversarial", "speech", "clean", "clean_offset", "sliding_renderings", "stream_detections_c2",
                    "stream_hours"),
    "calibrated": ("threshold", "calibration_hours", "warnings", "degenerate", "fp_per_hour_c2",
                   "fp_per_hour_runs_c2", "sliding_recall_c2", "sliding_consecutive2_fire_rate", "far_adversarial",
                   "frr_clean", "frr_clean_offset", "targets_met", "all_targets_met", "intervals"),
    "calibrated.intervals": ("far_adversarial", "frr_clean", "sliding_recall_c2", "fp_per_hour_c2"),
    "threshold_curve[]": ("threshold", "far_adversarial", "far_speech", "frr_clean", "frr_clean_offset",
                          "sliding_recall_c2", "fp_per_hour_c2"),
}


def quality_keys_match(results: Dict) -> Dict[str, bool]:
    """Each key set of the harness's JSON against the JAX report's."""
    def at(path: str) -> Dict:
        node = results
        for part in filter(None, path.split(".")):
            node = node[part]
        return node

    got = {path: set(at(path)) for path in QUALITY_KEYS if not path.endswith("[]")}
    got["threshold_curve[]"] = set().union(*(set(c) for c in results["threshold_curve"]))
    return {path: got[path] == set(keys) for path, keys in QUALITY_KEYS.items()}


def run_quality(argv: List[str]) -> Dict:
    """``tools.quality_eval.main(argv)``: its rc checked, its JSON line parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = qe.main(argv)
    check(rc == 0, f"quality_eval {' '.join(argv[:2])} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def quality_phase(dev: torch.device, tmp: str) -> Dict:
    """(a) ``--eval-only`` of the shipped head, cut: the held-out sets, the
    streams and the sliding renderings on the card, K1 / K2 launches = the
    segments the streams and contexts give + one a held-out set, the first
    QUALITY_CHECK_WINDOWS windows of a stream scored on the card and on the CPU,
    the JSON's key set; the stages' times and the scoring's busy share.
    (b) ``--quick`` training on the card: the loss falls in every training,
    the mining round harvests and retrains, the same key set."""
    saved_cache = os.environ.get("HEYBUDDY_CACHE_DIR")
    os.environ["HEYBUDDY_CACHE_DIR"] = os.path.join(tmp, "quality-cache")
    try:
        return _quality_phase(dev, tmp)
    finally:
        if saved_cache is None:
            os.environ.pop("HEYBUDDY_CACHE_DIR", None)
        else:
            os.environ["HEYBUDDY_CACHE_DIR"] = saved_cache


def _quality_phase(dev: torch.device, tmp: str) -> Dict:
    paths: Dict[str, Dict[str, int]] = {}
    # ---- (a) eval-only -----------------------------------------------------------------
    argv = ["--eval-only", QUALITY_HEAD, "--heldout-samples", str(QUALITY_HELDOUT), "--stream-minutes",
            f"{QUALITY_STREAM_MINUTES:g}", "--stream-seeds", str(QUALITY_STREAM_SEEDS), "--calibration-seeds",
            str(QUALITY_CALIBRATION_SEEDS), "--sliding-clips", str(QUALITY_SLIDING_CLIPS), "--no-snr-buckets",
            "--dataset-dir", os.path.join(tmp, "quality-data"), "--out", os.path.join(tmp, "quality.json"),
            "--device", dev.type]
    profiling.GLOBAL_STAGE_TIMES = profiling.StageTimes()
    t0 = time.perf_counter()
    results, paths["quality"] = run_path("quality", lambda: run_quality(argv), ("mel_patches", "embedding_pool"))
    wall_s = time.perf_counter() - t0
    stage = profiling.GLOBAL_STAGE_TIMES  # the harness's stages, host clock
    stream_dir = os.path.join(tmp, "quality-cache", "quality-streams")
    stream_files = sorted(glob.glob(os.path.join(stream_dir, "*.npy")))
    streams = [np.load(f) for f in stream_files]
    segments = sum(-(-stream_window_count(x) // STREAM_SEGMENT_WINDOWS) for x in streams)
    contexts = QUALITY_SLIDING_CLIPS + 6 * len(qe.ADVERSARIAL_SLIDING_PHRASES)  # one segment each
    heldout_calls = 5 * -(-QUALITY_HELDOUT // min(DEFAULT_FEATURE_BATCH_SIZE,
                                                  autoconfigure_batch_sizes(dev)["embed_batch_size"]))
    expect = segments + contexts + heldout_calls
    keys = quality_keys_match(results)
    print(f"quality (a) --eval-only {os.path.basename(QUALITY_HEAD)}: {len(streams)} streams "
          f"({QUALITY_STREAM_SEEDS} x {QUALITY_STREAM_MINUTES:g} min + {QUALITY_CALIBRATION_SEEDS} calibration), "
          f"{segments} segments, {contexts} sliding contexts, {heldout_calls} held-out featurize calls: launches "
          f"{paths['quality']} (expected {expect} each); key sets equal the JAX report's: {keys}")
    check(len(streams) == QUALITY_STREAM_SEEDS + QUALITY_CALIBRATION_SEEDS, f"quality: {len(streams)} stream files")
    check(paths["quality"] == {"mel_patches": expect, "embedding_pool": expect},
          f"quality (a) launched {paths['quality']}, expected {expect} of K1 and K2")
    check(all(keys.values()), f"quality (a): the JSON's key sets differ from the JAX report's: {keys}")
    rates = [results[k] for k in ("frr", "frr_clean", "frr_clean_offset", "far_adversarial", "far_speech",
                                  "sliding_recall_c2")]
    check(all(0.0 <= r <= 1.0 for r in rates) and results["intervals"]["n"]["adversarial"] == QUALITY_HELDOUT,
          f"quality (a): rates {rates}")
    print(f"quality (a) results: FRR {results['frr']} (clean {results['frr_clean']}, offset "
          f"{results['frr_clean_offset']}), FAR_adv {results['far_adversarial']}, FAR_speech "
          f"{results['far_speech']}, fp/hr runs raw {results['fp_per_hour_runs']} c2 "
          f"{results['fp_per_hour_runs_consecutive2']}, sliding recall c2 {results['sliding_recall_c2']}, "
          f"calibrated thr {results['calibrated']['threshold']}, wall_s {results['wall_s']}")

    # the first windows of a measurement stream: card against the CPU
    # the harness's first measurement stream (seed 0 + 31), from its cache
    stream = qe.synth_speech_stream(QUALITY_STREAM_MINUTES, 31, exclude_phrase=QUALITY_PHRASE, device=dev)
    part = stream[: (QUALITY_CHECK_WINDOWS - 1) * RUNTIME_WINDOW_STRIDE + CLIP]
    head = WakeWordONNXModel(QUALITY_HEAD, device=dev)
    card = qe.sliding_scores(head, part, device=dev)
    cpu = qe.sliding_scores(WakeWordONNXModel(QUALITY_HEAD, device="cpu"), part, device="cpu")
    err = float(np.abs(card - cpu).max())
    grid = np.round(np.arange(0.05, 0.96, 0.01), 2)
    both = np.concatenate([card, cpu])
    clear = [float(t) for t in grid if np.abs(both - t).min() > QUALITY_SCORE_ATOL]
    det = {c: [(qe.count_detections(card, t, consecutive=c), qe.count_detections(cpu, t, consecutive=c))
               for t in clear] for c in (1, 2)}
    det_equal = all(a == b for pairs in det.values() for a, b in pairs)
    print(f"quality (a) the first {len(card)} windows card vs CPU: max |d| {err:.3e} (limit {QUALITY_SCORE_ATOL}), "
          f"max score {card.max():.4f}; detections equal at {len(clear)} clear thresholds (gates 1 and 2): "
          f"{det_equal}; at 0.5: raw {det[1][clear.index(0.5)] if 0.5 in clear else 'not clear'}")
    check(len(card) == QUALITY_CHECK_WINDOWS and err <= QUALITY_SCORE_ATOL, "quality (a): card vs CPU scores")
    check(det_equal and len(clear) > 0, "quality (a): card vs CPU detections")

    # the scoring's rates: a segment's device time (upload, K1, K2, the head) by CUDA events,
    # the stream's host clock, its busy share
    emb = get_speech_embeddings(device=dev)
    seg_ms = cuda_ms(lambda: qe.head_scores(
        head, emb.featurize_stream_device(stream, STREAM_SEGMENT_WINDOWS, RUNTIME_WINDOW_STRIDE)[0]))
    busy = device_busy(lambda: qe.sliding_scores(head, stream, device=dev))
    n_windows = stream_window_count(stream)
    host_wps = n_windows / (busy["wall_ms"] / 1e3)
    busy_share = busy["busy_ms"] / busy["wall_ms"] if busy["busy_ms"] is not None else None
    run_windows = sum(stream_window_count(x) for x in streams)
    synth_minutes = stage.count["quality/stream_synthesis"] * QUALITY_STREAM_MINUTES
    heldout_clips = 5 * QUALITY_HELDOUT
    summary = {
        "windows_per_s_cuda_events": STREAM_SEGMENT_WINDOWS / (seg_ms / 1e3), "segment_ms": seg_ms,
        "windows_per_s_host": host_wps, "stream_windows": n_windows, "busy_share": busy_share,
        "busy_kernels": busy["kernels"], "run_windows_per_s_host": run_windows / stage.total["quality/stream_scoring"],
        "synth_s_per_stream_minute": stage.total["quality/stream_synthesis"] / synth_minutes,
        "synth_minutes": synth_minutes, "heldout_clips_per_s": heldout_clips / stage.total["quality/heldout"],
        "heldout_clips": heldout_clips, "wall_s": results["wall_s"], "phase_a_s": wall_s, "card_vs_cpu": err,
        "results": {k: results[k] for k in ("frr", "frr_clean", "frr_clean_offset", "far_adversarial", "far_speech",
                                            "fp_per_hour_runs", "fp_per_hour_runs_consecutive2",
                                            "sliding_recall_c2")},
    }
    print(f"quality (a) times: scoring a {STREAM_SEGMENT_WINDOWS}-window segment {seg_ms:.4f} ms by CUDA events "
          f"(upload, K1, K2, head: {summary['windows_per_s_cuda_events']:.0f} windows/s); a {QUALITY_STREAM_MINUTES:g}"
          f"-min stream ({n_windows} windows) {busy['wall_ms']:.1f} ms host clock ({host_wps:.0f} windows/s), "
          f"busy {busy['busy_ms']} ms ({busy_share}) in {busy['kernels']} kernels; in the run (its stage "
          f"times): scoring the streams' {run_windows} windows in {stage.total['quality/stream_scoring']:.2f} s "
          f"({summary['run_windows_per_s_host']:.0f} windows/s), synthesis {synth_minutes:g} stream-minutes in "
          f"{stage.total['quality/stream_synthesis']:.1f} s ({summary['synth_s_per_stream_minute']:.2f} s per "
          f"stream-minute), held-out {heldout_clips} clips in {stage.total['quality/heldout']:.1f} s "
          f"({summary['heldout_clips_per_s']:.1f} clips/s); wall_s {results['wall_s']} "
          f"(host clock of the phase's run {wall_s:.1f} s)")

    # ---- (b) --quick training ------------------------------------------------------------------
    log = QualityLog()
    logger.addHandler(log)
    try:
        t0 = time.perf_counter()
        quick, launches = run_path("quality_quick", lambda: run_quality(
            ["--quick", "--dataset-dir", os.path.join(tmp, "quality-quick"), "--device", dev.type]),
            ("mel_patches", "embedding_pool"))
        quick_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    paths["quality_quick"] = launches
    falls = [run[-1] < run[0] for run in log.runs]
    keys = quality_keys_match(quick)
    print(f"quality (b) --quick: {len(log.runs)} trainings, logged loss first -> last "
          f"{[(round(r[0], 5), round(r[-1], 5)) for r in log.runs]}; mining: {log.mining}; mined "
          f"{quick['mined_negatives']}; launches {launches}; key sets equal {all(keys.values())}; "
          f"{quick_s:.1f} s (host clock), wall_s {quick['wall_s']}")
    check(len(log.runs) == 2 and all(falls), "quality (b): the loss did not fall in every training")
    check(len(log.mining) == 1 and quick["mined_negatives"] > 0, "quality (b): the mining round did not harvest")
    check(all(keys.values()), f"quality (b): the JSON's key sets differ from the JAX report's: {keys}")
    check(launches["mel_patches"] == launches["embedding_pool"], f"quality (b) launches {launches}")
    summary.update(quick_s=quick_s, quick_wall_s=quick["wall_s"], quick_mined=quick["mined_negatives"])
    return {"paths": paths, "summary": summary}


class QualityLog(logging.Handler):
    """The harness's trainings (their logged losses) and its mining rounds, from its log records."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.runs: List[List[float]] = []
        self.mining: List[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if msg.startswith("=== training classifier ("):
            self.runs.append([])
        elif m := re.match(r"Training step \d+/\d+: loss=(\S+) ", msg):
            self.runs[-1].append(float(m[1]))
        elif msg.startswith("mining round "):
            self.mining.append(msg)


# The tools phase: the port's counterparts of the JAX package's scripts and
# example, each through its main(argv) on the card, at cut sizes:
# (a) tools/mel_precision_probe: accuracy on its 16 realistic clips, timing at
#     batch 2048 in TOOLS_MEL_PASSES passes of TOOLS_MEL_ITERS calls (the
#     script's defaults are 6 of 10); the records' arrays on the card held
#     against the same arrays by the plain path on the card, K3 by the split's
#     limit, its bf16 DFT by BF16_DFT_ATOL, the features by K2's rule;
# (b) tools/diagnose_stream_fps on a 1-minute stream (seed 31; the script's
#     default is 15 minutes) with CHECKPOINT: one K1 / K2 a 1024-window
#     segment, scores card vs CPU within SCORE_ATOL, hits equal at a threshold
#     SCORE_ATOL clear of every score;
# (c) tools/embedding_separation_probe on the bundled embedding, clean and
#     --augment, TOOLS_SWAPS swap texts x 2 renders and TOOLS_PHRASE_RENDERS of
#     the phrase (the script's: 24 x 4 and 48); the clean cosines card vs CPU
#     within TOOLS_COSINE_ATOL;
# (d) tools/train_neural_g2p at TOOLS_G2P_STEPS steps (the script's 6000): the
#     loss falls, the saved npz decodes alike through the torch and numpy forwards
#     (tools/g2p_accuracy runs Python only and is held to its script by the CPU tests);
# (e) the walkthrough examples/train_wake_word at a toy size: it trains, the
#     .onnx by the numpy runner within ONNX_ATOL of the head on the card.
TOOLS_MEL_ITERS, TOOLS_MEL_PASSES = 3, 2
TOOLS_STREAM_MINUTES, TOOLS_STREAM_SEED = 1.0, 31
TOOLS_SWAPS, TOOLS_PHRASE_RENDERS = 12, 12
TOOLS_COSINE_ATOL = 5e-3  # the probe's cosines, card vs CPU (the same clips; K1 -> K2 vs the plain path)
TOOLS_G2P_STEPS = 300
TOOLS_WALKTHROUGH = ["--positive-samples", "16", "--adversarial-samples", "16", "--validation-samples", "8",
                     "--steps", "20"]


def run_tool(main_fn: Callable, argv: List[str]) -> List[str]:
    """A tool's ``main(argv)``: its rc checked, its printed lines returned."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    check(rc == 0, f"{main_fn.__module__} {' '.join(argv)} exited {rc}")
    return out.getvalue().splitlines()


def separation_line(line: str) -> Dict[str, float]:
    """The probe's printed cosines."""
    m = re.search(r"phrase<->phrase (\S+), phrase<->swap mean (\S+) / nearest (\S+), margin (\S+)$", line)
    check(m is not None, f"separation probe line {line!r}")
    return dict(zip(("phrase_phrase", "mean", "nearest", "margin"), map(float, m.groups())))


def tools_phase(dev: torch.device, tmp: str) -> Dict:
    from heybuddy_tpu_torch.examples import train_wake_word
    from heybuddy_tpu_torch.text.neural_g2p import NeuralG2P
    from heybuddy_tpu_torch.tools import diagnose_stream_fps as dsf
    from heybuddy_tpu_torch.tools import embedding_separation_probe as esp
    from heybuddy_tpu_torch.tools import train_neural_g2p
    from heybuddy_tpu_torch.tools import mel_precision_probe as mpp

    paths: Dict[str, Dict[str, int]] = {}
    summary: Dict[str, object] = {}
    cpu = torch.device("cpu")
    # ---- (a) the mel precision probe ------------------------------------------------------------
    argv = ["--batch", str(BATCH), "--iters", str(TOOLS_MEL_ITERS), "--passes", str(TOOLS_MEL_PASSES),
            "--device", dev.type]
    t0 = time.perf_counter()
    lines, paths["tools_mel_probe"] = run_path("tools_mel_probe", lambda: run_tool(mpp.main, argv), (
        "mel_spectrogram", "mel_spectrogram_bf16", "mel_patches", "mel_patches_bf16", "embedding_pool"))
    mel_s = time.perf_counter() - t0
    records = {r["probe"]: r for r in map(json.loads, filter(lambda x: x.startswith('{"probe"'), lines))}
    calls = TOOLS_MEL_ITERS * TOOLS_MEL_PASSES
    # accuracy: K3 for pallas_f32 and under banded_f32, K1 and K1-bf16 -> K2 once each; timing: the
    # first patches, one warm-up call of each variant, then each variant's calls (K1 in two, K1-bf16
    # in two, K2 in three variants)
    expect = {"mel_spectrogram": 2, "mel_spectrogram_bf16": 1, "mel_patches": 1 + 1 + 2 + 2 * calls,
              "mel_patches_bf16": 1 + 2 + 2 * calls, "embedding_pool": 2 + 3 + 3 * calls}
    print(f"tools (a) mel_precision_probe: {lines[0]}; launches {paths['tools_mel_probe']} (expected {expect}); "
          f"{mel_s:.1f} s")
    for line in lines[1:]:
        if line.startswith("{"):
            print(f"  {line}")
    check(paths["tools_mel_probe"] == expect, f"tools (a) launches {paths['tools_mel_probe']}, expected {expect}")
    check(sorted(records) == sorted(list(mpp.ACCURACY_KERNELS) + list(mpp.TIMING_KERNELS)),
          f"tools (a) records {sorted(records)}")
    check(records["pallas_bf16"]["max_abs_err"] > records["pallas_f32"]["max_abs_err"],
          "tools (a): the bf16 DFT does not read farther from float64 than the float32 one")
    # the records' arrays, card against the plain path on the card
    clips = torch.from_numpy(mpp.realistic_clips(16)).to(dev)
    ref = mpp.f64_logmel(clips.cpu().numpy())
    got, plain = mpp.mel_arrays(clips), mpp.mel_arrays(clips, plain=True)
    mel_errs = {"pallas_f32": check_split("tools (a) K3", got["pallas_f32"], plain["pallas_f32"]),
                "pallas_bf16": check_mel("tools (a) K3-bf16", got["pallas_bf16"], plain["pallas_bf16"],
                                         BF16_DFT_ATOL, 0.0)}
    plain_records = {k: float(np.abs(v.cpu().numpy().astype(np.float64) - ref).max()) for k, v in plain.items()}
    net = mpp._net(dev)
    feats, feats_plain = mpp.feature_arrays(net, clips), mpp.feature_arrays(net, clips, plain=True)
    starts = embedding_window_starts(CLIP)
    feature_errs = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        p64, n64 = mk.mel_patches_plain(clips, dft_dtype=dtype, accumulate=torch.float64)
        ref64 = ek.fused_embedding_plain(net, p64, starts, n64, accumulate=torch.float64)
        feature_errs[key] = check_bf16(f"tools (a) K1{'-bf16' if key == 'bf16' else ''} -> K2", feats[key],
                                       feats_plain[key], ref64)[0]
    check_path("tools (a) K3 -> banded f32", feats["banded_f32"], feats_plain["banded_f32"], BF16_ATOL)
    print(f"tools (a) records card / plain path on the card (max |d| from float64): "
          + ", ".join(f"{k} {records[k]['max_abs_err']:.3e} / {plain_records[k]:.3e}" for k in plain_records)
          + f"; arrays card vs plain K3 {mel_errs['pallas_f32']:.3e} (limit {SPLIT_ATOL}), K3-bf16 "
          f"{mel_errs['pallas_bf16']:.3e} (limit {BF16_DFT_ATOL})")
    summary["mel_probe"] = {"records": records, "plain_records": plain_records, "array_errs": mel_errs,
                            "feature_errs": feature_errs, "seconds": mel_s}
    del clips, got, plain, feats, feats_plain

    # ---- (b) the stream false-positive diagnosis ----------------------------------------------
    phrase = "hey buddy"
    stream, _ = dsf.stream_and_schedule(TOOLS_STREAM_MINUTES, TOOLS_STREAM_SEED, phrase, dev)
    n_windows = stream_window_count(stream)
    segments = -(-n_windows // STREAM_SEGMENT_WINDOWS)
    card = qe.sliding_scores(load_model(CHECKPOINT, device=dev), stream, device=dev, emb=SpeechEmbeddings(device=dev))
    host = qe.sliding_scores(load_model(CHECKPOINT, device=cpu), stream, device=cpu, emb=SpeechEmbeddings(device=cpu))
    err = float(np.abs(card - host).max())
    both = np.concatenate([card, host])
    grid = np.round(np.arange(0.05, 0.96, 0.01), 2)
    clear = [float(t) for t in grid if np.abs(both - t).min() > SCORE_ATOL]
    threshold = next((t for t in clear if (card >= t).any()), clear[0] if clear else 0.5)
    argv = ["--checkpoint", CHECKPOINT, "--minutes", f"{TOOLS_STREAM_MINUTES:g}", "--seed", str(TOOLS_STREAM_SEED),
            "--threshold", str(threshold)]
    t0 = time.perf_counter()
    lines, paths["tools_diagnose"] = run_path("tools_diagnose", lambda: run_tool(
        dsf.main, argv + ["--out", os.path.join(tmp, "fps-card.json"), "--device", dev.type]),
        ("mel_patches", "embedding_pool"))
    diagnose_s = time.perf_counter() - t0
    run_tool(dsf.main, argv + ["--out", os.path.join(tmp, "fps-cpu.json"), "--device", "cpu"])
    fps = {k: json.load(open(os.path.join(tmp, f"fps-{k}.json"))) for k in ("card", "cpu")}
    hits_equal = ([(h["t"], h["phrases"]) for h in fps["card"]["hits"]]
                  == [(h["t"], h["phrases"]) for h in fps["cpu"]["hits"]]
                  and fps["card"]["by_phrase"] == fps["cpu"]["by_phrase"])
    print(f"tools (b) diagnose_stream_fps: {TOOLS_STREAM_MINUTES:g} min, {n_windows} windows in {segments} "
          f"segments; launches {paths['tools_diagnose']}; scores card vs CPU max |d| {err:.3e} (limit "
          f"{SCORE_ATOL}), max score {card.max():.4f}; at {threshold} ({len(clear)} clear thresholds) "
          f"{len(fps['card']['hits'])} hits, equal to the CPU's: {hits_equal}; {diagnose_s:.1f} s; "
          f"report: {' | '.join(l.strip() for l in lines if l.strip())}")
    check(paths["tools_diagnose"] == {"mel_patches": segments, "embedding_pool": segments},
          f"tools (b) launches {paths['tools_diagnose']}, expected {segments} of K1 and K2")
    check(err <= SCORE_ATOL and len(clear) > 0 and hits_equal, "tools (b): card and CPU disagree")
    summary["diagnose"] = {"windows": n_windows, "card_vs_cpu": err, "threshold": threshold,
                           "hits": len(fps["card"]["hits"]), "seconds": diagnose_s}

    # ---- (c) the embedding separation probe, clean and augmented ----------------------------------
    argv = ["--swaps", str(TOOLS_SWAPS), "--per-text", "2", "--phrase-renders", str(TOOLS_PHRASE_RENDERS)]
    t0 = time.perf_counter()
    clean, paths["tools_separation"] = run_path("tools_separation", lambda: run_tool(
        esp.main, argv + ["--device", dev.type]), ("mel_patches", "embedding_pool"))
    augmented, launches = run_path("tools_separation_augment", lambda: run_tool(
        esp.main, argv + ["--augment", "--device", dev.type]), ("mel_patches", "embedding_pool"))
    separation_s = time.perf_counter() - t0
    host_line = run_tool(esp.main, argv + ["--device", "cpu"])
    got, want, aug = (separation_line(x[-1]) for x in (clean, host_line, augmented))
    gap = max(abs(got[k] - want[k]) for k in got)
    print(f"tools (c) embedding_separation_probe ({TOOLS_SWAPS} swaps x 2, {TOOLS_PHRASE_RENDERS} phrase "
          f"renders): card {clean[-1]!r}; CPU {host_line[-1]!r}; max |d| {gap:.3e} (limit {TOOLS_COSINE_ATOL}); "
          f"--augment {augmented[-1]!r}; launches {paths['tools_separation']} / {launches}; {separation_s:.1f} s")
    check(paths["tools_separation"] == launches == {"mel_patches": 2, "embedding_pool": 2},
          f"tools (c) launches {paths['tools_separation']} / {launches}: one K1 and one K2 a pool")
    check(gap <= TOOLS_COSINE_ATOL, "tools (c): the card's cosines disagree with the CPU's")
    check(all(-1.0 <= aug[k] <= 1.0 for k in ("phrase_phrase", "mean", "nearest")), f"tools (c) augmented {aug}")
    summary["separation"] = {"card": got, "cpu": want, "augmented": aug, "seconds": separation_s}

    # ---- (d) the neural G2P's training ---------------------------------------------------------
    out = os.path.join(tmp, "g2p-neural.npz")
    log = PretrainLog()
    logger.addHandler(log)
    try:
        t0 = time.perf_counter()
        run_tool(train_neural_g2p.main, ["--steps", str(TOOLS_G2P_STEPS), "-o", out, "--json",
                                         os.path.join(tmp, "g2p-metrics.json"), "--device", dev.type])
        g2p_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
    metrics = json.load(open(os.path.join(tmp, "g2p-metrics.json")))
    model, params = NeuralG2P.load(out)
    _, heldout, _ = train_neural_g2p.training_table()
    words = sorted(heldout)
    decoded_equal = model.to(dev).decode(params, words) == model.decode(params, words, numpy=True)
    print(f"tools (d) train_neural_g2p {TOOLS_G2P_STEPS} steps in {g2p_s:.2f} s, logged losses {log.g2p}, "
          f"held-out {metrics['heldout_golden']}; the saved npz decodes the held-out words alike on the card and "
          f"in numpy: {decoded_equal}")
    check(len(log.g2p) >= 2 and log.g2p[-1][1] < log.g2p[0][1], f"tools (d): the G2P loss did not fall: {log.g2p}")
    check(decoded_equal, "tools (d): the saved G2P decodes differently on the card and in numpy")
    summary["g2p"] = {"neural_seconds": g2p_s, "losses": log.g2p, "heldout": metrics["heldout_golden"]}

    # ---- (e) the API walkthrough at a toy size --------------------------------------------------
    wav = os.path.join(tmp, "walkthrough.wav")
    t_axis = np.arange(3 * 16000) / 16000.0
    write_wav(wav, (0.3 * np.sin(2 * np.pi * (220.0 + 180.0 * t_axis) * t_axis)).astype(np.float32))
    ckpt = os.path.join(tmp, "walkthrough-ckpt")
    t0 = time.perf_counter()
    lines, paths["tools_walkthrough"] = run_path("tools_walkthrough", lambda: run_tool(
        train_wake_word.main, TOOLS_WALKTHROUGH + ["--checkpoint-dir", ckpt, "--dataset-dir",
                                                   os.path.join(tmp, "walkthrough-data"), "--audio", wav,
                                                   "--device", dev.type]), ("mel_patches", "embedding_pool"))
    walkthrough_s = time.perf_counter() - t0
    onnx_path = os.path.join(ckpt, "hey-computer_final.onnx")
    head = load_model(os.path.join(ckpt, "hey-computer_final.npz"), device=dev)
    x = np.random.default_rng(SEED + 3).normal(0.0, 1.0, (64, 16, 96)).astype(np.float32)
    runner = OnnxRunner.from_file(onnx_path)(input=x)["output"].reshape(-1)
    with torch.no_grad():
        card_scores = head(torch.from_numpy(x).to(dev)).cpu().numpy().reshape(-1)
    onnx_err = float(np.abs(runner - card_scores).max())
    print(f"tools (e) walkthrough ({' '.join(TOOLS_WALKTHROUGH)}): {lines[-2:]}; launches "
          f"{paths['tools_walkthrough']}; .onnx by the numpy runner vs the head on the card max |d| {onnx_err:.3e} "
          f"(limit {ONNX_ATOL}); {walkthrough_s:.1f} s")
    k1 = paths["tools_walkthrough"]
    check(os.path.exists(onnx_path) and onnx_err <= ONNX_ATOL, "tools (e): the walkthrough's ONNX head disagrees")
    # one featurize call a generated cache (positives, adversarials, validation: each one embed
    # batch at these counts) and one for the wav's timecode windows
    check(k1 == {"mel_patches": 4, "embedding_pool": 4}, f"tools (e) launches {k1}, expected 4 of K1 and K2")
    summary["walkthrough"] = {"onnx_err": onnx_err, "seconds": walkthrough_s, "launches": k1}
    return {"paths": paths, "summary": summary}


def device_busy(fn: Callable[[], object]) -> Dict[str, float]:
    """Host-clock ms of ``fn`` under ``torch.profiler`` and the ms its CUDA
    kernels ran (None when the trace holds no device events; the device
    spans of ``record_function`` annotations are not kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the device-side spans of record_function (stage_timer's names)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if kernels else None
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": len(kernels)}


START = time.perf_counter()


def elapsed(phase: str) -> None:
    print(f"[{time.perf_counter() - START:.1f} s] {phase} done")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    os.environ["HEYBUDDY_OFFLINE"] = "1"  # generation's noise provider: never probe the hub
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- build -------------------------------------------------------------------
    seconds = build.build_all()
    print(f"build: {seconds:.1f} s for {', '.join(build.SOURCES)}")
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "spill" in line or "error" in line.lower() or "C75" in line:
                print(f"  {name}: {line.strip()}")
    resource_report()

    rng = np.random.default_rng(SEED)
    # the shared featurizer, which extract and predict reach too: built here, out of their timing
    featurizer = get_speech_embeddings(device=dev)
    net = featurizer.net

    # ---- each kernel against its plain version ------------------------------------------
    errs = {k: 0.0 for k in ("K1", "K1b", "K2", "K3", "K4", "K1-bf16", "K3-bf16", "K1b-bf16")}
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
        f16, _, errf16 = check_k1(audio, expect, "fat", bf16)
        errs["K1b-bf16"] = max(errs["K1b-bf16"], errf16)
        # the same bf16 operands and exact products as K1-bf16, summed in another order
        f16_vs_k1 = check_mel("K1b-bf16 vs K1-bf16", f16[:, :n], p16[:, :n])
        s16 = mk.mel_spectrogram(audio, dft_dtype=bf16)
        errs["K3-bf16"] = max(errs["K3-bf16"], check_mel(
            "K3-bf16", s16, mk.mel_spectrogram_plain(audio, bf16), BF16_DFT_ATOL, 0.0))
        k1_err = (patches[:, :n] - mk.mel_patches_plain(audio)[0][:, :n]).abs().max().item()
        print(f"K1/K1b/K3 {kind} t={t} b={b}: num_patches {n}, frames {spec.shape[1]}; K1b loads its "
              f"hop rows by {mk.fat_load_path(audio)}; max |d| vs "
              f"plain K1 {k1_err:.3e} K3 {k3_err:.3e} K1b {err:.3e} (limits {MEL_ATOL} + {MEL_RTOL} "
              f"|ref| and {SPLIT_ATOL}); K1b vs K1 {fat_vs_k1:.3e} (limit {MEL_ATOL} + {MEL_RTOL} |ref|); "
              f"K3 vs K1 layout {layout:.3e} (one mel body: 0 expected); bf16 DFT vs its plain "
              f"K1 {err16:.3e} K3 {errs['K3-bf16']:.3e} K1b {errf16:.3e} (limit {BF16_DFT_ATOL}), vs K1 "
              f"{(p16[:, :n] - patches[:, :n]).abs().max().item():.3e}; K1b-bf16 vs K1-bf16 "
              f"{f16_vs_k1:.3e} (limit {MEL_ATOL} + {MEL_RTOL} |ref|)")
        check(layout == 0.0, "K3 differs from K1's layout")
        err, limit = check_k2(net, patches, n, t)
        errs["K2"] = max(errs["K2"], err)
        starts = embedding_window_starts(t)
        windows = ek.fused_embedding_windows(net, spec, starts)
        direct = ek.fused_embedding_from_patches(net, patches, starts, n)
        torch.cuda.synchronize()
        check_path("fused_embedding_windows(K3) vs K2 on K1's patches", windows, direct, limit)
        errs["K4"] = max(errs["K4"], check_k4(net, audio, t)[0])

    # K1b on a whole number of hops at a base 4 bytes past 16-byte alignment:
    # no flat TMA view, so the plain loads (its own generator: the cases
    # below see the draws they always saw)
    b, t = 3, 17280
    offset_rng = np.random.default_rng(SEED + 1)
    buf = torch.from_numpy(offset_rng.normal(0.0, 1000.0, b * t + 1).astype(np.float32)).to(dev)
    audio = buf[1:].view(b, t)
    for dtype in (torch.float32, bf16):
        _, _, err = check_k1(audio, 26, "fat", dtype)
        key = "K1b" if dtype == torch.float32 else "K1b-bf16"
        errs[key] = max(errs[key], err)
        print(f"{key} t={t} b={b}, base offset 4 B: loads its hop rows by {mk.fat_load_path(audio)}; "
              f"max |d| vs plain {err:.3e}")
    check(mk.fat_load_path(audio) == "plain", "an unaligned base took the TMA path")

    clips = np.clip(rng.normal(0.0, 0.05, (BATCH, CLIP)), -1.0, 1.0).astype(np.float32)
    audio = torch.from_numpy(clips * 32767.0).to(dev)
    starts = embedding_window_starts(CLIP)
    # ---- the kernels at batch 2048 against their plain versions --------------------------------
    patches, n = mk.mel_patches(audio)
    errs["K1"] = max(errs["K1"], check_split("K1", patches[:, :n], mk.mel_patches_plain(audio)[0][:, :n]))
    fat, _ = mk.mel_patches(audio, "fat")
    errs["K1b"] = max(errs["K1b"], check_split("K1b", fat[:, :n], mk.mel_patches_plain(audio, "fat")[0][:, :n]))
    errs["K1b-bf16"] = max(errs["K1b-bf16"], check_k1(audio, n, "fat", bf16)[2])
    spec = mk.mel_spectrogram(audio)
    errs["K3"] = max(errs["K3"], check_split("K3", spec, mk.mel_spectrogram_plain(audio)))
    errs["K1-bf16"] = max(errs["K1-bf16"], check_k1(audio, n, "chunked", bf16)[2])
    errs["K3-bf16"] = max(errs["K3-bf16"], check_mel(
        "K3-bf16", mk.mel_spectrogram(audio, dft_dtype=bf16), mk.mel_spectrogram_plain(audio, bf16),
        BF16_DFT_ATOL, 0.0))
    print(f"kernels at {BATCH} x {CLIP}: max |d| vs plain K1 {errs['K1']:.3e} K1b {errs['K1b']:.3e} "
          f"K3 {errs['K3']:.3e} K1-bf16 {errs['K1-bf16']:.3e} K3-bf16 {errs['K3-bf16']:.3e} "
          f"K1b-bf16 {errs['K1b-bf16']:.3e} (maxima over every shape so far)")
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

    def fat_bf16_path():
        fat16, n_fat = mk.mel_patches(audio, dft_mode="fat", dft_dtype=bf16)
        return ek.fused_embedding_from_patches(net, fat16, starts, n_fat)

    fat16_out, paths["fat_bf16"] = run_path("fat_bf16", fat_bf16_path,
                                            ("mel_patches_fat_bf16", "embedding_pool"))
    plain16, n16 = mk.mel_patches_plain(audio, "fat", bf16)
    print(f"path fat_bf16 (hop-block bf16-DFT mel -> K2): launches {paths['fat_bf16']}; vs fused "
          f"max |d| {(fat16_out - emb_dev).abs().max().item():.3e}")
    check_path("fat_bf16 vs K2 on the hop-block bf16-DFT plain mel", fat16_out,
               ek.fused_embedding_from_patches(net, plain16, starts, n16), path_limit)
    del fat16_out, plain16

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
        # ---- the training path: caches on the card, train, convert, predict ----------------
        elapsed("the featurizer paths, extract and predict")
        train = train_phase(net, dev, tmp)
        paths["train_cache"], paths["train_predict"] = train["train_cache"], train["train_predict"]
        # ---- feature generation: train from an empty dataset directory ---------------
        elapsed("train")
        generate = generate_phase(net, dev, tmp)
        paths["generate_fused"], paths["generate_formant"] = generate["generate_fused"], generate["generate_formant"]
        # ---- stream-window negatives, then listen with the head they trained ------------
        elapsed("generate")
        stream = stream_phase(net, dev, tmp)
        paths["stream"], paths["stream_train"] = stream["launches"]["speech"], stream["train_launches"]
        elapsed("stream")
        listen = listen_phase(dev, tmp, stream["head"])
        paths["listen"], paths["listen_vad"] = listen["listen"]["launches"], listen["listen_vad"]["launches"]
        # ---- embedding pretraining, the new npz in the featurizer and the browser bundle, the G2P ----
        elapsed("listen")
        pretrain = pretrain_phase(dev, tmp)
        paths.update(pretrain["launches"])
        elapsed("pretrain")
        # ---- the ONNX importer (K3 under the bundled embedding graph), then the VITS TTS ----
        onnx = onnx_phase(net, dev, clips, audio, tmp)
        paths["onnx"] = onnx["launches"]
        elapsed("onnx")
        vits = vits_phase(dev, tmp)
        paths["vits_generate"] = vits["launches"]
        elapsed("vits")
        # ---- the mesh: one rank on NCCL, then two ranks on gloo sharing the card ----
        mesh = mesh_phase(dev, tmp, clips, emb, os.path.join(tmp, "shards0"))
        paths.update(mesh["paths"])
        elapsed("mesh")
        # ---- the quality harness on the shipped head, then a quick training run ----
        quality = quality_phase(dev, tmp)
        paths.update(quality["paths"])
        elapsed("quality")
        # ---- the tools: the probes, the stream diagnosis, the G2P tools, the walkthrough ----
        tools = tools_phase(dev, tmp)
        paths.update(tools["paths"])
        elapsed("tools")
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
        "K1b-bf16": (cuda_ms(lambda: mk.mel_patches(audio, "fat", bf16)),
                     cuda_ms(lambda: mk.mel_patches_plain(audio, "fat", bf16))),
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
    work["K1-bf16"], work["K3-bf16"], work["K1b-bf16"] = work["K1"], work["K3"], work["K1"]  # the same least work

    def bound(name: str) -> Tuple[float, str]:
        t_ops, nbytes, _ = work[name]
        t_bytes = nbytes / PEAK_BYTES
        return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")

    # Floors of each kernel's own method: the direct DFT (400 x 256 products a
    # frame) as 3 16-bit tensor-core products (split) or 1 (bf16 DFT); K1b's
    # the same over its 480 hop-block rows, 64 hop rows for every 62 frames;
    # plus the float32 tail (power, filterbank); K2's trunk is the function's
    # own work. The larger of those operations at their peak and the
    # function's bytes.
    dft_flop = mk.TAPS * 2 * mk.N_FREQ_PAD * 2
    fat_flop = mk.HOP_BLOCKS * 160 * 2 * mk.N_FREQ_PAD * 2 * 64 / 62
    tail_s = (2 * mk.N_FREQ_PAD + 2 * mk.N_FREQ_PAD * 32) / PEAK_FP32
    frame_s = {"K1": 3 * dft_flop / PEAK_BF16 + tail_s, "K3": 3 * dft_flop / PEAK_BF16 + tail_s,
               "K1-bf16": dft_flop / PEAK_BF16 + tail_s, "K3-bf16": dft_flop / PEAK_BF16 + tail_s,
               "K1b": 3 * fat_flop / PEAK_BF16 + tail_s, "K1b-bf16": fat_flop / PEAK_BF16 + tail_s}
    method_s = {k: BATCH * (frames if k.startswith("K3") else usable) * v for k, v in frame_s.items()}
    method_s["K2"] = k2_ops / PEAK_BF16
    method_s["K4"] = method_s["K1"] + method_s["K2"]

    def floor(name: str) -> float:
        return max(method_s[name], work[name][1] / PEAK_BYTES) * 1e3

    meta = {
        "K1": ("mel_patches", "mel_patches.cu", "melspec_kernel.py:199", "fused"),
        "K1b": ("mel_patches_fat", "mel_patches_fat.cu", "melspec_kernel.py:346", "fat"),
        "K2": ("embedding_pool", "embedding_pool.cu", "embedding_kernel.py:309", "fused"),
        "K3": ("mel_spectrogram", "mel_spectrogram.cu", "melspec_kernel.py:96", "pretrain"),
        "K4": ("featurize", "featurize.cu", "featurize_kernel.py:105", "mega"),
        "K1-bf16": ("mel_patches_bf16", "mel_patches.cu", "melspec_kernel.py:204", "bf16_dft"),
        "K3-bf16": ("mel_spectrogram_bf16", "mel_spectrogram.cu", "melspec_kernel.py:101",
                    "bf16_spectrogram"),
        "K1b-bf16": ("mel_patches_fat_bf16", "mel_patches_fat.cu", "melspec_kernel.py:348", "fat_bf16"),
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
            "launches_by_path": {p: c[name] for p, c in paths.items() if name in c},
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
                      "train": train["summary"], "generate": generate["summary"],
                      "stream": {**stream["summary"], "train": stream["train"]}, "listen": listen,
                      "pretrain": pretrain["summary"], "onnx": onnx["summary"], "vits": vits["summary"],
                      "mesh": mesh["summary"], "quality": quality["summary"], "tools": tools["summary"],
                      "seconds": time.perf_counter() - START, **extract}))
    print(f"chip_smoke.py: {time.perf_counter() - START:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["mesh-rank"]:  # one rank of the mesh phase, started by mesh_phase
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
