"""
End-to-end offline quality evaluation: FRR / FAR / false wakes per hour, on the card.

    python -m heybuddy_tpu_torch.tools.quality_eval [--eval-only CKPT] [--quick] [--out results.json]
        [--device cpu | --cpu]

The port's counterpart of the JAX package's ``scripts/quality_eval.py``, with
its arguments, its ``--quick`` sizes, its function names and the keys of its
JSON summary. It trains a wake-word classifier with the port's own pipeline
(formant TTS on the host, augmentation, K1 -> K2 featurization, the trainer
with its fp/hour negative-weight controller, hard-negative mining, K-candidate
selection), or re-scores a checkpoint with ``--eval-only`` (an ``.npz``, a
reference ``.pt`` or an exported ``.onnx`` head), and reports:

  - FRR               held-out augmented positives scored < threshold
  - FAR (adversarial) held-out phonetic near-collisions scored >= threshold
  - FAR (speech)      held-out ordinary-speech clips scored >= threshold
  - fp_per_hour       detections on hours of synthetic continuous ordinary
                      speech through the runtime's sliding window (1.44 s
                      window, 0.12 s stride, 1.92 s debounce), raw and at the
                      deployed 2-consecutive gate
  - sliding-offset max scores for the wake phrase and known near-collisions
    ("hay bunny" etc.), each embedded at random offsets in context audio

The sliding windows of a stream are featurized as the stream caches are
(``SpeechEmbeddings.featurize_stream_device``: one upload a 1024-window
segment, K1 on its row-strided window view, then K2) and scored on the card;
features come to the host only for mining. An ``.onnx`` head scores device
features through the ONNX importer's tensor ops (``device_scores``). The
streams are bit-equal to the JAX package's, so the same head scores the same
audio; the augmentation of the held-out sets and of the bucket analyses draws
from ``torch.Generator``s (``seeded_generator`` on the JAX keys' integers),
so those clips differ from JAX's by design.

Everything runs on ``cuda`` unless ``--device cpu`` (or ``--cpu``) is given.
The stages ``quality/stream_synthesis`` (a stream rendered on a cache miss),
``quality/heldout`` (the five held-out sets' generation) and
``quality/stream_scoring`` (the measurement and calibration streams' sliding
scoring) are timed into ``utils/profiling.GLOBAL_STAGE_TIMES``.
``HEYBUDDY_EMBEDDING_WEIGHTS`` carries ``--embedding`` to the featurizer, so
the feature caches follow the feature space. Rendered streams are cached
under ``get_cache_dir("quality-streams")`` (``HEYBUDDY_CACHE_DIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.utils.profiling import stage_timer

__all__ = [
    "parse_args", "main", "operating_threshold", "count_detections", "wilson_interval",
    "poisson_rate_interval", "selection_key", "operating_point_warnings", "threshold_curve",
    "targets", "headline_intervals", "calibrated_block", "head_scores", "host_scores",
    "sliding_features_scores", "sliding_scores", "frr_by_snr_buckets", "far_by_snr_buckets",
    "far_attribution", "derive_hard_pairs", "ADVERSARIAL_SLIDING_PHRASES",
]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phrase", default="hey buddy")
    p.add_argument("--embedding", default=None, help="embedding weights .npz")
    p.add_argument("--dataset-dir", default=None, help="feature cache dir (default: temp)")
    p.add_argument("--checkpoint-dir", default=None, help="classifier checkpoint dir")
    p.add_argument("--out", default=None, help="write the JSON summary here")
    p.add_argument("--quick", action="store_true", help="tiny sizes (smoke test)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-samples", type=int, default=800)
    p.add_argument("--heldout-samples", type=int, default=200)
    p.add_argument("--partial-samples", type=int, default=400)
    p.add_argument("--stream-samples", type=int, default=800,
                   help="sliding-window stream negatives (speech; half as many adversarial)")
    p.add_argument("--val-stream-samples", type=int, default=1600,
                   help="validation stream windows for the negative-weight "
                        "controller (1600 ~= 3.2 min; rare FPs need more)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--layers", type=int, default=2, help="classifier MLP blocks")
    p.add_argument("--layer-dim", type=int, default=96, help="classifier hidden dim")
    p.add_argument("--stream-minutes", type=float, default=60.0,
                   help="length of EACH fp/hour stream")
    p.add_argument("--stream-seeds", type=int, default=3,
                   help="independent fp/hour streams (the metric has ~10x seed noise at 1 h; a "
                        "bare single-stream point estimate is never reported alone)")
    p.add_argument("--sliding-clips", type=int, default=20,
                   help="renderings for the headline sliding-gate recall")
    p.add_argument("--no-snr-buckets", action="store_true",
                   help="skip the FRR-by-SNR/reverb breakdown")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--validation-consecutive", type=int, default=2,
                   help="consecutive-window gate for the trainer's stream validation negatives "
                        "(the shipped runtime gate the headline metrics are measured at)")
    p.add_argument("--select-runs", type=int, default=1,
                   help="train this many candidates (different trainer init + mining stream seeds), "
                        "score each on SELECTION data disjoint from the report sets (a dedicated "
                        "speech stream, a dedicated adversarial clip set, and the controller's "
                        "clean-offset validation positives), and report held-out metrics only for "
                        "the winner")
    p.add_argument("--select-stream-minutes", type=float, default=15.0,
                   help="length of the selection fp/hr stream per candidate")
    p.add_argument("--select-consolidate", action=argparse.BooleanOptionalAction, default=True,
                   help="after the K candidates, train one more model on the UNION of all "
                        "candidates' mined hard negatives and let it compete on the selection data")
    p.add_argument("--select-adversarial-samples", type=int, default=400,
                   help="size of the selection adversarial clip set")
    p.add_argument("--fixed-negative-weight", type=float, default=None,
                   help="disable the dynamic negative-weight controller and train with this "
                        "constant weight on all negatives")
    p.add_argument("--mine-rounds", type=int, default=2,
                   help="hard-negative mining rounds (stream -> harvest FPs -> retrain)")
    p.add_argument("--mine-floor", type=float, default=0.2,
                   help="mine windows scoring at or above this")
    p.add_argument("--adversarial-phrases", type=int, default=60,
                   help="TRAINING adversarial phrase-pool size (the held-out pool stays at 60)")
    p.add_argument("--prefix-negatives", type=int, default=0,
                   help="N>0 adds N auto-derived PREFIX-negative texts (the wake phrase's exact "
                        "onset continuing into non-target words) to the TRAINING adversarial pool")
    p.add_argument("--reverb-positives", type=int, default=0,
                   help="N>0 adds N REVERB-MODE positives (guaranteed reverb + mid-SNR noise, no "
                        "other distortion) as dedicated positive coverage")
    p.add_argument("--collision-negatives", type=int, default=0,
                   help="N>0 adds N SINGLE-SWAP collision texts (one word of the phrase replaced "
                        "by a phonetic neighbor) to the TRAINING adversarial pool; the exact "
                        "held-out texts are excluded")
    p.add_argument("--collision-swap-depth", type=int, default=1,
                   help="maximum words swapped per collision-negative text")
    p.add_argument("--reverb-collisions", type=int, default=0,
                   help="N>0 renders N REVERB-ONLY collision negatives of the swap-collision "
                        "emphasis texts (the mirror of --reverb-positives)")
    p.add_argument("--mine-adversarial-clips", type=int, default=0, metavar="N",
                   help="N>0 renders N fresh augmented ADVERSARIAL CLIPS per mining round and "
                        "harvests those scoring >= --mine-floor as negatives")
    p.add_argument("--hard-pair-boost", type=int, default=0,
                   help="N>0 adds the wake phrase's closest single-word phonetic neighbors to the "
                        "TRAINING adversarial pool, each duplicated N times")
    p.add_argument("--collision-streams", action=argparse.BooleanOptionalAction, default=False,
                   help="add collision-salad stream windows to training negatives and mining")
    p.add_argument("--far-attribution", type=int, default=0, metavar="N",
                   help="with N>0, additionally report per-text FAR over N fresh augmented "
                        "renderings of each held-out adversarial text")
    p.add_argument("--calibration-seeds", type=int, default=2,
                   help="independent CALIBRATION streams (each --stream-minutes long, "
                        "seed-disjoint from the measurement streams) used only to pick the "
                        "deployed per-head threshold")
    p.add_argument("--eval-only", default=None, metavar="CKPT",
                   help="skip training/mining and re-score this checkpoint (.npz, .pt or .onnx)")
    return p.parse_args(argv)


ADVERSARIAL_SLIDING_PHRASES = [
    "hay bunny",
    "say study",
    "hey bunny",
    "a buddy",
    "hey but",
    "hey budget meeting",
    "good morning",
    "hello there",
    "turn on the lights",
    "play some music",
]


# --- scoring on the device ------------------------------------------------------


@torch.no_grad()
def head_scores(model: Any, features: torch.Tensor) -> torch.Tensor:
    """(n, 16, 96) features on the model's device -> (n,) float32 scores
    there: ``model.device_scores`` where the head has one (the ``.onnx``
    head), else ``model(features)`` (the native heads)."""
    score = getattr(model, "device_scores", None)
    out = score(features) if score is not None else model(features)
    return out.reshape(-1).float()


def host_scores(model: Any, features: np.ndarray, device: DeviceLike = "cuda") -> np.ndarray:
    """Host features -> host (n,) scores, scored on ``device``."""
    x = torch.from_numpy(np.require(features, np.float32, ["C", "W"])).to(resolve_device(device))
    return head_scores(model, x).cpu().numpy()


def _repair_nan(emb: Any, features: torch.Tensor) -> torch.Tensor:
    """``SpeechEmbeddings.__call__(remove_nan=True)``'s repair on device
    features: rows with a NaN replaced by random good rows of the batch, drawn
    from the featurizer's generator (one host copy, only when a row is NaN)."""
    if not bool(torch.isnan(features).any()):
        return features
    repaired = emb._repair_nan(features.cpu().numpy(), emb.generator)
    return torch.from_numpy(repaired).to(features.device)


@torch.no_grad()
def _featurize(emb: Any, audio: torch.Tensor) -> torch.Tensor:
    """(b, t) float32 audio in [-1, 1] on the device -> (b, 16, 96) features
    there, as ``SpeechEmbeddings.__call__`` computes them (int16 scaling, the
    active backend, the NaN repair) without the host round trip."""
    return _repair_nan(emb, emb._featurize(audio * 32767.0))


# --- clips and streams ------------------------------------------------------------


def _pipeline_clips(text: str, n: int, seed: int, device: DeviceLike = "cuda") -> List[np.ndarray]:
    """Render ``text`` through the SAME TTS pipeline training uses (settings
    grid, speaker sampling): direct low-level synthesizer calls produce
    out-of-distribution audio that measures renderer mismatch, not the model."""
    from heybuddy_tpu_torch.data.tts_generator import SpeechSampleGenerator

    gen = SpeechSampleGenerator(
        text, batch_size=min(n, 8), seed=seed, tts_backend="formant", phrase_augment_prob=0.0, device=device,
    )
    clips = []
    for sample in gen(n):
        arr = np.asarray(sample["audio"]["array"], dtype=np.float32)
        if np.abs(arr).max() > 4.0:  # int16-scale PCM
            arr = arr / 32768.0
        clips.append(arr)
    return clips


def _sliding_context(clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Embed a rendered clip in silence at a random stream offset, with
    context on BOTH sides (deployment is a continuous stream): with no
    trailing room, placements in the last ~0.5 s leave fewer than 2 windows
    fully containing the phrase and the consecutive gate CANNOT fire."""
    from heybuddy_tpu_torch.data.streams import RUNTIME_WINDOW_STRIDE

    lead = 2 * 16000
    trail = 24000
    ctx = np.zeros(lead + len(clip) + trail, dtype=np.float32)
    off = int(rng.integers(2 * RUNTIME_WINDOW_STRIDE, lead))
    ctx[off : off + len(clip)] = clip
    return ctx


_STREAM_CACHE_DIR: str = ""


def _stream_content_tag() -> str:
    """Hash of everything that determines stream CONTENT beyond the
    synthesizer versions: the wordlist (speech-stream vocabulary), the
    phonemizer backend, and the adversarial lexicon source. Defaults (simple
    g2p, builtin lexicon) contribute nothing, so the key is the JAX
    package's for the same content."""
    import hashlib

    from heybuddy_tpu_torch.text.phonemizer import get_phonemizer, load_cmudict
    from heybuddy_tpu_torch.text.wordlist import WORDS

    payload = ",".join(sorted(set(WORDS)))
    g2p = getattr(get_phonemizer(), "name", "simple")
    if g2p != "simple":
        payload += f"|g2p:{g2p}"
    if load_cmudict() is not None:
        payload += "|lex:cmu"
    return hashlib.md5(payload.encode()).hexdigest()[:8]


def _cached_stream(kind: str, minutes: float, seed: int, build: Callable[[], np.ndarray]) -> np.ndarray:
    """Disk-cache rendered stream waveforms: host-side synthesis dominates
    multi-hour fp/hour measurement, and the waveforms are embedding-agnostic.
    Keyed on the formant / sampling versions AND the stream-content hash."""
    from heybuddy_tpu_torch.models.formant import FORMANT_VERSION
    from heybuddy_tpu_torch.models.tts import SAMPLING_VERSION

    if not _STREAM_CACHE_DIR:
        return build()
    os.makedirs(_STREAM_CACHE_DIR, exist_ok=True)
    path = os.path.join(
        _STREAM_CACHE_DIR,
        f"{kind}-v{FORMANT_VERSION}.{SAMPLING_VERSION}"
        f"-w{_stream_content_tag()}-{minutes:g}m-{seed}.npy",
    )
    if os.path.exists(path):
        return np.load(path)
    with stage_timer("quality/stream_synthesis"):
        stream = build()
    np.save(path, stream.astype(np.float32))
    return stream


def synth_speech_stream(minutes: float, seed: int, exclude_phrase: str = "",
                        device: DeviceLike = "cuda") -> np.ndarray:
    """Continuous ordinary speech (``data/streams.py``, formant TTS)."""
    from heybuddy_tpu_torch.data.streams import synth_speech_stream as _synth

    return _cached_stream(
        f"speech-x{exclude_phrase.replace(' ', '-')}", minutes, seed,
        lambda: _synth(minutes, seed, exclude_phrase=exclude_phrase, tts_backend="formant", device=device),
    )


def derive_hard_pairs(phrase: str) -> List[str]:
    """The phrase's closest single-word phonetic substitutions, auto-derived:
    for each word, the lexicon neighbors with the highest wildcard-match
    multiplicity (= fewest phone edits) swapped into the phrase."""
    import collections

    from heybuddy_tpu_torch.text.adversarial import get_adversarial_text_generator

    g = get_adversarial_text_generator()
    words = phrase.split()
    pairs = []
    for i, w in enumerate(words):
        counts = collections.Counter(g.adversarial_words(w))
        top = counts.most_common()
        if not top:
            continue
        best = top[0][1]
        closest = [cand for cand, n in top if n == best][:8]
        for cand in closest:
            text = " ".join(words[:i] + [cand] + words[i + 1 :])
            if text != phrase:
                pairs.append(text)
    return sorted(set(pairs))


def synth_adversarial_stream(phrase: str, minutes: float, seed: int, device: DeviceLike = "cuda") -> np.ndarray:
    """Continuous phonetic near-collisions (``data/streams.py``)."""
    from heybuddy_tpu_torch.data.streams import synth_adversarial_stream as _synth

    return _cached_stream(
        f"adv-{phrase.replace(' ', '-')}", minutes, seed,
        lambda: _synth(phrase, minutes, seed, tts_backend="formant", device=device),
    )


def synth_collision_stream(phrase: str, minutes: float, seed: int, device: DeviceLike = "cuda") -> np.ndarray:
    """Near-collision words embedded in word salads (``data/streams.py``)."""
    from heybuddy_tpu_torch.data.streams import synth_collision_salad_stream as _synth

    return _cached_stream(
        f"collision-{phrase.replace(' ', '-')}", minutes, seed,
        lambda: _synth(phrase, minutes, seed, tts_backend="formant", device=device),
    )


@torch.no_grad()
def sliding_features_scores(model: Any, stream: np.ndarray, batch: int = 1024, with_features: bool = True,
                            device: DeviceLike = "cuda") -> Tuple[Optional[np.ndarray], np.ndarray]:
    """(features, scores) for every sliding window position over the stream,
    with the runtime's window geometry (``data/streams.py``). Each segment of
    up to ``batch`` (at most ``STREAM_SEGMENT_WINDOWS``) windows is uploaded
    once and featurized as a row-strided view (K1 -> K2), NaN rows repaired
    as ``SpeechEmbeddings.__call__`` repairs them, and scored on the device;
    the scores come to the host once. ``with_features=True`` also copies the
    (16, 96) inputs to the host, so mining can reuse the exact features the
    classifier saw."""
    from heybuddy_tpu_torch.data.streams import RUNTIME_WINDOW_STRIDE, stream_window_count
    from heybuddy_tpu_torch.models.featurizer import STREAM_SEGMENT_WINDOWS, get_speech_embeddings

    dev = resolve_device(device)
    emb = get_speech_embeddings(device=dev)
    n = stream_window_count(stream)
    step = max(1, min(batch, STREAM_SEGMENT_WINDOWS))
    feats = np.zeros((n, 16, 96), dtype=np.float32) if with_features else None
    scores = torch.zeros(n, dtype=torch.float32, device=dev)
    for i in range(0, n, step):
        f, count = emb.featurize_stream_device(stream[i * RUNTIME_WINDOW_STRIDE :], min(step, n - i),
                                               RUNTIME_WINDOW_STRIDE)
        f = _repair_nan(emb, f)
        if feats is not None:
            feats[i : i + count] = f.cpu().numpy()
        scores[i : i + count] = head_scores(model, f)
    return feats, scores.cpu().numpy()


def sliding_scores(model: Any, stream: np.ndarray, batch: int = 1024, device: DeviceLike = "cuda") -> np.ndarray:
    """Classifier score for every sliding window position over the stream."""
    return sliding_features_scores(model, stream, batch, with_features=False, device=device)[1]


# --- statistics and thresholds ----------------------------------------------------------


def operating_threshold(score_runs: Any, hours: float, target_per_hour: float = 1.5,
                        consecutive: int = 1) -> float:
    """Smallest grid threshold whose debounced detection rate meets the
    operating target (1.5 false wakes/hour), aggregated over ALL independent
    stream runs (``hours`` is their total). The grid extends into the
    sigmoid-saturated tail (0.995-0.9999)."""
    if isinstance(score_runs, np.ndarray):
        score_runs = [score_runs]
    grid = np.concatenate(
        [np.arange(0.5, 1.0, 0.01), [0.995, 0.998, 0.999, 0.9995, 0.9999]]
    )
    for thr in grid:
        rate = sum(
            count_detections(s, float(thr), consecutive=consecutive)
            for s in score_runs
        )
        if rate / max(hours, 1e-9) <= target_per_hour:
            # np.arange grid values carry float noise (0.5700000000000003);
            # round so results JSON records clean thresholds.
            return float(round(thr, 4))
    return 1.0


def count_detections(scores: np.ndarray, threshold: float, consecutive: int = 1,
                     debounce_windows: int = 16) -> int:
    """Hits with the runtime's gate (refractory ~1.92 s debounce, optional
    consecutive-window requirement: ``runtime/detection.py``)."""
    from heybuddy_tpu_torch.runtime.detection import count_detections as _count

    return _count(scores, threshold, consecutive=consecutive, debounce_windows=debounce_windows)


def wilson_interval(k: int, n: int, z: float = 1.96) -> List[float]:
    """95% Wilson score interval for a binomial rate ``k/n``."""
    if n <= 0:
        return [0.0, 1.0]
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return [round(float(max(center - half, 0.0)), 4),
            round(float(min(center + half, 1.0)), 4)]


def poisson_rate_interval(k: int, hours: float) -> List[float]:
    """Exact (Garwood) 95% CI for a Poisson rate: ``k`` events / ``hours``;
    a sampling-noise floor (between-run spread is in the per-run rates)."""
    from scipy.stats import chi2

    if hours <= 0:
        return [0.0, float("inf")]
    lo = 0.0 if k == 0 else float(chi2.ppf(0.025, 2 * k) / 2.0)
    hi = float(chi2.ppf(0.975, 2 * k + 2) / 2.0)
    return [round(lo / hours, 3), round(hi / hours, 3)]


def selection_key(det2: int, sel_hours: float, sel_far: float, sel_frr_off: float,
                  sel_recall: float = 1.0) -> tuple:
    """Rank a selection candidate; lower tuples win. Returns ``(key_tuple,
    fp2, fp2_upper, penalty)``: recall gates first, then the FAR target, then
    a penalty on the ~97.5% Poisson upper bound of the gated rate (short
    selection streams cannot resolve rates near 1.5/hr), then FAR + 0.1 fp2."""
    fp2 = det2 / sel_hours
    fp2_upper = float((det2 + 1.96 * np.sqrt(det2) + 3.0) / sel_hours)
    pen = (
        max(0.0, sel_far - 0.05) * 20.0
        + max(0.0, sel_frr_off - 0.05) * 20.0
        + max(0.0, fp2_upper - 1.5)
    )
    key = (
        0 if sel_recall >= 1.0 else 1,
        0 if sel_far <= 0.05 else 1,
        pen,
        sel_far + 0.1 * fp2,
    )
    return key, fp2, fp2_upper, pen


def operating_point_warnings(threshold: float, frr: float, hours: float,
                             target_per_hour: float = 1.5) -> List[str]:
    """Degeneracy checks for a calibrated / operating threshold block: too
    few stream-hours to resolve the target, a threshold at the grid ceiling,
    an FRR that puts the threshold above the positive score mass. Empty
    means the block is interpretable."""
    warnings = []
    if hours * target_per_hour < 1.0:
        warnings.append(
            f"{hours:g} stream-hours cannot resolve {target_per_hour:g}/hr "
            f"(need >= {1.0 / target_per_hour:.2f} h for one expected event)"
        )
    if threshold >= 0.9999:
        warnings.append(
            f"threshold {threshold:g} is at the grid ceiling: no threshold "
            "met the target rate on these streams; metrics at this "
            "threshold are degenerate"
        )
    if frr >= 0.99:
        warnings.append(
            f"FRR {frr:g} at this threshold: the threshold sits above the "
            "positive score mass; recall metrics are meaningless here"
        )
    return warnings


THRESHOLD_CURVE = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.98, 0.99)


def targets(sliding_recall_c2: float, far_adversarial: float, frr_clean: float, frr_clean_offset: float,
            fp_per_hour_c2: float) -> Dict[str, bool]:
    """The five targets, all at one operating point."""
    return {
        "sliding_recall_c2>=0.95": sliding_recall_c2 >= 0.95,
        "far_adversarial<=0.05": far_adversarial <= 0.05,
        "frr_clean<=0.05": frr_clean <= 0.05,
        "frr_clean_offset<=0.05": frr_clean_offset <= 0.05,
        "fp_per_hour_c2<=1.5": fp_per_hour_c2 <= 1.5,
    }


def threshold_curve(adv_scores: np.ndarray, speech_scores: np.ndarray, clean_scores: np.ndarray,
                    clean_offset_scores: np.ndarray, phrase_runs: List[np.ndarray], score_runs: List[np.ndarray],
                    hours: float) -> Tuple[List[Dict[str, float]], List[Dict[str, float]]]:
    """Every headline metric at a grid of thresholds from the score arrays in
    memory, and the points that pass all five targets."""
    curve = []
    for t in THRESHOLD_CURVE:
        t_recall_counts = [int(count_detections(s, t, consecutive=2) > 0) for s in phrase_runs]
        t_fp_counts = [int(count_detections(s, t, consecutive=2)) for s in score_runs]
        curve.append({
            "threshold": t,
            "far_adversarial": round(float(np.mean(adv_scores >= t)), 4),
            "far_speech": round(float(np.mean(speech_scores >= t)), 4),
            "frr_clean": round(float(np.mean(clean_scores < t)), 4),
            "frr_clean_offset": round(float(np.mean(clean_offset_scores < t)), 4),
            "sliding_recall_c2": round(float(np.mean(t_recall_counts)), 4),
            "fp_per_hour_c2": round(sum(t_fp_counts) / max(hours, 1e-9), 3),
        })
    passing = [
        c for c in curve
        if c["sliding_recall_c2"] >= 0.95 and c["far_adversarial"] <= 0.05
        and c["frr_clean"] <= 0.05 and c["frr_clean_offset"] <= 0.05
        and c["fp_per_hour_c2"] <= 1.5
    ]
    return curve, passing


def headline_intervals(thr: float, adv_scores: np.ndarray, speech_scores: np.ndarray, clean_scores: np.ndarray,
                       clean_offset_scores: np.ndarray, recall_k: int, recall_n: int, det_c2_total: int,
                       hours: float) -> Dict[str, Any]:
    """95% intervals for every headline rate, with their sample sizes."""
    return {
        "far_adversarial": wilson_interval(int((adv_scores >= thr).sum()), len(adv_scores)),
        "far_speech": wilson_interval(int((speech_scores >= thr).sum()), len(speech_scores)),
        "frr_clean": wilson_interval(int((clean_scores < thr).sum()), len(clean_scores)),
        "frr_clean_offset": wilson_interval(int((clean_offset_scores < thr).sum()), len(clean_offset_scores)),
        "sliding_recall_c2": wilson_interval(recall_k, recall_n),
        "fp_per_hour_consecutive2": poisson_rate_interval(det_c2_total, hours),
        "n": {
            "adversarial": len(adv_scores),
            "speech": len(speech_scores),
            "clean": len(clean_scores),
            "clean_offset": len(clean_offset_scores),
            "sliding_renderings": recall_n,
            "stream_detections_c2": det_c2_total,
            "stream_hours": round(hours, 2),
        },
        "basis": "Wilson 95% (rates) / Garwood 95% (fp per hour)",
    }


def calibrated_block(cal_runs: List[np.ndarray], cal_hours: float, thr: float, phrase: str,
                     score_runs: List[np.ndarray], run_hours: float, hours: float,
                     sliding_runs: Dict[str, List[np.ndarray]], adv_scores: np.ndarray,
                     clean_scores: np.ndarray, clean_offset_scores: np.ndarray) -> Dict[str, Any]:
    """The c2 threshold calibrated on the calibration streams (never below
    ``thr``), and every target re-evaluated there on the held-out data."""
    cal_thr = operating_threshold(cal_runs, cal_hours, consecutive=2)
    cal_thr = max(cal_thr, thr)
    cal_fp_c2_counts = [int(count_detections(s, cal_thr, consecutive=2)) for s in score_runs]
    cal_fp_c2_runs = [d / max(run_hours, 1e-9) for d in cal_fp_c2_counts]
    cal_recall_runs = [
        float(np.mean([int(count_detections(s, cal_thr, consecutive=2) > 0) for s in sliding_runs[text]]))
        for text in sliding_runs
    ]
    cal_sliding_c2 = dict(zip(sliding_runs.keys(), [round(v, 3) for v in cal_recall_runs]))
    cal_recall = cal_sliding_c2[phrase]
    cal_far_adv = float(np.mean(adv_scores >= cal_thr))
    cal_frr_clean = float(np.mean(clean_scores < cal_thr))
    cal_frr_clean_offset = float(np.mean(clean_offset_scores < cal_thr))
    cal_fp_per_hour_c2 = float(np.mean(cal_fp_c2_runs))
    cal_targets = targets(cal_recall, cal_far_adv, cal_frr_clean, cal_frr_clean_offset, cal_fp_per_hour_c2)
    cal_warnings = operating_point_warnings(cal_thr, cal_frr_clean, cal_hours)
    return {
        "threshold": cal_thr,
        "calibration_hours": round(cal_hours, 2),
        "warnings": cal_warnings,
        "degenerate": bool(cal_warnings),
        "fp_per_hour_c2": round(cal_fp_per_hour_c2, 3),
        "fp_per_hour_runs_c2": [round(v, 2) for v in cal_fp_c2_runs],
        "sliding_recall_c2": cal_recall,
        "sliding_consecutive2_fire_rate": cal_sliding_c2,
        "far_adversarial": round(cal_far_adv, 4),
        "frr_clean": round(cal_frr_clean, 4),
        "frr_clean_offset": round(cal_frr_clean_offset, 4),
        "targets_met": cal_targets,
        "all_targets_met": all(cal_targets.values()),
        "intervals": {
            "far_adversarial": wilson_interval(int((adv_scores >= cal_thr).sum()), len(adv_scores)),
            "frr_clean": wilson_interval(int((clean_scores < cal_thr).sum()), len(clean_scores)),
            "sliding_recall_c2": wilson_interval(
                int(sum(int(count_detections(s, cal_thr, consecutive=2) > 0) for s in sliding_runs[phrase])),
                len(sliding_runs[phrase]),
            ),
            "fp_per_hour_c2": poisson_rate_interval(sum(cal_fp_c2_counts), hours),
        },
    }


# --- the bucket analyses --------------------------------------------------------------


_BUCKETS = [(-10, -5), (-5, 0), (0, 5), (5, 10), (10, 20)]


def _padded(clips: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Clips left-aligned in a (b, CLIP_SAMPLES) batch and their lengths."""
    from heybuddy_tpu_torch.constants import CLIP_SAMPLES

    audio = np.zeros((len(clips), CLIP_SAMPLES), dtype=np.float32)
    lengths = np.zeros((len(clips),), dtype=np.int32)
    for i, c in enumerate(clips):
        n = min(len(c), CLIP_SAMPLES)
        audio[i, :n] = c[:n]
        lengths[i] = n
    return audio, lengths


def _bucket_rates(model: Any, clips: List[np.ndarray], seed: int, thr: float, key_offset: int,
                  fire: bool, device: torch.device) -> Dict[str, float]:
    """The clips augmented at each pinned SNR bucket, without and with
    reverb (no other distortion), featurized and scored on the device: the
    share below ``thr`` (``fire=False``) or at or above it (``fire=True``).
    The draws come from ``seeded_generator(device, seed + 7 lo + reverb +
    key_offset)``, the integers of JAX's keys."""
    from heybuddy_tpu_torch.data.augmented import NoiseProvider
    from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings
    from heybuddy_tpu_torch.ops.augment import AugmentConfig, augment_batch, seeded_generator

    audio, lengths = _padded(clips)
    provider = NoiseProvider(seed=seed, use_remote=True)
    noise = provider.noise_batch(len(clips))
    impulse = provider.impulse_batch(len(clips))
    emb = get_speech_embeddings(device=device)
    audio_t, lengths_t = torch.from_numpy(audio).to(device), torch.from_numpy(lengths).to(device)
    noise_t, impulse_t = torch.from_numpy(noise).to(device), torch.from_numpy(impulse).to(device)
    out = {}
    for reverb in (0.0, 1.0):
        for lo, hi in _BUCKETS:
            cfg = AugmentConfig(
                background_noise_prob=1.0,
                background_noise_min_snr_db=float(lo),
                background_noise_max_snr_db=float(hi),
                reverb_prob=reverb,
                # isolate the SNR/reverb axes: no EQ/distortion/pitch draws
                seven_band_prob=0.0, tanh_distortion_prob=0.0,
                pitch_shift_prob=0.0, band_stop_prob=0.0,
                colored_noise_prob=0.0, gain_prob=0.0,
            )
            generator = seeded_generator(device, seed + 7 * lo + int(reverb) + key_offset)
            aug = augment_batch(audio_t, lengths_t, noise_t, impulse_t, cfg, generator=generator)
            scores = head_scores(model, _featurize(emb, aug)).cpu().numpy()
            tag = f"snr[{lo},{hi})dB" + ("+reverb" if reverb else "")
            out[tag] = round(float(np.mean(scores >= thr if fire else scores < thr)), 3)
    return out


def frr_by_snr_buckets(model: Any, phrase: str, seed: int, thr: float, n_clips: int = 48,
                       device: DeviceLike = "cuda") -> Dict[str, float]:
    """FRR on positives augmented at PINNED background-noise SNR buckets, with
    and without reverb: whether the misses concentrate in the low-SNR tail."""
    clips = _pipeline_clips(phrase, n_clips, seed=seed + 901, device=device)
    return _bucket_rates(model, clips, seed, thr, 0, False, resolve_device(device))


def far_by_snr_buckets(model: Any, phrase: str, seed: int, thr: float, n_clips: int = 48,
                       device: DeviceLike = "cuda") -> Dict[str, float]:
    """FAR on SWAP-COLLISION texts (the seed-31337 unseen swap family, depth
    <= 2, disjoint from every training pool) augmented at PINNED SNR buckets:
    where the false accepts live on the SNR / reverb axes."""
    from heybuddy_tpu_torch.text.adversarial import single_swap_collision_texts

    swaps = single_swap_collision_texts(phrase, num_samples=12, seed=31337, max_swaps=2)
    per_text = max(n_clips // max(len(swaps), 1), 1)
    clips: List[np.ndarray] = []
    for j, text in enumerate(swaps):
        clips.extend(_pipeline_clips(text, per_text, seed=seed + 903 + 13 * j, device=device))
    return _bucket_rates(model, clips, seed, thr, 31, True, resolve_device(device))


def far_attribution(model: Any, texts: List[str], seed: int, thr: float, per_text: int = 24,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Per-text FAR over fresh augmented renderings of each adversarial text:
    WHICH texts carry the tail. Each text's batch takes the DEFAULT augment
    chain with its own draw (``seeded_generator(device, seed + 31 t_i)``)."""
    from heybuddy_tpu_torch.data.augmented import NoiseProvider
    from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings
    from heybuddy_tpu_torch.ops.augment import AugmentConfig, augment_batch, seeded_generator

    dev = resolve_device(device)
    emb = get_speech_embeddings(device=dev)
    provider = NoiseProvider(seed=seed + 3, use_remote=True)
    cfg = AugmentConfig()
    rates = {}
    for t_i, text in enumerate(sorted(texts)):
        clips = _pipeline_clips(text, per_text, seed=seed + 977 * t_i + 5, device=dev)
        audio, lengths = _padded(clips)
        noise = provider.noise_batch(len(clips))
        impulse = provider.impulse_batch(len(clips))
        aug = augment_batch(
            torch.from_numpy(audio).to(dev), torch.from_numpy(lengths).to(dev), torch.from_numpy(noise).to(dev),
            torch.from_numpy(impulse).to(dev), cfg, generator=seeded_generator(dev, seed + 31 * t_i),
        )
        scores = head_scores(model, _featurize(emb, aug)).cpu().numpy()
        rates[text] = round(float(np.mean(scores >= thr)), 4)
    ranked = sorted(rates.items(), key=lambda kv: -kv[1])
    firing = [(t, r) for t, r in ranked if r > 0]
    top5 = sum(r for _, r in ranked[:5])
    total = sum(r for _, r in ranked)
    return {
        "per_text_renderings": per_text,
        "texts": len(ranked),
        "texts_firing": len(firing),
        "top5_share": round(top5 / total, 3) if total else None,
        "profile": (
            "SPECIFIC" if total and top5 / total > 0.5 else "DIFFUSE"
        ),
        "rates": dict(ranked[:20]),
    }


# --- the harness -------------------------------------------------------------------------


def _load_head(path: str, device: torch.device) -> Any:
    """An ``.onnx`` head (``WakeWordONNXModel``), a reference ``.pt`` or a checkpoint npz, on ``device``."""
    if path.endswith(".onnx"):
        # deployed artifacts (browser/models/hey-buddy.onnx) exist only as ONNX
        from heybuddy_tpu_torch.runtime.onnx_model import WakeWordONNXModel

        return WakeWordONNXModel(path, device=device)
    if path.endswith(".pt"):
        from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel

        return WakeWordMLPModel.from_torch_file(path, device=device)
    from heybuddy_tpu_torch.models.wakeword import load_model

    return load_model(path, device=device)


def _apply_quick(args: argparse.Namespace) -> None:
    args.train_samples = 24
    args.heldout_samples = 12
    args.partial_samples = 12
    args.stream_samples = 12
    args.val_stream_samples = 24
    args.steps = 40
    args.stream_minutes = min(args.stream_minutes, 1.0)
    args.stream_seeds = min(args.stream_seeds, 2)
    args.sliding_clips = min(args.sliding_clips, 6)
    args.no_snr_buckets = True
    args.mine_rounds = min(args.mine_rounds, 1)
    args.select_stream_minutes = min(args.select_stream_minutes, 1.0)
    args.select_adversarial_samples = min(args.select_adversarial_samples, 12)
    args.calibration_seeds = min(args.calibration_seeds, 1)
    args.mine_adversarial_clips = min(args.mine_adversarial_clips, 12)
    args.reverb_positives = min(args.reverb_positives, 12)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.embedding:
        os.environ["HEYBUDDY_EMBEDDING_WEIGHTS"] = os.path.abspath(args.embedding)
    os.environ.setdefault("HEYBUDDY_OFFLINE", "1")
    device = resolve_device("cpu" if args.cpu else args.device)

    from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
    from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator
    from heybuddy_tpu_torch.data.training import WakeWordTrainingDatasetIterator
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer
    from heybuddy_tpu_torch.utils.log import logger

    if args.quick:
        _apply_quick(args)

    # Rendered streams are embedding-agnostic waveforms: cache them in the
    # shared cache so multi-hour fp/hour costs synthesis once per seed ever.
    global _STREAM_CACHE_DIR
    try:
        from heybuddy_tpu_torch.utils.downloads import get_cache_dir

        _STREAM_CACHE_DIR = get_cache_dir("quality-streams")
    except OSError:
        _STREAM_CACHE_DIR = ""

    def speech_stream(minutes: float, seed: int) -> np.ndarray:
        return synth_speech_stream(minutes, seed=seed, exclude_phrase=args.phrase, device=device)

    def scores_of(model: Any, stream: np.ndarray) -> np.ndarray:
        return sliding_scores(model, stream, device=device)

    def stream_scores(model: Any, seed: int) -> np.ndarray:
        """A measurement or calibration stream's scores (synthesis, or the cache, untimed)."""
        stream = speech_stream(args.stream_minutes, seed)
        with stage_timer("quality/stream_scoring"):
            return scores_of(model, stream)

    dataset_dir = args.dataset_dir or tempfile.mkdtemp(prefix="quality-eval-")
    ckpt_dir = args.checkpoint_dir or os.path.join(dataset_dir, "ckpt")
    t0 = time.time()

    gen_kwargs: Dict[str, Any] = dict(directory=dataset_dir, tts_backend="formant", seed=args.seed, device=device)
    hard_texts: List[str] = []
    if args.hard_pair_boost > 0:
        hard_texts = derive_hard_pairs(args.phrase) * args.hard_pair_boost
        logger.info(
            f"hard-pair boost: {len(set(hard_texts))} phrases x {args.hard_pair_boost} = "
            f"{len(hard_texts)} pool entries: {sorted(set(hard_texts))}"
        )
    if args.prefix_negatives > 0:
        from heybuddy_tpu_torch.text.adversarial import prefix_negative_texts

        prefix_texts = prefix_negative_texts(args.phrase, num_samples=args.prefix_negatives, seed=args.seed)
        logger.info(f"prefix negatives: {len(prefix_texts)} texts (deepest: {prefix_texts[:4]})")
        hard_texts = hard_texts + prefix_texts
    collision_texts: List[str] = []
    if args.collision_negatives > 0:
        from heybuddy_tpu_torch.text.adversarial import single_swap_collision_texts

        # the held-out pool's exact texts (sidecar, or derived pre-cache): the
        # emphasis class transfers, the literal measured strings must not be
        # trained on
        heldout_pool = TrainingFeaturesGenerator(args.phrase, **gen_kwargs).adversarial_texts(
            testing=True, adversarial_phrases=60)
        collision_texts = single_swap_collision_texts(
            args.phrase, num_samples=args.collision_negatives, seed=args.seed, exclude=heldout_pool,
            max_swaps=args.collision_swap_depth,
        )
        logger.info(
            f"swap-collision negatives (depth<={args.collision_swap_depth}): {len(collision_texts)} texts "
            f"(held-out pool excluded: {len(heldout_pool)} texts), e.g. {collision_texts[:6]}"
        )
        hard_texts = hard_texts + collision_texts
    if args.reverb_collisions > 0 and not collision_texts:
        # the emphasis pool with the same held-out exclusion
        from heybuddy_tpu_torch.text.adversarial import single_swap_collision_texts

        heldout_pool = TrainingFeaturesGenerator(args.phrase, **gen_kwargs).adversarial_texts(
            testing=True, adversarial_phrases=60)
        collision_texts = single_swap_collision_texts(
            args.phrase, num_samples=max(args.collision_negatives, 48), seed=args.seed, exclude=heldout_pool,
            max_swaps=args.collision_swap_depth,
        )
    train_gen_kwargs = dict(gen_kwargs)
    if hard_texts:
        train_gen_kwargs["custom_adversarial_texts"] = hard_texts
    gen = TrainingFeaturesGenerator(args.phrase, **train_gen_kwargs)
    # held-out / report pools stay free of the boosted pairs
    gen_heldout = TrainingFeaturesGenerator(args.phrase, **gen_kwargs) if hard_texts else gen
    train_adv_pool = args.adversarial_phrases + len(hard_texts)

    if not args.eval_only:
        logger.info("=== generating training features ===")
        pos_train = gen.get_training_features(args.train_samples, adversarial=False)
        adv_train = gen.get_training_features(
            args.train_samples, adversarial=True, adversarial_phrases=args.adversarial_phrases)
        partial_train = (gen.get_partial_phrase_features(args.partial_samples)
                         if args.partial_samples > 0 else None)
        partial_adv_train = (
            gen.get_partial_phrase_features(args.partial_samples, adversarial=True,
                                            adversarial_phrases=train_adv_pool)
            if args.partial_samples > 0 else None
        )
        speech_train = gen.get_negative_speech_features(args.train_samples, num_texts=400, seed=args.seed)
        stream_train = (gen.get_stream_window_features(args.stream_samples, seed=args.seed)
                        if args.stream_samples > 0 else None)
        stream_adv_train = (
            gen.get_stream_window_features(max(args.stream_samples // 2, 1), adversarial=True, seed=args.seed)
            if args.stream_samples > 0 else None
        )
        stream_collision_train = (
            gen.get_stream_window_features(max(args.stream_samples // 2, 1), collision=True, seed=args.seed)
            if args.stream_samples > 0 and args.collision_streams else None
        )

    logger.info("=== generating held-out features ===")
    with stage_timer("quality/heldout"):
        pos_test = gen.get_training_features(args.heldout_samples, adversarial=False, testing=True)
        adv_test = gen_heldout.get_training_features(
            args.heldout_samples, adversarial=True, adversarial_phrases=60, testing=True)
        speech_test = gen.get_negative_speech_features(args.heldout_samples, num_texts=200, seed=args.seed + 77)
    val_pos = val_clean_offset = None
    if not args.eval_only:
        # clean (pad-only) positives, clean positives at random window offsets
        # and the symmetric clean near-collisions at random offsets, as
        # training coverage
        clean_train = gen.get_validation_features(max(args.train_samples // 4, 1))
        clean_offset_train = gen.get_clean_offset_features(max(args.train_samples // 4, 1))
        clean_offset_adv_train = gen.get_clean_offset_features(
            max(args.train_samples // 4, 1), adversarial=True, adversarial_phrases=train_adv_pool)
        reverb_train = (gen.get_reverb_positive_features(args.reverb_positives)
                        if args.reverb_positives > 0 else None)
        reverb_collision_train = (
            gen.get_reverb_collision_features(args.reverb_collisions, collision_texts)
            if args.reverb_collisions > 0 else None
        )
        # the negative-weight controller's validation sets: disjoint pad-only
        # and clean-offset positives (testing caches), a fresh stream seed
        val_pos = gen.get_validation_features(args.heldout_samples, testing=True)
        val_clean_offset = gen.get_clean_offset_features(args.heldout_samples, testing=True)
    # REPORTING sets, disjoint from training coverage and from the controller's
    # validation sets (fresh seed, a cache directory of their own)
    report_gen = TrainingFeaturesGenerator(
        args.phrase, directory=os.path.join(dataset_dir, "report"), tts_backend="formant",
        seed=args.seed + 50021, device=device,
    )
    with stage_timer("quality/heldout"):
        report_clean = report_gen.get_validation_features(args.heldout_samples, testing=True)
        report_clean_offset = report_gen.get_clean_offset_features(args.heldout_samples, testing=True)
    val_stream = (
        gen.get_stream_window_features(args.val_stream_samples, seed=args.seed + 999)
        if args.val_stream_samples > 0 and not args.eval_only else None
    )

    bs = max(4, min(25, args.train_samples // 8))

    def train_model(mined: list, label: str, seed_offset: int = 0) -> Any:
        negative_specs = [(adv_train, bs), (clean_offset_adv_train, max(bs // 2, 1))]
        if partial_train is not None:
            negative_specs.append((partial_train, bs))
            negative_specs.append((partial_adv_train, bs))
        negative_specs.append((speech_train, bs))
        if reverb_collision_train is not None:
            negative_specs.append((reverb_collision_train, max(bs // 2, 1)))
        if stream_train is not None:
            negative_specs.append((stream_train, bs))
            negative_specs.append((stream_adv_train, bs))
            if stream_collision_train is not None:
                negative_specs.append((stream_collision_train, bs))
        if mined:
            mined_arr = np.concatenate(mined).astype(np.float32)
            negative_specs.append((PrecalculatedDatasetIterator("mined", data=mined_arr, seed=args.seed), bs))
            logger.info(f"training with {len(mined_arr)} mined hard negatives")
        positive_specs = [
            (pos_train, 2 * bs),
            (clean_train, max(bs // 2, 1)),
            (clean_offset_train, max(bs // 2, 1)),
        ]
        if reverb_train is not None:
            positive_specs.append((reverb_train, max(bs // 2, 1)))
        training = WakeWordTrainingDatasetIterator(
            num_batch_threads=1, positive=positive_specs, negative=negative_specs)
        # validation = pad-only positives + FRESH stream windows, driving the
        # trainer's dynamic negative-weight controller
        validation = None
        if val_pos is not None and val_stream is not None:
            val_bs = max(len(val_stream) // 8, 1)
            val_pos_bs = max(args.heldout_samples // 16, 1)
            validation = WakeWordTrainingDatasetIterator(
                num_batch_threads=1,
                positive=[(val_pos, val_pos_bs), (val_clean_offset, val_pos_bs)],
                negative=[(val_stream, val_bs)],
            )
            validation.max_samples = 8
        logger.info(f"=== training classifier ({label}) ===")
        trainer = WakeWordTrainer(
            checkpoint_dir=ckpt_dir, seed=args.seed + seed_offset, num_layers=args.layers,
            layer_dim=args.layer_dim, device=device,
        )
        history = trainer.train_epoch(
            training,
            validation=validation,
            num_steps=args.steps,
            validation_steps=max(args.steps // 8, 50),
            negative_weight_schedule=(1.0 if args.fixed_negative_weight is None else args.fixed_negative_weight),
            negative_weight_adjust_ratio=(
                2.0 if validation is not None and args.fixed_negative_weight is None else None
            ),
            validation_gate_consecutive=args.validation_consecutive,
            checkpoint_steps=args.steps + 1,
            logging_steps=max(args.steps // 10, 1),
            name="quality-eval",
        )
        if validation is not None:
            vfp = history["validation_false_positive_per_hour"]
            nw = history["negative_weight"]
            logger.info(
                f"validation fp/hr trajectory: {[round(float(v), 1) for v in vfp[-5:]]}; "
                f"final negative weight {float(nw[-1]):.1f}"
            )
            validation.stop()
        training.stop()
        return trainer

    mined: list = []
    selection = None
    if args.eval_only:
        final = os.path.abspath(args.eval_only)
        model = _load_head(final, device)
        logger.info(f"=== eval-only: re-scoring {final} ===")
    else:
        # --- hard-negative mining rounds: train, stream ordinary speech and
        # adversarial phrases through the sliding runtime, harvest every
        # window scoring above the mining floor as a negative, retrain
        mine_minutes = max(args.stream_minutes / 4.0, 1.0)

        def train_and_mine(cand: int) -> Tuple[Any, list]:
            """One full train + mine candidate; seeds vary per candidate."""
            cand_mined: list = []
            seed_offset = 7919 * cand
            tr = train_model(cand_mined, f"round 0 (cand {cand})", seed_offset)
            for r in range(args.mine_rounds):
                cand_model = tr.model
                mine_streams = [
                    speech_stream(mine_minutes, args.seed + 100 + r + 100000 * cand),
                    synth_adversarial_stream(args.phrase, max(mine_minutes / 2.0, 1.0),
                                             seed=args.seed + 200 + r + 100000 * cand, device=device),
                ]
                if args.collision_streams:
                    mine_streams.append(synth_collision_stream(
                        args.phrase, max(mine_minutes / 2.0, 1.0), seed=args.seed + 300 + r + 100000 * cand,
                        device=device))
                new_mined = 0
                for stream in mine_streams:
                    feats, scores = sliding_features_scores(cand_model, stream, device=device)
                    hard = feats[scores >= args.mine_floor]
                    new_mined += len(hard)
                    if len(hard):
                        cand_mined.append(hard)
                clip_mined = 0
                if args.mine_adversarial_clips > 0:
                    # clip-metric mining: a fresh adversarial clip pool each
                    # round, high scorers harvested
                    mine_gen = TrainingFeaturesGenerator(
                        args.phrase, directory=os.path.join(dataset_dir, f"mine-adv-{cand}-{r}"),
                        tts_backend="formant", seed=args.seed + 900_000 + 100_000 * cand + 1_000 * r,
                        custom_adversarial_texts=(collision_texts or None), device=device,
                    )
                    mine_iter = mine_gen.get_training_features(
                        args.mine_adversarial_clips, adversarial=True,
                        adversarial_phrases=60 + len(collision_texts))
                    mine_feats = np.asarray(mine_iter.precalculated[:], dtype=np.float32)
                    mine_scores = host_scores(cand_model, mine_feats, device)
                    hard = mine_feats[mine_scores >= args.mine_floor]
                    clip_mined = len(hard)
                    new_mined += clip_mined
                    if clip_mined:
                        cand_mined.append(hard)
                logger.info(f"mining round {r + 1}: {new_mined} hard negatives harvested "
                            f"({clip_mined} adversarial clips)")
                if new_mined == 0:
                    break
                tr = train_model(cand_mined, f"round {r + 1} (cand {cand})", seed_offset)
            return tr, cand_mined

        if args.select_runs > 1:
            # train-K-select-on-validation: every candidate scored on
            # SELECTION data disjoint from the report sets
            sel_stream = speech_stream(args.select_stream_minutes, args.seed + 424243)
            sel_hours = max(args.select_stream_minutes / 60.0, 1e-9)
            select_gen = TrainingFeaturesGenerator(
                args.phrase, directory=os.path.join(dataset_dir, "select"), tts_backend="formant",
                seed=args.seed + 60013, device=device,
            )
            sel_adv = select_gen.get_training_features(
                args.select_adversarial_samples, adversarial=True, adversarial_phrases=60, testing=True)
            sel_adv_feats = np.asarray(sel_adv.precalculated[:], dtype=np.float32)
            sel_off_feats = np.asarray(val_clean_offset.precalculated[:], dtype=np.float32)
            # selection-time recall: sliding renderings of the phrase itself
            sel_rng = np.random.default_rng(args.seed + 515151)
            sel_pos_ctx = [
                _sliding_context(clip, sel_rng)
                for clip in _pipeline_clips(args.phrase, 12, seed=args.seed + 515151, device=device)
            ]
            selection = []
            best = None
            all_mined: list = []

            def score_candidate(label: object, tr_c: Any) -> tuple:
                model_c = tr_c.model
                det2 = count_detections(scores_of(model_c, sel_stream), args.threshold, consecutive=2)
                sel_far = float(np.mean(host_scores(model_c, sel_adv_feats, device) >= args.threshold))
                sel_frr_off = float(np.mean(host_scores(model_c, sel_off_feats, device) < args.threshold))
                sel_recall = float(np.mean([
                    int(count_detections(scores_of(model_c, ctx), args.threshold, consecutive=2) > 0)
                    for ctx in sel_pos_ctx
                ])) if sel_pos_ctx else 1.0
                key, fp2, fp2_upper, pen = selection_key(det2, sel_hours, sel_far, sel_frr_off, sel_recall)
                entry = {
                    "candidate": label,
                    "sel_fp_per_hour_c2": round(fp2, 3),
                    "sel_fp_per_hour_c2_upper": round(fp2_upper, 3),
                    "sel_far_adversarial": round(sel_far, 4),
                    "sel_frr_clean_offset": round(sel_frr_off, 4),
                    "sel_recall_c2": round(sel_recall, 4),
                    "penalty": round(pen, 4),
                }
                selection.append(entry)
                logger.info(f"selection: {entry}")
                return key, entry

            for cand in range(args.select_runs):
                tr_c, mined_c = train_and_mine(cand)
                all_mined.extend(mined_c)
                key, _ = score_candidate(cand, tr_c)
                if best is None or key < best[0]:
                    best = (key, cand, tr_c, mined_c)
            assert best is not None
            if args.select_consolidate and args.select_runs > 1:
                # consolidation: one more train on the UNION of every
                # candidate's mined hard negatives, competing on the same data
                tr_u = train_model(all_mined, f"consolidated (union of {args.select_runs} minings)",
                                   7919 * best[1])
                key, _ = score_candidate("consolidated", tr_u)
                if key < best[0]:
                    best = (key, "consolidated", tr_u, all_mined)
            _, sel_cand, trainer, mined = best
            for e in selection:
                e["selected"] = e["candidate"] == sel_cand
            logger.info(f"selected candidate {sel_cand} of {args.select_runs} "
                        "(held-out reporting uses only the winner)")
        else:
            trainer, mined = train_and_mine(0)
            selection = None

        trainer.save_checkpoint("quality-eval_final")
        final = os.path.join(ckpt_dir, "quality-eval_final.npz")
        model = trainer.model

    def class_scores(iterator: Any) -> np.ndarray:
        return host_scores(model, np.asarray(iterator.precalculated[:], dtype=np.float32), device)

    def stats(scores: np.ndarray) -> Dict[str, float]:
        return {
            "mean": round(float(scores.mean()), 4),
            "p10": round(float(np.percentile(scores, 10)), 4),
            "p50": round(float(np.percentile(scores, 50)), 4),
            "p90": round(float(np.percentile(scores, 90)), 4),
        }

    thr = args.threshold
    pos_scores = class_scores(pos_test)
    adv_scores = class_scores(adv_test)
    speech_scores = class_scores(speech_test)
    clean_scores = class_scores(report_clean)  # pad-only (unaugmented) positives
    clean_offset_scores = class_scores(report_clean_offset)  # clean, random offset
    frr = float(np.mean(pos_scores < thr))
    frr_clean = float(np.mean(clean_scores < thr))
    frr_clean_offset = float(np.mean(clean_offset_scores < thr))
    far_adv = float(np.mean(adv_scores >= thr))
    far_speech = float(np.mean(speech_scores >= thr))
    score_stats = {"positive": stats(pos_scores), "adversarial": stats(adv_scores), "speech": stats(speech_scores)}
    logger.info(f"FRR={frr:.4f} (clean {frr_clean:.4f}, clean-offset {frr_clean_offset:.4f}) "
                f"FAR_adv={far_adv:.4f} FAR_speech={far_speech:.4f}")
    logger.info(f"score stats: {score_stats}")

    far_attrib = None
    if args.far_attribution > 0:
        # the EXACT text pool the held-out adversarial cache rendered (its sidecar)
        heldout_texts = gen_heldout.adversarial_texts(testing=True, adversarial_phrases=60)
        logger.info("=== per-text FAR attribution ===")
        far_attrib = far_attribution(model, heldout_texts, seed=args.seed, thr=thr, per_text=args.far_attribution,
                                     device=device)
        logger.info(
            f"FAR attribution: {far_attrib['texts_firing']}/{far_attrib['texts']} texts fire; top-5 share "
            f"{far_attrib['top5_share']} ({far_attrib['profile']}); top rates "
            f"{dict(list(far_attrib['rates'].items())[:8])}"
        )

    # multi-seed streaming: the per-run spread beside the aggregate, never a
    # bare single-stream point estimate
    n_runs = max(args.stream_seeds, 1)
    run_hours = args.stream_minutes / 60.0
    hours = n_runs * run_hours
    logger.info(f"=== streaming fp/hour: {n_runs} x {args.stream_minutes:.0f} min ({hours:.1f} h total) ===")
    score_runs = []
    fp_runs = []
    fp_runs_c2 = []
    fp_counts = []
    fp_counts_c2 = []
    for k in range(n_runs):
        s = stream_scores(model, args.seed + 31 + 1009 * k)
        score_runs.append(s)
        d = count_detections(s, thr)
        d2 = count_detections(s, thr, consecutive=2)
        fp_counts.append(int(d))
        fp_counts_c2.append(int(d2))
        fp_runs.append(d / max(run_hours, 1e-9))
        fp_runs_c2.append(d2 / max(run_hours, 1e-9))
        logger.info(f"  stream {k + 1}/{n_runs}: {d} raw / {d2} gated detections "
                    f"({fp_runs[-1]:.1f} / {fp_runs_c2[-1]:.1f} per hr)")
    detections = int(sum(fp_counts))
    fp_per_hour = float(np.mean(fp_runs))
    logger.info(f"stream aggregate: {fp_per_hour:.2f}/hr raw over {hours:.2f} h "
                f"(per-run {['%.1f' % v for v in fp_runs]})")

    # operating point: the threshold meeting 1.5 false wakes/hour over all streams
    op_thr = operating_threshold(score_runs, hours)
    op_frr = float(np.mean(pos_scores < op_thr))
    op_frr_clean = float(np.mean(clean_scores < op_thr))
    op_frr_clean_offset = float(np.mean(clean_offset_scores < op_thr))
    op_fp_per_hour = sum(count_detections(s, op_thr) for s in score_runs) / max(hours, 1e-9)
    logger.info(f"operating point: thr={op_thr} -> {op_fp_per_hour:.2f} fp/hr, "
                f"FRR={op_frr:.4f} (clean {op_frr_clean:.4f})")
    op_warnings = operating_point_warnings(op_thr, op_frr, hours)
    for w in op_warnings:
        logger.warning(f"operating point (raw): {w}")

    # the consecutive-window gate (runtime/detection.py)
    fp_per_hour_c2 = float(np.mean(fp_runs_c2))
    op_thr_c2 = operating_threshold(score_runs, hours, consecutive=2)
    op_frr_c2 = float(np.mean(pos_scores < op_thr_c2))
    op_frr_clean_c2 = float(np.mean(clean_scores < op_thr_c2))
    op_frr_clean_offset_c2 = float(np.mean(clean_offset_scores < op_thr_c2))
    logger.info(f"consecutive=2 gate: {fp_per_hour_c2:.2f} fp/hr at thr={thr}; operating thr={op_thr_c2} -> "
                f"FRR={op_frr_c2:.4f} (clean {op_frr_clean_c2:.4f})")
    op_warnings_c2 = operating_point_warnings(op_thr_c2, op_frr_c2, hours)
    for w in op_warnings_c2:
        logger.warning(f"operating point (c2): {w}")

    logger.info("=== sliding-offset phrase check (pipeline-rendered) ===")
    rng = np.random.default_rng(args.seed + 5)
    sliding = {}
    sliding_c2 = {}
    sliding_counts: Dict[str, Tuple[int, int]] = {}
    sliding_runs: Dict[str, List[np.ndarray]] = {}
    for text in [args.phrase] + ADVERSARIAL_SLIDING_PHRASES:
        # the wake phrase's gated fire rate IS the product's recall: a larger sample
        n_clips = args.sliding_clips if text == args.phrase else 6
        maxima = []
        fired_c2 = []
        sliding_runs[text] = []
        for clip in _pipeline_clips(text, n_clips, seed=args.seed + 5, device=device):
            ctx = _sliding_context(clip, rng)
            s = scores_of(model, ctx)
            sliding_runs[text].append(s)
            maxima.append(float(s.max()) if s.size else 0.0)
            fired_c2.append(int(count_detections(s, thr, consecutive=2) > 0))
        sliding[text] = round(float(np.mean(maxima)), 3)
        sliding_c2[text] = round(float(np.mean(fired_c2)), 3)
        sliding_counts[text] = (int(sum(fired_c2)), len(fired_c2))
        logger.info(f"  {text!r}: mean max score {sliding[text]}, consecutive=2 fire rate {sliding_c2[text]}")
    sliding_recall_c2 = sliding_c2[args.phrase]

    curve, curve_pass = threshold_curve(adv_scores, speech_scores, clean_scores, clean_offset_scores,
                                        sliding_runs[args.phrase], score_runs, hours)
    logger.info(
        "threshold curve (thr: FAR_adv / fp_hr_c2 / recall_c2 / frr_clean): "
        + "; ".join(f"{c['threshold']}: {c['far_adversarial']:.3f}/{c['fp_per_hour_c2']:.2f}/"
                    f"{c['sliding_recall_c2']:.2f}/{c['frr_clean']:.3f}" for c in curve)
    )
    if curve_pass:
        logger.info(f"threshold(s) passing ALL 5 targets: {[c['threshold'] for c in curve_pass]}")

    # the calibrated operating point: the c2 threshold picked on separate
    # calibration streams, every target re-evaluated there on held-out data
    calibrated: Dict[str, Any] = {}
    if args.calibration_seeds > 0:
        logger.info(f"=== calibrating threshold on {args.calibration_seeds} x {args.stream_minutes:.0f} min "
                    "disjoint streams ===")
        cal_runs = [stream_scores(model, args.seed + 71 + 1009 * k) for k in range(args.calibration_seeds)]
        calibrated = calibrated_block(
            cal_runs, args.calibration_seeds * run_hours, thr, args.phrase, score_runs, run_hours, hours,
            sliding_runs, adv_scores, clean_scores, clean_offset_scores,
        )
        for w in calibrated["warnings"]:
            logger.warning(f"calibrated block: {w}")
        logger.info(
            f"calibrated thr={calibrated['threshold']} -> fp/hr_c2={calibrated['fp_per_hour_c2']:.2f} (held-out), "
            f"recall_c2={calibrated['sliding_recall_c2']}, FAR_adv={calibrated['far_adversarial']:.4f}, clean "
            f"FRR={calibrated['frr_clean']:.4f}/{calibrated['frr_clean_offset']:.4f}; targets: "
            + ", ".join(f"{k}={'PASS' if v else 'FAIL'}" for k, v in calibrated["targets_met"].items())
        )

    # 95% intervals for every headline rate
    det_c2_total = int(sum(fp_counts_c2))
    recall_k, recall_n = sliding_counts[args.phrase]
    intervals = headline_intervals(thr, adv_scores, speech_scores, clean_scores, clean_offset_scores,
                                   recall_k, recall_n, det_c2_total, hours)
    logger.info("95% intervals: " + ", ".join(
        f"{k}={v}" for k, v in intervals.items() if k not in ("n", "basis")))

    # HEADLINE: every target at the production operating point, together
    targets_met = targets(sliding_recall_c2, far_adv, frr_clean, frr_clean_offset, fp_per_hour_c2)
    logger.info(
        f"HEADLINE sliding-gate recall (c2) = {sliding_recall_c2} over {args.sliding_clips} renderings; "
        "targets: " + ", ".join(f"{k}={'PASS' if v else 'FAIL'}" for k, v in targets_met.items())
    )

    frr_by_snr: Dict[str, float] = {}
    far_by_snr: Dict[str, float] = {}
    if not args.no_snr_buckets:
        logger.info("=== FRR by SNR / reverb bucket ===")
        frr_by_snr = frr_by_snr_buckets(model, args.phrase, args.seed, thr, device=device)
        for k, v in frr_by_snr.items():
            logger.info(f"  {k}: FRR {v}")
        logger.info("=== FAR (unseen swap family) by SNR / reverb bucket ===")
        far_by_snr = far_by_snr_buckets(model, args.phrase, args.seed, thr, device=device)
        for k, v in far_by_snr.items():
            logger.info(f"  {k}: FAR {v}")

    results = {
        "phrase": args.phrase,
        "threshold": thr,
        "embedding": args.embedding or "packaged-default",
        "train_samples": args.train_samples,
        "partial_samples": args.partial_samples,
        "adversarial_phrases": args.adversarial_phrases,
        "hard_pair_boost": args.hard_pair_boost,
        "prefix_negatives": args.prefix_negatives,
        "collision_negatives": args.collision_negatives,
        "collision_swap_depth": args.collision_swap_depth,
        "mine_adversarial_clips": args.mine_adversarial_clips,
        "reverb_positives": args.reverb_positives,
        "steps": args.steps,
        "layers": args.layers,
        "layer_dim": args.layer_dim,
        "fixed_negative_weight": args.fixed_negative_weight,
        "frr": round(frr, 4),
        "frr_clean": round(frr_clean, 4),
        "frr_clean_offset": round(frr_clean_offset, 4),
        "far_adversarial": round(far_adv, 4),
        "far_speech": round(far_speech, 4),
        "stream_minutes": args.stream_minutes,
        "stream_seeds": n_runs,
        "stream_hours_total": round(hours, 2),
        "stream_detections": detections,
        "fp_per_hour": round(fp_per_hour, 3),
        "fp_per_hour_runs": [round(v, 2) for v in fp_runs],
        "fp_per_hour_runs_consecutive2": [round(v, 2) for v in fp_runs_c2],
        "mine_rounds": args.mine_rounds,
        "mined_negatives": int(sum(len(m) for m in mined)),
        "select_runs": args.select_runs,
        "selection": selection,
        "operating_threshold": op_thr,
        "operating_fp_per_hour": round(float(op_fp_per_hour), 3),
        "operating_frr": round(op_frr, 4),
        "operating_frr_clean": round(op_frr_clean, 4),
        "operating_frr_clean_offset": round(op_frr_clean_offset, 4),
        "fp_per_hour_consecutive2": round(float(fp_per_hour_c2), 3),
        "operating_warnings": op_warnings + op_warnings_c2,
        "threshold_curve": curve,
        "threshold_curve_all_targets": [c["threshold"] for c in curve_pass],
        "operating_threshold_consecutive2": op_thr_c2,
        "operating_frr_consecutive2": round(op_frr_c2, 4),
        "operating_frr_clean_consecutive2": round(op_frr_clean_c2, 4),
        "operating_frr_clean_offset_consecutive2": round(op_frr_clean_offset_c2, 4),
        "score_stats": score_stats,
        "clean_positive_stats": stats(clean_scores),
        "clean_offset_stats": stats(clean_offset_scores),
        "sliding_max_scores": sliding,
        "sliding_consecutive2_fire_rate": sliding_c2,
        "sliding_recall_c2": sliding_recall_c2,
        "sliding_clips": args.sliding_clips,
        "targets_met": targets_met,
        "all_targets_met": all(targets_met.values()),
        "intervals": intervals,
        "calibrated": calibrated,
        "far_attribution": far_attrib,
        "frr_by_snr": frr_by_snr,
        "far_by_snr": far_by_snr,
        "checkpoint": final,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
