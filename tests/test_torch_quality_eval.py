"""The port's quality harness (``heybuddy_tpu_torch.tools.quality_eval``)
against the JAX package's ``scripts/quality_eval.py``, on the CPU.

Held: every statistics function equal to the script's on a seeded grid (the
selection cases of tests/test_quality_selection.py among them), and the
threshold curve, intervals, targets and calibrated block of the script's
``main`` (its source lines, run as they are) equal to the port's functions;
the clips, the sliding contexts, the hard pairs and the stream cache keys bit
for bit; the sliding scoring of speech and the phrase with the shipped head
against the script's function on JAX (features by the generated-feature
rule, scores, detections at clear thresholds, the strided path against
``__call__`` on the materialised windows); a tiny ``--eval-only`` run and a
``--quick`` training run.
"""

import importlib.util
import json
import logging
import os
import re
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heybuddy_tpu.models.featurizer as jax_featurizer
import heybuddy_tpu.models.tts as jax_tts
from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.runtime.onnx_model import WakeWordONNXModel as JaxOnnxModel
from heybuddy_tpu_torch.data import streams
from heybuddy_tpu_torch.models import featurizer, tts
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings, get_speech_embeddings
from heybuddy_tpu_torch.runtime.onnx_model import WakeWordONNXModel
from heybuddy_tpu_torch.tools import quality_eval as qe
from heybuddy_tpu_torch.utils.log import logger

from torch_fixtures import assert_features_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "quality_eval.py")
HEAD = os.path.join(ROOT, "browser", "models", "hey-buddy.onnx")
REPORT = os.path.join(ROOT, "reports", "quality-shipped-v26-evalonly.json")
# the head card vs CPU and port vs JAX: predict's bound
SCORE_ATOL = 0.02
# the ONNX head's graph through the importer's tensor ops against the numpy runner
ONNX_DEVICE_ATOL = 1e-5


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("quality_eval_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    assert spec.loader is not None
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small eager ops, and
    the suite runs several workers on the machine's cores, where thread
    pools oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def quality_env(monkeypatch, tmp_path):
    """Offline, the rule G2P, fresh shared TTS / featurizer instances in both
    packages, the cache and dataset dirs under the test's tmp_path."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.setenv("HEYBUDDY_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("HEYBUDDY_DATASET_DIR", str(tmp_path / "data"))
    monkeypatch.delenv("HEYBUDDY_TTS_BACKEND", raising=False)
    monkeypatch.setattr(tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(jax_tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    monkeypatch.setattr(jax_featurizer, "_GLOBAL_EMBEDDINGS", None)
    monkeypatch.setattr(qe, "_STREAM_CACHE_DIR", "")


# --- (b) the statistics ----------------------------------------------------------------

def _stat_cases():
    """(function, args, kwargs) on a seeded grid."""
    rng = np.random.default_rng(11)
    cases = []
    for i in range(6):
        runs = [rng.beta(0.3, 2.0, int(rng.integers(200, 900))).astype(np.float32) for _ in range(int(rng.integers(1, 4)))]
        hours = float(rng.choice([0.05, 0.3, 1.0, 6.0]))
        cases.append(("operating_threshold", (runs, hours), {"consecutive": 1 + i % 2}))
    saturated = [np.full(400, 0.99995, np.float32)]
    cases.append(("operating_threshold", (saturated[0], 0.01), {}))  # the grid ceiling: 1.0
    cases.append(("operating_threshold", (saturated, 0.5), {"target_per_hour": 40.0, "consecutive": 2}))
    for i in range(6):
        scores = rng.beta(0.5, 0.5, 300).astype(np.float32)
        cases.append(("count_detections", (scores, float(rng.uniform(0.2, 0.9))),
                      {"consecutive": 1 + i % 3, "debounce_windows": int(rng.choice([0, 4, 16]))}))
    for k, n in ((0, 0), (0, 800), (53, 800), (11, 800), (38, 40), (40, 40), (3, 7), (1, 1)):
        cases.append(("wilson_interval", (k, n), {}))
    for k, hours in ((0, 6.0), (3, 6.0), (209, 6.0), (1, 0.25), (5, 0.0), (0, 2.0)):
        cases.append(("poisson_rate_interval", (k, hours), {}))
    # tests/test_quality_selection.py's nine selection cases, then a seeded grid
    for args, kw in (((0, 2.0, 0.02, 0.02), {}), ((0, 1.0, 0.02, 0.02), {}), ((0, 2.0, 0.0775, 0.015), {}),
                     ((8, 2.0, 0.045, 0.04), {}), ((2, 2.0, 0.045, 0.04), {}), ((0, 2.0, 0.03, 0.01), {}),
                     ((0, 2.0, 0.01, 0.01), {"sel_recall": 11 / 12}), ((6, 2.0, 0.049, 0.04), {"sel_recall": 1.0}),
                     ((0, 2.0, 0.08, 0.01), {"sel_recall": 1.0})):
        cases.append(("selection_key", args, kw))
    for _ in range(4):
        cases.append(("selection_key", (int(rng.integers(0, 12)), float(rng.uniform(0.25, 3.0)),
                                        float(rng.uniform(0.0, 0.12)), float(rng.uniform(0.0, 0.12))),
                      {"sel_recall": float(rng.choice([1.0, 0.9]))}))
    for args in ((1.0, 1.0, 1.0), (0.68, 0.02, 0.5), (0.68, 0.015, 6.0), (0.9999, 0.5, 2.0), (0.5, 0.995, 0.1)):
        cases.append(("operating_point_warnings", args, {}))
    return cases


STAT_CASES = _stat_cases()


@pytest.mark.parametrize("case", range(len(STAT_CASES)),
                         ids=[f"{name}-{i}" for i, (name, _, _) in enumerate(STAT_CASES)])
def test_statistics_equal_the_script(case, script):
    """Exactly equal: the same values, types and rounding."""
    name, args, kwargs = STAT_CASES[case]
    got, want = getattr(qe, name)(*args, **kwargs), getattr(script, name)(*args, **kwargs)
    assert type(got) is type(want) and got == want, (got, want)


def _script_block(script_src, start, end, namespace):
    """Run the script's ``main`` lines from the one starting with ``start``
    to the one starting with ``end`` (exclusive) in ``namespace``."""
    lines = script_src.splitlines()
    first = next(i for i, line in enumerate(lines) if line.strip().startswith(start))
    last = next(i for i in range(first + 1, len(lines)) if lines[i].strip().startswith(end))
    exec(textwrap.dedent("\n".join(lines[first:last])), namespace)
    return namespace


class _Quiet:
    def info(self, *_):
        pass

    warning = info


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_main_blocks_equal_the_scripts_lines(seed, script):
    """The threshold curve, the calibrated block, the intervals and the
    targets: the port's functions against the script's own lines of ``main``
    on seeded score arrays."""
    with open(SCRIPT) as f:
        src = f.read()
    rng = np.random.default_rng(seed)

    def scores(n, a, b):
        return rng.beta(a, b, n).astype(np.float32)

    adv, speech = scores(80, 0.3, 3.0), scores(70, 0.2, 4.0)
    clean, clean_offset = scores(60, 4.0, 0.3), scores(50, 3.0, 0.4)
    phrase_runs = [np.concatenate([scores(8, 0.5, 2.0), np.full(int(rng.integers(0, 5)), 0.97, np.float32),
                                   scores(8, 0.5, 2.0)]) for _ in range(10)]
    sliding_runs = {"hey buddy": phrase_runs, "hay bunny": [scores(20, 0.5, 3.0) for _ in range(6)]}
    score_runs = [scores(2000, 0.3, 4.0) for _ in range(3)]
    cal_runs = [scores(2000, 0.3, 4.0) for _ in range(2)]
    run_hours, thr = 0.05, 0.5
    hours = 3 * run_hours
    ns = dict(np=np, count_detections=script.count_detections, wilson_interval=script.wilson_interval,
              poisson_rate_interval=script.poisson_rate_interval, operating_threshold=script.operating_threshold,
              operating_point_warnings=script.operating_point_warnings, logger=_Quiet(),
              args=SimpleNamespace(phrase="hey buddy", calibration_seeds=2),
              adv_scores=adv, speech_scores=speech, clean_scores=clean, clean_offset_scores=clean_offset,
              sliding_runs=sliding_runs, score_runs=score_runs, hours=hours, run_hours=run_hours, thr=thr,
              cal_runs=cal_runs, fp_counts_c2=[script.count_detections(s, thr, consecutive=2) for s in score_runs],
              sliding_counts={"hey buddy": (7, 10)}, sliding_recall_c2=0.7, far_adv=0.05, frr_clean=0.05,
              frr_clean_offset=0.051, fp_per_hour_c2=1.5)
    _script_block(src, "threshold_curve = []", "logger.info(", ns)
    curve, passing = qe.threshold_curve(adv, speech, clean, clean_offset, phrase_runs, score_runs, hours)
    assert curve == ns["threshold_curve"] and passing == ns["curve_pass"]
    _script_block(src, "cal_hours = args.calibration_seeds", "logger.info(", ns)
    got = qe.calibrated_block(cal_runs, 2 * run_hours, thr, "hey buddy", score_runs, run_hours, hours,
                              sliding_runs, adv, clean, clean_offset)
    assert got == ns["calibrated"]
    _script_block(src, "det_c2_total = int(sum(fp_counts_c2))", "logger.info(", ns)
    assert qe.headline_intervals(thr, adv, speech, clean, clean_offset, 7, 10, ns["det_c2_total"],
                                 hours) == ns["intervals"]
    _script_block(src, "targets_met = {", "logger.info(", ns)
    assert qe.targets(0.7, 0.05, 0.05, 0.051, 1.5) == ns["targets_met"]


def test_intervals_and_targets_reproduce_the_jax_report():
    """The shipped head's JAX report: its intervals and targets from its own counts."""
    with open(REPORT) as f:
        report = json.load(f)
    n = report["intervals"]["n"]
    counts = {k: int(round(report[k] * n[key])) for k, key in (
        ("far_adversarial", "adversarial"), ("far_speech", "speech"), ("frr_clean", "clean"),
        ("frr_clean_offset", "clean_offset"))}
    recall_k = int(round(report["sliding_recall_c2"] * n["sliding_renderings"]))

    def rates(k, size, below):  # scores that put k of size on the counted side of 0.5
        return np.array([0.1 if below else 0.9] * k + [0.9 if below else 0.1] * (size - k), np.float32)

    got = qe.headline_intervals(
        0.5, rates(counts["far_adversarial"], n["adversarial"], False),
        rates(counts["far_speech"], n["speech"], False), rates(counts["frr_clean"], n["clean"], True),
        rates(counts["frr_clean_offset"], n["clean_offset"], True), recall_k, n["sliding_renderings"],
        n["stream_detections_c2"], n["stream_hours"])
    assert got == report["intervals"]
    assert qe.targets(report["sliding_recall_c2"], report["far_adversarial"], report["frr_clean"],
                      report["frr_clean_offset"], report["fp_per_hour_consecutive2"]) == report["targets_met"]


# --- (c) clips, contexts, hard pairs, stream keys ------------------------------------------------

@pytest.mark.parametrize("text,n,seed", [("hey buddy", 3, 5), ("hay bunny", 2, 906)])
def test_pipeline_clips_and_sliding_context_equal_the_script(text, n, seed, script):
    got = qe._pipeline_clips(text, n, seed, device="cpu")
    want = script._pipeline_clips(text, n, seed)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    ctx = [qe._sliding_context(c, np.random.default_rng(seed)) for c in got]
    ref = [script._sliding_context(c, np.random.default_rng(seed)) for c in want]
    for a, b in zip(ctx, ref):
        np.testing.assert_array_equal(a, b)


def test_hard_pairs_and_stream_keys_equal_the_script(script, tmp_path, monkeypatch):
    assert qe.derive_hard_pairs("hey buddy") == script.derive_hard_pairs("hey buddy")
    assert qe._stream_content_tag() == script._stream_content_tag()
    cache = {}
    for mod in (qe, script):
        directory = tmp_path / mod.__name__
        monkeypatch.setattr(mod, "_STREAM_CACHE_DIR", str(directory))
        stream = np.arange(5, dtype=np.float32)
        np.testing.assert_array_equal(mod._cached_stream("speech-xhey-buddy", 0.5, 7, lambda: stream), stream)
        # a second call reads the file and never calls build
        np.testing.assert_array_equal(mod._cached_stream("speech-xhey-buddy", 0.5, 7, lambda: None), stream)
        cache[mod] = os.listdir(directory)
    assert cache[qe] == cache[script] and len(cache[qe]) == 1


# --- (d) sliding scoring ------------------------------------------------------------------------

def _clear_thresholds(*score_sets, margin=SCORE_ATOL):
    allscores = np.concatenate(score_sets)
    grid = np.round(np.arange(0.05, 0.96, 0.01), 2)
    return [float(t) for t in grid if np.abs(allscores - t).min() > margin]


def test_sliding_scores_of_the_shipped_head_match_the_script(script):
    """A seeded 6 s speech stream followed by a rendering of the phrase in
    its sliding context (72 windows): the port's strided path in segments of
    32 against the script's function on JAX (its CPU bf16 featurizer, the
    head through its numpy runner). Features by the generated-feature rule;
    scores within SCORE_ATOL of the head on JAX's float32 features;
    detections equal to the script's at every threshold SCORE_ATOL clear of
    every score, both gates; the strided features equal
    ``SpeechEmbeddings.__call__`` on the materialised windows bit for bit."""
    speech = streams.synth_speech_stream(0.1, 31, exclude_phrase="hey buddy", tts_backend="formant", device="cpu")
    phrase = qe._sliding_context(script._pipeline_clips("hey buddy", 1, 5)[0], np.random.default_rng(5))
    stream = np.concatenate([speech, phrase])
    n = streams.stream_window_count(stream)
    assert n == 72
    feats, scores = qe.sliding_features_scores(WakeWordONNXModel(HEAD, device="cpu"), stream, batch=32,
                                               device="cpu")
    want_feats, want_scores = script.sliding_features_scores(JaxOnnxModel(HEAD), stream)
    assert feats.shape == want_feats.shape == (n, 16, 96) and scores.shape == want_scores.shape == (n,)
    clips = streams.stream_window_clips(stream)
    assert_features_close(feats, want_feats, clips * 32767.0)
    # the scores against the head on JAX's float32 features: the phrase's
    # onset window sits on the sigmoid's slope, where JAX's own bf16 path
    # lies 0.069 off (0.014 measured for the port)
    exact = np.asarray(jax_featurizer.featurize_batch(
        jax_net.default_params(), jnp.asarray(clips * 32767.0), pooling="banded", compute_dtype=jnp.float32))
    exact_scores = np.asarray(JaxOnnxModel(HEAD)(exact)).reshape(-1)
    assert np.abs(scores - exact_scores).max() <= SCORE_ATOL
    clear = _clear_thresholds(scores, want_scores, exact_scores)
    assert len(clear) >= 10
    for t in clear:
        for c in (1, 2):
            assert qe.count_detections(scores, t, consecutive=c) == script.count_detections(
                want_scores, t, consecutive=c), (t, c)
    assert scores.min() < 0.01 and scores.max() > 0.99  # the speech and the phrase
    assert qe.count_detections(scores, 0.5, consecutive=2) == 1
    np.testing.assert_array_equal(feats, get_speech_embeddings(device="cpu")(clips))
    only = qe.sliding_scores(WakeWordONNXModel(HEAD, device="cpu"), stream, batch=32, device="cpu")
    np.testing.assert_array_equal(only, scores)


def test_onnx_device_scores_equal_the_numpy_runner():
    feats = np.random.default_rng(3).normal(0.0, 1.0, (40, 16, 96)).astype(np.float32)
    head = WakeWordONNXModel(HEAD, device="cpu")
    got = qe.host_scores(head, feats, "cpu")
    assert got.shape == (40,) and got.dtype == np.float32
    np.testing.assert_allclose(got, head.scores(feats), atol=ONNX_DEVICE_ATOL, rtol=0)


def test_nan_rows_are_repaired_as_the_featurizer_repairs_them():
    """A NaN row is replaced from the batch's good rows by the featurizer's
    generator, as ``SpeechEmbeddings.__call__(remove_nan=True)`` does."""
    feats = torch.from_numpy(np.random.default_rng(4).normal(size=(6, 16, 96)).astype(np.float32))
    feats[2, 3, 5] = float("nan")
    got = qe._repair_nan(SimpleNamespace(_repair_nan=SpeechEmbeddings._repair_nan,
                                         generator=torch.Generator().manual_seed(9)), feats.clone())
    want = SpeechEmbeddings._repair_nan(feats.numpy(), torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).all()
    clean = feats.clone()
    clean[2] = 0.0
    assert qe._repair_nan(None, clean) is clean  # no NaN: no copy, no draw


def test_far_attribution_contract():
    """Per-text FAR: a constant-score model makes every rate exact (the
    script's own contract test, on the port's device scorer)."""
    fire = qe.far_attribution(lambda f: torch.ones(f.shape[0], 1), ["hey bunny", "say study"], seed=0, thr=0.5,
                              per_text=2, device="cpu")
    assert fire["texts"] == 2 and fire["texts_firing"] == 2
    assert set(fire["rates"]) == {"hey bunny", "say study"} and all(r == 1.0 for r in fire["rates"].values())
    quiet = qe.far_attribution(lambda f: torch.zeros(f.shape[0], 1), ["hey bunny"], seed=0, thr=0.5, per_text=2,
                               device="cpu")
    assert quiet["texts_firing"] == 0 and quiet["top5_share"] is None


# --- (e) a tiny eval-only run --------------------------------------------------------------------

def _rates(results):
    yield from (results[k] for k in ("frr", "frr_clean", "frr_clean_offset", "far_adversarial", "far_speech",
                                     "sliding_recall_c2", "operating_frr", "operating_frr_consecutive2"))
    for c in results["threshold_curve"]:
        yield from (c[k] for k in ("far_adversarial", "far_speech", "frr_clean", "frr_clean_offset",
                                   "sliding_recall_c2"))
    yield from results["sliding_consecutive2_fire_rate"].values()
    for key, value in results["intervals"].items():
        if key not in ("n", "basis", "fp_per_hour_consecutive2"):
            yield from value


def test_eval_only_run_keys_and_rates(tmp_path, capsys):
    """``--eval-only`` of the shipped head on the CPU: 4 clips a held-out set,
    one 0.2-minute stream and one calibration stream, one sliding rendering,
    no buckets. It exits 0 and prints one JSON line with the JAX report's key
    set (top level, intervals, calibrated, the curve's points); every rate
    lies in [0, 1]; the file it writes holds the same."""
    out = tmp_path / "results.json"
    rc = qe.main(["--eval-only", HEAD, "--device", "cpu", "--heldout-samples", "4", "--stream-minutes", "0.2",
                  "--stream-seeds", "1", "--sliding-clips", "1", "--calibration-seeds", "1", "--no-snr-buckets",
                  "--dataset-dir", str(tmp_path / "data"), "--out", str(out)])
    assert rc == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(REPORT) as f:
        report = json.load(f)
    assert set(results) == set(report)
    assert set(results["intervals"]) == set(report["intervals"])
    assert set(results["intervals"]["n"]) == set(report["intervals"]["n"])
    assert set(results["calibrated"]) == set(report["calibrated"])
    assert set(results["calibrated"]["intervals"]) == set(report["calibrated"]["intervals"])
    assert all(set(c) == set(report["threshold_curve"][0]) for c in results["threshold_curve"])
    assert set(results["sliding_max_scores"]) == set(report["sliding_max_scores"])
    rates = list(_rates(results))
    assert len(rates) > 50 and all(0.0 <= r <= 1.0 for r in rates)
    assert results["intervals"]["n"]["adversarial"] == 4 and results["stream_seeds"] == 1
    assert results["checkpoint"] == HEAD and results["frr_by_snr"] == {} and results["far_attribution"] is None
    with open(out) as f:
        assert json.load(f) == results
    assert os.listdir(os.path.join(os.environ["HEYBUDDY_CACHE_DIR"], "quality-streams"))  # the streams were cached


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_quick_training_run_trains_mines_and_reports(tmp_path, capsys):
    """``--quick`` on the CPU: generation from an empty dataset directory,
    the trainer with its validation-driven negative weight, one mining round
    that harvests windows and retrains, then the report; the loss falls in
    each training and the JSON has the report's key set."""
    handler = _Records()
    logger.addHandler(handler)
    try:
        rc = qe.main(["--quick", "--device", "cpu", "--dataset-dir", str(tmp_path / "data")])
    finally:
        logger.removeHandler(handler)
    assert rc == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(REPORT) as f:
        assert set(results) == set(json.load(f))
    assert results["steps"] == 40 and results["mine_rounds"] == 1 and results["mined_negatives"] > 0
    assert any(m.startswith("mining round 1: ") for m in handler.messages)
    assert sum(m.startswith("=== training classifier (round ") for m in handler.messages) == 2
    losses = [float(re.search(r"loss=(\S+)", m)[1]) for m in handler.messages if m.startswith("Training step ")]
    assert len(losses) == 2 * 20
    for run in (losses[:20], losses[20:]):
        assert run[-1] < run[0], run
    assert os.path.exists(results["checkpoint"])



def attribute_heldout_far(directory: str, n: int = 800) -> dict:
    """Where the held-out FARs of the shipped head move between the packages.
    JAX's generator renders and augments the held-out adversarial and speech
    sets of ``--eval-only`` (seed 0: the JAX report's clips and draws) on the
    CPU; that augmented audio is featurized and scored by JAX (its CPU bf16
    path), by the port (its plain versions) and on JAX's float32 features.
    Counts of clips at or above 0.5 per set, and the largest score gaps."""
    from heybuddy_tpu.data.features import TrainingFeaturesGenerator as JaxGenerator

    captured = []
    featurize_device = jax_featurizer.SpeechEmbeddings.featurize_device

    def capture(self, audio_batch):
        captured.append(np.array(audio_batch, np.float32))
        return featurize_device(self, audio_batch)

    gen = JaxGenerator("hey buddy", directory=directory, tts_backend="formant", seed=0)
    sets = (("adversarial", lambda: gen.get_training_features(n, adversarial=True, adversarial_phrases=60,
                                                              testing=True)),
            ("speech", lambda: gen.get_negative_speech_features(n, num_texts=200, seed=77)))
    out = {}
    jax_featurizer.SpeechEmbeddings.featurize_device = capture
    try:
        for name, make in sets:
            captured.clear()
            jax_feats = np.asarray(make().precalculated[:], np.float32)
            audio = np.concatenate(captured)[:n]
            port_feats = get_speech_embeddings(device="cpu").featurize_device(audio)[0].numpy()
            exact = np.concatenate([np.asarray(jax_featurizer.featurize_batch(
                jax_net.default_params(), jnp.asarray(audio[i : i + 100] * 32767.0), pooling="banded",
                compute_dtype=jnp.float32)) for i in range(0, len(audio), 100)])
            jax_scores = np.asarray(JaxOnnxModel(HEAD)(jax_feats)).reshape(-1)
            exact_scores = np.asarray(JaxOnnxModel(HEAD)(exact)).reshape(-1)
            port_scores = qe.host_scores(WakeWordONNXModel(HEAD, device="cpu"), port_feats, "cpu")
            out[name] = {"clips": len(audio), "fire_jax_featurizer": int((jax_scores >= 0.5).sum()),
                         "fire_port_featurizer": int((port_scores >= 0.5).sum()),
                         "fire_float32_features": int((exact_scores >= 0.5).sum()),
                         "jax_vs_float32_max": float(np.abs(jax_scores - exact_scores).max()),
                         "port_vs_float32_max": float(np.abs(port_scores - exact_scores).max())}
    finally:
        jax_featurizer.SpeechEmbeddings.featurize_device = featurize_device
    return out



def attribute_stream_detections(minutes: float = 60.0, streams_n: int = 6, chunk: int = 256) -> list:
    """The detections of ``--eval-only``'s measurement streams (seeds
    31 + 1009 k, the same audio in both packages) at threshold 0.5, raw and
    at the 2-consecutive gate, with the shipped head on three featurizations
    of every window: JAX's float32 features (the reference), JAX's CPU bf16
    path and the port's (its plain versions, ``sliding_scores``)."""
    import heybuddy_tpu.data.streams as jax_streams

    head = JaxOnnxModel(HEAD)
    params = jax_net.default_params()
    rows = []
    for k in range(streams_n):
        stream = jax_streams.synth_speech_stream(minutes, 31 + 1009 * k, exclude_phrase="hey buddy",
                                                 tts_backend="formant")
        n = jax_streams.stream_window_count(stream)
        scores = {"float32": [], "jax_bf16": []}
        for i in range(0, n, chunk):
            mono = jnp.asarray(jax_streams.stream_window_clips(stream, start=i, count=chunk) * 32767.0)
            for name, dtype in (("float32", jnp.float32), ("jax_bf16", jnp.bfloat16)):
                feats = jax_featurizer.featurize_batch(params, mono, pooling="banded", compute_dtype=dtype)
                scores[name].append(np.asarray(head(np.asarray(feats, np.float32))).reshape(-1))
        scores = {name: np.concatenate(v) for name, v in scores.items()}
        scores["port"] = qe.sliding_scores(WakeWordONNXModel(HEAD, device="cpu"), stream, device="cpu")
        rows.append({"seed": 31 + 1009 * k, "windows": n, **{
            name: [qe.count_detections(v, 0.5), qe.count_detections(v, 0.5, consecutive=2)]
            for name, v in scores.items()},
            "port_vs_float32_max": float(np.abs(scores["port"] - scores["float32"]).max()),
            "jax_bf16_vs_float32_max": float(np.abs(scores["jax_bf16"] - scores["float32"]).max())})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    # PYTHONPATH=.:tests JAX_PLATFORMS=cpu HEYBUDDY_OFFLINE=1 python tests/test_torch_quality_eval.py
    #     heldout [N]             the held-out FARs on JAX's own clips and draws (800: about 4 min)
    #     streams [MINUTES] [K]   the measurement streams' detections (60 6: about 20 min)
    import sys
    import tempfile

    if sys.argv[1] == "heldout":
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(attribute_heldout_far(tmp, int(sys.argv[2]) if len(sys.argv) > 2 else 800)))
    else:
        attribute_stream_detections(*(float(sys.argv[2]),) if len(sys.argv) > 2 else (),
                                    *(int(sys.argv[3]),) if len(sys.argv) > 3 else ())
