"""The port's program spans (``utils/profiling.span``) on the CPU.

With no profiler running a span is one shared no-op context and opens no
``record_function`` range; under ``torch.profiler`` each layer's range
appears, nested as its calls nest: generation's fused batch, the trainer's
step and its epoch, and ``listen``'s scoring of a chunk (serial and
threaded).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from heybuddy_tpu_torch.data import precalculated, training
from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
from heybuddy_tpu_torch.models import featurizer, formant_device, tts
from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel, save_model
from heybuddy_tpu_torch.ops.augment import AugmentConfig
from heybuddy_tpu_torch.runtime.listen import _SerialModel
from heybuddy_tpu_torch.runtime.model_thread import WakeWordModelThread
from heybuddy_tpu_torch.training.trainer import WakeWordTrainer
from heybuddy_tpu_torch.utils import profiling

CPU = torch.autograd.DeviceType.CPU
L_MAX = 24000
PATTERN = np.sign(np.sin(np.arange(16 * 96))).reshape(16, 96).astype(np.float32)


@pytest.fixture(autouse=True)
def program_env(monkeypatch):
    """Offline, the rule G2P, fresh shared TTS / featurizer instances."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.delenv("HEYBUDDY_TTS_BACKEND", raising=False)
    monkeypatch.delenv("HEYBUDDY_FUSED_TTS", raising=False)
    monkeypatch.setattr(tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof):
    """(name, start, end, thread) of every program range of a CPU profile."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
            if e.device_type == CPU and "/" in e.name and not e.name.startswith(("aten::", "hbbench/"))]


def _parents(ranges):
    """{child name: {innermost enclosing program range's name on its thread}} (None at the top)."""
    out = {}
    for name, start, end, thread in ranges:
        holders = [r for r in ranges if r[3] == thread and r[1] <= start and end <= r[2]
                   and (r[1], r[2]) != (start, end)]
        inner = min(holders, key=lambda r: r[2] - r[1])[0] if holders else None
        out.setdefault(name, set()).add(inner)
    return out


@contextlib.contextmanager
def _no_ranges_or_device(monkeypatch):
    """Any ``record_function`` range, synchronise or CUDA event fails the block."""

    def refuse(*args, **kwargs):
        raise AssertionError("a span touched the profiler or the device with no profiler running")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        m.setattr(torch.cuda, "synchronize", refuse)
        m.setattr(torch.cuda, "Event", refuse)
        yield


def _trainer(tmp_path):
    return WakeWordTrainer(checkpoint_dir=str(tmp_path / "ckpt"), num_layers=1, layer_dim=32, dropout=0.0,
                           device="cpu")


def _batch(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n, 16, 96)).astype(np.float32)
    x[: n // 2] += 0.3 * PATTERN
    x[n // 2 :] -= 0.3 * PATTERN
    return x, np.concatenate([np.ones(n // 2), np.zeros(n - n // 2)]).astype(np.float32)


def _step(t):
    carry = t._init_carry(t.device)
    return t._train_step(carry, *t._to_device(*_batch()), 2e-3, 1.0, 1e-4, 0.5, torch.Generator().manual_seed(1))


def _resident_iterator(seed=0):
    rng = np.random.default_rng(seed)

    def source(sign, n, s):
        data = rng.normal(0.0, 1.0, (n, 16, 96)).astype(np.float32) + 0.3 * sign * PATTERN
        return precalculated.PrecalculatedDatasetIterator("resident", data=data, seed=s)

    return training.WakeWordTrainingDatasetIterator(
        num_batch_threads=1, positive=[(source(1, 50, 1), 24)], negative=[(source(-1, 60, 2), 24)],
    )


@pytest.fixture(scope="module")
def head_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("head") / "head.npz")
    save_model(WakeWordMLPModel(num_layers=1, seed=4, device="cpu"), path)
    return path


def _chunk():
    return np.random.default_rng(1).normal(0, 0.1, 32000).astype(np.float32)  # listen's 2 s buffer


def test_span_off_is_one_shared_no_op_context():
    first, second = profiling.span("test/a"), profiling.span("test/b")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with profiling.span("test/a"), profiling.span("test/b"):
        torch.ones(4).sum()
    with _profile() as prof:
        torch.ones(4).sum()
    assert not {"test/a", "test/b"} & {e.name for e in prof.events()}


def test_span_on_ranges_nest():
    with _profile() as prof:
        with profiling.span("test/outer"):
            with profiling.span("test/inner"):
                torch.ones(4).sum()
            with profiling.span("test/second"):
                torch.ones(4).sum()
    parents = _parents(_ranges(prof))
    assert parents == {"test/outer": {None}, "test/inner": {"test/outer"}, "test/second": {"test/outer"}}


def test_stage_timer_records_when_off_and_opens_its_range_only_when_on(monkeypatch):
    times = profiling.StageTimes()
    with _no_ranges_or_device(monkeypatch):
        with profiling.stage_timer("test/stage", times):
            torch.ones(4).sum()
    assert times.count == {"test/stage": 1} and times.total["test/stage"] > 0.0
    with _profile() as prof:
        with profiling.stage_timer("test/stage", times):
            torch.ones(4).sum()
    assert times.count == {"test/stage": 2}
    assert _parents(_ranges(prof)) == {"test/stage": {None}}


def test_no_profiler_no_range_no_sync_on_the_paths(tmp_path, monkeypatch, head_path):
    """The trainer's step, its epoch and listen's scoring with no profiler: no
    span opens a range, synchronises or records an event."""
    t = _trainer(tmp_path)
    model = _SerialModel(head_path, device="cpu")
    with _no_ranges_or_device(monkeypatch):
        _step(t)
        t.train_epoch(_resident_iterator(), validation=_resident_iterator(1), num_steps=3, validation_steps=2,
                      checkpoint_steps=1000, learning_rate=2e-3)
        model.put(_chunk())
        model.get()


def test_trainer_step_holds_forward_backward_and_adam(tmp_path):
    t = _trainer(tmp_path)
    with _profile() as prof:
        _step(t)
    parents = _parents(_ranges(prof))
    assert parents == {"trainer/step": {None}, "trainer/forward": {"trainer/step"},
                       "trainer/backward": {"trainer/step"}, "trainer/adam": {"trainer/step"}}


def test_trainer_epoch_ranges_gather_step_flush_eval(tmp_path):
    t = _trainer(tmp_path)
    with _profile() as prof:
        t.train_epoch(_resident_iterator(), validation=_resident_iterator(1), num_steps=3, validation_steps=2,
                      checkpoint_steps=1000, learning_rate=2e-3)
    ranges = _ranges(prof)
    counts = {name: sum(r[0] == name for r in ranges) for name in {r[0] for r in ranges}}
    assert counts["trainer/gather"] == counts["trainer/step"] == 3
    assert counts["trainer/eval"] == 1 and counts["trainer/flush"] >= 1
    parents = _parents(ranges)
    for name in ("trainer/gather", "trainer/step", "trainer/flush", "trainer/eval"):
        assert parents[name] == {None}, name


def test_listen_score_holds_the_featurizer_and_the_head(head_path):
    model = _SerialModel(head_path, device="cpu")
    model.put(_chunk())
    model.get()  # the shared featurizer built outside the profile
    with _profile() as prof:
        model.put(_chunk())
        model.get()
    parents = _parents(_ranges(prof))
    assert parents == {
        "listen/score": {None}, "wakeword/prepare": {"listen/score"}, "featurizer/embed": {"listen/score"},
        "featurizer/upload": {"featurizer/embed"}, "featurizer/featurize": {"featurizer/embed"},
        "featurizer/download": {"featurizer/embed"}, "wakeword/contexts": {"listen/score"},
        "wakeword/head": {"listen/score"},
    }


def test_threaded_listen_score_is_traced_on_its_worker(head_path):
    """A profiler of every thread (the worker's ranges are its own thread's)
    sees the worker's ``listen/score``."""
    thread = WakeWordModelThread(head_path, device="cpu")
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    try:
        thread.put(_chunk())
        thread.get(timeout=60)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    experimental_config=every_thread) as prof:
            thread.put(_chunk())
            thread.get(timeout=60)
    finally:
        thread.stop()
    ranges = _ranges(prof)
    scores = [r for r in ranges if r[0] == "listen/score"]
    assert len(scores) == 1
    parents = _parents(ranges)
    assert parents["listen/score"] == {None} and parents["wakeword/head"] == {"listen/score"}
    assert parents["featurizer/embed"] == {"listen/score"}


def test_fused_batch_ranges_render_augment_and_featurize():
    planner = formant_device.DeviceFormantPlanner(max_samples=L_MAX)
    plans = [planner.plan(t, speaker=s, seed=40 + s) for s, t in enumerate(["hey buddy", "buddy"])]
    net = featurizer.get_speech_embeddings(device="cpu").net
    bank, irs = torch.zeros((2, AugmentConfig().target_samples)), torch.zeros((2, 256))
    generator = torch.Generator().manual_seed(0)
    with _profile() as prof:
        out, n = formant_device.fused_features_batch(plans, net, generator, bank, irs, AugmentConfig(),
                                                     l_max=L_MAX, harmonics=48)
    assert n == 2 and out.shape == (2, 16, 96)
    parents = _parents(_ranges(prof))
    assert parents == {"formant/pack": {None}, "formant/render": {None}, "augment/batch": {None},
                       "featurizer/featurize_batch": {None}}


def test_fused_route_ranges_plan_batch_and_drain(tmp_path, monkeypatch):
    """The fused route of ``generate`` under ``features/generate``: each batch's
    plans under ``tts/samples``, its device work under ``features/batch``, the
    drain split in copy and write."""
    monkeypatch.setitem(tts._GLOBAL_TTS, ("formant-device", "cpu"),
                        tts.DeviceFormantTTS(max_samples=L_MAX, harmonics=48, device="cpu"))
    monkeypatch.setenv("HEYBUDDY_NOISE_BANK", "4")
    gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), seed=7, device="cpu",
                                    tts_backend="formant-device", tts_batch_size=2, augment_batch_size=2,
                                    embed_batch_size=2)
    monkeypatch.setenv("HEYBUDDY_FUSED_TTS_BATCH", "2")
    assert gen._use_fused_pipeline()
    with _profile() as prof:
        gen.get_training_features(4)
    assert os.path.exists(os.path.join(str(tmp_path), "hey-buddy.npy"))
    ranges = _ranges(prof)
    parents = _parents(ranges)
    assert parents["features/generate"] == {None}
    assert parents["tts/samples"] == {"features/generate"} and parents["formant/plan"] == {"tts/samples"}
    assert parents["features/batch"] == {"features/generate"}
    for name in ("formant/pack", "formant/render", "augment/batch", "featurizer/featurize_batch"):
        assert parents[name] == {"features/batch"}, name
    assert parents["features/drain/copy"] == parents["features/drain/write"] == {"features/generate"}
    assert sum(r[0] == "features/batch" for r in ranges) == 2
    assert sum(r[0] == "features/drain/copy" for r in ranges) == 2
