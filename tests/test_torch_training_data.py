"""The port's feature stores, caches and space checks against the JAX package's."""

import json

import numpy as np
import pytest

from heybuddy_tpu.data import precalculated as jax_pre
from heybuddy_tpu.data import space as jax_space
from heybuddy_tpu.data import training as jax_training
from heybuddy_tpu.data.features import TrainingFeaturesGenerator as JaxFeatures
from heybuddy_tpu.runtime import detection as jax_detection
from heybuddy_tpu.text.tokens import BERTTokenizer as JaxTokenizer
from heybuddy_tpu.utils import strings as jax_strings
from heybuddy_tpu_torch.data import precalculated, space, training
from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
from heybuddy_tpu_torch.models import featurizer
from heybuddy_tpu_torch.runtime import detection
from heybuddy_tpu_torch.text.tokens import BERTTokenizer
from heybuddy_tpu_torch.utils import strings


def _data(n=37, labeled=False, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, 17 if labeled else 16, 96)).astype(np.float32)
    if labeled:
        texts = ["hey there friend", "buddy holly song", "good morning all", "what a day"]
        tok = BERTTokenizer()
        data[:, -1] = np.stack([tok(texts[i % len(texts)]) for i in range(n)]).astype(np.float32)
    return data


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("labeled", [False, True])
def test_take_and_take_indices_sequences_match_jax(ordered, labeled):
    data = _data(labeled=labeled)
    kwargs = dict(data=data, seed=7, ordered=ordered, labeled=labeled)
    port = precalculated.PrecalculatedDatasetIterator("store", **kwargs)
    ref = jax_pre.PrecalculatedDatasetIterator("store", **kwargs)
    for n in (5, 30, 37, 80, 1):  # within, across and beyond one pass (wraparound reshuffles)
        np.testing.assert_array_equal(port.take(n), ref.take(n))
    port_idx = precalculated.PrecalculatedDatasetIterator("store", **kwargs)
    ref_idx = jax_pre.PrecalculatedDatasetIterator("store", **kwargs)
    rows = len(port_idx.resident_features())
    for n in (11, 30, 100, 3):
        got, want = port_idx.take_indices(n, rows), ref_idx.take_indices(n, rows)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert port.total_taken == ref.total_taken


def test_exclude_filtering_matches_jax(tmp_path):
    """Labeled rows sharing a token with the exclude phrase are dropped, in take
    and in resident_features, as in JAX (the two tokenizers give the same ids)."""
    data = _data(n=40, labeled=True, seed=1)
    assert np.array_equal(BERTTokenizer()("hey buddy"), JaxTokenizer()("hey buddy"))
    path = tmp_path / "negatives.npy"
    np.save(path, data)
    kwargs = dict(directory=str(tmp_path), labeled=True, exclude_phrase="Hey, Buddy!", seed=3)
    port = precalculated.PrecalculatedDatasetIterator("negatives", **kwargs)
    ref = jax_pre.PrecalculatedDatasetIterator("negatives", **kwargs)
    assert port.exclude_text == ref.exclude_text == "Hey Buddy"
    assert port.exclude_tokens == ref.exclude_tokens
    kept = port.resident_features()
    np.testing.assert_array_equal(kept, ref.resident_features())
    assert kept.shape == (20, 16, 96)  # "hey there friend" and "buddy holly song" rows go
    assert port.resident_nbytes() == ref.resident_nbytes()
    for n in (7, 19, 3):
        np.testing.assert_array_equal(port.take(n), ref.take(n))


def test_device_plan_matches_jax():
    def iterator(pre, train):
        return train.WakeWordTrainingDatasetIterator(
            num_batch_threads=1,
            positive=[(pre.PrecalculatedDatasetIterator("p", data=_data(20, seed=1), seed=1), 6)],
            negative=[
                (pre.PrecalculatedDatasetIterator("n", data=_data(30, seed=2), seed=2), 9),
                (pre.PrecalculatedDatasetIterator("e", data=_data(5, seed=3), seed=3), 0),
            ],
        )

    port, ref = iterator(precalculated, training), iterator(jax_pre, jax_training)
    assert port.device_plan(10) is None and ref.device_plan(10) is None  # over budget
    plan, ref_plan = port.device_plan(1 << 30), ref.device_plan(1 << 30)
    assert plan.labels == ref_plan.labels == (1.0, 0.0)
    for _ in range(3):
        assert plan.counts() == ref_plan.counts()
        for a, b in zip(plan.sample(), ref_plan.sample()):
            np.testing.assert_array_equal(a, b)
        port.multiply_batch_size(0.5)
        ref.multiply_batch_size(0.5)


def test_host_batches_have_the_composition():
    it = training.WakeWordTrainingDatasetIterator(
        num_batch_threads=2, max_samples=3,
        positive=[(precalculated.PrecalculatedDatasetIterator("p", data=_data(20), seed=1), 6)],
        negative=[(precalculated.PrecalculatedDatasetIterator("n", data=_data(30), seed=2), 9)],
    )
    it.start()
    try:
        batches = list(it)
    finally:
        it.stop()
    assert len(batches) == 3
    for x, y in batches:
        assert x.shape == (15, 16, 96) and x.dtype == np.float32
        np.testing.assert_array_equal(y, np.r_[np.ones(6), np.zeros(9)].astype(np.float32))
    assert not it.threads


@pytest.fixture()
def fresh_featurizers(monkeypatch):
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    import heybuddy_tpu.models.featurizer as jax_featurizer

    monkeypatch.setattr(jax_featurizer, "_GLOBAL_EMBEDDINGS", None)


def test_active_space_and_provenance_match_jax(fresh_featurizers, monkeypatch):
    assert space.active_space(device="cpu") == jax_space.active_space()
    monkeypatch.setenv("HEYBUDDY_TTS_CHECKPOINT", "/nonexistent/voice.pt")
    for backend in (None, "formant", "formant-device", "device", "vits"):
        assert space.tts_provenance(backend) == jax_space.tts_provenance(backend), backend


@pytest.mark.parametrize("backend,env,checkpoint,resolved", [
    ("formant", "vits", "present", "formant"),  # the argument first
    ("formant-device", None, None, "formant-device"),
    ("device", None, None, "formant-device"),  # the alias
    ("vits", None, None, "vits"),
    ("", "device", None, "formant-device"),  # an empty argument reads the variable
    (None, "formant-device", "present", "formant-device"),  # the variable before the checkpoint
    (None, "formant", "present", "formant"),
    (None, None, "present", "vits"),
    (None, None, "missing", "formant"),
    (None, None, None, "formant"),
])
def test_resolve_tts_backend_table_and_provenance_equal_jax(tmp_path, monkeypatch, backend, env, checkpoint,
                                                            resolved):
    """``resolve_tts_backend``: argument > ``HEYBUDDY_TTS_BACKEND`` > "vits"
    for an existing checkpoint > "formant", "device" read as
    "formant-device"; each case's provenance is the JAX package's."""
    from heybuddy_tpu_torch.models.tts import resolve_tts_backend

    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    if env is None:
        monkeypatch.delenv("HEYBUDDY_TTS_BACKEND", raising=False)
    else:
        monkeypatch.setenv("HEYBUDDY_TTS_BACKEND", env)
    if checkpoint is None:
        monkeypatch.delenv("HEYBUDDY_TTS_CHECKPOINT", raising=False)
    else:
        path = tmp_path / "voice.pt"
        if checkpoint == "present":
            path.write_bytes(b"")
        monkeypatch.setenv("HEYBUDDY_TTS_CHECKPOINT", str(path))
    assert resolve_tts_backend(backend) == resolved
    assert space.tts_provenance(backend) == jax_space.tts_provenance(backend)
    assert space.tts_provenance(backend).startswith(resolved + ":")


def test_sidecar_accept_stamp_reject(tmp_path, fresh_featurizers, monkeypatch):
    path = str(tmp_path / "feats.npy")
    np.save(path, np.zeros((3, 16, 96), np.float32))
    current = space.active_space(device="cpu")
    # no sidecar: stamped with the active space, accepted
    assert space.check_cache_space(path, device="cpu")
    assert space.read_space_sidecar(path) == current == jax_space.read_space_sidecar(path)
    assert jax_space.check_cache_space(path)  # the JAX package accepts the port's stamp
    # another embedding space: rejected by both, kept with the override
    space.write_space_sidecar(path, {**current, "space_id": "0000000000000000"})
    assert not space.check_cache_space(path, device="cpu")
    assert not jax_space.check_cache_space(path)
    monkeypatch.setenv("HEYBUDDY_KEEP_STALE_FEATURES", "1")
    assert space.check_cache_space(path, device="cpu")
    monkeypatch.delenv("HEYBUDDY_KEEP_STALE_FEATURES")
    # the same space from another synthesizer: rejected; a legacy sidecar
    # without "tts" reads as formant:2
    space.write_space_sidecar(path, {**current, "tts": "vits:other.pt;s2"})
    assert not space.check_cache_space(path, device="cpu")
    legacy = {k: v for k, v in current.items() if k != "tts"}
    space.write_space_sidecar(path, legacy)
    assert space.check_cache_space(path, device="cpu") == jax_space.check_cache_space(path)


def test_stale_cache_is_removed_then_raises(tmp_path, fresh_featurizers, monkeypatch):
    """A cache in another space is dropped (with its texts sidecar), as JAX
    drops it, and then generated anew: the stale rows are gone, the texts
    sidecar holds the new pool (JAX's for the same seed), the space sidecar
    is the active space."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), device="cpu")
    path = str(tmp_path / "hey-buddy-adversarial.npy")
    np.save(path, np.full((8, 16, 96), 7.0, np.float32))
    space.write_space_sidecar(path, {**space.active_space(device="cpu"), "space_id": "stale"})
    with open(str(tmp_path / "hey-buddy-adversarial.texts.json"), "w") as f:
        f.write('["stale text"]')
    it = gen.get_training_features(8, adversarial=True, adversarial_phrases=6)
    data = np.load(path)
    assert len(it) == 8 and data.shape == (8, 16, 96)
    assert np.isfinite(data).all() and not (data == 7.0).any()
    assert space.read_space_sidecar(path) == space.active_space(device="cpu")
    with open(str(tmp_path / "hey-buddy-adversarial.texts.json")) as f:
        texts = json.load(f)
    assert "stale text" not in texts
    jax_pool = JaxFeatures("hey buddy", directory=str(tmp_path / "jax")).adversarial_texts(adversarial_phrases=6)
    assert texts == sorted(set(jax_pool)) and len(texts) == 6


def test_cache_names_and_iterators_match_jax(tmp_path, fresh_featurizers, monkeypatch):
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    phrase = ["Hey", "Buddy!"]
    port = TrainingFeaturesGenerator(phrase, directory=str(tmp_path), seed=3, device="cpu")
    ref = JaxFeatures(phrase, directory=str(tmp_path), seed=3)
    for flags in [(a, t, v, p) for a in (0, 1) for t in (0, 1) for v in (0, 1) for p in (0, 1)]:
        assert port._cache_name(*map(bool, flags)) == ref._cache_name(*map(bool, flags))
    space_now = space.active_space(device="cpu")
    calls = [
        ("get_training_features", (6,), {}, "hey-buddy"),
        ("get_training_features", (6,), {"adversarial": True, "testing": True}, "hey-buddy-adversarial-testing"),
        ("get_validation_features", (6,), {"testing": True}, "hey-buddy-testing-validation"),
        ("get_partial_phrase_features", (6,), {"adversarial": True}, "hey-buddy-adversarial-partial"),
        ("get_clean_offset_features", (6,), {}, "hey-buddy-clean-offset"),
        ("get_reverb_positive_features", (6,), {"testing": True}, "hey-buddy-testing-reverb"),
        ("get_stream_window_features", (6,), {"seed": 9}, "negative-speech-stream-9-xhey-buddy"),
        ("get_stream_window_features", (6,), {"collision": True}, "hey-buddy-collision-stream-3"),
        ("get_negative_speech_features", (6,), {"num_texts": 40}, "negative-speech-40-3"),
    ]
    for method, args, kwargs, name in calls:
        path = str(tmp_path / f"{name}.npy")
        np.save(path, _data(10, seed=len(name)))
        space.write_space_sidecar(path, space_now)
        got = getattr(port, method)(*args, **kwargs)
        want = getattr(ref, method)(*args, **kwargs)  # a full cache: JAX generates nothing
        assert got.name == want.name == name
        assert got.stream_stride_seconds == want.stream_stride_seconds
        np.testing.assert_array_equal(got.take(4), want.take(4))
    # a short cache is topped up, its first rows unchanged (JAX's rule: extend, never regenerate)
    first = np.load(str(tmp_path / "hey-buddy.npy"))
    assert len(port.get_training_features(11)) == 11
    grown = np.load(str(tmp_path / "hey-buddy.npy"))
    np.testing.assert_array_equal(grown[:10], first)
    assert grown.shape == (11, 16, 96) and np.isfinite(grown[10]).all()
    # a short stream-window cache is topped up too (it raised while
    # data/streams.py was not ported), its rows kept
    stream_path = str(tmp_path / "negative-speech-stream-9-xhey-buddy.npy")
    first = np.load(stream_path)
    assert len(port.get_stream_window_features(11, seed=9)) == 11
    grown = np.load(stream_path)
    np.testing.assert_array_equal(grown[:10], first)
    assert grown.shape == (11, 16, 96) and np.isfinite(grown[10]).all()


def test_hosted_sets_on_a_local_file(tmp_path, fresh_featurizers, monkeypatch):
    monkeypatch.setenv("HEYBUDDY_DATASET_DIR", str(tmp_path))
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    local = str(tmp_path / "validation.npy")
    # no file: the reference space's hosted sets are disabled, as in JAX
    assert not space.hosted_sets_compatible("test", local_path=local, device="cpu")
    with pytest.raises(FileNotFoundError, match="Hosted dataset validation unavailable"):
        precalculated.PrecalculatedValidationDataset()  # offline: no download is attempted
    np.save(local, _data(12, labeled=True))
    space.write_space_sidecar(local, space.active_space(device="cpu"))
    assert space.hosted_sets_compatible("test", local_path=local, device="cpu")
    assert jax_space.hosted_sets_compatible("test", local_path=local)
    hosted = precalculated.PrecalculatedValidationDataset()
    assert hosted.labeled and len(hosted) == 12
    assert hosted.take(5).shape == (5, 16, 96)
    space.write_space_sidecar(local, {"space_id": "elsewhere", "backend": "onnx"})
    assert not space.hosted_sets_compatible("test", local_path=local, device="cpu")
    assert not jax_space.hosted_sets_compatible("test", local_path=local)
    monkeypatch.setenv("HEYBUDDY_ALLOW_SPACE_MISMATCH", "1")
    assert space.hosted_sets_compatible("test", local_path=local, device="cpu")


def test_strings_and_gate_match_jax():
    for text in ("Hey, Buddy!", "  hey   buddy  ", "ÄÖ--x", "", "123 go"):
        assert strings.safe_name(text) == jax_strings.safe_name(text)
    for seconds in (0.0, 0.5, 0.9994, 1.0, 59.6, 90, 3599.5, 3725, 86400):
        assert strings.human_duration(seconds) == jax_strings.human_duration(seconds)
    rng = np.random.default_rng(0)
    for _ in range(20):
        scores = rng.uniform(0, 1, 200) ** 3
        for consecutive, debounce in ((1, 16), (2, 16), (3, 4), (1, 0)):
            args = (scores, 0.3, consecutive, debounce)
            assert detection.count_detections(*args) == jax_detection.count_detections(*args)
    with pytest.raises(ValueError):
        detection.ConsecutiveGate(consecutive=0)
