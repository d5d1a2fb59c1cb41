"""Feature generation in the port against the JAX package's: the sample
generator's sequences, the caches' names, seed blocks, augmentation configs
and text sidecars, top-ups, the pad-only caches of both routes, the fused
route's augmented batch, and ``train`` from an empty dataset directory on
the CPU."""

import functools
import json
import os
import unittest.mock as mock
from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heybuddy_tpu.data.features as jax_features
import heybuddy_tpu.data.tts_generator as jax_tts_generator
import heybuddy_tpu.models.featurizer as jax_featurizer
import heybuddy_tpu.ops.pallas.embedding_kernel as jax_ek
import heybuddy_tpu.ops.pallas.melspec_kernel as jax_mk
from heybuddy_tpu.data.augmented import AugmentedAudioGenerator as JaxAugmented
from heybuddy_tpu.data.augmented import NoiseProvider as JaxNoiseProvider
from heybuddy_tpu.data.tts_generator import SpeechSampleGenerator as JaxSpeech
from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.models import formant_device as jax_fd
from heybuddy_tpu.models import tts as jax_tts
from heybuddy_tpu.ops import augment as jax_augment
from heybuddy_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.data import features
from heybuddy_tpu_torch.data import tts_generator as port_tts_generator
from heybuddy_tpu_torch.data.augmented import AugmentedAudioGenerator
from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
from heybuddy_tpu_torch.data.tts_generator import SpeechSampleGenerator
from heybuddy_tpu_torch.models import featurizer, formant_device, tts
from heybuddy_tpu_torch.ops.augment import AugmentConfig

from test_torch_formant import jax_clip_noise
from torch_fixtures import assert_features_close, jax_draws

L_MAX = 24000


@pytest.fixture(autouse=True)
def generation_env(monkeypatch):
    """Offline, the rule G2P, fresh shared TTS / featurizer instances in both packages."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.delenv("HEYBUDDY_TTS_BACKEND", raising=False)
    monkeypatch.delenv("HEYBUDDY_FUSED_TTS", raising=False)
    monkeypatch.setattr(tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(jax_tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    monkeypatch.setattr(jax_featurizer, "_GLOBAL_EMBEDDINGS", None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small eager ops, and
    the suite runs several workers on the machine's cores, where thread
    pools oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_fused(params, mono: np.ndarray) -> np.ndarray:
    """JAX's fused Pallas featurizer in interpret mode (its CPU default is the XLA banded path)."""
    with _jax_pallas_interpret():
        return np.asarray(jax_featurizer.featurize_batch(params, jnp.asarray(mono), pooling="fused"))


def _jax_pallas_interpret() -> ExitStack:
    """JAX's "auto" pooling on the fused Pallas kernels, in interpret mode."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        jax_mk, "mel_patches_pallas", functools.partial(jax_mk.mel_patches_pallas, interpret=True)))
    stack.enter_context(mock.patch.object(
        jax_ek, "fused_embedding_from_patches", functools.partial(jax_ek.fused_embedding_from_patches, interpret=True)))
    stack.enter_context(mock.patch.object(jax_featurizer, "_resolve_pooling", lambda pooling: "fused"))
    return stack


@pytest.mark.parametrize("adversarial", [False, True])
def test_sample_generator_sequences_equal_jax(adversarial):
    """Texts, grid offsets and seeds per batch: the host audio is bit-equal;
    the device backend's plans too."""
    kwargs = dict(adversarial=adversarial, batch_size=3, seed=21, num_adversarial_texts=12)
    port = SpeechSampleGenerator("hey buddy", device="cpu", **kwargs)
    ref = JaxSpeech("hey buddy", **kwargs)
    assert port.get_texts() == ref.get_texts()
    got, want = list(port(7)), list(ref(7))
    assert [s["phrase"] for s in got] == [s["phrase"] for s in want]
    for a, b in zip(got, want):
        assert a["audio"]["sampling_rate"] == b["audio"]["sampling_rate"] == 16000
        np.testing.assert_array_equal(a["audio"]["array"], b["audio"]["array"])
        assert a["audio"]["array"].dtype == np.int16
    port_d = SpeechSampleGenerator("hey buddy", tts_backend="formant-device", device="cpu", **kwargs)
    ref_d = JaxSpeech("hey buddy", tts_backend="formant-device", **kwargs)
    for a, b in zip(port_d(5, yield_plans=True), ref_d(5, yield_plans=True)):
        assert a["phrase"] == b["phrase"]
        np.testing.assert_array_equal(a["plan"].tracks, b["plan"].tracks)
        assert a["plan"].clip_seed == b["plan"].clip_seed


class _Recorder:
    """Records every sample generator and featurize call of a package's
    TrainingFeaturesGenerator, writing zero rows instead of featurizing."""

    def __init__(self, module, generator_module, monkeypatch):
        self.calls = []
        recorder = self
        base = generator_module.SpeechSampleGenerator

        class Speech(base):
            def __init__(self, phrase, **kwargs):
                super().__init__(phrase, **kwargs)
                keep = ("adversarial", "seed", "num_adversarial_texts", "custom_adversarial_texts",
                        "phrase_augment_prob", "additional_phrases")
                recorder.calls.append(("speech", phrase, {k: kwargs.get(k) for k in keep}))

        def featurize(self, samples, pad_only, store, limit, seed_offset=0, config=None):
            cfg = (config or self.augment_config)._asdict()
            recorder.calls.append(("featurize", os.path.basename(store.path), pad_only, limit, seed_offset, cfg))
            store.append(np.zeros((limit, 16, 96), np.float32))
            return limit

        monkeypatch.setattr(module, "SpeechSampleGenerator", Speech)
        monkeypatch.setattr(generator_module, "SpeechSampleGenerator", Speech)
        monkeypatch.setattr(module.TrainingFeaturesGenerator, "_featurize_stream", featurize)


def test_cache_names_seed_blocks_configs_and_sidecars_equal_jax(tmp_path, monkeypatch):
    """Every getter, then top-ups: the same caches, generator seeds, text
    options, augmentation configs, seed offsets and texts sidecars as JAX."""
    port_rec = _Recorder(features, port_tts_generator, monkeypatch)
    ref_rec = _Recorder(jax_features, jax_tts_generator, monkeypatch)
    common = dict(seed=3, phrase_augment_prob=0.5, custom_adversarial_texts=["hey body"])
    port = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path / "port"), device="cpu",
                                     augment_config=AugmentConfig(gain_prob=0.5), **common)
    ref = jax_features.TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path / "jax"),
                                                 augment_config=JaxAugmentConfig(gain_prob=0.5), **common)
    calls = [
        ("get_training_features", (6,), {}),
        ("get_training_features", (9,), {}),  # top-up: 3 more from a later seed
        ("get_training_features", (5,), {"adversarial": True, "adversarial_phrases": 8}),
        ("get_training_features", (4,), {"adversarial": True, "testing": True}),
        ("get_validation_features", (4,), {}),
        ("get_validation_features", (4,), {"testing": True}),
        ("get_partial_phrase_features", (3,), {}),
        ("get_partial_phrase_features", (3,), {"adversarial": True, "min_visible": 0.4}),
        ("get_clean_offset_features", (3,), {"adversarial": True, "testing": True}),
        ("get_reverb_positive_features", (3,), {}),
        ("get_reverb_collision_features", (3, ["hate buddy", "hey bunny"]), {}),
        ("get_negative_speech_features", (3,), {"num_texts": 20}),
        ("get_negative_speech_features", (5,), {"num_texts": 20}),
    ]
    for method, args, kwargs in calls:
        got, want = getattr(port, method)(*args, **kwargs), getattr(ref, method)(*args, **kwargs)
        assert got.name == want.name
    assert port_rec.calls == ref_rec.calls
    assert sum(c[0] == "featurize" for c in port_rec.calls) == len(calls)
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert os.path.exists(tmp_path / "port" / name), name
        if name.endswith(".texts.json"):
            with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
                assert json.load(f) == json.load(g), name
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for partial in (False, True):
        assert port.adversarial_texts(partial=partial) == ref.adversarial_texts(partial=partial)
    assert port.adversarial_texts(validation=True) == ref.adversarial_texts(validation=True)  # no sidecar: derived


def test_pad_only_cache_host_route_matches_jax(tmp_path):
    """The default route's pad-only validation cache: the centred host audio
    is the JAX package's bit for bit, and its features lie within the
    featurizer's bound of JAX's fused path on that audio."""
    port = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), seed=5, device="cpu")
    port.get_validation_features(4)
    cache = np.load(tmp_path / "hey-buddy-validation.npy")
    assert cache.shape == (4, 16, 96) and np.isfinite(cache).all()
    seed = 5 + features._SEED_NAMESPACE * 7
    assert jax_features._SEED_NAMESPACE == features._SEED_NAMESPACE
    port_audio = [s["audio"]["array"] for s in AugmentedAudioGenerator(
        SpeechSampleGenerator("hey buddy", batch_size=port.tts_batch_size, seed=seed, device="cpu")(4),
        pad_only=True, device="cpu")()]
    ref_audio = [s["audio"]["array"] for s in JaxAugmented(
        JaxSpeech("hey buddy", batch_size=port.tts_batch_size, seed=seed)(4), pad_only=True)()]
    np.testing.assert_array_equal(np.stack(port_audio), np.stack(ref_audio))
    mono = np.stack(ref_audio) * 32767.0
    assert_features_close(cache, _jax_fused(jax_net.default_params(), mono), mono)


def _fused_plans():
    planner = jax_fd.DeviceFormantPlanner(max_samples=L_MAX)
    plans = [planner.plan(t, speaker=s, seed=40 + s) for s, t in enumerate(["hey buddy", "hay bunny", "buddy"])]
    packed = jax_fd.pack_plans(plans, L_MAX)
    return plans, packed, [packed[k] for k in ("tracks", "table", "scale", "noise_scale", "length", "seeds")]


def _jax_fused_batch(inputs, bank, irs, key, pad_only):
    """JAX's ``_fused_features_impl`` (its fused featurizer in interpret mode) and its staged audio."""
    cfg = JaxAugmentConfig()
    impl = jax.jit(functools.partial(jax_fd._fused_features_impl, l_max=L_MAX, harmonics=48, sample_rate=16000,
                                     clip_samples=cfg.target_samples, config=cfg, pad_only=pad_only))
    with _jax_pallas_interpret():
        ref = np.asarray(impl(*inputs, bank, irs, key, jax_net.default_params()))
    audio = jax_fd._render_impl(*inputs, l_max=L_MAX, harmonics=48, sample_rate=16000)
    clip = audio[:, :cfg.target_samples] * (1.0 / 0.7)
    lengths = jnp.minimum(inputs[4], cfg.target_samples)
    if pad_only:
        return ref, jax_fd._center_place(clip, lengths, cfg.target_samples), None
    b = clip.shape[0]
    rows_n = jax.random.randint(jax.random.fold_in(key, 1000), (b,), 0, bank.shape[0])
    rows_i = jax.random.randint(jax.random.fold_in(key, 1001), (b,), 0, irs.shape[0])
    staged = jax_augment.augment_batch(key, clip, lengths, jnp.asarray(bank)[rows_n], jnp.asarray(irs)[rows_i], cfg)
    draws = jax_draws(key, b, cfg.target_samples, cfg)
    draws["noise_rows"] = torch.from_numpy(np.array(rows_n)).long()
    draws["impulse_rows"] = torch.from_numpy(np.array(rows_i)).long()
    return ref, staged, draws


def test_fused_pad_only_batch_matches_jax_with_jax_noise():
    """``fused_features_batch(pad_only=True)`` with JAX's render draws against
    JAX's ``_fused_features_impl`` (its fused featurizer in interpret mode)."""
    plans, packed, inputs = _fused_plans()
    bank = np.zeros((1, JaxAugmentConfig().target_samples), np.float32)
    irs = np.zeros((1, 256), np.float32)
    ref, staged, _ = _jax_fused_batch(inputs, bank, irs, jax.random.PRNGKey(0), pad_only=True)
    net = featurizer.get_speech_embeddings(device="cpu").net
    got, n = formant_device.fused_features_batch(
        plans, net, None, torch.from_numpy(bank), torch.from_numpy(irs), AugmentConfig(), pad_only=True,
        l_max=L_MAX, harmonics=48, noise=jax_clip_noise(packed["seeds"], L_MAX))
    assert n == 3 and got.shape == ref.shape == (3, 16, 96)
    assert_features_close(got.numpy(), ref, np.asarray(staged) * 32767.0)


def test_fused_augmented_batch_matches_jax_with_jax_draws():
    """The fused batch of the augmented caches, render -> bank rows ->
    ``augment_batch`` -> K1 -> K2, given JAX's render noise, bank rows and
    augmentation draws rebuilt from its key, against JAX's
    ``_fused_features_impl``."""
    plans, packed, inputs = _fused_plans()
    provider = JaxNoiseProvider(seed=3, use_remote=False)
    bank, irs = provider.noise_batch(4, JaxAugmentConfig().target_samples), provider.impulse_batch(4)
    ref, staged, draws = _jax_fused_batch(inputs, bank, irs, jax.random.PRNGKey(9), pad_only=False)
    net = featurizer.get_speech_embeddings(device="cpu").net
    got, n = formant_device.fused_features_batch(
        plans, net, None, torch.from_numpy(bank), torch.from_numpy(irs), AugmentConfig(), l_max=L_MAX,
        harmonics=48, noise=jax_clip_noise(packed["seeds"], L_MAX), draws=draws)
    assert n == 3 and got.shape == ref.shape == (3, 16, 96)
    assert_features_close(got.numpy(), ref, np.asarray(staged) * 32767.0)


def test_fused_route_generates_and_tops_up(tmp_path, monkeypatch):
    """The fused route on the CPU: augmented and pad-only caches, a top-up
    that keeps the first rows, the noise banks built once, host fallback
    clips for a phrase too long to plan."""
    monkeypatch.setitem(tts._GLOBAL_TTS, ("formant-device", "cpu"),
                        tts.DeviceFormantTTS(max_samples=L_MAX, harmonics=48, device="cpu"))
    monkeypatch.setenv("HEYBUDDY_NOISE_BANK", "16")
    gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), seed=7, device="cpu",
                                    tts_backend="formant-device", tts_batch_size=4, augment_batch_size=4,
                                    embed_batch_size=4)
    assert gen._use_fused_pipeline()
    gen.get_training_features(5)
    first = np.load(tmp_path / "hey-buddy.npy")
    gen.get_training_features(7)
    grown = np.load(tmp_path / "hey-buddy.npy")
    assert grown.shape == (7, 16, 96) and np.isfinite(grown).all() and grown.std() > 0.01
    np.testing.assert_array_equal(grown[:5], first)
    banks = gen._fused_banks()
    assert banks[0].shape == (16, 23040) and banks[1].shape == (16, 8000) and gen._fused_banks() is banks
    gen.get_validation_features(3)
    with open(tmp_path / "hey-buddy-validation.space.json") as f:
        assert json.load(f)["tts"].startswith("formant-device:")
    long_phrase = " ".join(["fundamental counterrevolutionaries"] * 3)
    mixed = TrainingFeaturesGenerator([long_phrase, "hey buddy"], directory=str(tmp_path), seed=11, device="cpu",
                                      tts_backend="formant-device", tts_batch_size=4, augment_batch_size=4,
                                      embed_batch_size=4)
    mixed.get_training_features(6)
    assert np.load(tmp_path / (mixed._cache_name(False, False, False) + ".npy")).shape == (6, 16, 96)
    monkeypatch.setenv("HEYBUDDY_FUSED_TTS", "0")
    assert not gen._use_fused_pipeline()


@pytest.mark.parametrize("route,events", [
    # fused batches of 2: batch i dispatched (D) before batch i-1 is drained (R); the fourth
    # batch is dispatched and dropped once the third's drain reaches the limit
    ("fused", {5: "DDRDRDR", 8: "DDRDRDRR"}),
    # classic batches of 3: the short tail is dispatched only after the pending batch is
    # drained, and not at all once that drain reaches the limit
    ("classic", {5: "DDRR", 8: "DDRRDR"}),
])
def test_the_dispatch_loop_cuts_at_the_limit(tmp_path, monkeypatch, route, events):
    """Eight samples into a store with room for 5: the first 5 rows of the
    uncut run, in order, through the same dispatches and ``_drain`` calls up
    to the cut."""
    fused = route == "fused"
    if fused:
        monkeypatch.setitem(tts._GLOBAL_TTS, ("formant-device", "cpu"),
                            tts.DeviceFormantTTS(max_samples=L_MAX, harmonics=48, device="cpu"))
        monkeypatch.setenv("HEYBUDDY_FUSED_TTS_BATCH", "2")
    log = []
    if fused:
        dispatch = formant_device.fused_features_batch
        monkeypatch.setattr(formant_device, "fused_features_batch",
                            lambda *args, **kwargs: log.append("D") or dispatch(*args, **kwargs))
    else:
        embeddings = featurizer.get_speech_embeddings(device="cpu")
        featurize = embeddings.featurize_device
        monkeypatch.setattr(embeddings, "featurize_device", lambda *args: log.append("D") or featurize(*args))
    rows = {}
    for limit in (5, 8):
        log.clear()
        # a generator of its own: the augmenter's noise provider draws as it goes
        gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), seed=7, device="cpu",
                                        tts_backend="formant-device" if fused else "formant", tts_batch_size=4,
                                        augment_batch_size=4, embed_batch_size=3)
        drain = gen._drain
        monkeypatch.setattr(gen, "_drain", lambda *args, drain=drain: log.append("R") or drain(*args))
        store = features.AppendableNpyFile(str(tmp_path / f"cut-{limit}.npy"))
        speech = gen._speech(False, 9)
        run = gen._featurize_plan_stream if fused else gen._featurize_stream
        written = run(speech(8, yield_plans=True) if fused else speech(8), pad_only=False, store=store,
                      limit=limit, seed_offset=3)
        assert written == limit and "".join(log) == events[limit]
        rows[limit] = np.load(store.path)
    assert rows[5].shape == (5, 16, 96) and np.isfinite(rows[5]).all()
    np.testing.assert_array_equal(rows[5], rows[8][:5])


def test_stream_windows_still_raise(tmp_path):
    """Stream-window caches are generated (they raised while data/streams.py
    was not ported): speech and collision windows on the host route, and
    adversarial windows rendered on the device backend's 128-clip batches."""
    gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), device="cpu")
    for kwargs, name in (({}, "negative-speech-stream-0-xhey-buddy"), ({"collision": True},
                                                                       "hey-buddy-collision-stream-0")):
        it = gen.get_stream_window_features(4, **kwargs)
        rows = np.load(tmp_path / f"{name}.npy")
        assert it.name == name and it.stream_stride_seconds == 0.12 and len(it) == 4
        assert rows.shape == (4, 16, 96) and np.isfinite(rows).all() and rows.std() > 0.01
    device_gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path / "device"), device="cpu",
                                           tts_backend="formant-device")
    it = device_gen.get_stream_window_features(3, adversarial=True)
    rows = np.load(tmp_path / "device" / "hey-buddy-adversarial-stream-0.npy")
    assert rows.shape == (3, 16, 96) and np.isfinite(rows).all()
    with open(tmp_path / "device" / "hey-buddy-adversarial-stream-0.space.json") as f:
        assert json.load(f)["tts"].startswith("formant-device:")


def test_autoconfigure_batch_sizes_on_the_cpu():
    sizes = features.autoconfigure_batch_sizes("cpu")
    assert set(sizes) == {"tts_batch_size", "augment_batch_size", "embed_batch_size"}
    assert sizes["embed_batch_size"] <= 8192  # no device memory to read: never the 16384 tier


def test_cli_trains_from_an_empty_dataset_directory(tmp_dataset_dir, tmp_path, capsys):
    """``train --device cpu`` with tiny counts generates every default cache
    (positives, adversarials, the testing-validation, both testing caches),
    with prefix-negative and swap-collision texts in the adversarial pool,
    and trains."""
    ckpt = tmp_path / "ckpt"
    argv = ["train", "hey buddy", "--device", "cpu", "--positive-samples", "12", "--adversarial-samples", "12",
            "--validation-samples", "4", "--testing-positive-samples", "4", "--testing-adversarial-samples", "4",
            "--steps", "6", "--stages", "1", "--validation-steps", "3", "--checkpoint-steps", "100",
            "--positive-batch-size", "4", "--adversarial-batch-size", "4", "--training-no-default-dataset",
            "--adversarial-phrases", "6", "--prefix-negative-phrases", "4", "--collision-swap-phrases", "3",
            "--num-batch-threads", "1", "--checkpoint-dir", str(ckpt)]
    assert cli_main(argv) == 0
    assert capsys.readouterr().out.strip() == f"Training complete; final checkpoint: {ckpt}/hey-buddy_final.npz"
    rows = {"hey-buddy": 12, "hey-buddy-adversarial": 12, "hey-buddy-testing-validation": 4,
            "hey-buddy-testing": 4, "hey-buddy-adversarial-testing": 4}
    for name, n in rows.items():
        data = np.load(os.path.join(tmp_dataset_dir, f"{name}.npy"))
        assert data.shape == (n, 16, 96) and np.isfinite(data).all(), name
    with open(os.path.join(tmp_dataset_dir, "hey-buddy-adversarial.texts.json")) as f:
        pool = json.load(f)
    from heybuddy_tpu_torch.text.adversarial import prefix_negative_texts, single_swap_collision_texts

    assert set(prefix_negative_texts("hey buddy", num_samples=4)) <= set(pool)
    assert set(single_swap_collision_texts("hey buddy", num_samples=3)) <= set(pool)
    assert (ckpt / "hey-buddy_final.npz").exists()
