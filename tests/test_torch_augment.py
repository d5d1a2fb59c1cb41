"""The port's augmentation chain against the JAX package's.

``jax.random`` cannot be reproduced in torch, so each random stage takes its
draws explicitly: ``jax_draws`` rebuilds, from a JAX key, exactly the values
the JAX chain draws inside (its 12-way split, the ``fold_in(key, 1)``
placement and mixing keys), and the port's apply step gets them. Every
transform and the whole chain then stay within 1e-4 of JAX's on [-1, 1]
audio (measured on the CPU: at most 4.5e-7 for a transform, the band-stop;
8.9e-7 for the chain; the pitch shift and gain exactly). The noise
provider is numpy on both sides and bit-equal; the placements are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.data import augmented as jax_augmented
from heybuddy_tpu.ops import augment as jax_aug
from heybuddy_tpu_torch.constants import CLIP_SAMPLES
from heybuddy_tpu_torch.data import augmented
from heybuddy_tpu_torch.ops import augment

ATOL = 1e-4
T = CLIP_SAMPLES


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run thousands of small eager ops, and
    the suite runs several workers on the machine's cores, where thread
    pools oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_draws(key, b: int, t: int, cfg) -> dict:
    """The draws the JAX ``augment_batch`` makes from ``key``, as the port's draw dict."""
    keys = jax.random.split(key, 12)
    u = jax.random.uniform
    d = {}
    if cfg.seven_band_prob > 0:
        d["eq_apply"] = jax.random.bernoulli(keys[0], cfg.seven_band_prob, (b, 1))
        d["eq_gains_db"] = u(jax.random.split(keys[1])[0], (b, 7), minval=-cfg.seven_band_gain_db,
                             maxval=cfg.seven_band_gain_db)
    if cfg.tanh_distortion_prob > 0:
        d["tanh_apply"] = jax.random.bernoulli(keys[2], cfg.tanh_distortion_prob, (b, 1))
        d["tanh_amount"] = u(keys[3], (b, 1), minval=cfg.tanh_min_distortion, maxval=cfg.tanh_max_distortion)
    if cfg.pitch_shift_prob > 0:
        d["pitch_apply"] = jax.random.bernoulli(keys[4], cfg.pitch_shift_prob, ())
        d["pitch_ratio"] = 2.0 ** (u(keys[5], (), minval=-float(cfg.pitch_shift_semitones),
                                     maxval=float(cfg.pitch_shift_semitones)) / 12.0)
    if cfg.band_stop_prob > 0:
        d["band_stop_apply"] = jax.random.bernoulli(keys[6], cfg.band_stop_prob, (b, 1))
        k_center, k_width = jax.random.split(keys[7])
        d["band_stop_center"] = 2.0 ** u(k_center, (b, 1), minval=np.log2(200.0), maxval=np.log2(4000.0))
        d["band_stop_fraction"] = u(k_width, (b, 1), minval=0.5, maxval=1.99)
    if cfg.colored_noise_prob > 0:
        d["colored_apply"] = jax.random.bernoulli(keys[8], cfg.colored_noise_prob, (b, 1))
        k_noise, k_snr, k_decay = jax.random.split(keys[9], 3)
        d["colored_white"] = jax.random.normal(k_noise, (b, t))
        d["colored_decay"] = u(k_decay, (b, 1), minval=cfg.colored_noise_min_f_decay,
                               maxval=cfg.colored_noise_max_f_decay)
        d["colored_snr_db"] = u(k_snr, (b, 1), minval=cfg.colored_noise_min_snr_db,
                                maxval=cfg.colored_noise_max_snr_db)
    if cfg.gain_prob > 0:
        d["gain_apply"] = jax.random.bernoulli(keys[10], cfg.gain_prob, (b, 1))
        d["gain_db"] = u(keys[11], (b, 1), minval=cfg.gain_min_db, maxval=cfg.gain_max_db)
    k_pad, k_bg, k_bgp, k_rvp = jax.random.split(jax.random.fold_in(key, 1), 4)
    if cfg.placement == "edge":
        k_frac, k_mode = jax.random.split(k_pad)
        d["edge_fraction"] = u(k_frac, (b,), minval=cfg.edge_min_visible, maxval=cfg.edge_max_visible)
        d["edge_head"] = jax.random.bernoulli(k_mode, 0.5, (b,))
    else:
        d["pad_uniform"] = u(k_pad, (b,))
    if cfg.background_noise_prob > 0:
        d["background_snr_db"] = u(k_bg, (b, 1), minval=cfg.background_noise_min_snr_db,
                                   maxval=cfg.background_noise_max_snr_db)
        d["background_apply"] = jax.random.bernoulli(k_bgp, cfg.background_noise_prob, (b, 1))
    if cfg.reverb_prob > 0:
        d["reverb_apply"] = jax.random.bernoulli(k_rvp, cfg.reverb_prob, (b, 1))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def batch(b: int = 4, seed: int = 0):
    """(b, T) left-aligned speech-like clips in [-1, 1] of varied lengths, their
    lengths, and NoiseProvider background noise and impulse responses."""
    rng = np.random.default_rng(seed)
    lengths = np.array([16000, T, 9000, 20001, 12345, 23000][:b], np.int64)
    audio = np.zeros((b, T), np.float32)
    for i, n in enumerate(lengths):
        tt = np.arange(n) / 16000.0
        env = np.sin(np.pi * np.arange(n) / n) ** 2
        audio[i, :n] = (0.5 * env * np.sin(2 * np.pi * (180 + 40 * i) * tt * (1 + tt))
                        + 0.02 * rng.standard_normal(n)).astype(np.float32)
    provider = augmented.NoiseProvider(seed=seed, use_remote=False)
    return audio, lengths, provider.noise_batch(b, T), provider.impulse_batch(b)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= atol, err
    return err


def test_noise_provider_bit_equal_jax():
    port = augmented.NoiseProvider(seed=5, use_remote=False)
    ref = jax_augmented.NoiseProvider(seed=5, use_remote=False)
    for _ in range(2):
        np.testing.assert_array_equal(port.noise_batch(6, T), ref.noise_batch(6, T))
        np.testing.assert_array_equal(port.impulse_batch(5), ref.impulse_batch(5))
    # offline, use_remote falls back to synthetic without touching the network
    assert augmented.NoiseProvider(seed=1)._background_iter is None


def test_each_transform_matches_jax_with_jax_draws():
    cfg = jax_aug.AugmentConfig()
    audio, lengths, noise, impulse = batch()
    x, xj = _t(audio), jnp.asarray(audio)
    key = jax.random.PRNGKey(11)
    d = jax_draws(key, 4, T, cfg._replace(seven_band_prob=0.5, tanh_distortion_prob=0.5, pitch_shift_prob=0.5,
                                           band_stop_prob=0.5, colored_noise_prob=0.5, gain_prob=0.5,
                                           background_noise_prob=0.5))
    keys = jax.random.split(key, 12)
    _close(augment.seven_band_eq(x, d["eq_gains_db"]), jax_aug._seven_band_eq(keys[1], xj, cfg))
    _close(augment.tanh_distortion(x, d["tanh_amount"]), jax_aug._tanh_distortion(keys[3], xj, cfg))
    got, got_len = augment.pitch_shift(x, _t(lengths), d["pitch_ratio"])
    ref, ref_len = jax_aug._pitch_shift(keys[5], xj, jnp.asarray(lengths, jnp.int32), cfg)
    _close(got, ref)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    _close(augment.band_stop(x, d["band_stop_center"], d["band_stop_fraction"]),
           jax_aug._band_stop(keys[7], xj, cfg))
    _close(augment.colored_noise(x, d["colored_white"], d["colored_decay"], d["colored_snr_db"]),
           jax_aug._colored_noise(keys[9], xj, cfg))
    _close(augment.gain(x, d["gain_db"]), jax_aug._gain(keys[11], xj, cfg))
    k_bg = jax.random.split(jax.random.fold_in(key, 1), 4)[1]
    _close(augment.background_noise(x, _t(noise), d["background_snr_db"]),
           jax_aug._background_noise(k_bg, xj, jnp.asarray(noise), cfg))
    _close(augment.reverb(x, _t(impulse)), jax_aug._reverb(xj, jnp.asarray(impulse)))


def test_placements_exact():
    audio, lengths, _, _ = batch(b=6)
    key = jax.random.PRNGKey(4)
    uniform = jax.random.uniform(key, (6,))
    got = augment.random_center_pad(_t(audio), _t(lengths), _t(uniform), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_aug.random_center_pad(
        key, jnp.asarray(audio), jnp.asarray(lengths, jnp.int32), T)))
    k_frac, k_mode = jax.random.split(key)
    frac = jax.random.uniform(k_frac, (6,), minval=0.3, maxval=0.8)
    head = jax.random.bernoulli(k_mode, 0.5, (6,))
    got = augment.edge_pad(_t(audio), _t(lengths), _t(frac), _t(head), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_aug.edge_pad(
        key, jnp.asarray(audio), jnp.asarray(lengths, jnp.int32), T, 0.3, 0.8)))
    assert bool(head.any()) and not bool(head.all())  # both modes exercised


CONFIGS = {
    "defaults": {},
    "every_stage": dict(seven_band_prob=1.0, tanh_distortion_prob=1.0, pitch_shift_prob=1.0, band_stop_prob=1.0,
                        colored_noise_prob=1.0, background_noise_prob=1.0, gain_prob=1.0, reverb_prob=1.0),
    "half": dict(seven_band_prob=0.5, tanh_distortion_prob=0.5, pitch_shift_prob=0.5, band_stop_prob=0.5,
                 colored_noise_prob=0.5, background_noise_prob=0.5, gain_prob=0.5, reverb_prob=0.5),
    "edge": dict(placement="edge", edge_min_visible=0.3, edge_max_visible=0.8),
    "clean_offset": dict(seven_band_prob=0.0, tanh_distortion_prob=0.0, pitch_shift_prob=0.0, band_stop_prob=0.0,
                         colored_noise_prob=0.0, background_noise_prob=0.0, gain_prob=0.0, reverb_prob=0.0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_batch_matches_jax_with_jax_draws(name, seed):
    kwargs = CONFIGS[name]
    cfg, ref_cfg = augment.AugmentConfig(**kwargs), jax_aug.AugmentConfig(**kwargs)
    audio, lengths, noise, impulse = batch(seed=seed)
    if seed == 1:  # all-zero banks switch mixing and reverb off on both sides
        noise, impulse = np.zeros_like(noise), np.zeros((4, 256), np.float32)
    key = jax.random.PRNGKey(100 + seed)
    ref = jax_aug.augment_batch(key, jnp.asarray(audio), jnp.asarray(lengths, jnp.int32), jnp.asarray(noise),
                                jnp.asarray(impulse), ref_cfg)
    got = augment.augment_batch(_t(audio), _t(lengths), _t(noise), _t(impulse), cfg,
                                draws=jax_draws(key, 4, T, ref_cfg))
    _close(got, ref)
    assert float(got.abs().max()) <= 1.0


def test_draws_and_generator_path():
    """``draw_augment``'s shapes are the injected ones; the generator path is
    deterministic per seed and does not move the host-side inputs."""
    cfg = augment.AugmentConfig(**CONFIGS["half"])
    ref_shapes = {k: v.shape for k, v in jax_draws(jax.random.PRNGKey(0), 4, T, cfg).items()}
    draws = augment.draw_augment(augment.seeded_generator(torch.device("cpu"), 3, 1), 4, T, cfg, torch.device("cpu"))
    assert {k: v.shape for k, v in draws.items()} == ref_shapes
    assert draws["eq_apply"].dtype == torch.bool and draws["pitch_ratio"].dtype == torch.float32
    audio, lengths, noise, impulse = batch()
    runs = [augment.augment_batch(_t(audio), _t(lengths), _t(noise), _t(impulse), cfg,
                                  generator=augment.seeded_generator(torch.device("cpu"), 3, k)) for k in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_chain_properties():
    """The JAX suite's properties: gain range, SNR, band stop, reverb smear,
    the pitch shift's lengths and silence, energy-preserving placement."""
    tone = np.zeros((2, T), np.float32)
    tone[:, :T] = 0.3 * np.sin(2 * np.pi * 440 * np.arange(T) / 16000)
    x = _t(tone)
    out = augment.gain(x, torch.full((2, 1), -6.0))
    np.testing.assert_allclose(float(out.pow(2).mean().sqrt() / x.pow(2).mean().sqrt()), 10 ** (-6 / 20), rtol=1e-3)
    noise = _t(np.random.default_rng(2).normal(0, 1.0, (2, T)).astype(np.float32))
    added = augment.background_noise(x, noise, torch.full((2, 1), 10.0)) - x
    snr = 10 * np.log10(float(x.pow(2).mean() / added.pow(2).mean()))
    assert abs(snr - 10.0) < 0.5
    k1 = _t(0.5 * np.sin(2 * np.pi * 1000 * np.arange(T) / 16000).astype(np.float32))[None]
    notched = augment.band_stop(k1, torch.tensor([[1000.0]]), torch.tensor([[1.0]]))
    assert float(notched.pow(2).sum() / k1.pow(2).sum()) < 0.5
    click = torch.zeros((1, T))
    click[0, 1000] = 1.0
    ir = torch.zeros((1, 2048))
    ir[0, 0], ir[0, 500] = 1.0, 0.5
    assert abs(float(augment.reverb(click, ir)[0, 1500])) > 0.1
    audio = np.zeros((2, T), np.float32)
    audio[0, :12000] = 1.0
    audio[1, :] = 1.0
    lengths = np.array([12000, T])
    for semis in (2.5, -2.5):
        ratio = torch.tensor(2.0) ** (torch.tensor(semis) / 12.0)
        out, new_lengths = augment.pitch_shift(_t(audio), _t(lengths), ratio)
        ratio = float(ratio)
        out, new_lengths = out.numpy(), new_lengths.numpy()
        np.testing.assert_array_equal(new_lengths, np.minimum(np.ceil(lengths / np.float32(ratio)), T))
        assert abs(out[0, : new_lengths[0] - 1]).min() > 0.4
        assert abs(out[0, new_lengths[0] + 1:]).max() == 0.0
        if ratio > 1.0:
            assert abs(out[1, int((T - 1) / ratio) + 2:]).max() == 0.0
    placed = augment.random_center_pad(_t(audio), _t(lengths), torch.tensor([0.3, 0.9]), T)
    np.testing.assert_allclose(placed.pow(2).sum(1).numpy(), (audio ** 2).sum(1), rtol=1e-6)


def test_augmented_audio_generator_batches():
    """Host batching as JAX's: _prepare_clip's normalisation, centring for
    pad-only, full batches then the tail; the provider's stream stays in step."""
    port = augmented.AugmentedAudioGenerator(iter([]), pad_only=True, device="cpu")
    ref = jax_augmented.AugmentedAudioGenerator(iter([]), pad_only=True)
    t = np.sin(2 * np.pi * 440 * np.arange(1600) / 16000)
    for arr in ((0.5 * t).astype(np.float32), (0.5 * t * 32768).astype(np.int16),
                ((0.5 * t + 1.0) * 127.5).astype(np.uint8), (0.5 * t * 32767.0).astype(np.float32)):
        sample = {"audio": {"array": arr, "sampling_rate": 16000}}
        np.testing.assert_array_equal(port._prepare_clip(sample), ref._prepare_clip(sample))
    clips = [np.full(n, 0.25, np.float32) for n in (100, 23040, 5000, 30000)]
    np.testing.assert_array_equal(port.execute_augment_batch(clips), ref.execute_augment_batch(clips))

    source = [{"audio": {"array": np.full(4000 + 10 * i, 0.1, np.float32), "sampling_rate": 16000},
               "phrase": f"p{i}"} for i in range(5)]
    gen = augmented.AugmentedAudioGenerator(iter(source), batch_size=2, seed=3, device="cpu")
    out = list(gen())
    assert [o["phrase"] for o in out] == [f"p{i}" for i in range(5)] and gen._batch_index == 3
    assert all(o["audio"]["array"].shape == (T,) and np.abs(o["audio"]["array"]).max() <= 1.0 for o in out)
    ref_provider = jax_augmented.NoiseProvider(seed=3, use_remote=False)
    for _ in range(3):  # three batches of two noise rows, the tail drawn for a full batch
        ref_provider.noise_batch(2, T)
        ref_provider.impulse_batch(2)
    np.testing.assert_array_equal(gen.noise.noise_batch(1, T), ref_provider.noise_batch(1, T))
