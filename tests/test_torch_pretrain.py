"""Embedding pretraining, the port against the JAX package (both on the CPU).

Held: the two losses and their gradients with respect to the embeddings; the
text pool; the index, speaker, bank-row and pair-mask streams (bit for bit);
the host ``formant`` clip pool (bit for bit); one step's loss and gradient
from JAX's initial parameters with JAX's augmentation draws injected, in
float32 compute (tight) and in bf16 (by the rule below); three steps'
parameters under the Adam rule; the npz in both directions; and
``pretrain-embedding`` end to end at a tiny size. The clip pools of the
step tests are seeded speech-like clips, the same arrays on both sides.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.ops import augment as jax_aug
from heybuddy_tpu.ops.melspec import mel_spectrogram as jax_mel_spectrogram
from heybuddy_tpu.ops.windows import embedding_window_starts as jax_window_starts
from heybuddy_tpu.training import embedding_pretrain as jax_pretrain
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.constants import CLIP_SAMPLES
from heybuddy_tpu_torch.models import embedding_net
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings
from heybuddy_tpu_torch.training import embedding_pretrain as pretrain
from heybuddy_tpu_torch.utils import profiling

from torch_fixtures import jax_draws

T = CLIP_SAMPLES
B = 4
LOSS_Z_TOL = 1e-6  # the losses on the same embeddings, relative to max(|loss|, 1): float32, another summation order
GRAD_Z_ATOL = 1e-7  # their gradients with respect to z, elementwise, relative to the largest
# One step in float32 compute, relative loss and gradient (as max |d| over the
# gradient's norm). The views agree to 1.5e-7 and K3's plain mel to JAX's XLA
# mel to 1.9e-6; the embedding carries that to 2.0e-5 in the loss and 5.3e-6
# in the gradient (measured, step 0).
F32_LOSS_RTOL = 1e-4
F32_GRAD_TOL = 1e-4
# bf16 compute: max(this, 1.25x JAX's own bf16-vs-f32 distance), loss and
# gradient alike (step 0: JAX's own 6.0e-3 / 6.8e-4, the port's 6.1e-4 / 2.3e-4)
BF16_FLOOR = 5e-4
# three Adam steps in float32 compute: the wake-word trainer's rule, 99% within
# 1e-5 + 1e-4 |x|, all within PARAM_MAX: a near-zero gradient whose sign flips
# moves by up to about lr (1e-3) a step
PARAM_ATOL, PARAM_RTOL, PARAM_SHARE = 1e-5, 1e-4, 0.99
PARAM_MAX = 3e-3


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ losses


def _z_batch(seed=0, b=6, d=96):
    rng = np.random.default_rng(seed)
    z1 = rng.normal(size=(b, d)).astype(np.float32)
    z2 = (z1 + 0.5 * rng.normal(size=(b, d))).astype(np.float32)
    mask = np.zeros((b, b), bool)
    for i, j in ((0, 1), (0, 2), (3, 4)):
        mask[i, j] = mask[j, i] = True
    z1[1] = z1[0] + 0.1 * z1[1]  # a close pair, above the margin
    return z1, z2, mask


@pytest.mark.parametrize("temperature,margin", [(0.1, 0.4), (0.5, 0.0), (0.05, 0.8)])
def test_losses_and_their_gradients_match_jax(temperature, margin):
    z1, z2, mask = _z_batch()

    def jax_total(a, b):
        return (jax_pretrain.nt_xent_loss(a, b, temperature),
                jax_pretrain.hard_pair_margin_loss(a, b, jnp.asarray(mask), margin))

    ref = jax_total(jnp.asarray(z1), jnp.asarray(z2))
    ref_grads = [jax.grad(lambda a, b, k=k: jax_total(a, b)[k], argnums=(0, 1))(jnp.asarray(z1), jnp.asarray(z2))
                 for k in range(2)]
    for k, fn in enumerate((lambda a, b: pretrain.nt_xent_loss(a, b, temperature),
                            lambda a, b: pretrain.hard_pair_margin_loss(a, b, torch.from_numpy(mask), margin))):
        t1, t2 = torch.tensor(z1, requires_grad=True), torch.tensor(z2, requires_grad=True)
        loss = fn(t1, t2)
        loss.backward()
        want = float(ref[k])
        assert abs(loss.item() - want) <= LOSS_Z_TOL * max(abs(want), 1.0), (k, loss.item(), want)
        for got, g_ref in zip((t1.grad.numpy(), t2.grad.numpy()), ref_grads[k]):
            g_ref = np.asarray(g_ref)
            assert np.abs(got - g_ref).max() <= GRAD_Z_ATOL + 1e-5 * np.abs(g_ref).max(), k
    assert ref[1] > 0.0


def test_loss_properties_follow_jax():
    z = torch.ones((8, 96))
    assert abs(pretrain.nt_xent_loss(z, z).item() - np.log(2 * 8 - 1)) < 1e-3
    assert pretrain.hard_pair_margin_loss(z, z, torch.zeros((8, 8), dtype=torch.bool)).item() == 0.0


# -------------------------------------------------------------- host streams


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(adversarial_fraction=0.5),
    dict(adversarial_fraction=0.25, focus_phrase="hey buddy"),
    dict(adversarial_fraction=0.25, focus_phrase="hey buddy", focus_swap_depth=8),
    dict(adversarial_fraction=0.25, focus_phrase="hey buddy", focus_swap_depth=6, focus_swap_max_swaps=2),
])
def test_default_texts_equal_jax(kwargs):
    for num_texts, seed in ((64, 0), (40, 3)):
        got = pretrain.EmbeddingPretrainer._default_texts(num_texts, seed, **kwargs)
        want = jax_pretrain.EmbeddingPretrainer._default_texts(num_texts, seed, **kwargs)
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype


def _pretrainers(**kwargs):
    port = pretrain.EmbeddingPretrainer(device="cpu", **kwargs)
    ref = jax_pretrain.EmbeddingPretrainer(**kwargs)
    return port, ref


def _jax_sample_step(ref, cluster_members, n_texts, n_spk):
    """The index draws of the JAX ``train`` loop, line for line."""
    text_idx = ref._sample_batch(cluster_members, n_texts)
    ids = ref.cluster_ids[text_idx]
    pair_mask = (ids[:, None] == ids[None, :]) & (ids[:, None] >= 0)
    np.fill_diagonal(pair_mask, False)
    spk = np.stack([ref.rng.choice(n_spk, size=2, replace=n_spk < 2) for _ in range(ref.batch_size)])
    noise = ref.rng.integers(0, 256, (2, ref.batch_size)).astype(np.int32)
    imp = ref.rng.integers(0, 64, (2, ref.batch_size)).astype(np.int32)
    return text_idx.astype(np.int32), spk.astype(np.int32), noise, imp, pair_mask


@pytest.mark.parametrize("kwargs", [
    dict(num_texts=64, batch_size=16, adversarial_fraction=0.5, focus_phrase="hey buddy", seed=0),
    dict(num_texts=32, batch_size=8, seed=5),
    dict(num_texts=32, batch_size=8, adversarial_fraction=0.5, seed=2, cluster_slots_fraction=0.5),
])
def test_index_and_pair_mask_streams_bit_equal_jax(kwargs):
    port, ref = _pretrainers(speakers_per_text=3, **kwargs)
    members = port._cluster_members()
    ref_members = {int(c): np.flatnonzero(ref.cluster_ids == c) for c in np.unique(ref.cluster_ids) if c >= 0}
    assert members.keys() == ref_members.keys()
    n_texts = len(port.texts)
    pairs = 0
    for _ in range(50):
        got = port.sample_step(members, n_texts, 3)
        want = _jax_sample_step(ref, ref_members, n_texts, 3)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        pairs += int(got.pair_mask.sum())
    assert (pairs > 0) == bool(kwargs.get("adversarial_fraction"))


def test_host_formant_clip_pool_bit_equal_jax():
    texts = ["hey buddy", "turn on the lights", "hello", "what time is it", "buddy", "stop"]
    port, ref = _pretrainers(texts=texts, speakers_per_text=2, batch_size=4, tts_backend="formant", seed=3)
    port.build_clip_pool()
    ref.build_clip_pool()
    assert port._pool.shape == ref._pool.shape == (6, 2, T)
    assert np.array_equal(port._pool, ref._pool)
    assert np.array_equal(port._pool_lengths, ref._pool_lengths)
    assert (port._pool_lengths > 4000).all()


def test_device_formant_clip_pool_plans_in_batches(monkeypatch):
    """The formant-device clip pool plans each chunk of renderings in one
    ``plan_batch`` call, and its clips equal those rendered from the JAX
    package's one-clip plans."""
    from heybuddy_tpu.models import formant_device as jax_fd
    from heybuddy_tpu_torch.models import formant_device

    kwargs = dict(texts=["hey buddy", "hello", "stop"], speakers_per_text=2, batch_size=2,
                  tts_backend="formant-device", seed=5, device="cpu")
    sizes = []
    batched = formant_device.DeviceFormantPlanner.plan_batch
    monkeypatch.setattr(formant_device.DeviceFormantPlanner, "plan_batch",
                        lambda self, texts, *rest: sizes.append(len(texts)) or batched(self, texts, *rest))
    port = pretrain.EmbeddingPretrainer(**kwargs)
    port.build_clip_pool()
    assert sizes == [6]

    one_clip = jax_fd.DeviceFormantPlanner()
    monkeypatch.setattr(formant_device.DeviceFormantPlanner, "plan_batch",
                        lambda self, *columns: [one_clip.plan(text, speaker=speaker, length_scale=ls, noise_scale=ns,
                                                              seed=seed, speaker_params=params)
                                                for text, speaker, ls, ns, seed, params in zip(*columns)])
    ref = pretrain.EmbeddingPretrainer(**kwargs)
    ref.build_clip_pool()
    assert np.array_equal(port._pool, ref._pool)
    assert np.array_equal(port._pool_lengths, ref._pool_lengths)
    assert (port._pool_lengths > 4000).all()


# ----------------------------------------------------------------- the step


def _speech_pool(n_texts=8, n_spk=2, seed=0):
    """(texts, speakers, T) left-aligned speech-like clips in [-1, 1] and their lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(9000, T, (n_texts, n_spk)).astype(np.int32)
    pool = np.zeros((n_texts, n_spk, T), np.float32)
    for i in range(n_texts):
        for j in range(n_spk):
            n = lengths[i, j]
            t = np.arange(n) / 16000.0
            env = np.sin(np.pi * np.arange(n) / n) ** 2
            f0 = 120 + 25 * i + 40 * j
            pool[i, j, :n] = (0.5 * env * np.sin(2 * np.pi * f0 * t * (1 + 0.3 * t))
                              + 0.02 * rng.standard_normal(n)).astype(np.float32)
    return pool, lengths


@pytest.fixture(scope="module")
def step_setup(tmp_path_factory):
    """A JAX pretrainer (its seeded initial parameters) and a port pretrainer
    warm-started from them, sharing one clip pool and the same banks."""
    texts = [f"text {i}" for i in range(8)]
    ref = jax_pretrain.EmbeddingPretrainer(texts=texts, speakers_per_text=2, batch_size=B, seed=0)
    path = str(tmp_path_factory.mktemp("init") / "jax-init.npz")
    jax_net.save_params(ref.params, path)
    pool, lengths = _speech_pool()
    ref._pool, ref._pool_lengths = pool, lengths
    from heybuddy_tpu.data.augmented import NoiseProvider as JaxNoiseProvider

    provider = JaxNoiseProvider(seed=0, use_remote=False)
    banks = (provider.noise_batch(256), provider.impulse_batch(64))
    batches = []
    for _ in range(3):
        text_idx = ref.rng.choice(len(texts), size=B, replace=False)
        mask = np.zeros((B, B), bool)
        mask[0, 1] = mask[1, 0] = True
        batches.append(pretrain.PretrainBatch(
            text_idx, np.stack([ref.rng.choice(2, size=2, replace=False) for _ in range(B)]),
            ref.rng.integers(0, 256, (2, B)), ref.rng.integers(0, 64, (2, B)), mask))
    return {"ref": ref, "init_path": path, "texts": texts, "pool": pool, "lengths": lengths, "banks": banks,
            "batches": batches}


def _port(setup, **kwargs):
    port = pretrain.EmbeddingPretrainer(texts=setup["texts"], speakers_per_text=2, batch_size=B, seed=0,
                                        init_weights=setup["init_path"], device="cpu", **kwargs)
    port._pool, port._pool_lengths = setup["pool"], setup["lengths"]
    res = port.resident()
    assert np.array_equal(res["noise"].numpy(), setup["banks"][0])
    assert np.array_equal(res["impulse"].numpy(), setup["banks"][1])
    return port


def _jax_draw_pair(key, cfg):
    k1, k2 = jax.random.split(key)
    return jax_draws(k1, B, T, cfg), jax_draws(k2, B, T, cfg)


def _jax_step_loss(setup, batch, key, compute, temperature=0.1, params=None):
    """JAX's pretrain loss and its gradient (the step's ``loss_fn``) in ``compute``,
    at ``params`` (default: JAX's initial parameters)."""
    ref = setup["ref"]
    cfg, starts = ref.augment_config, jax_window_starts(T)
    pool, lengths = jnp.asarray(setup["pool"]), jnp.asarray(setup["lengths"])
    noise_bank, impulse_bank = (jnp.asarray(b) for b in setup["banks"])
    text_idx = jnp.asarray(batch.text_idx)
    k1, k2 = jax.random.split(key)
    clips = [pool[text_idx, batch.spk_idx[:, v]] for v in range(2)]
    lens = [lengths[text_idx, batch.spk_idx[:, v]] for v in range(2)]
    noise, impulse = noise_bank[batch.noise_idx], impulse_bank[batch.imp_idx]

    def embed(p, audio):
        spec = jax_mel_spectrogram(audio * 32767.0)
        return jnp.mean(jax_net.apply_spectrogram(p, spec, starts, compute_dtype=compute), axis=1)

    def loss_fn(p):
        v1 = jax_aug.augment_batch(k1, clips[0], lens[0], noise[0], impulse[0], cfg)
        v2 = jax_aug.augment_batch(k2, clips[1], lens[1], noise[1], impulse[1], cfg)
        z1, z2 = embed(p, v1), embed(p, v2)
        base = jax_pretrain.nt_xent_loss(z1, z2, temperature)
        hard = jax_pretrain.hard_pair_margin_loss(z1, z2, jnp.asarray(batch.pair_mask), ref.hard_pair_margin)
        return base + ref.hard_pair_weight * hard, (base, hard)

    (loss, (base, hard)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        ref.params if params is None else params)
    flat = {k: np.asarray(v) for k, v in jax_net._flatten(grads).items()}
    return np.array([loss, base, hard], np.float64), flat


def _port_step_loss(port, batch, draws, compute):
    port.net.zero_grad(set_to_none=True)
    loss, base, hard = port.loss(batch, 0, draws=draws, compute_dtype=compute)
    loss.backward()
    grads = {k.replace(".", "/"): p.grad.numpy().copy() for k, p in port.net.named_parameters()}
    return np.array([loss.item(), base.item(), hard.item()]), grads


def _grad_gap(got, ref):
    """max |got - ref| over every parameter, as a fraction of ref's norm."""
    keys = sorted(ref)
    assert sorted(got) == keys
    norm = np.sqrt(sum(float(np.sum(ref[k].astype(np.float64) ** 2)) for k in keys))
    return max(float(np.abs(got[k] - ref[k]).max()) for k in keys) / norm


@pytest.mark.parametrize("step", [0, 1])
def test_one_step_float32_matches_jax(step_setup, step):
    port = _port(step_setup)
    key = jax.random.fold_in(jax.random.PRNGKey(13), step)
    batch = step_setup["batches"][step]
    ref_loss, ref_grads = _jax_step_loss(step_setup, batch, key, jnp.float32)
    draws = _jax_draw_pair(key, step_setup["ref"].augment_config)
    loss, grads = _port_step_loss(port, batch, draws, torch.float32)
    assert np.all(np.abs(loss - ref_loss) <= F32_LOSS_RTOL * np.abs(ref_loss) + 1e-7), (loss, ref_loss)
    assert ref_loss[2] > 0.0  # the masked pair sits above the margin
    assert _grad_gap(grads, ref_grads) <= F32_GRAD_TOL


@pytest.mark.parametrize("step", [0, 1])
def test_one_step_bf16_matches_jax_by_its_own_rounding(step_setup, step):
    """bf16 compute rounds the same values in both packages, but the backward
    products round elsewhere (JAX differentiates ``dot(..., preferred f32)``
    and bf16 einsums, the port float32 products of rounded operands). Held:
    loss and gradient within max(5e-3, 1.25x JAX's own bf16-vs-f32 distance)."""
    port = _port(step_setup)
    key = jax.random.fold_in(jax.random.PRNGKey(13), step)
    batch = step_setup["batches"][step]
    ref_loss, ref_grads = _jax_step_loss(step_setup, batch, key, jnp.bfloat16)
    f32_loss, f32_grads = _jax_step_loss(step_setup, batch, key, jnp.float32)
    loss, grads = _port_step_loss(port, batch, _jax_draw_pair(key, step_setup["ref"].augment_config), torch.bfloat16)
    loss_limit = max(BF16_FLOOR, 1.25 * float(np.abs(ref_loss[0] - f32_loss[0]) / abs(f32_loss[0])))
    assert abs(loss[0] - ref_loss[0]) / abs(ref_loss[0]) <= loss_limit
    grad_limit = max(BF16_FLOOR, 1.25 * _grad_gap(ref_grads, f32_grads))
    assert _grad_gap(grads, ref_grads) <= grad_limit


def _params_close(got, ref):
    keys = sorted(ref)
    g = np.concatenate([np.asarray(got[k]).ravel() for k in keys])
    r = np.concatenate([np.asarray(ref[k]).ravel() for k in keys])
    err = np.abs(g - r)
    return float(np.mean(err <= PARAM_ATOL + PARAM_RTOL * np.abs(r))), float(err.max())


def test_three_steps_follow_jax_under_the_adam_rule(step_setup):
    """Three steps in float32 compute from JAX's initial parameters with JAX's
    draws, against optax's Adam on JAX's loss: float64 (torch) against
    float32 (optax) bias correction moves a few near-zero gradients."""
    import optax

    ref = step_setup["ref"]
    batches = step_setup["batches"]
    keys = [jax.random.fold_in(jax.random.PRNGKey(ref.seed + 13), i) for i in range(3)]
    tx = optax.adam(1e-3)
    params = jax.tree_util.tree_map(jnp.array, ref.params)
    state = tx.init(params)
    ref_losses = []
    for batch, key in zip(batches, keys):
        loss, grads = _jax_step_loss(step_setup, batch, key, jnp.float32, params=params)
        tree = jax.tree_util.tree_map(jnp.asarray, embedding_net.unflatten_params(grads))
        updates, state = tx.update(tree, state, params)
        params = optax.apply_updates(params, updates)
        ref_losses.append(loss)
    port = _port(step_setup)
    got_losses = [port.step(batch, i, draws=_jax_draw_pair(key, ref.augment_config), compute_dtype=torch.float32)
                  .numpy() for i, (batch, key) in enumerate(zip(batches, keys))]
    # after an update the parameters differ (the Adam rule below), and the
    # losses with them: 1.2e-4 relative at steps 1-2 (measured)
    np.testing.assert_allclose(np.stack(got_losses), np.stack(ref_losses), rtol=5e-4)
    got = embedding_net.flatten_params(port.net)
    share, worst = _params_close(got, {k: np.asarray(v) for k, v in jax_net._flatten(params).items()})
    print(f"three float32 steps: {share:.6f} of the parameters within {PARAM_ATOL} + {PARAM_RTOL} |x|, max |d| {worst:.3e}")
    assert share >= PARAM_SHARE and worst <= PARAM_MAX, (share, worst)
    init = embedding_net.load_params(step_setup["init_path"])
    assert _params_close(got, embedding_net.flatten_params(init))[0] < 0.5  # the steps moved most parameters


def test_jax_jitted_bf16_steps_match_the_port_step(step_setup):
    """JAX's own jitted step (three steps under ``lax.scan``, bf16 compute)
    against the port's ``step``: the logged metrics within the bf16 rule's
    floor of 1.25x JAX's own bf16-vs-f32 loss distance (6.0e-3 at step 0)."""
    ref = step_setup["ref"]
    batches = step_setup["batches"]
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(ref.seed + 13), i) for i in range(3)])
    params = jax.tree_util.tree_map(jnp.array, ref.params)
    _, _, metrics = ref._build_step()(
        params, ref.tx.init(params), jnp.asarray(step_setup["pool"]), jnp.asarray(step_setup["lengths"]),
        jnp.asarray(step_setup["banks"][0]), jnp.asarray(step_setup["banks"][1]), keys,
        *(np.stack([getattr(b, f) for b in batches]).astype(np.int32)
          for f in ("text_idx", "spk_idx", "noise_idx", "imp_idx")),
        np.stack([b.pair_mask for b in batches]),
    )
    port = _port(step_setup)
    got = np.stack([port.step(batch, i, draws=_jax_draw_pair(keys[i], ref.augment_config)).numpy()
                    for i, batch in enumerate(batches)])
    np.testing.assert_allclose(got, np.asarray(metrics), rtol=1.25 * 6.0e-3)


def test_generator_draws_are_seeded_per_step_and_view(step_setup):
    port = _port(step_setup)
    batch = step_setup["batches"][0]
    a = [x.item() for x in port.loss(batch, 0)]
    b = [x.item() for x in port.loss(batch, 0)]
    c = [x.item() for x in port.loss(batch, 1)]
    assert a == b and a != c


# ---------------------------------------------------------------- the npz


def test_npz_crosses_both_packages(tmp_path, step_setup, monkeypatch):
    port = _port(step_setup)
    port.step(step_setup["batches"][0], 0)
    port.params = embedding_net.unflatten_params(embedding_net.flatten_params(port.net))
    path = str(tmp_path / "port.npz")
    port.save(path)
    loaded = jax_net.load_params(path)
    flat = {k: np.asarray(v) for k, v in jax_net._flatten(loaded).items()}
    mine = embedding_net.flatten_params(port.net)
    assert flat.keys() == mine.keys() and all(np.array_equal(flat[k], mine[k]) for k in flat)
    space = jax_net.embedding_space_id(loaded)
    assert embedding_net.embedding_space_id(embedding_net.load_params(path)) == space
    assert embedding_net.embedding_space_id(port.net) == space
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_WEIGHTS", path)
    monkeypatch.setattr(jax_net, "_DEFAULT_PARAMS_CACHE", {})
    assert SpeechEmbeddings(device="cpu").space_id == space
    assert jax_net.embedding_space_id(jax_net.default_params()) == space
    # and JAX's npz warm-starts the port
    warm = pretrain.EmbeddingPretrainer(texts=step_setup["texts"], batch_size=B, init_weights=step_setup["init_path"],
                                        device="cpu")
    ref_flat = {k: np.asarray(v) for k, v in jax_net._flatten(step_setup["ref"].params).items()}
    assert all(np.array_equal(embedding_net.flatten_params(warm.net)[k], ref_flat[k]) for k in ref_flat)


def test_seeded_init_follows_jax_distributions():
    cfg = embedding_net.EmbeddingNetConfig()
    got = embedding_net.flatten_params(embedding_net.init_params(torch.Generator().manual_seed(0), cfg))
    ref = {k: np.asarray(v) for k, v in jax_net._flatten(jax_net.init_params(jax.random.PRNGKey(0))).items()}
    assert got.keys() == ref.keys()
    for k, v in got.items():
        assert v.shape == ref[k].shape and v.dtype == np.float32, k
        if k.endswith("/b"):
            assert not v.any()
        elif k == "pos":
            assert 0.018 < v.std() < 0.022
        else:
            bound = 1.0 / np.sqrt(v.shape[0])
            assert bound * 0.95 < np.abs(v).max() <= bound, k


# --------------------------------------------------------------- end to end


def test_pretrain_embedding_cli_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "GLOBAL_STAGE_TIMES", profiling.StageTimes())
    out = str(tmp_path / "emb.npz")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli_main(["pretrain-embedding", "-o", out, "--num-texts", "8", "--speakers-per-text", "2",
                       "--batch-size", "4", "--steps", "3", "--tts-backend", "formant",
                       "--adversarial-fraction", "0.5", "--device", "cpu"])
    assert rc == 0
    assert stdout.getvalue().strip() == f"Wrote {out}; set HEYBUDDY_EMBEDDING_WEIGHTS={out} to use it."
    times = profiling.GLOBAL_STAGE_TIMES
    assert times.count["pretrain/step"] == 3 and times.count["pretrain/clip_pool"] == 1
    params = jax_net.load_params(out)
    bundled = embedding_net.load_params(embedding_net.bundled_weights_path())
    assert jax_net.embedding_space_id(params) != embedding_net.embedding_space_id(bundled)
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_WEIGHTS", out)
    emb = SpeechEmbeddings(device="cpu")
    assert emb.space_id == jax_net.embedding_space_id(params)
    feats = emb(np.random.default_rng(0).normal(0, 0.1, (2, T)).astype(np.float32))
    assert feats.shape == (2, 16, 96) and np.isfinite(feats).all()


def test_pretrainer_refuses_a_batch_above_the_text_pool():
    with pytest.raises(ValueError, match="exceeds the text pool"):
        pretrain.EmbeddingPretrainer(texts=["a", "b"], batch_size=4, device="cpu")
