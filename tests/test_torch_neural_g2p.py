"""The port's neural G2P against the JAX package's: encodings, the numpy
forward (bit for bit), the torch forward (1e-5 of JAX's ``apply``), decoding
of the bundled checkpoint, one training step's loss and gradient from shared
initial parameters, the learning rate per step against optax's schedule,
checkpoints in both directions, and ``NeuralPhonemizer``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heybuddy_tpu.text import neural_g2p as jax_g2p
from heybuddy_tpu.text.wordlist import WORDS as JAX_WORDS
from heybuddy_tpu_torch.text import neural_g2p as g2p

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLED = os.path.join(ROOT, "heybuddy_tpu", "assets", "g2p-neural.npz")
FORWARD_ATOL = 1e-5  # torch forward vs JAX's apply (float32, the same operations)
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4  # one step's gradient, float32 sums in another order
TABLE = {
    "hello": ["HH", "AH", "L", "OW"], "world": ["W", "ER", "L", "D"], "buddy": ["B", "AH", "D", "IY"],
    "hey": ["HH", "EY"], "cat": ["K", "AE", "T"], "dog": ["D", "AO", "G"], "fish": ["F", "IH", "SH"],
    "water": ["W", "AO", "T", "ER"],
}
SMALL = dict(dim=48, heads=4, layers=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_init(cfg=SMALL, seed=0):
    model = jax_g2p.NeuralG2P(**cfg)
    return model, jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))


def _chars(model, words):
    return np.stack([g2p.encode_word(w, model.max_word) for w in words])


def _words(n=200):
    words = sorted(set(JAX_WORDS))
    return [words[i] for i in np.random.default_rng(0).choice(len(words), n, replace=False)]


def test_encodings_equal_jax():
    assert g2p.ARPABET == jax_g2p.ARPABET
    for word in ("hey", "Buddy's", "x-ray", "", "abcdefghijklmnopqrstuvwxyz"):
        for n in (8, 16):
            assert np.array_equal(g2p.encode_word(word, n), jax_g2p.encode_word(word, n))
    for phones in (["HH", "EY"], ["B", "XX", "AH"], []):
        assert np.array_equal(g2p.encode_phones(phones, 6), jax_g2p.encode_phones(phones, 6))


def test_init_params_shapes_and_distributions_follow_jax():
    jax_model, ref = _jax_init()
    model = g2p.NeuralG2P(**SMALL)
    got = model.init_params(torch.Generator().manual_seed(0))
    flat, ref_flat = g2p._flatten(got), g2p._flatten(ref)
    assert sorted(flat) == sorted(ref_flat)
    for k in flat:
        assert flat[k].shape == ref_flat[k].shape and flat[k].dtype == np.float32, k
        if k.endswith("/b"):
            assert not flat[k].any()
        elif k.endswith("/w"):
            bound = np.sqrt(1.0 / flat[k].shape[0])
            assert np.abs(flat[k]).max() <= bound and np.abs(flat[k]).max() > 0.9 * bound, k
        else:
            assert 0.015 < flat[k].std() < 0.025, k
    again = model.init_params(torch.Generator().manual_seed(0))
    assert all(np.array_equal(a, b) for a, b in zip(g2p._flatten(again).values(), flat.values()))


def test_numpy_forward_bit_equal_and_torch_forward_close():
    jax_model, params = _jax_init()
    model = g2p.NeuralG2P(**SMALL)
    chars = _chars(model, sorted(TABLE) + ["zephyr", "qat", "a"])
    ref_np = jax_model.apply_np(params, chars)
    assert np.array_equal(model.apply_np(params, chars), ref_np)
    ref = np.asarray(jax_model.apply(params, jnp.asarray(chars)))
    got = model.apply_torch(params, chars).detach().numpy()
    assert got.shape == ref.shape == (len(chars), model.max_phones, model.n_phones)
    assert np.abs(got - ref).max() <= FORWARD_ATOL
    got_module = model.load_params(params)(torch.from_numpy(chars).long()).detach().numpy()
    assert np.array_equal(got_module, got)


def test_bundled_checkpoint_decodes_as_jax():
    jax_model, jax_params = jax_g2p.NeuralG2P.load(BUNDLED)
    model, params = g2p.NeuralG2P.load(BUNDLED)
    assert model.config == jax_model.config
    words = _words()
    ref = jax_model.decode(jax_params, words, numpy=True)
    assert model.decode(params, words, numpy=True) == ref
    assert model.decode(params, words) == jax_model.decode(jax_params, words) == ref
    chars = _chars(model, words)
    assert np.array_equal(model.apply_np(params, chars), jax_model.apply_np(jax_params, chars))


def test_checkpoints_cross_both_ways(tmp_path):
    jax_model, params = _jax_init(seed=4)
    model = g2p.NeuralG2P(**SMALL)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    model.save(params, port_path)
    jax_model.save(params, jax_path)
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    for path in (port_path, jax_path):
        m, p = g2p.NeuralG2P.load(path)
        jm, jp = jax_g2p.NeuralG2P.load(path)
        assert m.config == jm.config == model.config
        words = sorted(TABLE)
        assert m.decode(p, words, numpy=True) == jm.decode(jp, words, numpy=True)
        flat, ref = g2p._flatten(p), g2p._flatten(jp)
        assert list(flat) == list(ref) and all(np.array_equal(flat[k], ref[k]) for k in flat)


def test_one_training_step_loss_and_gradient_match_jax():
    jax_model, params = _jax_init(seed=2)
    words = sorted(TABLE)
    chars = _chars(jax_model, words)
    targets = np.stack([g2p.encode_phones(TABLE[w], jax_model.max_phones) for w in words])
    ref_loss, ref_grads = jax.value_and_grad(jax_model.loss)(params, jnp.asarray(chars), jnp.asarray(targets))
    model = g2p.NeuralG2P(**SMALL).load_params(params)
    loss = model.loss(torch.from_numpy(chars).long(), torch.from_numpy(targets).long())
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    ref_flat = g2p._flatten(jax.tree_util.tree_map(np.asarray, ref_grads))
    grads = {k.replace(".", "/"): p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(ref_flat)
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref_flat[k], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)


def test_learning_rate_per_step_follows_optax():
    steps, lr = 40, 3e-3
    schedule = optax.cosine_decay_schedule(lr, steps)
    adam, decay = g2p.optimizer(g2p.NeuralG2P(**SMALL), lr, steps)
    for i in range(steps + 5):
        got = adam.param_groups[0]["lr"]
        assert abs(got - float(schedule(i))) <= 1e-7 * lr, i
        adam.step()
        decay.step()


def test_training_from_shared_init_follows_jax():
    """20 full-batch steps from JAX's initial parameters. The parameters are
    held by the Adam rule of the wake-word trainer's tests: 99% within 1e-5 +
    1e-4 |x|, all within 2e-4, but for the attention key biases. Their exact
    gradient is 0 (a softmax is blind to a shift shared by every key), so
    each package's gradient is rounding noise that Adam scales to steps of up
    to the learning rate: they are held to ``steps * lr``, the most Adam
    moves them (measured 5.5e-4 after 20 steps). The loss falls."""
    steps, lr = 20, 1e-3
    jax_model, init = _jax_init(seed=0)
    words = sorted(TABLE)
    chars = jnp.asarray(_chars(jax_model, words))
    targets = jnp.asarray(np.stack([g2p.encode_phones(TABLE[w], jax_model.max_phones) for w in words]))
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps))
    p = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(p)
    for _ in range(steps):
        grads = jax.grad(jax_model.loss)(p, chars, targets)
        updates, state = tx.update(grads, state, p)
        p = optax.apply_updates(p, updates)
    model, got = g2p.train_neural_g2p(TABLE, steps=steps, lr=lr, model=g2p.NeuralG2P(**SMALL), device="cpu",
                                      params=init)
    got_tree, ref_tree = g2p._flatten(got), g2p._flatten(p)
    assert sorted(got_tree) == sorted(ref_tree)
    key_bias = [k for k in got_tree if k.startswith("blocks/") and k.endswith("/k/b")] + ["xk/b"]
    for k in key_bias:
        assert np.abs(got_tree[k] - np.asarray(ref_tree[k])).max() <= steps * lr, k
    held = sorted(set(got_tree) - set(key_bias))
    got_flat = np.concatenate([got_tree[k].ravel() for k in held])
    ref_flat = np.concatenate([np.asarray(ref_tree[k]).ravel() for k in held])
    err = np.abs(got_flat - ref_flat)
    assert np.mean(err <= 1e-5 + 1e-4 * np.abs(ref_flat)) >= 0.99, err.max()
    assert err.max() <= 2e-4
    t_chars, t_targets = torch.from_numpy(np.array(chars)).long(), torch.from_numpy(np.array(targets)).long()
    with torch.no_grad():
        assert model.loss(t_chars, t_targets) < g2p.NeuralG2P(**SMALL).load_params(init).loss(t_chars, t_targets)


def test_neural_phonemizer_follows_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("HEYBUDDY_G2P_WEIGHTS", raising=False)
    port, ref = g2p.NeuralPhonemizer(), jax_g2p.NeuralPhonemizer()
    assert port.name == ref.name == "neural"
    for text in ("hello world", "hey buddy", "Turn ON the lights!", "quokka zephyr's", ""):
        assert port(text) == ref(text), text
    for word in _words(40):
        assert port.word_phones(word) == ref.word_phones(word), word
    jax_model, params = _jax_init(seed=5)
    path = str(tmp_path / "g2p.npz")
    jax_model.save(params, path)
    monkeypatch.setenv("HEYBUDDY_G2P_WEIGHTS", path)
    assert g2p.NeuralPhonemizer()("hello world") == jax_g2p.NeuralPhonemizer()("hello world")
    with pytest.raises(FileNotFoundError):
        g2p.NeuralPhonemizer(weights=str(tmp_path / "missing.npz"))
