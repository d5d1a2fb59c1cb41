"""The port's wake-word trainer against the JAX package's, on the CPU.

Every comparison starts from the JAX trainer's initial parameters carried
across (never a torch initialisation) with dropout 0 on both sides, and feeds
both packages the same numpy batches or the same seeded index draws.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from heybuddy_tpu.data import precalculated as jax_pre
from heybuddy_tpu.data import training as jax_training
from heybuddy_tpu.models import wakeword as jax_wakeword
from heybuddy_tpu.runtime.detection import count_detections as jax_count_detections
from heybuddy_tpu.training import trainer as jax_trainer
from heybuddy_tpu_torch import constants
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.convert import wakeword_params_to_numpy
from heybuddy_tpu_torch.data import precalculated, training
from heybuddy_tpu_torch.data.space import active_space, write_space_sidecar
from heybuddy_tpu_torch.models import wakeword
from heybuddy_tpu_torch.training import trainer
from heybuddy_tpu_torch.utils.audio_io import write_wav

# Tolerances (float32 on both sides; only summation order differs). The
# metric histories: rtol 1e-4 (measured: at most 2.5e-6 relative). The final
# parameters: 1e-5 + 1e-4 of their size for 99% of the elements, and 2e-4 for
# every element. Adam divides each gradient element by its own root mean
# square, so an element whose gradient sits near float32 rounding moves a
# different fraction of a full step in each package: measured 6.9e-5 at 1 of
# 768 elements of one perceptron run (2e-3 learning rate), under 1.4e-5
# everywhere else.
HISTORY_RTOL, HISTORY_ATOL = 1e-4, 1e-7
PARAM_ATOL, PARAM_RTOL, PARAM_SHARE, PARAM_MAX = 1e-5, 1e-4, 0.99, 2e-4

PATTERN = np.sign(np.sin(np.arange(16 * 96))).reshape(16, 96).astype(np.float32)
KW = dict(num_layers=1, layer_dim=32, dropout=0.0)


def _batches(sizes, seed=0, amplitude=0.3):
    """Half positives (+pattern), half negatives (-pattern) under unit noise."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        h = n // 2
        x = rng.normal(0.0, 1.0, (n, 16, 96)).astype(np.float32)
        x[:h] += amplitude * PATTERN
        x[h:] -= amplitude * PATTERN
        out.append((x, np.concatenate([np.ones(h), np.zeros(n - h)]).astype(np.float32)))
    return out


def _pair(tmp_path, architecture="perceptron", **kw):
    """A JAX trainer and a port trainer on the CPU with the JAX one's initial parameters."""
    kw = {**KW, **kw}
    jax_t = jax_trainer.WakeWordTrainer(
        checkpoint_dir=str(tmp_path / "jax"), architecture=architecture, **kw
    )
    tree = jax.tree_util.tree_map(np.asarray, jax_t.model.params)
    port_t = trainer.WakeWordTrainer(
        checkpoint_dir=str(tmp_path / "port"), architecture=architecture, device="cpu",
        params=tree, **kw,
    )
    return jax_t, port_t


def _assert_params_close(jax_params, port_model):
    got = jax.tree_util.tree_leaves(wakeword_params_to_numpy(port_model))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jax_params))
    assert len(got) == len(ref)
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    got = np.concatenate([g.reshape(-1) for g in got])
    ref = np.concatenate([r.reshape(-1) for r in ref])
    err = np.abs(got - ref)
    assert np.mean(err <= PARAM_ATOL + PARAM_RTOL * np.abs(ref)) >= PARAM_SHARE, err.max()
    assert err.max() <= PARAM_MAX


def _assert_history_close(got, ref, keys=("loss", "high_loss_rate", "recall", "false_positive_rate")):
    for key in keys:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], rtol=HISTORY_RTOL, atol=HISTORY_ATOL, err_msg=key)


def test_constants_equal_jax():
    from heybuddy_tpu import constants as jax_constants
    from heybuddy_tpu.data.streams import RUNTIME_WINDOW_STRIDE
    from heybuddy_tpu.models.formant import FORMANT_VERSION
    from heybuddy_tpu.models.formant_device import DEVICE_FORMANT_VERSION
    from heybuddy_tpu.models.tts import SAMPLING_VERSION

    names = [n for n in dir(constants) if n.isupper()]
    moved = {
        "RUNTIME_WINDOW_STRIDE": RUNTIME_WINDOW_STRIDE,
        "FORMANT_VERSION": FORMANT_VERSION,
        "SAMPLING_VERSION": SAMPLING_VERSION,
        "DEVICE_FORMANT_VERSION": DEVICE_FORMANT_VERSION,
    }
    assert len(names) > 70
    for name in names:
        ref = moved[name] if name in moved else getattr(jax_constants, name)
        assert getattr(constants, name) == ref, name


def test_learning_rate_and_negative_weight_match_jax():
    for total in (1, 10, 250, 5000):
        for warmup, hold in ((0, 0), (total // 5, total // 3), (3, 0), (0, 7)):
            for step in range(0, total + 2, max(1, total // 37)):
                args = (step, warmup, hold, total, 1e-3)
                assert trainer.get_learning_rate(*args) == jax_trainer.get_learning_rate(*args)
    for current in (1.0, 2.0, 64.0):
        for fp in (0.0, 0.5, 0.74, 0.75, 1.0, 1.5, 1.51, 9.0):
            for ratio in (2.0, 1.5):
                args = (current, fp, 1.5, ratio)
                assert trainer.adjust_negative_weight(*args) == jax_trainer.adjust_negative_weight(*args)


def test_masked_adam_is_torch_adam_on_fired_steps():
    """With the flag set, the update is torch.optim.Adam's; with it clear nothing moves."""
    rng = np.random.default_rng(3)
    start = rng.normal(0.0, 1.0, 257).astype(np.float32)
    flat = torch.from_numpy(start.copy())
    adam = trainer._MaskedAdam(flat)
    ref = torch.nn.Parameter(torch.from_numpy(start.copy()))
    opt = torch.optim.Adam([ref], lr=1.0, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    fires = [False, True, True, False, False, True, True, True, False, True]
    for i, fire in enumerate(fires):
        grad = torch.from_numpy(rng.normal(0.0, 10.0 ** rng.uniform(-6, 0), 257).astype(np.float32))
        lr = 1e-3 * (i + 1)
        before = flat.clone()
        adam.update(grad, torch.tensor(fire), lr)
        if fire:
            for group in opt.param_groups:
                group["lr"] = lr
            ref.grad = grad.clone()
            opt.step()
            torch.testing.assert_close(flat, ref.detach(), rtol=1e-6, atol=1e-9)
        else:
            assert torch.equal(flat, before)
    assert int(adam.count) == sum(fires) == opt.state[ref]["step"]
    torch.testing.assert_close(adam.mu, opt.state[ref]["exp_avg"], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(adam.nu, opt.state[ref]["exp_avg_sq"], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("architecture", ["perceptron", "transformer"])
def test_train_steps_match_jax_on_host_batches(tmp_path, architecture):
    """24 steps of the train step on identical batches: the accumulation holds
    (batches under 128 hard examples), fires (on reaching 128) and takes the
    big-batch branch (>= 128 hard in one batch)."""
    jax_t, port_t = _pair(tmp_path, architecture)
    sizes = [40, 40, 40, 40, 160, 40, 24, 24, 160, 160, 40, 40, 40, 40, 40, 160, 24, 24, 24, 24, 40, 40, 160, 40]
    thr, act = 1e-4, 0.5
    jax_step = jax_t._build_train_step(thr, act)
    params, opt_state, carry = jax_t.model.params, jax_t.opt_state, jax_trainer._init_carry()
    port_carry = port_t._init_carry(port_t.device)
    generator = torch.Generator().manual_seed(1)
    ref, got = [], []
    for i, (x, y) in enumerate(_batches(sizes)):
        lr, nw = 2e-3 * (1 + i % 3), 1.0 + 0.25 * i
        params, opt_state, carry, metrics = jax_step(
            params, opt_state, carry, x, y, jax.random.PRNGKey(1), np.int32(i),
            np.float32(lr), np.float32(nw),
        )
        ref.append(np.asarray(metrics))
        port_carry, m = port_t._train_step(
            port_carry, *port_t._to_device(x, y), lr, nw, thr, act, generator
        )
        got.append(m.numpy())
    ref, got = np.stack(ref), np.stack(got)
    did_step, n_hard = ref[:, 4], ref[:, 5]
    np.testing.assert_array_equal(got[:, 4], did_step)
    np.testing.assert_array_equal(got[:, 5], n_hard)
    assert (did_step == 0).any() and (did_step == 1).any()
    assert ((n_hard >= 128) & (did_step == 1)).any()  # the big-batch branch
    assert ((n_hard < 128) & (did_step == 1)).any()  # a fire on the accumulated count
    np.testing.assert_allclose(got[:, :4], ref[:, :4], rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
    assert np.ptp(ref[:, 2]) > 0 and np.ptp(ref[:, 3]) > 0  # recall and fp rate both move
    _assert_params_close(params, port_t.model)
    assert int(port_t.optimizer_leaves()[0]) == int(jax.tree_util.tree_leaves(opt_state)[0])


def test_train_epoch_history_matches_jax(tmp_path):
    """The host path of train_epoch: the same 24-step history as JAX's."""
    jax_t, port_t = _pair(tmp_path)
    batches = _batches([40, 40, 40, 40, 160, 40, 24, 24, 160, 160, 40, 40] * 2, seed=1)
    args = dict(
        num_steps=24, validation_steps=1000, checkpoint_steps=1000, learning_rate=2e-3,
        negative_weight_schedule=np.linspace(1, 3, 24).tolist(),
    )
    ref = jax_t.train_epoch(iter(batches), **args)
    got = port_t.train_epoch(iter(batches), **args)
    np.testing.assert_array_equal(got["learning_rate"], ref["learning_rate"])
    np.testing.assert_array_equal(got["negative_weight"], ref["negative_weight"])
    _assert_history_close(got, ref)
    _assert_params_close(jax_t.model.params, port_t.model)


def _resident_iterator(pre, train, seed=0):
    rng = np.random.default_rng(seed)

    def source(sign, n, s):
        data = rng.normal(0.0, 1.0, (n, 16, 96)).astype(np.float32) + 0.3 * sign * PATTERN
        return pre.PrecalculatedDatasetIterator("resident", data=data, seed=s)

    return train.WakeWordTrainingDatasetIterator(
        num_batch_threads=1,
        positive=[(source(1, 50, 1), 24)],
        negative=[(source(-1, 60, 2), 24), (source(-0.5, 90, 3), 40)],
    )


def test_resident_path_matches_jax(tmp_path):
    """The device-resident path through the stage loop: 2 stages of 12
    steps, the batch doubled after the first (88 rows a step, then 176: the
    big-batch branch), the same seeded index draws in both packages."""
    jax_t, port_t = _pair(tmp_path)
    jax_it = _resident_iterator(jax_pre, jax_training)
    port_it = _resident_iterator(precalculated, training)
    assert port_t._device_plan_for(port_it) is not None
    args = dict(
        num_steps=12, num_stages=2, validation_steps=4, checkpoint_steps=1000,
        dynamic_negative_weight=False, max_negative_weight=2.0, batch_size_adjust_ratio=2.0,
        step_adjust_ratio=1.0, learning_rate=2e-3,
    )
    ref = jax_t(jax_it, graph_dir=str(tmp_path / "jax"), **args)
    got = port_t(port_it, graph_dir=str(tmp_path / "port"), **args)
    assert got["loss"].shape == (24,)
    # n_hard / batch exactly: the same rows were drawn and mined
    np.testing.assert_array_equal(got["high_loss_rate"], ref["high_loss_rate"])
    _assert_history_close(got, ref)
    _assert_params_close(jax_t.model.params, port_t.model)
    jax_leaves = jax.tree_util.tree_leaves(jax_t.opt_state)
    port_leaves = port_t.optimizer_leaves()
    assert int(port_leaves[0]) == int(jax_leaves[0]) > 0
    # the same cursor state: the next draws agree too
    for (a, _), (b, _) in zip(port_it.positive + port_it.negative, jax_it.positive + jax_it.negative):
        np.testing.assert_array_equal(a.take_indices(7, len(a)), b.take_indices(7, len(b)))


def _assert_checkpoints_equal(dir_a, name_a, dir_b, name_b):
    a = np.load(os.path.join(dir_a, f"{name_a}.npz"))
    b = np.load(os.path.join(dir_b, f"{name_b}.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert json.loads(bytes(a["__config__"])) == json.loads(bytes(b["__config__"]))
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with open(os.path.join(dir_a, f"{name_a}_optimizer.pkl"), "rb") as f:
        leaves_a = pickle.load(f)
    with open(os.path.join(dir_b, f"{name_b}_optimizer.pkl"), "rb") as f:
        leaves_b = pickle.load(f)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert np.shape(x) == np.shape(y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with open(os.path.join(dir_a, f"{name_a}_state.json")) as f:
        state_a = json.load(f)
    with open(os.path.join(dir_b, f"{name_b}_state.json")) as f:
        assert state_a == json.load(f)


@pytest.mark.parametrize("architecture", ["perceptron", "transformer"])
def test_checkpoints_cross_over_both_ways(tmp_path, architecture):
    """A port checkpoint resumes in JAX and a JAX checkpoint in the port:
    params, Adam leaves and state json equal; both continue alike."""
    batches = _batches([40, 40, 160, 40, 40, 40] * 2, seed=2)
    args = dict(validation_steps=1000, checkpoint_steps=1000, learning_rate=2e-3)
    jax_t, port_t = _pair(tmp_path, architecture)
    jax_t.train_epoch(iter(batches[:6]), num_steps=6, **args)
    port_t.train_epoch(iter(batches[:6]), num_steps=6, **args)
    for t in (jax_t, port_t):
        t.start_stage, t.resumed_negative_weight = 1, 4.0
        t.save_checkpoint("cross", step=3)

    # port checkpoint -> JAX
    jax_loaded = jax_wakeword.load_model(os.path.join(port_t.checkpoint_dir, "cross.npz"))
    assert jax_loaded.config() == port_t.model.config()
    jax_resumed = jax_trainer.WakeWordTrainer(
        checkpoint_dir=port_t.checkpoint_dir, architecture=architecture, **KW
    )
    jax_resumed.resume("cross")
    assert (jax_resumed.start_stage, jax_resumed.start_step, jax_resumed.resumed_negative_weight) == (1, 3, 4.0)
    jax_resumed.save_checkpoint("again", step=3)
    _assert_checkpoints_equal(port_t.checkpoint_dir, "cross", port_t.checkpoint_dir, "again")

    # JAX checkpoint -> port
    port_resumed = trainer.WakeWordTrainer(
        checkpoint_dir=jax_t.checkpoint_dir, architecture=architecture, device="cpu", **KW
    )
    port_resumed.resume("cross")
    assert (port_resumed.start_stage, port_resumed.start_step, port_resumed.resumed_negative_weight) == (1, 3, 4.0)
    port_resumed.save_checkpoint("again", step=3)
    _assert_checkpoints_equal(jax_t.checkpoint_dir, "cross", jax_t.checkpoint_dir, "again")

    # each resumed trainer continues (fast-forwarding to step 3) as the
    # checkpoint's own package does
    rest = dict(num_steps=9, **args)
    jax_own = jax_trainer.WakeWordTrainer(checkpoint_dir=jax_t.checkpoint_dir, architecture=architecture, **KW)
    jax_own.resume("cross")
    port_own = trainer.WakeWordTrainer(
        checkpoint_dir=port_t.checkpoint_dir, architecture=architecture, device="cpu", **KW
    )
    port_own.resume("cross")
    for resumed, own in ((port_resumed, jax_own), (port_own, jax_resumed)):
        got = resumed.train_epoch(iter(batches[6:]), **rest)
        ref = own.train_epoch(iter(batches[6:]), **rest)
        assert got["loss"].shape == ref["loss"].shape == (6,)
        _assert_history_close(got, ref)
        _assert_params_close(own.model.params, resumed.model)


def test_gate_aware_stream_validation_matches_jax(tmp_path):
    """Stream-tagged validation negatives are scored in order and gated; the
    port's eval counts equal JAX's on the same parameters and pools."""
    rng = np.random.default_rng(4)
    pos_pool = (rng.normal(size=(16, 16, 96)) + PATTERN).astype(np.float32)
    stream_pool = (rng.normal(size=(240, 16, 96)) + 0.2 * PATTERN).astype(np.float32)
    clip_pool = rng.normal(size=(64, 16, 96)).astype(np.float32)

    def validation(pre, train):
        stream = pre.PrecalculatedDatasetIterator("stream", data=stream_pool, seed=0)
        stream.stream_stride_seconds = 0.12
        return train.WakeWordTrainingDatasetIterator(
            num_batch_threads=1,
            positive=[(pre.PrecalculatedDatasetIterator("pos", data=pos_pool, seed=0), 4)],
            negative=[(stream, 8), (pre.PrecalculatedDatasetIterator("clips", data=clip_pool, seed=0), 8)],
        )

    jax_t, port_t = _pair(tmp_path)
    jax_t.train_epoch(iter(_batches([64] * 4)), num_steps=4, validation_steps=1000,
                      checkpoint_steps=1000, learning_rate=5e-3)
    tree = jax.tree_util.tree_map(np.asarray, jax_t.model.params)
    port_t.model.load_state_dict(
        wakeword.WakeWordMLPModel(layer_dim=32, num_layers=1, params=tree, device="cpu").state_dict()
    )
    for consecutive in (1, 2, 3):
        ref = jax_t._run_eval(
            jax_t._build_eval(0.5), jax_t.model.params, validation(jax_pre, jax_training),
            gate_consecutive=consecutive, gate_threshold=0.5,
        )
        got = port_t._run_eval(
            validation(precalculated, training), gate_consecutive=consecutive, gate_threshold=0.5
        )
        assert got == pytest.approx(ref, rel=1e-12)
        assert got["stream_hours"] == pytest.approx(240 * 0.12 / 3600.0)
    scores = port_t.model.scores(stream_pool)
    assert got["gated_fp"] == jax_count_detections(scores, 0.5, consecutive=3)


def _seed_caches(directory, sizes, device="cpu"):
    rng = np.random.default_rng(0)
    space = active_space(device=device)
    for name, (n, sign) in sizes.items():
        path = os.path.join(directory, f"{name}.npy")
        np.save(path, (rng.normal(0.0, 1.0, (n, 16, 96)) + sign * PATTERN).astype(np.float32))
        write_space_sidecar(path, space)


TRAIN_ARGS = [
    "--device", "cpu", "--positive-samples", "48", "--adversarial-samples", "48",
    "--validation-samples", "16", "--testing-positive-samples", "0",
    "--testing-adversarial-samples", "0", "--steps", "12", "--stages", "1",
    "--validation-steps", "6", "--checkpoint-steps", "100", "--positive-batch-size", "16",
    "--adversarial-batch-size", "16", "--training-no-default-dataset",
]


def test_train_with_missing_cache_raises(tmp_dataset_dir, tmp_path, monkeypatch, capsys):
    """A short cache is topped up as JAX tops it up (its 20 rows kept, 28
    generated), the missing validation cache is generated, and training
    completes; so does training with stream-window negatives, whose cache
    (which raised MissingFeaturesError while data/streams.py was not ported)
    is generated."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    _seed_caches(tmp_dataset_dir, {"hey-buddy": (48, 1), "hey-buddy-adversarial": (20, -1)})
    adversarial = os.path.join(tmp_dataset_dir, "hey-buddy-adversarial.npy")
    first = np.load(adversarial)
    ckpt = tmp_path / "ckpt"
    assert cli_main(["train", "hey buddy", *TRAIN_ARGS, "--adversarial-phrases", "8",
                     "--checkpoint-dir", str(ckpt)]) == 0
    assert capsys.readouterr().out.strip() == f"Training complete; final checkpoint: {ckpt}/hey-buddy_final.npz"
    grown = np.load(adversarial)
    assert grown.shape == (48, 16, 96) and np.isfinite(grown).all()
    np.testing.assert_array_equal(grown[:20], first)
    validation = np.load(os.path.join(tmp_dataset_dir, "hey-buddy-testing-validation.npy"))
    assert validation.shape == (16, 16, 96) and np.isfinite(validation).all()
    assert os.path.exists(os.path.join(tmp_dataset_dir, "hey-buddy-adversarial.texts.json"))
    ckpt2 = tmp_path / "ckpt2"
    assert cli_main(["train", "hey buddy", *TRAIN_ARGS, "--stream-negative-samples", "8",
                     "--checkpoint-dir", str(ckpt2)]) == 0
    assert capsys.readouterr().out.strip() == f"Training complete; final checkpoint: {ckpt2}/hey-buddy_final.npz"
    stream = np.load(os.path.join(tmp_dataset_dir, "negative-speech-stream-0-xhey-buddy.npy"))
    assert stream.shape == (8, 16, 96) and np.isfinite(stream).all()


def test_default_device_is_the_card(tmp_path):
    """No fallback: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.WakeWordTrainer(checkpoint_dir=str(tmp_path))


def test_cli_train_convert_predict(tmp_dataset_dir, tmp_path, capsys):
    """train --device cpu on seeded caches, then convert, then predict on its checkpoint."""
    _seed_caches(tmp_dataset_dir, {
        "hey-buddy": (48, 1), "hey-buddy-adversarial": (48, -1), "hey-buddy-testing-validation": (16, 1),
    })
    ckpt = tmp_path / "ckpt"
    assert cli_main(["train", "hey buddy", *TRAIN_ARGS, "--checkpoint-dir", str(ckpt)]) == 0
    final = ckpt / "hey-buddy_final.npz"
    assert capsys.readouterr().out.strip() == f"Training complete; final checkpoint: {final}"
    with open(ckpt / "hey-buddy_final_state.json") as f:
        assert json.load(f) == {"stage": 1, "step": 0, "negative_weight": 1.0}
    model = wakeword.load_model(str(final), device="cpu")
    x = np.stack([PATTERN, -PATTERN]).astype(np.float32)
    s_pos, s_neg = model.scores(x)
    assert s_pos > s_neg

    assert cli_main(["convert", str(final)]) == 0
    onnx_path = ckpt / "hey-buddy_final.onnx"
    assert capsys.readouterr().out.strip() == f"Wrote {onnx_path}"
    assert onnx_path.stat().st_size > 0

    wav = str(tmp_path / "noise.wav")
    write_wav(wav, np.random.default_rng(1).normal(0.0, 0.05, 40000).astype(np.float32), 16000)
    assert cli_main(["predict", str(final), wav, "--threshold", "-1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and all(line.startswith("Wake word detected at ") for line in lines)
