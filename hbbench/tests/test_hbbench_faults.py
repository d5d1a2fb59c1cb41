"""Whole runs on the CPU at small sizes with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have (one card, so there is no exchange between chips to leave out). A
sound run comes out true."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from hbbench import run
from small import SMALL

CPU = torch.device("cpu")


def _run(cell: str, seed: int = 11) -> dict:
    return run.run_cell(cell, seed, 0.5, False, CPU, overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result["checks"]) and result["attempted"] > 0


def test_gen_an_altered_feature(monkeypatch):
    from heybuddy_tpu_torch.models import formant_device

    original = formant_device.fused_features_batch

    @functools.wraps(original)  # the program's signature, by which the harness reads its calls
    def altered(*args, **kwargs):
        out, n = original(*args, **kwargs)
        out = out.clone()
        out[0, 3, 5] += 0.5  # one feature of one clip, where it is produced
        return out, n

    monkeypatch.setattr(formant_device, "fused_features_batch", altered)
    assert not _run("gen-fused.v8-mlp")["correct"]


def test_gen_a_planner_fault(monkeypatch):
    from heybuddy_tpu_torch.models.formant_device import DeviceFormantPlanner

    original = DeviceFormantPlanner.plan

    def shifted(self, *args, **kwargs):
        plan = original(self, *args, **kwargs)
        if plan is not None:
            plan.tracks[3] *= 1.05  # the second formant, where the plan is made
        return plan

    monkeypatch.setattr(DeviceFormantPlanner, "plan", shifted)
    assert not _run("gen-fused.v8-mlp")["correct"]


def test_listen_an_altered_score(monkeypatch):
    from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel

    original = WakeWordMLPModel.scores

    def altered(self, features):
        scores = original(self, features)
        return scores * 0.98
    monkeypatch.setattr(WakeWordMLPModel, "scores", altered)
    assert not _run("listen.v8-mlp")["correct"]


def test_train_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from heybuddy_tpu_torch.training import trainer

    monkeypatch.setattr(trainer._MaskedAdam, "update", lambda self, grad, fire, lr: None)
    assert not _run("train.v8-transformer")["correct"]


def test_train_half_the_batch_left_out(monkeypatch):
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer

    original = WakeWordTrainer._train_step

    def half(self, carry, x, y, *args, **kwargs):
        return original(self, carry, x[::2], y[::2], *args, **kwargs)

    monkeypatch.setattr(WakeWordTrainer, "_train_step", half)
    assert not _run("train.v8-transformer")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_train_a_fault_in_the_window_alone(monkeypatch, fault):
    """Set-up's steps stay sound; only the window's stage (the trainer's
    second ``train_epoch``) is broken, as a step captured or cached after the
    first steps could be."""
    from heybuddy_tpu_torch.training import trainer

    epochs = {"n": 0}
    train_epoch, update, step = (trainer.WakeWordTrainer.train_epoch, trainer._MaskedAdam.update,
                                 trainer.WakeWordTrainer._train_step)

    def counted(self, *args, **kwargs):
        epochs["n"] += 1
        return train_epoch(self, *args, **kwargs)

    def unchanged(self, grad, fire, lr):
        if epochs["n"] < 2:
            update(self, grad, fire, lr)

    def half(self, carry, x, y, *args, **kwargs):
        if epochs["n"] >= 2:
            x, y = x[::2], y[::2]
        return step(self, carry, x, y, *args, **kwargs)

    monkeypatch.setattr(trainer.WakeWordTrainer, "train_epoch", counted)
    if fault == "unchanged":
        monkeypatch.setattr(trainer._MaskedAdam, "update", unchanged)
    else:
        monkeypatch.setattr(trainer.WakeWordTrainer, "_train_step", half)
    result = _run("train.v8-transformer")
    failed = {name for name, c in result["checks"].items() if c["value"] > c["limit"]}
    assert not result["correct"] and failed and all(name.startswith("window_") for name in failed), result["checks"]


def test_train_rows_repeated_within_a_pass():
    from hbbench.traffic.trainloop import Stretch, _repeated

    crossing, stale = Stretch(0, 3, 3), Stretch(0, 3, 3)
    order = np.random.default_rng(1).permutation(10)
    again = np.random.default_rng(2).permutation(10)
    crossing.idxs = [[order[:4]], [order[4:8]], [np.concatenate([order[8:], again[:2]])]]
    stale.idxs = [[order[:4]]] * 3
    assert _repeated(crossing) == 0 and _repeated(stale) == 4
