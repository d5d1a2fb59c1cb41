"""The port's public surface against the JAX package's: the package's lazy
exports, ``utils`` and ``ops`` re-exports and their helpers, and ``--debug``
on every command."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heybuddy_tpu
import heybuddy_tpu_torch
from heybuddy_tpu import ops as jax_ops
from heybuddy_tpu import utils as jax_utils
from heybuddy_tpu.ops import melspec as jax_melspec
from heybuddy_tpu.ops import windows as jax_windows
from heybuddy_tpu_torch import ops, utils
from heybuddy_tpu_torch.cli import build_parser
from heybuddy_tpu_torch.ops import melspec, windows


def test_lazy_exports_name_the_jax_packages():
    assert sorted(heybuddy_tpu_torch._EXPORTS) == sorted(heybuddy_tpu._EXPORTS)
    assert heybuddy_tpu_torch.__all__ == heybuddy_tpu.__all__
    for name, module in heybuddy_tpu_torch._EXPORTS.items():
        value = getattr(heybuddy_tpu_torch, name)
        assert value.__module__ == module and value.__name__ == name
        assert module.replace("heybuddy_tpu_torch.", "") == heybuddy_tpu._EXPORTS[name].replace(
            "heybuddy_tpu.", "").replace("ops.melspec", "ops.kernels.melspec_kernel")
    with pytest.raises(AttributeError):
        heybuddy_tpu_torch.NotAName


def test_utils_and_ops_reexport_the_jax_names():
    assert utils.__all__ == jax_utils.__all__
    assert all(callable(getattr(utils, n)) or n == "logger" for n in utils.__all__)
    assert ops.__all__ == jax_ops.__all__
    assert all(callable(getattr(ops, n)) for n in ops.__all__)


@pytest.mark.parametrize("seed,scale", [(0, 0.3), (1, 1e-3), (2, 0.0)])
def test_normalize_peak_and_rms_equal_jax(seed, scale):
    audio = (np.random.default_rng(seed).normal(size=4000) * scale).astype(np.float32)
    for kw in ({}, {"peak": 0.5}):
        np.testing.assert_array_equal(utils.normalize_peak(audio, **kw), jax_utils.normalize_peak(audio, **kw))
    for kw in ({}, {"rms_db": -6.0}):
        np.testing.assert_array_equal(utils.normalize_rms(audio, **kw), jax_utils.normalize_rms(audio, **kw))


def test_human_size_equals_jax():
    for n in (0, 1, 512, 1023, 1024, 2048, 10 ** 6, 5 * 1024 ** 3, 1024 ** 5, 3 * 1024 ** 6, -4096):
        assert utils.human_size(n) == jax_utils.human_size(n), n


def test_file_is_downloaded_equals_jax(tmp_path):
    path = tmp_path / "blob.bin"
    cases = [dict(), dict(expected_size=5), dict(expected_size=6)]
    assert utils.file_is_downloaded(str(path)) == jax_utils.file_is_downloaded(str(path)) is False
    path.write_bytes(b"hello")
    digest = utils.file_sha256(str(path))
    cases += [dict(expected_sha256=digest), dict(expected_sha256="0" * 64), dict(expected_sha256=digest, expected_size=4)]
    for kw in cases:
        assert utils.file_is_downloaded(str(path), **kw) == jax_utils.file_is_downloaded(str(path), **kw), kw


def test_debug_logger_and_unified_logging_scope_the_level():
    before = utils.logger.level
    with utils.debug_logger():
        assert utils.logger.level == logging.DEBUG
        assert logging.getLogger("urllib3").level >= logging.WARNING
    assert utils.logger.level == before
    with utils.unified_logging(logging.WARNING):
        assert utils.logger.level == logging.WARNING
    assert utils.logger.level == before


@pytest.mark.parametrize("t", [17280, 23040, 32000])
def test_window_helpers_and_framing_equal_jax(t):
    assert windows.num_embedding_windows(t) == jax_windows.num_embedding_windows(t)
    rng = np.random.default_rng(t)
    spec = rng.normal(size=(2, melspec.num_frames(t), 32)).astype(np.float32)
    starts = windows.embedding_window_starts(t)
    got = windows.extract_windows(torch.from_numpy(spec), starts).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_windows.extract_windows(jnp.asarray(spec), starts)))
    audio = rng.normal(0, 1000.0, (2, t)).astype(np.float32)
    frames = melspec.frame_audio(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(frames, np.asarray(jax_melspec.frame_audio(jnp.asarray(audio))))
    assert frames.shape == (2, melspec.num_frames(t), 512)


def test_every_command_takes_debug():
    parser = build_parser()
    argv = {
        "train": ["train", "hey buddy"], "convert": ["convert", "a.npz"], "predict": ["predict", "a.npz", "b.wav"],
        "listen": ["listen", "a.npz"], "extract": ["extract", "n", "s"], "combine": ["combine", "a", "t"],
        "pretrain-embedding": ["pretrain-embedding"],
    }
    commands = parser._subparsers._group_actions[0].choices
    assert sorted(commands) == sorted(argv)
    for name, args in argv.items():
        assert parser.parse_args(args).debug is False
        assert parser.parse_args(args + ["--debug"]).debug is True


def test_debug_runs_a_command_at_debug_level(monkeypatch):
    from heybuddy_tpu_torch import cli

    levels = []
    monkeypatch.setitem(cli._COMMANDS, "combine", lambda args: levels.append(utils.logger.level) or 0)
    before = utils.logger.level
    assert cli.main(["combine", "a", "t", "--debug"]) == 0
    assert cli.main(["combine", "a", "t"]) == 0
    assert levels == [logging.DEBUG, before] and utils.logger.level == before
