"""The port's one-kernel featurizer (K4), the spectrogram-layout entry to K2
and every ``featurize_batch`` formulation against the JAX package.

On the CPU the port's wrappers run the kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, or XLA where the JAX package does.
"""

import contextlib
import functools
import unittest.mock as mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import heybuddy_tpu.ops.pallas.embedding_kernel as jax_ek
import heybuddy_tpu.ops.pallas.featurize_kernel as jax_fk
import heybuddy_tpu.ops.pallas.melspec_kernel as jax_mk
from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.models import featurizer as jax_featurizer
from heybuddy_tpu.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.convert import embedding_params_from_numpy
from heybuddy_tpu_torch.models import embedding_net as torch_net
from heybuddy_tpu_torch.models.featurizer import featurize_batch
from heybuddy_tpu_torch.ops.kernels.embedding_kernel import fused_embedding_windows
from heybuddy_tpu_torch.ops.kernels.featurize_kernel import fused_featurize
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_spectrogram

# bf16 rounding points turn any change in float32 summation order into
# one-ulp bf16 flips that the trunk carries on: the JAX suite holds its own
# Pallas kernels to 0.05 (test_melspec.py), and the port is held to the same
BF16_PATH_TOL = 0.05
# the float32 formulations: the same function, only summation order differs
F32_ATOL = F32_RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    return jax_net.default_params()


@pytest.fixture(scope="module")
def net():
    return embedding_params_from_numpy(torch_net.default_params())


def _audio(seed: int, b: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1000.0, (b, t)).astype(np.float32)


@contextlib.contextmanager
def _interpret():
    """The JAX package's three Pallas entries, run in interpret mode."""
    with mock.patch.object(
        jax_mk, "mel_patches_pallas", functools.partial(jax_mk.mel_patches_pallas, interpret=True)
    ), mock.patch.object(
        jax_ek,
        "fused_embedding_from_patches",
        functools.partial(jax_ek.fused_embedding_from_patches, interpret=True),
    ), mock.patch.object(
        jax_fk, "fused_featurize", functools.partial(jax_fk.fused_featurize, interpret=True)
    ):
        yield


def _jax_featurize(params, audio, pooling, compute_dtype=jnp.bfloat16):
    with _interpret():
        return np.asarray(
            jax_featurizer.featurize_batch(
                params, jnp.asarray(audio), pooling=pooling, compute_dtype=compute_dtype
            )
        )


@pytest.mark.parametrize("t", [23040, 17280])
def test_fused_embedding_windows_matches_pallas(jax_params, net, t):
    audio = _audio(51, 2, t)
    spec = mel_spectrogram(torch.from_numpy(audio))
    starts = embedding_window_starts(t)
    ref = np.asarray(
        jax_ek.fused_embedding_windows(jax_params, jnp.asarray(spec.numpy()), starts, interpret=True)
    )
    got = fused_embedding_windows(net, spec, starts).numpy()
    assert got.shape == ref.shape == (2, len(starts), 96)
    assert np.abs(got - ref).max() < BF16_PATH_TOL


@pytest.mark.parametrize("t", [23040, 17280])
def test_fused_featurize_matches_pallas(jax_params, net, t):
    audio = _audio(52, 2, t)
    starts = embedding_window_starts(t)
    ref = np.asarray(jax_fk.fused_featurize(jax_params, jnp.asarray(audio), starts, interpret=True))
    got = fused_featurize(net, torch.from_numpy(audio), starts).numpy()
    assert got.shape == ref.shape == (2, len(starts), 96)
    assert np.abs(got - ref).max() < BF16_PATH_TOL


def test_fused_featurize_odd_batch_equals_single_clips(net):
    audio = torch.from_numpy(_audio(53, 3, 23040))
    starts = embedding_window_starts(23040)
    batch = fused_featurize(net, audio, starts).numpy()
    assert batch.shape == (3, 16, 96)
    for i in range(3):
        single = fused_featurize(net, audio[i : i + 1].contiguous(), starts).numpy()
        # rows are independent: only the CPU matmul's blocking may differ
        np.testing.assert_allclose(batch[i : i + 1], single, atol=1e-5)


@pytest.mark.parametrize("pooling", ["fused", "mega"])
@pytest.mark.parametrize("t", [23040, 17280])
def test_featurize_batch_kernel_poolings_match_jax(jax_params, net, pooling, t):
    audio = _audio(54, 2, t)
    ref = _jax_featurize(jax_params, audio, pooling)
    got = featurize_batch(net, torch.from_numpy(audio), pooling=pooling).numpy()
    assert got.shape == ref.shape == (2, len(embedding_window_starts(t)), 96)
    assert np.abs(got - ref).max() < BF16_PATH_TOL


@pytest.mark.parametrize("pooling", ["banded", "gather"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_featurize_batch_xla_poolings_match_jax(jax_params, net, pooling, dtype):
    audio = _audio(55, 2, 23040)
    ref = _jax_featurize(jax_params, audio, pooling, getattr(jnp, dtype))
    got = featurize_batch(net, torch.from_numpy(audio), getattr(torch, dtype), pooling).numpy()
    assert got.shape == ref.shape == (2, 16, 96)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        assert np.abs(got - ref).max() < BF16_PATH_TOL


@pytest.mark.parametrize("pooling", ["fused", "mega", "auto"])
def test_float32_compute_falls_back_to_banded(net, pooling):
    audio = torch.from_numpy(_audio(56, 2, 17280))
    got = featurize_batch(net, audio, torch.float32, pooling)
    banded = featurize_batch(net, audio, torch.float32, "banded")
    np.testing.assert_array_equal(got.numpy(), banded.numpy())


def test_auto_is_fused(net):
    audio = torch.from_numpy(_audio(57, 2, 17280))
    np.testing.assert_array_equal(
        featurize_batch(net, audio, pooling="auto").numpy(),
        featurize_batch(net, audio, pooling="fused").numpy(),
    )


def test_unknown_pooling_raises(net):
    with pytest.raises(ValueError, match="unknown pooling"):
        featurize_batch(net, torch.zeros(1, 23040), pooling="attention")


def test_fused_featurize_rejects_windows_past_the_clip(net):
    with pytest.raises(ValueError, match="past the last real patch"):
        fused_featurize(net, torch.zeros(1, 17280), embedding_window_starts(23040))
