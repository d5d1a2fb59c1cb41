"""The port's embedding network and fused-embedding plain kernel against the JAX package.

The CUDA kernel itself runs only on the card (``chip_smoke.py``); here the
wrapper takes a CPU tensor and so runs its plain version.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.ops.melspec import mel_spectrogram as jax_mel_spectrogram
from heybuddy_tpu.ops.pallas.embedding_kernel import (
    fused_embedding_from_patches as jax_fused_embedding_from_patches,
)
from heybuddy_tpu.ops.pallas.melspec_kernel import mel_patches_pallas
from heybuddy_tpu.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.convert import embedding_params_from_numpy
from heybuddy_tpu_torch.models import embedding_net as torch_net
from heybuddy_tpu_torch.ops.kernels.embedding_kernel import fused_embedding_from_patches

# bf16 rounding points (feats, GELU, softmax weights, RMS outputs) turn any
# change in float32 summation order into one-ulp bf16 flips that the trunk
# carries on: the JAX suite holds its own Pallas kernel to 0.05 against the
# float32 reference (test_melspec.py), and the port is held to the same.
BF16_PATH_TOL = 0.05


@pytest.fixture(scope="module")
def jax_params():
    return jax_net.default_params()


@pytest.fixture(scope="module")
def net():
    return embedding_params_from_numpy(torch_net.default_params())


def _audio(seed: int, b: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1000.0, (b, t)).astype(np.float32)


@pytest.mark.parametrize("t", [23040, 17280])
def test_plain_kernel_matches_pallas(jax_params, net, t):
    audio = _audio(21, 3, t)
    patches, n = mel_patches_pallas(jnp.asarray(audio), interpret=True)  # batch padded to 16
    starts = embedding_window_starts(t)
    ref = np.asarray(
        jax_fused_embedding_from_patches(jax_params, patches, starts, n, interpret=True)
    )[:3]
    got = fused_embedding_from_patches(
        net, torch.from_numpy(np.asarray(patches)[:3].copy()), starts, n
    ).numpy()
    assert got.shape == ref.shape == (3, len(starts), 96)
    assert np.abs(got - ref).max() < BF16_PATH_TOL


def test_plain_kernel_matches_f32_apply_spectrogram(jax_params, net):
    audio = _audio(22, 3, 23040)
    spec = jax_mel_spectrogram(jnp.asarray(audio))
    starts = embedding_window_starts(23040)
    ref = np.asarray(
        jax_net.apply_spectrogram(jax_params, spec, starts, compute_dtype=jnp.float32)
    )
    n = np.asarray(spec).shape[1] // 4
    patches = np.asarray(spec)[:, : 4 * n].reshape(3, n, 128)
    patches = np.pad(patches, ((0, 0), (0, 40 - n), (0, 0)))
    got = fused_embedding_from_patches(net, torch.from_numpy(patches), starts, n).numpy()
    assert got.shape == ref.shape == (3, 16, 96)
    assert np.abs(got - ref).max() < BF16_PATH_TOL


def test_odd_batch_equals_single_clips(net):
    audio = _audio(23, 3, 23040)
    spec = jax_mel_spectrogram(jnp.asarray(audio))
    starts = embedding_window_starts(23040)
    patches = np.pad(np.asarray(spec)[:, :140].reshape(3, 35, 128), ((0, 0), (0, 5), (0, 0)))
    batch = fused_embedding_from_patches(net, torch.from_numpy(patches), starts, 35).numpy()
    for i in range(3):
        single = fused_embedding_from_patches(
            net, torch.from_numpy(patches[i : i + 1].copy()), starts, 35
        ).numpy()
        # rows are independent: only the CPU matmul's blocking may differ
        np.testing.assert_allclose(batch[i : i + 1], single, atol=1e-5)


@pytest.mark.parametrize("formulation", ["apply_spectrogram", "apply_spectrogram_banded"])
def test_embedding_net_matches_jax_in_float32(jax_params, net, formulation):
    audio = _audio(24, 2, 23040)
    spec = jax_mel_spectrogram(jnp.asarray(audio))
    starts = embedding_window_starts(23040)
    ref = np.asarray(
        getattr(jax_net, formulation)(jax_params, spec, starts, compute_dtype=jnp.float32)
    )
    got = getattr(net, formulation)(
        torch.from_numpy(np.array(spec)), starts, compute_dtype=torch.float32
    ).numpy()
    # the same float32 function: only summation order differs
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_banded_forward_matches_jax_in_bf16(jax_params, net):
    audio = _audio(25, 2, 23040)
    spec = jax_mel_spectrogram(jnp.asarray(audio))
    starts = embedding_window_starts(23040)
    ref = np.asarray(jax_net.apply_spectrogram_banded(jax_params, spec, starts))
    got = net(torch.from_numpy(np.array(spec)), starts).numpy()
    # XLA rounds some bf16 intermediates at other points than the emulation
    assert np.abs(got - ref).max() < BF16_PATH_TOL


def test_space_id_equals_jax(jax_params, net):
    expect = jax_net.embedding_space_id(jax_params, "trunkpool")
    assert torch_net.embedding_space_id(torch_net.default_params(), "trunkpool") == expect
    assert torch_net.embedding_space_id(net, "trunkpool") == expect


def test_load_params_keeps_the_tree(jax_params):
    tree = torch_net.load_params(torch_net.bundled_weights_path())
    assert len(tree["trunk"]) == len(jax_params["trunk"]) == 2
    for key, value in jax_net._flatten(jax_params).items():
        np.testing.assert_array_equal(torch_net.flatten_params(tree)[key], np.asarray(value))


def test_missing_weights_raise(monkeypatch):
    monkeypatch.delenv("HEYBUDDY_EMBEDDING_WEIGHTS", raising=False)
    monkeypatch.setattr(torch_net, "bundled_weights_path", lambda: None)
    with pytest.raises(FileNotFoundError):
        torch_net.default_params()
