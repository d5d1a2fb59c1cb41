"""The port's mel-spectrogram kernel (K3) and hop-block mel-patch kernel (K1b)
against the JAX package's Pallas kernels in interpret mode.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers take CPU tensors and so run their plain versions.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from heybuddy_tpu.ops.pallas.melspec_kernel import mel_patches_pallas, mel_spectrogram_pallas
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import fat_load_path, mel_patches, mel_spectrogram

# fp32 DFT of int16-range audio summed in another order than the Pallas
# kernel's: the JAX suite's own bound between its Pallas and XLA mel paths
# (test_melspec.py)
ATOL, RTOL = 5e-3, 1e-4


def _audio(seed: int, b: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1000.0, (b, t)).astype(np.float32)


@pytest.mark.parametrize("b, t, frames", [(2, 23040, 141), (3, 17280, 105)])
def test_mel_spectrogram_matches_pallas(b, t, frames):
    audio = _audio(41, b, t)
    ref = np.asarray(mel_spectrogram_pallas(jnp.asarray(audio), interpret=True))
    got = mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (b, frames, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b, t", [(4, 23040), (3, 17280)])
def test_mel_patches_equal_the_spectrogram_layout(b, t):
    audio = torch.from_numpy(_audio(42, b, t))
    spec = mel_spectrogram(audio).numpy()
    patches, n = mel_patches(audio)
    usable = (spec.shape[1] // 4) * 4
    p_pad = -(-n // 8) * 8
    expect = spec[:, :usable].reshape(b, n, 128)
    expect = np.pad(expect, ((0, 0), (0, p_pad - n), (0, 0)))
    np.testing.assert_allclose(patches.numpy(), expect, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b, t, expect", [(2, 23040, 35), (3, 17280, 26)])
def test_fat_mel_patches_match_pallas_and_chunked(b, t, expect):
    audio = _audio(43, b, t)
    ref, ref_n = mel_patches_pallas(jnp.asarray(audio), interpret=True, dft_mode="fat")
    ref = np.asarray(ref)[:b]  # the Pallas kernel pads the batch to 16
    got, n = mel_patches(torch.from_numpy(audio), dft_mode="fat")
    chunked, n_chunked = mel_patches(torch.from_numpy(audio))
    got, chunked = got.numpy(), chunked.numpy()
    assert n == ref_n == n_chunked == expect
    assert got.shape == ref.shape == chunked.shape == (b, -(-n // 8) * 8, 128)
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[:, :n], chunked[:, :n], atol=ATOL, rtol=RTOL)
    assert (got[:, n:] == 0).all()


@pytest.mark.parametrize("b, t, expect", [(2, 23040, 35), (3, 20001, 30)])
def test_fat_bf16_mel_patches_match_the_chunked_bf16_mode(b, t, expect):
    """
    The hop-block bf16 DFT rounds the same samples and basis values to bf16 as
    the chunked one and sums the same exact products in another order: JAX's
    two modes agree bit for bit, the port's within float32 rounding.
    """
    audio = _audio(44, b, t)
    ref, ref_n = mel_patches_pallas(jnp.asarray(audio), interpret=True, dft_dtype=jnp.bfloat16)
    ref = np.asarray(ref)[:b]
    got, n = mel_patches(torch.from_numpy(audio), dft_mode="fat", dft_dtype=torch.bfloat16)
    chunked, _ = mel_patches(torch.from_numpy(audio), dft_dtype=torch.bfloat16)
    got, chunked = got.numpy(), chunked.numpy()
    assert n == ref_n == expect
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[:, :n], chunked[:, :n], atol=ATOL, rtol=RTOL)
    assert (got[:, n:] == 0).all()


@pytest.mark.parametrize("t, offset, path", [(23040, 0, "tma"), (20001, 0, "plain"), (23040, 1, "plain")])
def test_fat_load_path_follows_the_flat_hop_view(t, offset, path):
    """K1b loads hop rows by TMA only where the audio is the flat (rows, 160) matrix, 16-byte aligned."""
    buf = torch.zeros(2 * t + offset)
    audio = buf[offset:].view(2, t)
    assert audio.data_ptr() % 16 == 4 * offset % 16
    assert fat_load_path(audio) == path


def test_unknown_dft_mode_raises():
    with pytest.raises(ValueError, match="dft_mode"):
        mel_patches(torch.zeros(1, 23040), dft_mode="wide")


@pytest.mark.parametrize(
    "bad",
    [torch.zeros(2, 23040, dtype=torch.float64), torch.zeros(23040), torch.zeros(23040, 2).t(),
     torch.zeros(2, 500)],
    ids=["float64", "1-d", "non-contiguous", "too-short"],
)
def test_mel_spectrogram_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        mel_spectrogram(bad)
