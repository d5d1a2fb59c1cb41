"""The port's mel spectrogram and mel-patch plain kernel against the JAX package.

The CUDA kernel itself runs only on the card (``chip_smoke.py``); here the
wrapper takes a CPU tensor and so runs its plain version.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from heybuddy_tpu.ops import melspec as jax_melspec
from heybuddy_tpu.ops.pallas.melspec_kernel import mel_patches_pallas
from heybuddy_tpu.ops.windows import embedding_window_starts as jax_window_starts
from heybuddy_tpu_torch.ops import melspec as torch_melspec
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_patches, mel_spectrogram
from heybuddy_tpu_torch.ops.windows import embedding_window_starts

# fp32 DFT of int16-range audio summed in another order than XLA's: the JAX
# suite's own bound between its Pallas and XLA mel paths (test_melspec.py)
ATOL, RTOL = 5e-3, 1e-4


def _audio(seed: int, b: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1000.0, (b, t)).astype(np.float32)


@pytest.mark.parametrize("t, frames", [(23040, 141), (17280, 105)])
def test_mel_spectrogram_matches_jax(t, frames):
    audio = _audio(11, 3, t)
    ref = np.asarray(jax_melspec.mel_spectrogram(jnp.asarray(audio)))
    got = mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (3, frames, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b, t, expect", [(4, 23040, 35), (3, 17280, 26)])
def test_mel_patches_match_pallas(b, t, expect):
    audio = _audio(12, b, t)
    ref, ref_n = mel_patches_pallas(jnp.asarray(audio), interpret=True)
    ref = np.asarray(ref)[:b]  # the Pallas kernel pads the batch to 16
    got, n = mel_patches(torch.from_numpy(audio))
    got = got.numpy()
    assert n == ref_n == expect
    p_pad = -(-n // 8) * 8
    assert got.shape == ref.shape == (b, p_pad, 128)
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=ATOL, rtol=RTOL)
    assert (got[:, n:] == 0).all()


def test_numpy_constants_equal_jax():
    np.testing.assert_array_equal(torch_melspec.dft_basis(), jax_melspec.dft_basis())
    band = jax_melspec.mel_band_freqs()
    assert torch_melspec.mel_band_freqs() == band
    np.testing.assert_array_equal(
        torch_melspec.dft_basis(512, 400, band), jax_melspec.dft_basis(512, 400, band)
    )
    np.testing.assert_array_equal(torch_melspec.mel_filterbank(), jax_melspec.mel_filterbank())
    for t in (400, 17280, 23040, 32000, 48000):
        assert torch_melspec.num_frames(t) == jax_melspec.num_frames(t)
    for t in (17280, 19200, 23040, 32000, 48000):
        assert embedding_window_starts(t) == jax_window_starts(t)
    assert embedding_window_starts(23040)[:6] == (0, 8, 16, 24, 12, 20)


@pytest.mark.parametrize(
    "bad",
    [
        torch.zeros(2, 23040, dtype=torch.float64),
        torch.zeros(23040),
        torch.zeros(23040, 2).t(),
        torch.zeros(2, 600),
    ],
    ids=["float64", "1-d", "non-contiguous", "too-short"],
)
def test_mel_patches_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        mel_patches(bad)
