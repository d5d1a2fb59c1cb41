"""The numerics of the mel kernels' tensor-core DFT, and the bf16-DFT variant,
on the CPU.

On the card K1, K3 and K4 compute the DFT as a split product: audio x and
basis b each become a pair of 16-bit values, hi + lo, and the spectrum is
x_hi b_hi + x_hi b_lo + x_lo b_hi with float32 accumulation
(``csrc/mel_common.cuh``). Here that arithmetic is emulated in plain PyTorch
(every product of two 16-bit values is exact in float64, and the terms are
summed there) and held to the JAX package's float32 mel. The kernels use fp16
pairs; bf16 pairs, the first design, are emulated beside them to show why:
both pass the mel tolerance, but on a tone with noise 60 dB below it the bf16
pair is more than ten times further from float32.

The bf16-DFT variant (``dft_dtype=torch.bfloat16``, the TPU kernels'
``dft_dtype=jnp.bfloat16``) runs its plain version here against JAX's Pallas
kernels in interpret mode.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from heybuddy_tpu.ops import melspec as jax_melspec
from heybuddy_tpu.ops.pallas.melspec_kernel import mel_patches_pallas, mel_spectrogram_pallas
from heybuddy_tpu_torch.constants import MEL_HOP_LENGTH, MEL_N_FFT
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk

# the port's mel tolerance against float32 (test_torch_melspec.py)
ATOL, RTOL = 5e-3, 1e-4
# the JAX suite's bound between the bf16 and the float32 DFT (test_melspec.py)
BF16_DFT_TOL = 1e-2
# csrc/mel_common.cuh X_SCALE: audio enters the fp16 pair scaled by 2^-8
X_SCALE = 1.0 / 256.0


def _noise(seed: int, b: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1000.0, (b, t)).astype(np.float32)


def _tonal(seed: int, b: int, t: int) -> np.ndarray:
    """A 220 -> 400 Hz sweep at 0.3 of full scale plus noise 60 dB below it (chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    time_s = np.arange(t) / 16000.0
    phase = 2 * np.pi * (220.0 * time_s + 90.0 * time_s**2 / time_s[-1])
    amp = 0.3 * 32767.0
    tone = amp * np.sin(phase[None, :] + rng.uniform(0, 2 * np.pi, (b, 1)))
    return (tone + rng.normal(0.0, amp / np.sqrt(2) * 1e-3, (b, t))).astype(np.float32)


def _pair(v: torch.Tensor, dtype: torch.dtype, scale: float = 1.0):
    """v * scale as hi + lo of ``dtype`` (lo = dtype(v * scale - hi)), unscaled, in float64."""
    s = v.float() * scale
    hi = s.to(dtype)
    lo = (s - hi.float()).to(dtype)
    return hi.double() / scale, lo.double() / scale


def _split_logmel(audio: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_logmel_taps`` with x and b split into pairs of ``dtype``, the x_lo b_lo term dropped."""
    taps, _, fb = mk.mel_constants(torch.device("cpu"))
    frames = audio.unfold(-1, MEL_N_FFT, MEL_HOP_LENGTH)[:, :, mk.TAP0 : mk.TAP0 + mk.TAPS]
    x_scale, b_scale = (X_SCALE, mk.SPLIT_BASIS_SCALE) if dtype == torch.float16 else (1.0, 1.0)
    x_hi, x_lo = _pair(frames, dtype, x_scale)
    b_hi, b_lo = _pair(taps, dtype, b_scale)
    spectrum = x_hi @ b_hi + x_hi @ b_lo + x_lo @ b_hi
    return mk._mel_tail(spectrum.float(), fb)


def _jax_mel(audio: np.ndarray) -> np.ndarray:
    return np.asarray(jax_melspec.mel_spectrogram(jnp.asarray(audio)))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=["fp16-pair", "bf16-pair"])
@pytest.mark.parametrize("kind", ["noise", "tonal"])
def test_split_dft_matches_the_float32_mel(kind, dtype):
    audio = (_noise if kind == "noise" else _tonal)(21, 3, 23040)
    got = _split_logmel(torch.from_numpy(audio), dtype).numpy()
    ref = _jax_mel(audio)
    assert got.shape == ref.shape == (3, 141, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_fp16_pairs_are_far_closer_than_bf16_pairs_on_a_tone():
    audio = _tonal(22, 3, 23040)
    ref = _jax_mel(audio)
    err = {
        name: np.abs(_split_logmel(torch.from_numpy(audio), dtype).numpy() - ref).max()
        for name, dtype in (("fp16", torch.float16), ("bf16", torch.bfloat16))
    }
    assert err["bf16"] > 5e-4  # 16 bits: the quiet bins show it
    assert err["fp16"] < err["bf16"] / 10  # 22 bits: about float32's own distance


@pytest.mark.parametrize("dtype, scale", [(torch.float16, X_SCALE), (torch.bfloat16, 1.0)],
                         ids=["fp16-pair", "bf16-pair"])
def test_int16_samples_are_exact_in_their_pair(dtype, scale):
    x = torch.arange(-32768, 32768, dtype=torch.float32)
    hi, lo = _pair(x, dtype, scale)
    assert torch.equal(hi + lo, x.double())


def test_the_basis_buffer_holds_its_operands_behind_it():
    taps, _, _ = mk.mel_constants(torch.device("cpu"))
    assert torch.equal(taps, torch.from_numpy(mk._numpy_constants()[0]))
    n = taps.numel()
    raw = torch.frombuffer(bytearray(bytes(taps.untyped_storage())), dtype=torch.uint8)
    assert raw.numel() == n * (4 + 3 * 2)
    hi = raw[4 * n : 6 * n].view(torch.float16).reshape(taps.shape)
    lo = raw[6 * n : 8 * n].view(torch.float16).reshape(taps.shape)
    b16 = raw[8 * n :].view(torch.bfloat16).reshape(taps.shape)
    scaled = taps * mk.SPLIT_BASIS_SCALE
    assert torch.equal(hi, scaled.half())
    assert torch.equal(lo, (scaled - hi.float()).half())
    assert torch.equal(b16, taps.bfloat16())


def test_the_filterbank_buffer_holds_each_bins_band_behind_it():
    _, _, fb = mk.mel_constants(torch.device("cpu"))
    assert torch.equal(fb, torch.from_numpy(mk._numpy_constants()[2]))
    raw = torch.frombuffer(bytearray(bytes(fb.untyped_storage())), dtype=torch.uint8)
    lo, hi = raw[4 * fb.numel() :].view(torch.int32).reshape(2, fb.shape[1])
    for m in range(fb.shape[1]):
        nz = torch.nonzero(fb[:, m]).flatten()
        assert lo[m] == nz.min() and hi[m] == nz.max()
        # zero outside lo..hi: the kernels' sum over the band is the whole sum
        assert not fb[: lo[m], m].any() and not fb[hi[m] + 1 :, m].any()


def test_the_constants_pass_their_own_check():
    taps, _, fb = mk.kernel_constants(torch.device("cpu"))
    assert taps.untyped_storage().nbytes() == mk.OPERAND_BYTES
    assert fb.untyped_storage().nbytes() == mk.BAND_BYTES
    mk.check_constants(taps, fb)


@pytest.mark.parametrize("which", ["taps", "fb"])
@pytest.mark.parametrize("copy", [
    lambda t: t.clone(),
    lambda t: t.to(torch.float64).to(torch.float32),
    lambda t: t.t().contiguous().t(),
], ids=["clone", "to", "transposed"])
def test_a_copy_of_a_constant_is_refused(which, copy):
    """A copy ends at its last float32 value: a kernel would read past it."""
    taps, _, fb = mk.mel_constants(torch.device("cpu"))
    if which == "taps":
        taps = copy(taps)
    else:
        fb = copy(fb)
    with pytest.raises(ValueError, match=which):
        mk.check_constants(taps, fb)


@pytest.mark.parametrize("b, t, frames", [(2, 23040, 141), (3, 17280, 105)])
def test_bf16_dft_spectrogram_matches_pallas(b, t, frames):
    audio = _noise(23, b, t)
    ref = np.asarray(mel_spectrogram_pallas(jnp.asarray(audio), interpret=True, dft_dtype=jnp.bfloat16))
    got = mk.mel_spectrogram(torch.from_numpy(audio), dft_dtype=torch.bfloat16).numpy()
    assert got.shape == ref.shape == (b, frames, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert np.abs(got - _jax_mel(audio)).max() < BF16_DFT_TOL


@pytest.mark.parametrize("b, t, expect", [(2, 23040, 35), (3, 17280, 26)])
def test_bf16_dft_patches_match_pallas(b, t, expect):
    audio = _noise(24, b, t)
    ref, ref_n = mel_patches_pallas(jnp.asarray(audio), interpret=True, dft_dtype=jnp.bfloat16)
    ref = np.asarray(ref)[:b]  # the Pallas kernel pads the batch to 16
    got, n = mk.mel_patches(torch.from_numpy(audio), dft_dtype=torch.bfloat16)
    f32, _ = mk.mel_patches(torch.from_numpy(audio))
    got, f32 = got.numpy(), f32.numpy()
    assert n == ref_n == expect
    assert got.shape == ref.shape == (b, -(-n // 8) * 8, 128)
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=ATOL, rtol=RTOL)
    assert np.abs(got[:, :n] - f32[:, :n]).max() < BF16_DFT_TOL
    assert (got[:, n:] == 0).all()


def test_dft_dtype_is_checked():
    audio = torch.zeros(1, 23040)
    with pytest.raises(ValueError, match="dft_dtype"):
        mk.mel_patches(audio, dft_dtype=torch.float16)
    with pytest.raises(ValueError, match="dft_dtype"):
        mk.mel_spectrogram(audio, dft_dtype=torch.float64)
    with pytest.raises(ValueError, match="fat"):
        mk.mel_patches(audio, dft_mode="fat", dft_dtype=torch.bfloat16)


def test_float64_accumulation_moves_the_mel_by_float32_rounding_only():
    audio = torch.from_numpy(_tonal(25, 2, 23040))
    f32, n = mk.mel_patches_plain(audio)
    f64, n64 = mk.mel_patches_plain(audio, accumulate=torch.float64)
    assert n == n64 and f64.dtype == torch.float32
    assert 0 < (f32 - f64).abs().max().item() < 1e-3
