"""The numerics of the split tensor-core DFT, and the bf16-DFT variant, on
the CPU.

A split product: audio x and basis b each become a pair of 16-bit values, hi
+ lo, and the spectrum is x_hi b_hi + x_hi b_lo + x_lo b_hi with float32
accumulation. K1b (``dft_mode="fat"``, ``csrc/mel_patches_fat.cu``) computes
its DFT so, and so did K1, K3 and K4 before their float32 mel became a real
FFT on the CUDA cores (``csrc/mel_fft.cuh``, emulated in
``test_torch_mel_fft.py``). Here that arithmetic is emulated in plain
PyTorch (every product of two 16-bit values is exact in float64, and the
terms are summed there) and held to the JAX package's float32 mel: the
design's history as much as K1b's check. The kernels used fp16 pairs; bf16
pairs, the first design, are emulated beside them to show why: both pass the
mel tolerance, but on a tone with noise 60 dB below it the bf16 pair is more
than ten times further from float32.

The bf16-DFT variant (``dft_dtype=torch.bfloat16``, the TPU kernels'
``dft_dtype=jnp.bfloat16``) runs its plain version here against JAX's Pallas
kernels in interpret mode, in both of ``mel_patches``' modes.

K1b computes the split as one product of the hop rows against the three
hop-aligned basis blocks, then shifted sums. Its split is emulated here the
same way, and so is the kernel's walk: its operand tiles decoded from the
buffer behind the blocks as its wgmma descriptors read them, its 64-row
tiles over the flat hop rows, the halo, the shifted sums in the epilogue and
the pad rows.
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
# the split's limit against the float32 mel (chip_smoke.py SPLIT_ATOL): fp16
# pairs stay within 6.1e-5 of it on the tone, bf16 pairs reach 2.3e-3
SPLIT_ATOL = 5e-4


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


def _split_hop_blocks(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """
    ``_logmel_hop_blocks`` with the hop rows and the blocks split into fp16
    pairs at the kernels' scalings: three products per 160-deep block, each
    exact and summed in float64, then the shifted sums.
    """
    _, blocks, fb = mk.mel_constants(torch.device("cpu"))
    b = audio.shape[0]
    n_hops = n_frames + mk.HOP_BLOCKS - 1
    hops = audio[:, : n_hops * MEL_HOP_LENGTH].reshape(b, n_hops, MEL_HOP_LENGTH)
    x_hi, x_lo = _pair(hops, torch.float16, X_SCALE)
    b_hi, b_lo = _pair(blocks, torch.float16, mk.SPLIT_BASIS_SCALE)
    z = x_hi @ b_hi + x_hi @ b_lo + x_lo @ b_hi  # (b, n_hops, 3 * 256)
    width = 2 * mk.N_FREQ_PAD
    spectrum = sum(z[:, j : j + n_frames, j * width : (j + 1) * width] for j in range(mk.HOP_BLOCKS))
    return mk._mel_tail(spectrum.float(), fb)


def _jax_fat(audio: np.ndarray, dft_dtype=jnp.float32):
    out, n = mel_patches_pallas(jnp.asarray(audio), interpret=True, dft_mode="fat", dft_dtype=dft_dtype)
    return np.asarray(out)[: audio.shape[0]], n  # the Pallas kernel pads the batch to 16


# csrc/mel_patches_fat.cu: hop rows a warpgroup multiplies, frames it keeps,
# warpgroups a block
ROWS_WG, FRAMES_WG, CONSUMERS = 64, 62, 2


def _operand_tiles(terms: int) -> list:
    """
    K1b's operand tiles decoded from the buffer behind the blocks, each as
    (160, 128) float64 per (half, block) in consumption order: element (n, k)
    of a k16 x n128 tile at 16-bit index 128 (n // 8) + 64 (k // 8) + 8 (n %
    8) + k % 8, the wgmma descriptors' strides (256 B along n, 128 B along k).
    """
    _, blocks, _ = mk.mel_constants(torch.device("cpu"))
    raw = torch.frombuffer(bytearray(bytes(blocks.untyped_storage())), dtype=torch.uint8)
    ops = raw[blocks.numel() * 4 :]
    tile = mk.FAT_TILE_BYTES
    n, k = torch.meshgrid(torch.arange(128), torch.arange(16), indexing="ij")
    index = 128 * (n // 8) + 64 * (k // 8) + 8 * (n % 8) + k % 8
    stages = mk.FAT_STAGES

    def decode(buf, dtype, stride, offset):
        out = []
        for st in range(stages):
            words = buf[st * stride + offset : st * stride + offset + tile].view(dtype)
            out.append(words[index].double().t())  # (k 16, n 128)
        # 10 k-steps per (half, block): (160, 128)
        return [torch.cat(out[i : i + 10]) for i in range(0, stages, 10)]

    if terms == 3:
        return list(zip(decode(ops, torch.float16, 2 * tile, 0), decode(ops, torch.float16, 2 * tile, tile)))
    bf16 = ops[stages * 2 * tile :]
    return [(b16, None) for b16 in decode(bf16, torch.bfloat16, tile, 0)]


def _emulate_fat_kernel(audio: torch.Tensor, terms: int) -> torch.Tensor:
    """
    K1b's walk in float64: blocks of two warpgroups, each 64 flat hop rows
    (zero past the batch) for 62 frames; per half and block the product of
    the split rows with the decoded tiles; block 0 written to frame r, block
    1 added to frame r - 1, block 2 added to frame r - 2; the frames of each
    clip below ``usable`` stored, each clip's pad rows zeroed by the
    warpgroup that holds its first pad frame. Unwritten values stay NaN.
    """
    b, t = audio.shape
    usable, _, p_pad = mk.patch_geometry(t)
    per_clip = t // MEL_HOP_LENGTH
    rows = b * per_clip
    flat = audio[:, : per_clip * MEL_HOP_LENGTH].reshape(rows, MEL_HOP_LENGTH)
    tiles = _operand_tiles(terms)
    _, _, fb = mk.mel_constants(torch.device("cpu"))
    out = torch.full((b, 4 * p_pad, 32), float("nan"))
    for r0 in range(0, rows, FRAMES_WG):  # each warpgroup's first row (= first frame)
        a = torch.zeros(ROWS_WG, MEL_HOP_LENGTH)
        a[: max(0, min(ROWS_WG, rows - r0))] = flat[r0 : r0 + ROWS_WG]
        if terms == 3:
            v = a * X_SCALE
            hi = v.half()
            x = (hi.double(), (v - hi.float()).half().double())
        else:
            x = (a.bfloat16().double(), None)
        halves = []
        for h in range(2):
            spec = torch.zeros(FRAMES_WG, 128, dtype=torch.float64)
            for j in range(3):
                b_hi, b_lo = tiles[h * 3 + j]
                d = x[0] @ b_hi
                if terms == 3:
                    d = d + x[0] @ b_lo + x[1] @ b_hi
                d = d.float().double()  # float32 accumulators
                spec = spec + d[j : j + FRAMES_WG]
            halves.append(spec)
        # (62, 256): the cos of bins 0..127, then their sin
        spectrum = torch.cat([halves[0][:, :64], halves[1][:, :64], halves[0][:, 64:], halves[1][:, 64:]], 1)
        logmel = mk._mel_tail(spectrum.float(), fb)
        for fl in range(FRAMES_WG):
            clip, f = divmod(r0 + fl, per_clip)
            if clip < b and f < usable:
                out[clip, f] = logmel[fl]
        for clip in range(b):
            if r0 <= clip * per_clip + usable < r0 + FRAMES_WG:
                out[clip, usable:] = 0.0
    return out.reshape(b, p_pad, 128)


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
    """The float32 taps, the fp16 pair and the bf16 operand, then the FFT's table, then the bf16 DFT's tiles."""
    taps, _, _ = mk.mel_constants(torch.device("cpu"))
    assert torch.equal(taps, torch.from_numpy(mk._numpy_constants()[0]))
    n = taps.numel()
    raw = torch.frombuffer(bytearray(bytes(taps.untyped_storage())), dtype=torch.uint8)
    assert raw.numel() == n * (4 + 3 * 2) + mk.FFT_TABLE_FLOATS * 4 + n * 2
    assert mk.FFT_TABLE_OFFSET == n * (4 + 3 * 2)
    assert mk.DFT_TILES_OFFSET == mk.FFT_TABLE_OFFSET + mk.FFT_TABLE_FLOATS * 4
    hi = raw[4 * n : 6 * n].view(torch.float16).reshape(taps.shape)
    lo = raw[6 * n : 8 * n].view(torch.float16).reshape(taps.shape)
    b16 = raw[8 * n : 10 * n].view(torch.bfloat16).reshape(taps.shape)
    scaled = taps * mk.SPLIT_BASIS_SCALE
    assert torch.equal(hi, scaled.half())
    assert torch.equal(lo, (scaled - hi.float()).half())
    assert torch.equal(b16, taps.bfloat16())
    tiles = raw[mk.DFT_TILES_OFFSET :].view(torch.bfloat16).view(mk.DFT_KSTEPS, 32, 2, 8, 8)
    assert torch.equal(tiles, mk.dft_tiles(taps.bfloat16()))


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
    taps, blocks, fb = mk.kernel_constants(torch.device("cpu"))
    assert taps.untyped_storage().nbytes() == mk.OPERAND_BYTES
    assert fb.untyped_storage().nbytes() == mk.BAND_BYTES
    assert blocks.untyped_storage().nbytes() == mk.FAT_OPERAND_BYTES
    mk.check_constants(taps, fb, blocks)


@pytest.mark.parametrize("which", ["taps", "fb", "blocks"])
@pytest.mark.parametrize("copy", [
    lambda t: t.clone(),
    lambda t: t.to(torch.float64).to(torch.float32),
    lambda t: t.t().contiguous().t(),
], ids=["clone", "to", "transposed"])
def test_a_copy_of_a_constant_is_refused(which, copy):
    """A copy ends at its last float32 value: a kernel would read past it."""
    taps, blocks, fb = mk.mel_constants(torch.device("cpu"))
    if which == "taps":
        taps = copy(taps)
    elif which == "fb":
        fb = copy(fb)
    else:
        blocks = copy(blocks)
    with pytest.raises(ValueError, match=which):
        mk.check_constants(taps, fb, blocks)


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
    with pytest.raises(ValueError, match="dft_dtype"):
        mk.mel_patches(audio, dft_mode="fat", dft_dtype=torch.float16)


@pytest.mark.parametrize("b, t, expect", [(2, 23040, 35), (3, 17280, 26)])
def test_fat_bf16_dft_patches_match_pallas(b, t, expect):
    audio = _noise(26, b, t)
    ref, ref_n = _jax_fat(audio, jnp.bfloat16)
    got, n = mk.mel_patches(torch.from_numpy(audio), dft_mode="fat", dft_dtype=torch.bfloat16)
    f32, _ = mk.mel_patches(torch.from_numpy(audio), dft_mode="fat")
    got, f32 = got.numpy(), f32.numpy()
    assert n == ref_n == expect
    assert got.shape == ref.shape == (b, -(-n // 8) * 8, 128)
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=ATOL, rtol=RTOL)
    assert np.abs(got[:, :n] - f32[:, :n]).max() < BF16_DFT_TOL
    assert (got[:, n:] == 0).all()


@pytest.mark.parametrize("kind", ["noise", "tonal"])
def test_fat_split_dft_matches_the_float32_fat_mel(kind):
    audio = (_noise if kind == "noise" else _tonal)(27, 3, 23040)
    ref, n = _jax_fat(audio)
    usable = 4 * n
    got = _split_hop_blocks(torch.from_numpy(audio), usable).numpy()
    assert np.abs(got.reshape(3, n, 128) - ref[:, :n]).max() < SPLIT_ATOL


def test_the_blocks_buffer_holds_their_operand_tiles_behind_them():
    _, blocks, _ = mk.mel_constants(torch.device("cpu"))
    assert torch.equal(blocks, torch.from_numpy(mk._numpy_constants()[1]))
    assert blocks.untyped_storage().nbytes() == mk.FAT_OPERAND_BYTES
    scaled = blocks.double() * mk.SPLIT_BASIS_SCALE
    hi = scaled.float().half()
    lo = (scaled.float() - hi.float()).half()
    width = 2 * mk.N_FREQ_PAD
    for terms, want in ((3, (hi, lo)), (1, (blocks.bfloat16(), None))):
        for i, got in enumerate(_operand_tiles(terms)):
            h, j = divmod(i, 3)
            bins = torch.arange(64 * h, 64 * h + 64)
            cols = j * width + torch.cat([bins, mk.N_FREQ_PAD + bins])
            for part, ref in zip(got, want):
                if ref is not None:
                    assert torch.equal(part, ref[:, cols].double()), (terms, h, j)


@pytest.mark.parametrize("terms", [3, 1], ids=["split", "bf16"])
@pytest.mark.parametrize("b, t", [(3, 23040), (2, 20001), (1, 32000), (5, 17280)])
def test_the_fat_kernels_walk_matches_the_plain_version(b, t, terms):
    """
    The kernel's tiling, halo, epilogue and pad rows, emulated on its own
    operand tiles, against the plain version of its DFT type: flat rows
    across clip boundaries (t % 160 == 0) and the clips' own rows (20001),
    a batch that ends inside a tile.
    """
    audio = torch.from_numpy(_noise(28, b, t))
    dtype = torch.float32 if terms == 3 else torch.bfloat16
    ref, n = mk.mel_patches_plain(audio, "fat", dtype)
    got = _emulate_fat_kernel(audio, terms)
    assert not torch.isnan(got).any()
    assert (got[:, n:] == 0).all()
    assert (got[:, :n] - ref[:, :n]).abs().max().item() < SPLIT_ATOL


def test_float64_accumulation_moves_the_mel_by_float32_rounding_only():
    audio = torch.from_numpy(_tonal(25, 2, 23040))
    f32, n = mk.mel_patches_plain(audio)
    f64, n64 = mk.mel_patches_plain(audio, accumulate=torch.float64)
    assert n == n64 and f64.dtype == torch.float32
    assert 0 < (f32 - f64).abs().max().item() < 1e-3
