"""
The mel kernels: audio -> scaled log-mel, in patch or spectrogram layout.

Counterparts of the JAX package's ``ops/pallas/melspec_kernel.py``:

* ``mel_patches(audio, dft_mode="chunked")`` is K1 (``mel_patches_pallas``):
  a (b, t) float32 int16-range batch -> ``(patches, num_patches)``, patches
  (b, p_pad, 128) where patch p holds frames 4p..4p+3 (32 mel bins each),
  ``num_patches = frames // 4`` and ``p_pad`` rounds it up to 8; rows
  ``num_patches..p_pad-1`` are exact zeros. K1 also reads a row-strided
  view in place (the overlapping windows of a stream segment, one row per
  window, ``stride(0)`` apart). ``dft_mode="fat"`` is K1b, the
  same function computed as one product of the hop rows against the three
  hop-aligned basis blocks side by side, then shifted sums.
* ``mel_spectrogram(audio)`` is K3 (``mel_spectrogram_pallas``): (b, t) ->
  (b, frames, 32), every frame, the contract of the JAX package's XLA
  ``ops/melspec.py::mel_spectrogram``.
* ``dft_dtype=torch.bfloat16`` (both modes of ``mel_patches``, and K3) is
  the TPU kernels' ``dft_dtype=bfloat16``: audio and basis rounded to bf16
  before the DFT product, float32 accumulation. The JAX suite bounds it at
  1e-2 from the float32 mel.

On the card K1 and K3 (and K4's mel) compute each frame's spectrum as a
float32 real FFT on the CUDA cores (``csrc/mel_fft.cuh``), and K1b as a split
tensor-core product of fp16 pairs (``csrc/mel_patches_fat.cu``), both within
5e-4 of the float32 plain version; the bf16-DFT entries of K1 and K3 as one
wgmma product over frames walked flat across the clips (``csrc/mel_dft.cuh``,
``dft_walk``). The kernels read their precomputed data from behind the
float32 constants (``mel_constants``): the FFT's window and twiddle table,
the basis's 16-bit operands and wgmma tiles, the filterbank's bands; so their
C entries take the same pointers as before, and each wrapper raises unless
the buffers it passes hold those bytes (``check_constants``).

Unlike the Pallas kernels nothing pads the batch. On a CUDA tensor each
wrapper launches its hand-written kernel (``csrc/mel_patches.cu``,
``mel_patches_fat.cu``, ``mel_spectrogram.cu``; their headers say what bounds
them and how they are laid out); on a CPU tensor it runs the plain version
beside it, the same arithmetic in plain PyTorch, which the tests and the chip
check compare against.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    MEL_BINS,
    MEL_HOP_LENGTH,
    MEL_LOG_EPS,
    MEL_N_FFT,
    MEL_SCALE_ADD,
    MEL_SCALE_DIV,
    MEL_WIN_LENGTH,
)
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.melspec import dft_basis, mel_band_freqs, mel_filterbank, num_frames

__all__ = [
    "mel_patches",
    "mel_patches_plain",
    "mel_spectrogram",
    "mel_spectrogram_plain",
    "patch_geometry",
    "DFT_MODES",
    "DFT_DTYPES",
    "PATCH_FRAMES",
]

PATCH_FRAMES = 4
N_FREQ_PAD = 128  # DFT bins kept: the mel band (124 bins) padded to 128
TAP0 = (MEL_N_FFT - MEL_WIN_LENGTH) // 2  # 56: the Hann window's first row
TAPS = MEL_WIN_LENGTH  # 400 rows of the basis are non-zero
HOP_BLOCKS = 3  # hop-aligned basis blocks with a non-zero row (rows 0..479)
DFT_MODES = ("chunked", "fat")
DFT_DTYPES = (torch.float32, torch.bfloat16)


def patch_geometry(t: int) -> Tuple[int, int, int]:
    """(usable frames, num_patches, p_pad) of a clip of ``t`` samples."""
    num_patches = num_frames(t) // PATCH_FRAMES
    p_pad = -(-num_patches // 8) * 8
    return num_patches * PATCH_FRAMES, num_patches, p_pad


@functools.lru_cache(maxsize=None)
def _numpy_constants() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    (taps (400, 256): the window's non-zero basis rows, 128 cos + 128 sin bins;
    hop blocks (160, 3 * 256): basis rows 160 j .. 160 j + 159 for j = 0, 1, 2
    side by side; filterbank (128, 32)).
    """
    assert N_FREQ_PAD >= mel_band_freqs(), "N_FREQ_PAD no longer covers the mel band"
    full = dft_basis(MEL_N_FFT, MEL_WIN_LENGTH, None)  # (512, 2*257)
    bins = MEL_N_FFT // 2 + 1
    basis = np.concatenate([full[:, :N_FREQ_PAD], full[:, bins : bins + N_FREQ_PAD]], axis=1)
    # rows outside the window are exactly zero, so dropping them is exact
    assert not basis[:TAP0].any() and not basis[TAP0 + TAPS :].any()
    assert not basis[HOP_BLOCKS * MEL_HOP_LENGTH :].any()
    blocks = np.concatenate(
        [basis[j * MEL_HOP_LENGTH : (j + 1) * MEL_HOP_LENGTH] for j in range(HOP_BLOCKS)], axis=1
    )
    fb = mel_filterbank()[:N_FREQ_PAD]
    return (
        np.ascontiguousarray(basis[TAP0 : TAP0 + TAPS]),
        np.ascontiguousarray(blocks),
        np.ascontiguousarray(fb),
    )


# the split DFT's power-of-two scaling of the basis (csrc/mel_common.cuh B_SCALE)
SPLIT_BASIS_SCALE = 256.0
# The float32 FFT of K1, K3 and K4 (csrc/mel_fft.cuh FFT_*): a frame's 512
# windowed samples as 256 complex points (even, odd sample pairs), transformed
# by two radix-16 passes of 16 lanes. Its table, offsets in float32 values:
# the window w[n] (512), the first pass's twiddles W256^(l k1) at k1 * 16 + l
# and the post-twiddles W512^k of the bins kept, each complex as (cos, -sin).
FFT_POINTS = MEL_N_FFT // 2
FFT_RADIX = 16
FFT_WIN = 0
FFT_TW1 = FFT_WIN + MEL_N_FFT
FFT_TW2 = FFT_TW1 + 2 * FFT_RADIX * FFT_RADIX
FFT_TABLE_FLOATS = FFT_TW2 + 2 * N_FREQ_PAD


@functools.lru_cache(maxsize=None)
def _numpy_fft_table() -> np.ndarray:
    """The FFT's table (``FFT_*`` offsets), computed in float64 and rounded once to float32."""
    padded = np.zeros(MEL_N_FFT)
    padded[TAP0 : TAP0 + TAPS] = np.hanning(MEL_WIN_LENGTH + 1)[:MEL_WIN_LENGTH]  # dft_basis's window
    lanes = np.arange(FFT_RADIX)
    tw1 = 2.0 * np.pi * (lanes[:, None] * lanes[None, :]) / FFT_POINTS  # [k1, l]
    tw2 = 2.0 * np.pi * np.arange(N_FREQ_PAD) / MEL_N_FFT
    pairs = [np.stack([np.cos(a), -np.sin(a)], axis=-1).reshape(-1) for a in (tw1, tw2)]
    table = np.concatenate([padded, *pairs]).astype(np.float32)
    assert table.size == FFT_TABLE_FLOATS
    return table


# K1b's operand tiles (csrc/mel_patches_fat.cu): k16 x n128, n128 = the cos
# and the sin columns of 64 bins, in the order the kernel consumes them
FAT_K = 16
FAT_BINS = 64
FAT_TILE_BYTES = FAT_K * 2 * FAT_BINS * 2
FAT_STAGES = (N_FREQ_PAD // FAT_BINS) * HOP_BLOCKS * (MEL_HOP_LENGTH // FAT_K)  # 60


# The bf16 DFT's wgmma operand (csrc/mel_dft.cuh): bf16(b) as 25 k16 x n256
# tiles, the 128 cos | 128 sin columns side by side, k-step by k-step
DFT_K = 16
DFT_KSTEPS = TAPS // DFT_K  # 25
DFT_TILE_BYTES = DFT_K * 2 * N_FREQ_PAD * 2
# its walk (mel_dft.cuh ITEM, HALO): items of DFT_ITEM rows of the padded
# frame sequence, clip c's frames f = 0 .. usable + DFT_HALO - 1 at row
# c (usable + DFT_HALO) + f, the last DFT_HALO of each clip dropped
DFT_ITEM = 128
DFT_HALO = (TAPS - 1) // MEL_HOP_LENGTH


def dft_walk(b: int, usable: int) -> Tuple[int, int]:
    """
    (rows a clip, items) of the bf16-DFT body's walk over ``b`` clips of
    ``usable`` frames each: every item computes DFT_ITEM rows, the frames of
    its rows and, where a row is a clip's padding or past the last clip, a
    row it drops.
    """
    rows_clip = usable + DFT_HALO
    return rows_clip, -(-b * rows_clip // DFT_ITEM)


def dft_tiles(values: torch.Tensor) -> torch.Tensor:
    """
    The taps (400, 256) of 16-bit ``values`` as the bf16 DFT's operand tiles:
    for each k-step s, rows 16 s .. 16 s + 15 and all 256 columns, as wgmma's
    K-major layout without swizzle reads them (``fat_tiles``' layout): 8 x 8
    core matrices of 8 columns (n) by 8 rows (k), 128 contiguous bytes each,
    the two along k next to each other and the 32 along n 256 bytes apart.
    Returns (DFT_KSTEPS, 32, 2, 8, 8): tile, n group, k half, n, k.
    """
    tiles = [values[s * DFT_K : (s + 1) * DFT_K].t().reshape(-1, 8, 2, 8).permute(0, 2, 1, 3)
             for s in range(DFT_KSTEPS)]
    return torch.stack(tiles).contiguous()


def _with_operands(taps: torch.Tensor) -> torch.Tensor:
    """
    One float32 buffer that holds ``taps`` (400, 256) and behind it the DFT
    operands, each (400, 256) of 16-bit values: the fp16 pair hi = fp16(b *
    256), lo = fp16(b * 256 - hi), then bf16(b) row by row
    (``csrc/mel_common.cuh`` OPS_*); then the FFT's table
    (``_numpy_fft_table``, ``csrc/mel_fft.cuh``); last bf16(b) as the bf16
    DFT's tiles (``dft_tiles``, ``csrc/mel_dft.cuh`` DFT_TILES_OFFSET). No
    kernel of this tree reads the fp16 pair or the bf16 rows: they stay so
    that the buffer's prefix is the one earlier builds of K1, K3 and K4 read
    (``compare_builds`` launches such builds on these constants). Returns
    the (400, 256) float32 view of its head, whose data pointer is the
    buffer's.
    """
    scaled = taps * SPLIT_BASIS_SCALE  # exact: a power of two
    hi = scaled.half()
    lo = (scaled - hi.float()).half()
    b16 = taps.bfloat16()
    table = torch.from_numpy(_numpy_fft_table()).to(taps.device)
    raw = [t.contiguous().view(torch.uint8).reshape(-1) for t in (taps, hi, lo, b16, table, dft_tiles(b16))]
    return torch.cat(raw).view(torch.float32)[: taps.numel()].view(taps.shape)


def _with_bands(fb: torch.Tensor) -> torch.Tensor:
    """
    One float32 buffer that holds the filterbank ``fb`` (128, 32) and behind it
    each mel bin's band as int32: the first bin its filter is non-zero on (32
    values), then the last (``csrc/mel_common.cuh`` FB_FLOATS). Returns the
    (128, 32) view of its head.
    """
    nz = fb != 0
    bins = torch.arange(fb.shape[0], device=fb.device)[:, None]
    lo = torch.where(nz, bins, fb.shape[0]).amin(dim=0).int()
    hi = torch.where(nz, bins, -1).amax(dim=0).int()
    raw = [t.contiguous().view(torch.uint8).reshape(-1) for t in (fb, lo, hi)]
    return torch.cat(raw).view(torch.float32)[: fb.numel()].view(fb.shape)


def fat_tiles(values: torch.Tensor) -> torch.Tensor:
    """
    The hop blocks (160, 3 * 256) of 16-bit ``values`` as K1b's operand tiles:
    for each half h (bins 64 h ..), block j and k-step s, the tile of rows
    16 s .. 16 s + 15 of block j and its columns of those bins' cos and sin,
    as wgmma's K-major layout without swizzle reads it: 8 x 8 core matrices
    of 8 columns (n) by 8 rows (k), 128 contiguous bytes each, the two along k
    next to each other and the 16 along n 256 bytes apart. Returns
    (FAT_STAGES, 16, 2, 8, 8): tile, n group, k half, n, k.
    """
    width = 2 * N_FREQ_PAD
    tiles = []
    for h in range(N_FREQ_PAD // FAT_BINS):
        bins = torch.arange(h * FAT_BINS, (h + 1) * FAT_BINS, device=values.device)
        cols = torch.cat([bins, N_FREQ_PAD + bins])
        for j in range(HOP_BLOCKS):
            block = values[:, j * width + cols]  # (160, 128)
            for s in range(MEL_HOP_LENGTH // FAT_K):
                tile = block[s * FAT_K : (s + 1) * FAT_K].t()  # (n 128, k 16)
                tiles.append(tile.reshape(16, 8, 2, 8).permute(0, 2, 1, 3))
    return torch.stack(tiles).contiguous()


def _with_fat_operands(blocks: torch.Tensor) -> torch.Tensor:
    """
    One float32 buffer that holds the hop blocks (160, 3 * 256) and behind
    them K1b's operands: the fp16 pair hi = fp16(b * 256), lo = fp16(b * 256
    - hi) as ``fat_tiles``, each tile's hi then its lo, then the bf16(b)
    tiles (``csrc/mel_patches_fat.cu`` OPS_*). Returns the (160, 768) view of
    its head.
    """
    scaled = blocks * SPLIT_BASIS_SCALE
    hi = scaled.half()
    lo = (scaled - hi.float()).half()
    pairs = torch.stack([fat_tiles(hi), fat_tiles(lo)], dim=1)
    raw = [t.contiguous().view(torch.uint8).reshape(-1)
           for t in (blocks, pairs, fat_tiles(blocks.bfloat16()))]
    return torch.cat(raw).view(torch.float32)[: blocks.numel()].view(blocks.shape)


@functools.lru_cache(maxsize=None)
def mel_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    The (taps, hop blocks, filterbank) constants the mel kernels read, on
    ``device``; ``taps`` and ``blocks`` head buffers that also hold their DFT
    operands, and ``fb`` one that also holds its bands.
    """
    taps, blocks, fb = (torch.from_numpy(c).to(device) for c in _numpy_constants())
    return _with_operands(taps), _with_fat_operands(blocks), _with_bands(fb)


# bytes the kernels read from the buffers that ``taps``, ``blocks`` and ``fb``
# head: the float32 taps, three 16-bit operands (``csrc/mel_common.cuh``
# OPS_*), the FFT's table from FFT_TABLE_OFFSET on (``csrc/mel_fft.cuh``) and
# the bf16 DFT's tiles from DFT_TILES_OFFSET on (``csrc/mel_dft.cuh``); the
# float32 hop blocks and three 16-bit operands (``csrc/mel_patches_fat.cu``
# OPS_*); the float32 filterbank and two int32 bands (FB_FLOATS)
FFT_TABLE_OFFSET = TAPS * 2 * N_FREQ_PAD * (4 + 3 * 2)
DFT_TILES_OFFSET = FFT_TABLE_OFFSET + FFT_TABLE_FLOATS * 4
OPERAND_BYTES = DFT_TILES_OFFSET + DFT_KSTEPS * DFT_TILE_BYTES
FAT_OPERAND_BYTES = MEL_HOP_LENGTH * HOP_BLOCKS * 2 * N_FREQ_PAD * 4 + FAT_STAGES * FAT_TILE_BYTES * 3
BAND_BYTES = (N_FREQ_PAD + 2) * MEL_BINS * 4


def check_constants(taps: torch.Tensor, fb: torch.Tensor, blocks: torch.Tensor) -> None:
    """
    Raise unless ``taps``, ``fb`` and ``blocks`` head buffers that hold what
    the kernels read behind them (``mel_constants``'s own): a copy of any,
    made with ``clone``, ``contiguous`` or ``to``, ends at its last float32
    value.
    """
    for what, t, need in (("taps", taps, OPERAND_BYTES), ("fb", fb, BAND_BYTES),
                          ("blocks", blocks, FAT_OPERAND_BYTES)):
        held = t.untyped_storage().nbytes() - t.storage_offset() * t.element_size()
        if t.dtype != torch.float32 or not t.is_contiguous() or held < need:
            raise ValueError(
                f"the mel kernels read {need} B from {what}'s buffer, which holds {held}: "
                "pass the tensors of mel_constants, not copies"
            )


def kernel_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mel_constants(device)`` for a launch, checked by ``check_constants``."""
    taps, blocks, fb = mel_constants(device)
    check_constants(taps, fb, blocks)
    return taps, blocks, fb


def _mel_tail(spectrum: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(..., 256) cos|sin spectrum -> power -> mel -> scaled log, in the spectrum's type."""
    re, im = spectrum[..., :N_FREQ_PAD], spectrum[..., N_FREQ_PAD:]
    mel = torch.matmul(re * re + im * im, fb.to(spectrum.dtype))
    return torch.log(mel + MEL_LOG_EPS) / MEL_SCALE_DIV + MEL_SCALE_ADD


def _logmel_taps(
    audio: torch.Tensor,
    n_frames: int,
    dft_dtype: torch.dtype = torch.float32,
    accumulate: torch.dtype = torch.float32,
) -> torch.Tensor:
    """
    The first ``n_frames`` frames by the 400-tap DFT: the plain version of K1,
    K3 and K4's mel (whose float32 kernels compute it by an FFT); with
    ``dft_dtype=torch.bfloat16`` the frames and the basis are rounded to bf16
    first and multiplied in float32 (each product exact). ``accumulate=
    torch.float64`` computes the float32 operands' DFT and tail in double
    precision (a float32 result).
    """
    taps, _, fb = mel_constants(audio.device)
    frames = audio.unfold(-1, MEL_N_FFT, MEL_HOP_LENGTH)[:, :n_frames, TAP0 : TAP0 + TAPS]
    if dft_dtype == torch.bfloat16:
        frames, taps = frames.bfloat16().float(), taps.bfloat16().float()
    return _mel_tail(torch.matmul(frames.to(accumulate), taps.to(accumulate)), fb).float()


def _logmel_hop_blocks(
    audio: torch.Tensor, n_frames: int, dft_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """
    The first ``n_frames`` frames by K1b's hop-block product and shifted
    sums; with ``dft_dtype=torch.bfloat16`` the hop rows and the blocks are
    rounded to bf16 first and multiplied in float32 (each product exact).
    """
    _, blocks, fb = mel_constants(audio.device)
    b = audio.shape[0]
    n_hops = n_frames + HOP_BLOCKS - 1  # frame f reads hops f, f+1, f+2
    hops = audio[:, : n_hops * MEL_HOP_LENGTH].reshape(b, n_hops, MEL_HOP_LENGTH)
    if dft_dtype == torch.bfloat16:
        hops, blocks = hops.bfloat16().float(), blocks.bfloat16().float()
    z = torch.matmul(hops, blocks)  # (b, n_hops, 3 * 256)
    width = 2 * N_FREQ_PAD
    spectrum = z[:, :n_frames, :width]
    for j in range(1, HOP_BLOCKS):
        spectrum = spectrum + z[:, j : j + n_frames, j * width : (j + 1) * width]
    return _mel_tail(spectrum, fb)


def mel_patches_plain(
    audio: torch.Tensor,
    dft_mode: str = "chunked",
    dft_dtype: torch.dtype = torch.float32,
    accumulate: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, int]:
    """
    The kernel's function in plain PyTorch (fp32 throughout, or a bf16 DFT).
    ``accumulate=torch.float64`` (chunked mode) computes the DFT and its tail
    in double precision: the chip check uses it to measure how far float32
    rounding of the mel alone moves what the trunk makes of it.
    """
    b, t = audio.shape
    usable, num_patches, p_pad = patch_geometry(t)
    if dft_mode == "fat":
        logmel = _logmel_hop_blocks(audio, usable, dft_dtype)
    else:
        logmel = _logmel_taps(audio, usable, dft_dtype, accumulate)
    out = audio.new_zeros((b, p_pad, PATCH_FRAMES * MEL_BINS))
    out[:, :num_patches] = logmel.reshape(b, num_patches, PATCH_FRAMES * MEL_BINS)
    return out, num_patches


def mel_spectrogram_plain(audio: torch.Tensor, dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3's function in plain PyTorch (fp32 throughout, or a bf16 DFT): (b, frames, 32)."""
    return _logmel_taps(audio, num_frames(audio.shape[1]), dft_dtype)


def check_audio(audio: torch.Tensor, what: str, row_strided: bool = False) -> None:
    """
    Raise unless ``audio`` is what the audio kernels take: 2-D float32 on the
    CPU or CUDA, contiguous. With ``row_strided`` (K1) it may also be a view
    whose rows lie ``stride(0) >= 1`` elements apart, each one contiguous and
    possibly overlapping the next, as long as its storage holds the last row
    whole: the kernel reads each row's ``t`` samples from where it starts.
    """
    if not isinstance(audio, torch.Tensor) or audio.dtype != torch.float32 or audio.ndim != 2:
        raise ValueError(f"{what} takes a 2-D float32 tensor (batch, samples)")
    if audio.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {audio.device}")
    if audio.is_contiguous():
        return
    if not row_strided:
        raise ValueError(f"{what} needs a contiguous audio tensor")
    b, t = audio.shape
    if audio.stride(1) != 1 or audio.stride(0) < 1:
        raise ValueError(f"{what} takes rows of contiguous samples at a positive row stride, "
                         f"not strides {audio.stride()}")
    end = audio.storage_offset() + (b - 1) * audio.stride(0) + t
    held = audio.untyped_storage().nbytes() // audio.element_size()
    if end > held:
        raise ValueError(f"{what}: the last row of the view ends at element {end} of a storage of {held}")


def check_dft_dtype(dft_dtype: torch.dtype) -> None:
    if dft_dtype not in DFT_DTYPES:
        raise ValueError(f"unknown dft_dtype {dft_dtype!r}; expected one of {DFT_DTYPES}")


def mel_patches(
    audio: torch.Tensor, dft_mode: str = "chunked", dft_dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, int]:
    """
    (b, t) float32 int16-range audio -> ((b, p_pad, 128) patches, num_patches).
    ``dft_mode`` "chunked" is K1, "fat" K1b; ``dft_dtype=torch.bfloat16`` the
    bf16-DFT variant of either. Launches the CUDA kernel for a CUDA tensor, the
    plain version for a CPU one. K1 (both DFT types) also takes a row-strided
    view (``check_audio``), such as the overlapping sliding windows of one
    stream segment, and reads it where it lies; K1b takes contiguous audio only.
    """
    if dft_mode not in DFT_MODES:
        raise ValueError(f"unknown dft_mode {dft_mode!r}; expected one of {DFT_MODES}")
    check_dft_dtype(dft_dtype)
    check_audio(audio, "mel_patches", row_strided=dft_mode == "chunked")
    b, t = audio.shape
    usable, num_patches, p_pad = patch_geometry(t)
    if num_patches < 1 or b < 1:
        raise ValueError(f"audio of shape {tuple(audio.shape)} holds no whole patch")
    if audio.device.type == "cpu":
        return mel_patches_plain(audio, dft_mode, dft_dtype)
    taps, blocks, fb = kernel_constants(audio.device)
    basis = blocks if dft_mode == "fat" else taps
    name = "mel_patches_fat" if dft_mode == "fat" else "mel_patches"
    out = torch.empty((b, p_pad, PATCH_FRAMES * MEL_BINS), device=audio.device, dtype=torch.float32)
    # K1 takes the row stride after t; a single row's stride can be anything
    ints = [b, t, usable, p_pad] if dft_mode == "fat" else [b, t, audio.stride(0) if b > 1 else t, usable, p_pad]
    build.launch(
        name,
        audio.device,
        [audio.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr()],
        ints,
        entry=f"{name}_bf16" if dft_dtype == torch.bfloat16 else name,
    )
    return out, num_patches


def fat_load_path(audio: torch.Tensor) -> str:
    """
    How K1b loads ``audio``'s hop rows: "tma" when the audio is the flat
    matrix of hop rows (t % 160 == 0, 16-byte aligned), else "plain"; the
    rule of ``csrc/mel_patches_fat.cu`` ``tma_path``.
    """
    aligned = audio.shape[-1] % MEL_HOP_LENGTH == 0 and audio.data_ptr() % 16 == 0
    return "tma" if aligned else "plain"


def mel_spectrogram(audio: torch.Tensor, dft_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """
    (b, t) float32 int16-range audio -> (b, frames, 32) scaled log-mel, K3
    (``dft_dtype=torch.bfloat16``: its bf16-DFT variant). Launches the CUDA
    kernel for a CUDA tensor, the plain version for a CPU one.
    """
    check_dft_dtype(dft_dtype)
    check_audio(audio, "mel_spectrogram")
    b, t = audio.shape
    frames = num_frames(t)
    if frames < 1 or b < 1:
        raise ValueError(f"audio of shape {tuple(audio.shape)} holds no whole frame")
    if audio.device.type == "cpu":
        return mel_spectrogram_plain(audio, dft_dtype)
    taps, _, fb = kernel_constants(audio.device)
    out = torch.empty((b, frames, MEL_BINS), device=audio.device, dtype=torch.float32)
    build.launch(
        "mel_spectrogram",
        audio.device,
        [audio.data_ptr(), taps.data_ptr(), fb.data_ptr(), out.data_ptr()],
        [b, t, frames],
        entry="mel_spectrogram_bf16" if dft_dtype == torch.bfloat16 else "mel_spectrogram",
    )
    return out
