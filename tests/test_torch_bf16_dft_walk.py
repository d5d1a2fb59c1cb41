"""The bf16-DFT mel body of K1 and K3 (``csrc/mel_dft.cuh``), emulated on the CPU.

On the card the bf16 DFT (``dft_dtype=torch.bfloat16``) is one wgmma product
a tile of rows: persistent blocks walk items of 128 rows of the padded frame
sequence (clip c's frames f = 0 .. usable + 1 at row c (usable + 2) + f, the
last two of each clip dropped), so an item spans clips; an item's 130 hop
rows of 160 samples are staged as bf16 (row P: samples 160 (P % (usable +
2)) + 56 .. of clip P // (usable + 2)), and row m reads, in k-step s, 16
taps of hop row m + s // 10 at column 16 (s % 10). The basis comes as 25
k16 x n256 tiles in wgmma's layout, laid out behind the FFT's table in the
taps buffer. Here the walk is emulated in PyTorch on the tiles decoded from
that buffer: the items, the padded rows and their staged hop rows, the
zeros past t and past the last clip, the k-steps in order, the power, and
the tail's pairs of mel bins summed over their joint bands (bit for bit the
band sums of ``mel_log_store``).

What the emulation cannot reproduce: the order in which wgmma sums the 16
products of one k16 step (and the precision it keeps inside it). Here each
k-step's 16 exact products are summed in float64 and rounded to float32
once, then added to the float32 sum of the earlier k-steps; the card's bits
may differ from these in the last places, which is why the emulation is held
to the plain version and JAX's kernel within the JAX suite's bound, and to
itself bit for bit.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.ops.pallas.melspec_kernel import mel_patches_pallas, mel_spectrogram_pallas
from heybuddy_tpu_torch.constants import MEL_BINS, MEL_HOP_LENGTH
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.melspec import num_frames

# the JAX suite's bound between the bf16 and the float32 DFT (test_melspec.py)
BF16_DFT_TOL = 1e-2
CPU = torch.device("cpu")
HALO = (mk.TAPS - 1) // MEL_HOP_LENGTH  # hop rows past a segment's last frame


def _noise(seed: int, b: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1000.0, (b, t)).astype(np.float32)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of the buffer ``t`` heads, as a uint8 tensor."""
    return torch.empty(0, dtype=torch.uint8).set_(t.untyped_storage())


@functools.lru_cache(maxsize=None)
def _tiles() -> torch.Tensor:
    """The 25 k16 x n256 tiles decoded from the taps buffer as (25, 16 k, 256 n) bf16."""
    taps, _, _ = mk.mel_constants(CPU)
    end = mk.DFT_TILES_OFFSET + mk.DFT_KSTEPS * mk.DFT_TILE_BYTES
    tiles = _raw(taps)[mk.DFT_TILES_OFFSET : end].clone().view(torch.bfloat16)
    tiles = tiles.view(mk.DFT_KSTEPS, 2 * mk.N_FREQ_PAD // 8, 2, 8, 8)  # tile, n group, k half, n, k
    return tiles.permute(0, 2, 4, 1, 3).reshape(mk.DFT_KSTEPS, mk.DFT_K, 2 * mk.N_FREQ_PAD)


def _bands():
    """The filterbank (128, 32) and each mel bin's first and last non-zero bin."""
    _, _, fb = mk.mel_constants(CPU)
    nz = fb != 0
    bins = torch.arange(fb.shape[0])[:, None]
    return fb, torch.where(nz, bins, fb.shape[0]).amin(0), torch.where(nz, bins, -1).amax(0)


def _mel_log(power: torch.Tensor) -> torch.Tensor:
    """``mel_log_store``: each mel bin's fmaf chain over its band in bin order, then the scaled log."""
    fb, lo, hi = _bands()
    mel = torch.zeros(power.shape[0], MEL_BINS, dtype=torch.float32)
    for b in range(fb.shape[0]):
        band = (lo <= b) & (b <= hi)
        fma = (power[:, b : b + 1].double() * fb[b].double() + mel.double()).float()
        mel = torch.where(band, fma, mel)
    return torch.log(mel + 1e-6) / 10.0 + 2.0


def _mel_log_pairs(power: torch.Tensor) -> torch.Tensor:
    """
    The kernel's tail: mel bins in pairs 2 i, 2 i + 1, each pair's two fmaf
    chains over the pair's joint band lo(2 i) .. hi(2 i + 1) in bin order (a
    weight outside a bin's own band is an exact zero), then the scaled log.
    """
    fb, lo, hi = _bands()
    mel = torch.zeros(power.shape[0], MEL_BINS, dtype=torch.float32)
    for i in range(0, MEL_BINS, 2):
        for b in range(int(lo[i]), int(hi[i + 1]) + 1):
            pair = (power[:, b : b + 1].double() * fb[b, i : i + 2].double() + mel[:, i : i + 2].double()).float()
            mel[:, i : i + 2] = pair
    return torch.log(mel + 1e-6) / 10.0 + 2.0


def _products(a: torch.Tensor) -> torch.Tensor:
    """(frames, 400) bf16-valued float32 taps -> (frames, 256) spectrum: k-steps in order."""
    tiles = _tiles().double()
    acc = torch.zeros(a.shape[0], 2 * mk.N_FREQ_PAD, dtype=torch.float32)
    for s in range(mk.DFT_KSTEPS):
        step = a[:, s * mk.DFT_K : (s + 1) * mk.DFT_K].double() @ tiles[s]  # 16 exact products a column
        acc = acc + step.float()
    return acc


def emulate_walk(audio: torch.Tensor, usable: int, n_out: int, item: int = mk.DFT_ITEM) -> torch.Tensor:
    """
    The body's walk over ``audio`` (b, t), any row-strided view: (b, n_out,
    32), frames past ``usable`` zero; ``item`` overrides the rows of an item.
    Raises unless every frame below ``usable`` is computed exactly once.
    """
    b, t = audio.shape
    rows_clip, _ = mk.dft_walk(b, usable)
    total = b * rows_clip
    out = torch.zeros(b, n_out, MEL_BINS)
    done = torch.zeros(b, usable, dtype=torch.int64)
    for i in range(-(-total // item)):
        # the staged hop rows: samples 160 h + 56 .. + 215 of clip c for padded
        # row P = c rows_clip + h, zeros from t on and past the last clip
        x = torch.zeros(item + HALO, MEL_HOP_LENGTH)
        for r in range(item + HALO):
            c, h = divmod(i * item + r, rows_clip)
            if c < b:
                g = MEL_HOP_LENGTH * h + mk.TAP0 + torch.arange(MEL_HOP_LENGTH)
                x[r, g < t] = audio[c, g[g < t]]
        x = x.bfloat16().float()
        n = min(item, total - i * item)
        # row m, tap k: staged row m + k // 160, column k % 160
        a = torch.stack([x[m : m + HALO + 1].reshape(-1)[: mk.TAPS] for m in range(n)])
        spectrum = _products(a)
        re, im = spectrum[:, : mk.N_FREQ_PAD], spectrum[:, mk.N_FREQ_PAD :]
        power = re * re + im * im  # each product rounded, then the sum: __fadd_rn(__fmul_rn, __fmul_rn)
        logmel = _mel_log_pairs(power)
        for m in range(n):
            c, f = divmod(i * item + m, rows_clip)
            if f < usable:
                out[c, f] = logmel[m]
                done[c, f] += 1
    assert bool((done == 1).all()), "a frame computed other than once"
    return out


def emulate_k1(audio: torch.Tensor, item: int = mk.DFT_ITEM) -> torch.Tensor:
    """K1-bf16: (b, p_pad, 128), rows num_patches .. p_pad - 1 zero."""
    b, t = audio.shape
    usable, _, p_pad = mk.patch_geometry(t)
    return emulate_walk(audio, usable, 4 * p_pad, item).reshape(b, p_pad, 4 * MEL_BINS)


def emulate_k3(audio: torch.Tensor, item: int = mk.DFT_ITEM) -> torch.Tensor:
    """K3-bf16: (b, frames, 32)."""
    n = num_frames(audio.shape[1])
    return emulate_walk(audio, n, n, item)


def test_the_tiles_unpack_to_the_bf16_basis_and_the_prefix_is_unchanged():
    """
    The 25 tiles behind the FFT's table are bf16(taps) bit for bit; the
    buffer before them holds the float32 taps, the fp16 pair, the bf16 rows
    and the table at their old offsets, the bytes earlier builds read; the
    header's offsets and walk constants are the Python side's.
    """
    taps, _, _ = mk.mel_constants(CPU)
    tiles = _tiles()
    assert tiles.shape == (25, 16, 256)
    b16 = taps.bfloat16()
    for s in range(mk.DFT_KSTEPS):
        assert torch.equal(tiles[s].view(torch.int16), b16[16 * s : 16 * s + 16].view(torch.int16)), s
    scaled = taps * mk.SPLIT_BASIS_SCALE
    hi = scaled.half()
    lo = (scaled - hi.float()).half()
    prefix = torch.cat([v.contiguous().view(torch.uint8).reshape(-1) for v in
                        (taps, hi, lo, b16, torch.from_numpy(mk._numpy_fft_table()))])
    raw = _raw(taps)
    assert mk.DFT_TILES_OFFSET == prefix.numel() == mk.FFT_TABLE_OFFSET + mk.FFT_TABLE_FLOATS * 4
    assert torch.equal(raw[: prefix.numel()], prefix)
    assert raw.numel() == mk.OPERAND_BYTES == mk.DFT_TILES_OFFSET + 25 * 8192
    with open(os.path.join(build.CSRC, "mel_dft.cuh")) as f:
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", f.read()))
    assert int(consts["DFT_TILES_OFFSET"]) * 4 == mk.DFT_TILES_OFFSET
    assert int(consts["TILE"]) * int(consts["CONSUMERS"]) == mk.DFT_ITEM
    assert int(consts["NR"]) >= mk.DFT_ITEM + mk.DFT_HALO == mk.DFT_ITEM + HALO
    with open(os.path.join(build.CSRC, "mel_common.cuh")) as f:
        assert re.search(r"constexpr int OPS_BF16 = 2 \* TAPS \* NCOL;", f.read())  # 16-bit values


@pytest.mark.parametrize("case", ["23040", "17280", "unaligned", "strided"])
def test_the_walk_computes_every_frame_once_within_the_bf16_bound(case):
    """
    The walk over clips that share items: every usable frame once (the
    emulation raises otherwise), exact zeros in every pad row, and the values
    within the JAX suite's 1e-2 of the plain bf16 DFT and of JAX's Pallas
    kernel in interpret mode.
    """
    if case == "strided":  # overlapping windows of one stream segment, 1280 samples apart
        t, stride, b = 23040, 1280, 3
        segment = torch.from_numpy(_noise(41, 1, t + stride * (b - 1))[0])
        audio = segment.as_strided((b, t), (stride, 1))
    else:
        t = {"23040": 23040, "17280": 17280, "unaligned": 20001}[case]
        b = 2 if t == 23040 else 3
        audio = torch.from_numpy(_noise(40, b, t))
    usable, n, p_pad = mk.patch_geometry(t)
    got = emulate_k1(audio)
    assert got.shape == (b, p_pad, 128)
    assert bool((got[:, n:] == 0).all())
    plain, _ = mk.mel_patches_plain(audio.contiguous(), dft_dtype=torch.bfloat16)
    assert (got[:, :n] - plain[:, :n]).abs().max().item() < BF16_DFT_TOL
    ref, ref_n = mel_patches_pallas(jnp.asarray(audio.contiguous().numpy()), interpret=True, dft_dtype=jnp.bfloat16)
    ref = torch.from_numpy(np.array(ref)[:b])  # the Pallas kernel pads the batch
    assert ref_n == n
    assert (got[:, :n] - ref[:, :n]).abs().max().item() < BF16_DFT_TOL
    if case == "17280":
        spec = emulate_k3(audio)
        ref3 = torch.from_numpy(np.array(mel_spectrogram_pallas(
            jnp.asarray(audio.numpy()), interpret=True, dft_dtype=jnp.bfloat16)))
        assert (spec - ref3).abs().max().item() < BF16_DFT_TOL


@pytest.mark.parametrize("t", [23040, 20001])
def test_a_frames_bits_do_not_depend_on_its_item(t):
    """
    A frame's emulated values, bit for bit, whichever item and tile row
    computes it: K1's walk (usable = 4 num_patches), K3's (every frame, so
    other item boundaries), items of 37 rows, and a row-strided view.
    """
    audio = torch.from_numpy(_noise(42, 3, t))
    usable, n, _ = mk.patch_geometry(t)
    k1 = emulate_k1(audio)[:, :n].reshape(3, usable, 32)
    assert torch.equal(emulate_k3(audio)[:, :usable], k1)
    assert torch.equal(emulate_k1(audio, item=37)[:, :n].reshape(3, usable, 32), k1)
    wide = torch.zeros(3, t + 13)
    wide[:, :t] = audio
    assert torch.equal(emulate_k1(wide[:, :t])[:, :n].reshape(3, usable, 32), k1)
    # the tail's pairs over their joint bands have the bits of each mel bin's
    # own band (mel_log_store's order), the bands rising with the mel bin
    _, lo, hi = _bands()
    assert bool((lo[1:] >= lo[:-1]).all() and (hi[1:] >= hi[:-1]).all())
    frames = audio[0].unfold(0, 512, MEL_HOP_LENGTH)[:, mk.TAP0 : mk.TAP0 + mk.TAPS]
    spectrum = _products(frames.bfloat16().float())
    power = spectrum[:, : mk.N_FREQ_PAD] ** 2 + spectrum[:, mk.N_FREQ_PAD :] ** 2
    assert torch.equal(_mel_log_pairs(power), _mel_log(power))
