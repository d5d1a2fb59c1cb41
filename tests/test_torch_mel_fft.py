"""The float32 FFT of the mel kernels K1, K3 and K4, emulated on the CPU.

On the card each frame's spectrum is a real FFT (``csrc/mel_fft.cuh``): the
frame's 512 windowed samples become 256 complex points z[m] = y[2m] + i
y[2m+1], a 256-point FFT of two radix-16 passes runs on 16 lanes, 16 points a
lane, with one exchange through shared memory between them, and a
post-twiddle splits bins 0..127 out of Z[k] and Z[256 - k], which a shuffle
brings together. Power, filterbank and log follow as ``mel_log_store``. Here
the kernel's walk is emulated in float32 PyTorch, with the same radix order,
index maps, operations and table values (read from the taps buffer at their
offsets): a chunk's audio span staged with zeros past t, the lanes' loads,
the passes, the exchange, the partner lanes of the post-twiddle and the
filterbank sums in band order. ``fmaf`` is emulated as a float64 product and
sum rounded to float32 (the product is exact in float64; the sum may round
twice, which moves the rare tie by an ulp).
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heybuddy_tpu.ops import melspec as jax_melspec
from heybuddy_tpu_torch.constants import MEL_BINS, MEL_HOP_LENGTH, MEL_N_FFT
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.melspec import num_frames

# the port's mel tolerance against float32 (test_torch_melspec.py)
ATOL, RTOL = 5e-3, 1e-4
# chip_smoke.py SPLIT_ATOL: the mel kernels' limit against the float32 mel
SPLIT_ATOL = 5e-4
CPU = torch.device("cpu")
R = mk.FFT_RADIX  # 16 lanes a frame, 16 points a lane
ITEM = 32  # frames of a K1 / K3 item (csrc/mel_fft.cuh ITEM)
K4_FRAMES = 144  # frames of a K4 mel pass (csrc/featurize.cu MEL_FRAMES)
K4_PIECE = 128  # patch rows of a K4 trunk chunk (csrc/trunk_pool.cuh CHUNK)


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


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The bytes of the buffer ``t`` heads, as a uint8 tensor."""
    return torch.empty(0, dtype=torch.uint8).set_(t.untyped_storage())


@functools.lru_cache(maxsize=None)
def _table() -> torch.Tensor:
    """The FFT's float32 table, read from behind the taps' operands."""
    taps, _, _ = mk.mel_constants(CPU)
    end = mk.FFT_TABLE_OFFSET + mk.FFT_TABLE_FLOATS * 4  # the bf16 DFT's tiles follow it
    return _raw(taps)[mk.FFT_TABLE_OFFSET : end].view(torch.float32).clone()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float64:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _cmul(a, w):
    """a w: re = fma(a.re, w.re, -a.im w.im), im = fma(a.re, w.im, a.im w.re)."""
    return _fma(a[0], w[0], -a[1] * w[1]), _fma(a[0], w[1], a[1] * w[0])


def _dft4(a0, a1, a2, a3):
    t0, t1, t2, t3 = _add(a0, a2), _sub(a0, a2), _add(a1, a3), _sub(a1, a3)
    return (_add(t0, t2), (t1[0] + t3[1], t1[1] - t3[0]), _sub(t0, t2), (t1[0] - t3[1], t1[1] + t3[0]))


def _dft16(x: list, w: dict) -> list:
    """
    X[k] = sum_j x[j] W16^(j k) as the kernel's ``dft16``: radix-4 over j2 (j =
    j1 + 4 j2), twiddles W16^(j1 k1a), radix-4 over j1; k = k1a + 4 k1b.
    """
    x = list(x)
    for j1 in range(4):
        x[j1], x[j1 + 4], x[j1 + 8], x[j1 + 12] = _dft4(x[j1], x[j1 + 4], x[j1 + 8], x[j1 + 12])
    r = w["r"]

    def w2(a):  # W16^2 = (r, -r)
        return (a[0] + a[1]) * r, (a[1] - a[0]) * r

    def w6(a):  # W16^6 = (-r, -r)
        return (a[1] - a[0]) * r, -((a[0] + a[1]) * r)

    x[5] = _cmul(x[5], w["w1"])
    x[9] = w2(x[9])
    x[13] = _cmul(x[13], w["w3"])
    x[6] = w2(x[6])
    x[10] = (x[10][1], -x[10][0])  # W16^4 = -i
    x[14] = w6(x[14])
    x[7] = _cmul(x[7], w["w3"])
    x[11] = w6(x[11])
    x[15] = _cmul(x[15], w["w9"])
    out = [None] * 16
    for k1a in range(4):
        y = _dft4(x[4 * k1a], x[4 * k1a + 1], x[4 * k1a + 2], x[4 * k1a + 3])
        for k1b in range(4):
            out[k1a + 4 * k1b] = y[k1b]
    return out


def _consts(dtype: torch.dtype):
    tab = _table().to(dtype)
    win = tab[mk.FFT_WIN : mk.FFT_WIN + MEL_N_FFT]
    tw1 = tab[mk.FFT_TW1 : mk.FFT_TW2].view(R, R, 2)  # [k1, l, (re, im)]
    tw2 = tab[mk.FFT_TW2 : mk.FFT_TW2 + 2 * mk.N_FREQ_PAD].view(mk.N_FREQ_PAD, 2)
    # the W16 twiddles are the table's W256^16, W256^32 and W256^48 (l = 2, 4, 6 of k1 = 8)
    w1, w2, w3 = (tuple(tw1[8, l]) for l in (2, 4, 6))
    w = {"w1": w1, "w3": w3, "w9": (-w1[0], -w1[1]), "r": w2[0]}
    return win, tw1, tw2, w


def _fft_power(span: torch.Tensor, frames: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """
    The power of bins 0..127 of ``frames`` (chunk frame indices) from a
    chunk's staged ``span`` (sample i = audio[160 f0 + 56 + i]), as the
    kernel's ``fft_power``: (len(frames), 128).
    """
    win, tw1, tw2, w = _consts(dtype)
    span = span.to(dtype)
    lanes = torch.arange(R)
    zero = torch.zeros(len(frames), R, dtype=dtype)
    x = []
    for j in range(R):  # pass 1: lane l loads m = l + 16 j; taps outside [56, 456) are zero
        m = lanes + R * j
        n = 2 * m
        keep = (n >= mk.TAP0) & (n + 1 < mk.TAP0 + mk.TAPS)
        if not keep.any():
            x.append((zero, zero))
            continue
        idx = (MEL_HOP_LENGTH * frames[:, None] + n[None, :] - mk.TAP0).clamp(min=0)
        idx = torch.where(keep[None, :], idx, torch.zeros_like(idx))
        re = torch.where(keep, span[idx] * win[n], zero)
        im = torch.where(keep, span[idx + 1] * win[n + 1], zero)
        x.append((re, im))
    big_x = _dft16(x, w)
    for k1 in range(1, R):  # W256^(l k1)
        big_x[k1] = _cmul(big_x[k1], (tw1[k1, :, 0], tw1[k1, :, 1]))
    # the exchange: lane k1 now holds A[l] = X[k1] of lane l
    re, im = (torch.stack([v[c] for v in big_x], 2) for c in (0, 1))  # (frames, l, k1)
    a = [(re[:, l], im[:, l]) for l in range(R)]
    z = _dft16(a, w)  # lane k1, register k2: Z[k1 + 16 k2]
    # the post-twiddle: lane k1 receives register 15 - i of lane (16 - k1) % 16
    partner = (R - lanes) % R
    power = torch.empty(len(frames), mk.N_FREQ_PAD, dtype=dtype)
    for k2 in range(mk.N_FREQ_PAD // R):
        zk = z[k2]
        recv = (z[15 - k2][0][:, partner], z[15 - k2][1][:, partner])
        own = z[0] if k2 == 0 else (z[16 - k2][0][:, partner], z[16 - k2][1][:, partner])
        zc = tuple(torch.where(lanes == 0, o, r) for o, r in zip(own, recv))
        er, ei = zk[0] + zc[0], zk[1] - zc[1]
        o_r, o_i = zk[1] + zc[1], zc[0] - zk[0]
        k = lanes + R * k2
        wr, wi = tw2[k, 0], tw2[k, 1]
        yr = _fma(wr, o_r, _fma(-wi, o_i, er))
        yi = _fma(wr, o_i, _fma(wi, o_r, ei))
        power[:, k] = _fma(yr, yr, yi * yi) * 0.25
    return power


def _bands():
    """The filterbank (128, 32) and each mel bin's first and last non-zero bin."""
    _, _, fb = mk.mel_constants(CPU)
    nz = fb != 0
    bins = torch.arange(fb.shape[0])[:, None]
    return fb, torch.where(nz, bins, fb.shape[0]).amin(0), torch.where(nz, bins, -1).amax(0)


def _mel_log(power: torch.Tensor) -> torch.Tensor:
    """``mel_log_store``: each mel bin's sum over its band in bin order, then the scaled log."""
    fb, lo, hi = _bands()
    fb = fb.to(power.dtype)
    mel = torch.zeros(power.shape[0], MEL_BINS, dtype=power.dtype)
    for b in range(fb.shape[0]):
        band = (lo <= b) & (b <= hi)
        mel = torch.where(band, _fma(power[:, b : b + 1], fb[b], mel), mel)
    return torch.log(mel + 1e-6) / 10.0 + 2.0


def logmel_chunk(clip: torch.Tensor, t: int, f0: int, n_frames: int, usable: int, n_out: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """
    The kernel's ``logmel_chunk`` over frames f0 .. f0 + n_frames - 1 of one
    clip row (its first t samples; any view): (frames below n_out, 32), the
    frames past ``usable`` zero.
    """
    n = max(0, min(n_frames, n_out - f0))
    out = torch.zeros(n, MEL_BINS, dtype=dtype)
    if f0 >= usable:
        return out
    span_len = MEL_HOP_LENGTH * (n_frames - 1) + mk.TAPS
    g = MEL_HOP_LENGTH * f0 + mk.TAP0 + torch.arange(span_len)
    span = torch.zeros(span_len, dtype=clip.dtype)
    span[g < t] = clip[g[g < t]]
    real = torch.arange(min(n, usable - f0))
    out[: len(real)] = _mel_log(_fft_power(span, real, dtype))
    return out


def emulate_k1(audio: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1's walk: items of (clip, 32 frames) over 4 p_pad frames -> (b, p_pad, 128)."""
    b, t = audio.shape
    usable, _, p_pad = mk.patch_geometry(t)
    rows = [torch.cat([logmel_chunk(audio[i], t, f0, ITEM, usable, 4 * p_pad, dtype)
                       for f0 in range(0, 4 * p_pad, ITEM)]) for i in range(b)]
    return torch.stack(rows).reshape(b, p_pad, 4 * MEL_BINS)


def emulate_k3(audio: torch.Tensor) -> torch.Tensor:
    """K3's walk: every frame, items of 32 -> (b, frames, 32)."""
    b, t = audio.shape
    frames = num_frames(t)
    return torch.stack([torch.cat([logmel_chunk(audio[i], t, f0, ITEM, frames, frames)
                                   for f0 in range(0, frames, ITEM)]) for i in range(b)])


def emulate_k4_mel(audio: torch.Tensor) -> torch.Tensor:
    """
    K4's mel: each clip in pieces of 128 patch rows, each piece in 144-frame
    passes from its first frame, frames past the piece's last patch dropped ->
    (b, usable, 32).
    """
    b, t = audio.shape
    usable, num_patches, _ = mk.patch_geometry(t)
    out = []
    for i in range(b):
        parts = []
        for pa in range(0, num_patches, K4_PIECE):
            pb = min(num_patches, pa + K4_PIECE)
            for f0 in range(4 * pa, 4 * pb, K4_FRAMES):
                parts.append(logmel_chunk(audio[i], t, f0, K4_FRAMES, 4 * pb, 4 * pb))
        out.append(torch.cat(parts))
    return torch.stack(out)


def _jax_mel(audio: np.ndarray) -> np.ndarray:
    return np.asarray(jax_melspec.mel_spectrogram(jnp.asarray(audio)))


@pytest.mark.parametrize("b, t, frames", [(2, 23040, 141), (3, 17280, 105)])
def test_the_kernels_fft_matches_jaxs_float32_mel(b, t, frames):
    audio = _noise(31, b, t)
    ref = _jax_mel(audio)
    spec = emulate_k3(torch.from_numpy(audio)).numpy()
    patches = emulate_k1(torch.from_numpy(audio)).numpy()
    usable, n, _ = mk.patch_geometry(t)
    assert spec.shape == ref.shape == (b, frames, 32)
    np.testing.assert_allclose(spec, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(patches[:, :n].reshape(b, usable, 32), spec[:, :usable])
    assert (patches[:, n:] == 0).all()


@pytest.mark.parametrize("kind", ["noise", "tonal"])
def test_the_kernels_fft_is_within_the_split_limit_of_the_float64_mel(kind):
    audio = torch.from_numpy((_noise if kind == "noise" else _tonal)(32, 3, 23040))
    f64, n = mk.mel_patches_plain(audio, accumulate=torch.float64)
    f32, _ = mk.mel_patches_plain(audio)
    got = emulate_k1(audio)
    err = (got[:, :n] - f64[:, :n]).abs().max().item()
    assert err < SPLIT_ATOL
    # about as far as the plain float32 mel itself
    assert err < 10 * max((f32[:, :n] - f64[:, :n]).abs().max().item(), 1e-6)


def test_the_walk_in_float64_is_the_exact_mel():
    """The radix order, index maps, exchange and post-twiddle compute the DFT: in
    float64 the walk's power equals numpy's real FFT of the windowed frames."""
    audio = torch.from_numpy(_tonal(33, 1, 23040)).double()
    clip = audio[0]
    span = clip[mk.TAP0 : mk.TAP0 + MEL_HOP_LENGTH * (ITEM - 1) + mk.TAPS]
    got = _fft_power(span, torch.arange(ITEM), torch.float64).numpy()
    window = _table()[mk.FFT_WIN : mk.FFT_WIN + MEL_N_FFT].double().numpy()
    frames = clip.unfold(0, MEL_N_FFT, MEL_HOP_LENGTH)[:ITEM].numpy() * window
    ref = np.abs(np.fft.rfft(frames, axis=1)[:, : mk.N_FREQ_PAD]) ** 2
    # the table's float32 window and twiddles: about 1e-7 of the frame's power
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * ref.max())


def test_the_table_is_float64_rounded_once():
    table = _table()
    assert table.numel() == mk.FFT_TABLE_FLOATS == mk._numpy_fft_table().size
    win = table[mk.FFT_WIN : mk.FFT_WIN + MEL_N_FFT].numpy()
    hann = np.zeros(MEL_N_FFT)
    hann[mk.TAP0 : mk.TAP0 + mk.TAPS] = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(mk.TAPS) / mk.TAPS)
    np.testing.assert_array_equal(win, hann.astype(np.float32))
    # the window of the plain version's basis (cos column of bin 0)
    np.testing.assert_array_equal(win[mk.TAP0 : mk.TAP0 + mk.TAPS], mk._numpy_constants()[0][:, 0])
    tw1 = table[mk.FFT_TW1 : mk.FFT_TW2].view(R, R, 2).numpy()
    k1, lane = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
    angle = 2 * np.pi * k1 * lane / mk.FFT_POINTS
    np.testing.assert_array_equal(tw1[..., 0], np.cos(angle).astype(np.float32))
    np.testing.assert_array_equal(tw1[..., 1], (-np.sin(angle)).astype(np.float32))
    tw2 = table[mk.FFT_TW2 :].view(-1, 2).numpy()
    angle = 2 * np.pi * np.arange(mk.N_FREQ_PAD) / MEL_N_FFT
    np.testing.assert_array_equal(tw2[:, 0], np.cos(angle).astype(np.float32))
    np.testing.assert_array_equal(tw2[:, 1], (-np.sin(angle)).astype(np.float32))


def test_check_constants_refuses_a_buffer_that_ends_before_the_table():
    """A taps buffer laid out as before the FFT (taps and 16-bit operands only) is too short."""
    taps, blocks, fb = mk.mel_constants(CPU)
    short = _raw(taps)[: mk.FFT_TABLE_OFFSET].clone().view(torch.float32)[: taps.numel()].view(taps.shape)
    assert short.untyped_storage().nbytes() == mk.FFT_TABLE_OFFSET < mk.OPERAND_BYTES
    with pytest.raises(ValueError, match="taps"):
        mk.check_constants(short, fb, blocks)
    mk.check_constants(taps, fb, blocks)


def test_the_header_agrees_with_the_table():
    """csrc/mel_fft.cuh's offsets and sizes are the Python side's."""
    with open(os.path.join(build.CSRC, "mel_fft.cuh")) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["FFT_WIN"]) == mk.FFT_WIN
    assert int(consts["FFT_TW1"]) == mk.FFT_TW1
    assert int(consts["FFT_TW2"]) == mk.FFT_TW2
    assert int(consts["FFT_TABLE"]) == mk.FFT_TABLE_FLOATS
    assert int(consts["FFT_TABLE_OFFSET"]) * 4 == mk.FFT_TABLE_OFFSET
    assert int(consts["RADIX"]) == R
    assert int(consts["ITEM"]) == ITEM
    with open(os.path.join(build.CSRC, "featurize.cu")) as f:
        assert re.search(rf"constexpr int MEL_FRAMES = {K4_FRAMES};", f.read())


@pytest.mark.parametrize("t", [23040, 20001, 160000])
def test_a_frames_bits_do_not_depend_on_its_chunk(t):
    """
    A frame's values, bit for bit, whether a 32-frame K1 item, a K3 item,
    a 144-frame K4 pass (from the first frame of a 128-patch piece) or a
    chunk that starts at another frame computes it.
    """
    audio = torch.from_numpy(_noise(34, 2, t))
    usable, n, _ = mk.patch_geometry(t)
    k1 = emulate_k1(audio)[:, :n].reshape(2, usable, 32)
    assert torch.equal(emulate_k3(audio)[:, :usable], k1)
    assert torch.equal(emulate_k4_mel(audio), k1)
    shifted = logmel_chunk(audio[1], t, 7, 64, usable, usable)
    assert torch.equal(shifted, k1[1, 7 : 7 + 64])


def test_a_row_strided_view_gives_the_bits_of_its_copy():
    """K1 on the overlapping windows of one segment, read where they lie, against the copy."""
    t, stride, rows = 23040, 1280, 4
    segment = torch.from_numpy(_noise(35, 1, t + stride * (rows - 1))[0])
    view = segment.as_strided((rows, t), (stride, 1))
    assert torch.equal(emulate_k1(view), emulate_k1(view.contiguous()))
    assert torch.equal(emulate_k1(view)[2], emulate_k1(segment[2 * stride : 2 * stride + t][None])[0])
