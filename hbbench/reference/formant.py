"""The formant voice's device render, a frozen copy in float32.

Each clip's plan (its decimated tracks of f0, phase, three formants,
amplitude, nasality and the nasal zero; its table of up to 24 noise
segments; its vocal-tract scale, breathiness and length) is rendered as a
sum of 100 harmonics shaped by the formant resonances, plus breath and
frame-wise shaped noise (a 128-point DFT, overlap-add at hop 64), masked to
the clip's length and peak-normalised to 0.7. The breath and white noise of
a clip come from a generator seeded by its seed alone. The expression tree
and the float32 rounding points are the published render's, so that the
reference and the program agree to float32 rounding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
TRACK_STRIDE = 64
NOISE_FFT = 128
DEFAULT_HARMONICS = 100
_NOISE_KEY = 0x600DF00D
_PEAK_FACTOR = 3.3


def resolve_device(device: torch.device) -> torch.device:
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _dft_matrices(n_fft: int = NOISE_FFT) -> Tuple[np.ndarray, ...]:
    """rfft/irfft as matmuls (np.fft conventions)."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    dft_c = np.cos(ang).astype(np.float32)            # (N, K): Re
    dft_s = (-np.sin(ang)).astype(np.float32)         # (N, K): Im
    w = np.full(n_fft // 2 + 1, 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    ang2 = 2.0 * np.pi * np.outer(k, n) / n_fft
    idft_re = (w[:, None] * np.cos(ang2) / n_fft).astype(np.float32)   # (K, N)
    idft_im = (-w[:, None] * np.sin(ang2) / n_fft).astype(np.float32)  # (K, N)
    return dft_c, dft_s, idft_re, idft_im


def clip_noise(seeds: np.ndarray, l_max: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each clip's breath (l_max) and white (l_max + NOISE_FFT) standard
    normal draws, on ``device``, from a generator seeded by its seed alone."""
    dev = resolve_device(device)
    breath = torch.empty((len(seeds), l_max), device=dev)
    white = torch.empty((len(seeds), l_max + NOISE_FFT), device=dev)
    gen = torch.Generator(device=dev)
    for i, seed in enumerate(np.asarray(seeds, np.int64)):
        gen.manual_seed((_NOISE_KEY << 31) | int(seed))
        breath[i].normal_(generator=gen)
        white[i].normal_(generator=gen)
    return breath, white


def _upsample(x: torch.Tensor, stride: int, length: int) -> torch.Tensor:
    """(B, Ld) decimated track -> (B, length) by linear interpolation."""
    a = x[:, :-1, None]
    b = x[:, 1:, None]
    frac = torch.arange(stride, dtype=x.dtype, device=x.device)[None, None, :] / stride
    full = (a + (b - a) * frac).reshape(x.shape[0], -1)
    return full[:, :length]


def _c(value: float, dtype: torch.dtype) -> float:
    """A float32 constant as the published render rounds it (kept exact in float64)."""
    return float(np.float32(value)) if dtype == torch.float32 else float(value)


@torch.no_grad()
def render(
    tracks: torch.Tensor,
    noise_table: torch.Tensor,
    scale: torch.Tensor,
    noise_scale: torch.Tensor,
    length: torch.Tensor,
    breath: torch.Tensor,
    white: torch.Tensor,
    *,
    l_max: int,
    harmonics: int = DEFAULT_HARMONICS,
    sample_rate: int = SAMPLE_RATE,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """
    The render, given the noise draws:
    (B, 8, Ld) tracks, (B, 24, 9) noise table, per-clip scale, noise scale
    and length, breath (B, l_max) and white (B, l_max + 128) -> (B, l_max)
    audio peak-normalized to 0.7, zero past each clip's length. Every tensor
    on one device. ``dtype`` float32 is the published arithmetic;
    float64 is the reference its float32 rounding is measured against.
    """
    tracks, noise_table, scale, noise_scale, breath, white = (
        t.to(dtype) for t in (tracks, noise_table, scale, noise_scale, breath, white))
    dev = tracks.device
    sr = float(sample_rate)
    stride = TRACK_STRIDE
    b = tracks.shape[0]

    f0_d = tracks[:, 0]
    ph_d = tracks[:, 1]
    scale_c = scale[:, None]

    # ---- voiced: upsample tracks, integrate phase analytically per run ----
    f0a, f0b = f0_d[:, :-1, None], f0_d[:, 1:, None]
    j = torch.arange(stride, dtype=dtype, device=dev)[None, None, :]
    incr = _c(2.0 * np.pi / sr, dtype) * (f0a * j + (f0b - f0a) * (j * j) / (2.0 * stride))
    phase = (ph_d[:, :-1, None] + incr).reshape(b, -1)[:, :l_max]
    del incr
    f0 = _upsample(f0_d, stride, l_max)
    f1s = _upsample(tracks[:, 2], stride, l_max) * scale_c
    f2s = _upsample(tracks[:, 3], stride, l_max) * scale_c
    f3s = _upsample(tracks[:, 4], stride, l_max) * scale_c
    amp = _upsample(tracks[:, 5], stride, l_max)
    nasal = _upsample(tracks[:, 6], stride, l_max)
    zs = _upsample(tracks[:, 7], stride, l_max) * scale_c

    inv_bw1 = 1.0 / (80.0 + _c(0.08, dtype) * f1s + 160.0 * nasal)
    inv_bw2 = 1.0 / (80.0 + _c(0.08, dtype) * f2s)
    inv_bw3 = 1.0 / (80.0 + _c(0.08, dtype) * f3s)
    g2 = _c(0.6, dtype) * (1.0 - _c(0.35, dtype) * nasal)
    g3 = _c(0.3, dtype) * (1.0 - _c(0.35, dtype) * nasal)
    nasal_gain = _c(0.85, dtype) * nasal
    murmur = 0.5 * nasal
    mur_center = 280.0 * scale_c
    nyquist = 0.5 * sr

    two_cos = 2.0 * torch.cos(phase)
    sin_h = torch.sin(phase)
    del phase
    sin_prev = torch.zeros_like(sin_h)
    acc = torch.zeros_like(sin_h)
    inv_300, inv_120 = _c(1.0 / 300.0, dtype), _c(1.0 / 120.0, dtype)
    # the published expression tree op for op (x + y * y, 1 / (1 + ...), ...),
    # one eager op at a time; temporaries are reused in place
    for h in range(1, harmonics + 1):
        freq = float(h) * f0
        x = (freq - f1s).mul_(inv_bw1)
        env = x.mul_(x).add_(1.0).reciprocal_()
        x = (freq - f2s).mul_(inv_bw2)
        env.add_(g2 / x.mul_(x).add_(1.0))
        x = (freq - f3s).mul_(inv_bw3)
        env.add_(g3 / x.mul_(x).add_(1.0))
        x = (freq - zs).mul_(inv_300)
        env.mul_(1.0 - nasal_gain / x.mul_(x).add_(1.0))
        x = (freq - mur_center).mul_(inv_120)
        env.add_(murmur / x.mul_(x).add_(1.0))
        gate = (freq < nyquist).to(dtype)
        acc.add_(gate.mul_(env).mul_(_c(1.0 / np.sqrt(h), dtype)).mul_(sin_h))
        sin_prev, sin_h = sin_h, (two_cos * sin_h).sub_(sin_prev)
    del sin_prev, sin_h, two_cos, freq, x, env, gate
    voiced = acc.mul_(amp)
    voiced.add_(breath * (_c(0.02, dtype) * noise_scale[:, None]) * amp)

    # ---- unvoiced: frame -> DFT -> spectral envelope -> iDFT -> OLA ----
    n_fft = NOISE_FFT
    hop = n_fft // 2
    n_frames = l_max // hop
    dft_c, dft_s, idft_re, idft_im = (torch.from_numpy(m).to(dev, dtype) for m in _dft_matrices(n_fft))
    hann = torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(dev, dtype)  # periodic
    frames = white.unfold(1, n_fft, hop)[:, :n_frames] * hann
    re = frames @ dft_c
    im = frames @ dft_s
    del frames

    # time envelope per (segment, frame)
    start = noise_table[:, :, 0][:, :, None]
    seg_n = noise_table[:, :, 1][:, :, None]
    level = noise_table[:, :, 2][:, :, None]
    kind = noise_table[:, :, 3][:, :, None]
    att_s = noise_table[:, :, 7][:, :, None]
    rel_s = noise_table[:, :, 8][:, :, None]
    t_c = torch.arange(n_frames, dtype=dtype, device=dev)[None, None, :] * hop + hop
    tr = (t_c - start) / sr                       # (B, S, F) seconds into segment
    ns = seg_n / sr
    ramp_band = (torch.clamp(tr / torch.clamp(att_s, min=1e-4), 0.0, 1.0)
                 * torch.clamp((ns - tr) / torch.clamp(rel_s, min=1e-4), 0.0, 1.0))
    fade_asp = torch.clamp((ns - tr) / torch.clamp(ns, min=1e-4), 0.2, 1.0)
    ramp = torch.where(kind > 0.5, fade_asp, ramp_band)
    active = ((tr >= 0.0) & (tr < ns)).to(dtype)
    lvl_sf = level * ramp * active                # (B, S, F)

    # spectral shape per (segment, bin): band edges / formant targets are
    # constant within a segment, so shaping factorizes into a matmul
    freqs = torch.from_numpy(np.fft.rfftfreq(n_fft, 1.0 / sr).astype(np.float32)).to(dev, dtype)[None, None, :]
    kind_s = noise_table[:, :, 3][:, :, None]
    pa = noise_table[:, :, 4][:, :, None] * scale[:, None, None]
    pb = noise_table[:, :, 5][:, :, None] * scale[:, None, None]
    pc = noise_table[:, :, 6][:, :, None] * scale[:, None, None]
    edge = 40.0
    band_mask = torch.sigmoid((freqs - pa) / edge) * torch.sigmoid((pb - freqs) / edge)
    shape_band = _c(0.05, dtype) + _c(0.95, dtype) * band_mask
    pa_raw = noise_table[:, :, 4][:, :, None]
    pb_raw = noise_table[:, :, 5][:, :, None]
    pc_raw = noise_table[:, :, 6][:, :, None]
    shape_asp = (
        1.0 / (1.0 + ((freqs - pa) / (150.0 + _c(0.1, dtype) * pa_raw)) ** 2)
        + _c(0.7, dtype) / (1.0 + ((freqs - pb) / (150.0 + _c(0.1, dtype) * pb_raw)) ** 2)
        + _c(0.4, dtype) / (1.0 + ((freqs - pc) / (150.0 + _c(0.1, dtype) * pc_raw)) ** 2)
    )
    shape = torch.where(kind_s > 0.5, shape_asp, shape_band)  # (B, S, K)
    # normalize so the time-domain amplitude matches the host's
    # peak-normalize-to-level convention (peak ~= _PEAK_FACTOR * sigma)
    rms = torch.sqrt(torch.mean(shape * shape, dim=2, keepdim=True))
    shape = shape / (_c(_PEAK_FACTOR, dtype) * torch.clamp(rms, min=1e-6))

    env_fk = torch.einsum("bsf,bsk->bfk", lvl_sf, shape)       # (B, F, K)
    out_frames = (re * env_fk) @ idft_re + (im * env_fk) @ idft_im
    del re, im
    first = out_frames[:, :, :hop].reshape(b, -1)
    second = out_frames[:, :, hop:].reshape(b, -1)
    unvoiced = first + torch.cat([torch.zeros((b, hop), dtype=dtype, device=dev), second[:, :-hop]], dim=1)
    del out_frames, first, second

    # ---- mix, mask, peak-normalize (the host synthesizer's contract) ----
    audio = voiced.add_(unvoiced)
    mask = (torch.arange(l_max, device=dev)[None, :] < length.to(dev)[:, None]).to(dtype)
    audio.mul_(mask)
    peak = torch.amax(torch.abs(audio), dim=1, keepdim=True)
    return audio.div_(torch.clamp(peak, min=1e-9)).mul_(_c(0.7, dtype))


def center_place(clip: torch.Tensor, lengths: torch.Tensor, target: int) -> torch.Tensor:
    """(B, target) left-aligned clips -> centered (the pad-only validation
    placement of ``AugmentedAudioGenerator.execute_augment_batch``)."""
    offset = (target - lengths) // 2
    idx = torch.arange(target, device=clip.device)[None, :] - offset[:, None]
    valid = (idx >= 0) & (idx < lengths[:, None])
    gathered = torch.gather(clip, 1, torch.clamp(idx, 0, target - 1))
    return torch.where(valid, gathered, torch.zeros((), dtype=clip.dtype, device=clip.device))