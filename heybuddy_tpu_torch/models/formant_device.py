"""
Device-resident formant TTS: plan on the host, render on the card.

Counterpart of the JAX package's ``models/formant_device.py``:

* the **host** plans (``DeviceFormantPlanner``, numpy, a copy of JAX's: the
  host synthesizer's own segment plan, formant / F0 tracks and phase,
  decimated 64x), so a ``ClipPlan`` is bit-equal to the JAX package's;
* the **device** renders (``render``): the voiced source-filter sum (linear
  upsampling of the tracks, the phase, the Chebyshev sin recurrence over the
  harmonics through the formant resonances) is one launch of the
  hand-written kernel ``ops/kernels/csrc/formant_voiced.cu`` on the card and
  its plain version, a loop of eager elementwise ops (``_voiced_plain``), on
  the CPU; the unvoiced residue is eager PyTorch on either: white noise
  shaped per 8 ms frame by matmul DFT -> spectral envelope -> matmul iDFT ->
  overlap-add (cuFFT is not needed: the 128-point DFT is a matmul, TF32 off,
  ``device.py``), then the mix, mask and peak normalisation.

Randomness is split from the arithmetic: ``clip_noise`` draws each clip's
breath and white noise from a ``torch.Generator`` seeded by the clip's seed
alone (a clip renders the same in any batch, as in JAX), and ``render``
takes the draws. The JAX package's ``jax.random`` streams cannot be
reproduced in torch; tests inject JAX's draws into ``render``.

``fused_features_batch`` runs plans -> render -> (augment | center
placement) -> ``featurize_batch`` (K1 -> K2 on the card) with the audio
never leaving the device. Batches are not padded (JAX pads them to bound
compiles).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.constants import CLIP_SAMPLES, SAMPLE_RATE
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.formant import FormantSynthesizer
from heybuddy_tpu_torch.ops.kernels import build
from heybuddy_tpu_torch.utils.profiling import span

__all__ = [
    "DEVICE_FORMANT_VERSION",
    "ClipPlan",
    "DeviceFormantPlanner",
    "pack_plans",
    "clip_noise",
    "render",
    "render_batch",
    "fused_features_batch",
]

# Bump when device rendering changes: the device backend's caches carry it in
# their space sidecar (data/space.py), the JAX package's value.
DEVICE_FORMANT_VERSION = 1

TRACK_STRIDE = 64            # decimation hop: 4 ms @ 16 kHz
NOISE_FFT = 128              # unvoiced shaping frame (8 ms), hop = NOISE_FFT // 2
MAX_NOISE_SEGMENTS = 24      # clips with more fall back to the host renderer
DEFAULT_MAX_SAMPLES = 48000  # 3.0 s @ 16 kHz
DEFAULT_HARMONICS = 100      # covers f0 >= ~80 Hz up to Nyquist
_N_TRACKS = 8                # f0, phase, f1, f2, f3, amp, nasal, zero
_PEAK_FACTOR = 3.3           # E[peak]/sigma of the host's peak-normalized noise
_NOISE_KEY = 0x600DF00D      # the per-clip noise streams' namespace

_KIND_BAND = 0.0             # fricative band noise (attack/release ramps)
_KIND_ASPIRATION = 1.0       # vowel-formant-shaped noise (linear 1->0.2 fade)


@dataclass
class ClipPlan:
    """Host-side plan for one clip: everything the device renderer needs."""

    length: int              # rendered samples (<= max_samples)
    scale: float             # speaker vocal-tract scale factor
    noise_scale: float       # breathiness level
    clip_seed: int           # the clip's noise stream id
    tracks: np.ndarray       # (8, Ld) f32 decimated tracks
    noise_table: np.ndarray  # (MAX_NOISE_SEGMENTS, 9) f32


class DeviceFormantPlanner:
    """Text -> :class:`ClipPlan` using the host synthesizer's own planning."""

    def __init__(self, sample_rate: int = SAMPLE_RATE, max_samples: int = DEFAULT_MAX_SAMPLES) -> None:
        assert max_samples % TRACK_STRIDE == 0
        self.sample_rate = sample_rate
        self.max_samples = max_samples
        self.n_dec = max_samples // TRACK_STRIDE + 1
        self.synth = FormantSynthesizer(sample_rate)

    def plan(
        self,
        text: str,
        speaker: int = 0,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        seed: Optional[int] = None,
        speaker_params: Optional[Tuple[float, float]] = None,
    ) -> Optional[ClipPlan]:
        """Build a device plan, or None when the clip needs the host fallback
        (longer than ``max_samples``, or too many noise segments).
        ``speaker_params`` overrides the speaker-derived voice exactly like
        ``FormantSynthesizer.synthesize``."""
        import hashlib

        if seed is None:
            seed = int.from_bytes(hashlib.md5(text.encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed + speaker * 7919)
        f0, scale = speaker_params or self.synth._speaker(speaker)
        sr = self.sample_rate

        segments = self.synth._plan(text, length_scale, noise_scale, rng)
        if not segments:
            return None
        cursor = 0
        for seg in segments:
            seg.start = cursor
            seg.n = max(int(seg.dur * sr), 1)
            cursor += seg.n
        total = cursor + int(0.02 * sr)
        if total > self.max_samples:
            return None

        noise_segments = [s for s in segments if s.noise is not None and s.n > 0]
        if len(noise_segments) > MAX_NOISE_SEGMENTS:
            return None

        # the host synthesizer's rng consumption order, every track evaluated
        # only at the decimated grid; knot phases by trapezoid accumulation
        # (the device integrates the linearly interpolated f0 between knots)
        n_dec = self.n_dec
        positions = np.arange(n_dec, dtype=np.float64) * TRACK_STRIDE
        f1, f2, f3, amp, nasal, zero_f = self.synth._build_tracks(
            segments, total, rng, noise_scale, positions=positions)
        f0_track = self.synth._f0_track(segments, total, f0, rng, noise_scale, positions=positions)
        steps = (f0_track[:-1] + f0_track[1:]) * (0.5 * TRACK_STRIDE)
        phase = rng.uniform(0, 2 * np.pi) + (2.0 * np.pi / sr) * np.concatenate([[0.0], np.cumsum(steps)])

        tracks = np.stack([
            f0_track.astype(np.float32),
            phase.astype(np.float32),
            f1, f2, f3,
            np.where(positions < total, amp, 0.0).astype(np.float32),
            np.where(positions < total, nasal, 0.0).astype(np.float32),
            zero_f,
        ])

        table = np.zeros((MAX_NOISE_SEGMENTS, 9), np.float32)
        table[:, 1] = 1.0   # n: avoid 0-division on unused rows
        table[:, 7] = 0.01  # attack
        table[:, 8] = 0.01  # release
        for i, seg in enumerate(noise_segments):
            low, high, level = seg.noise
            if seg.kind == "aspiration":
                tg = seg.targets[0] if seg.targets else (500.0, 1500.0, 2500.0)
                table[i] = (seg.start, seg.n, level, _KIND_ASPIRATION, tg[0], tg[1], tg[2], 0.0, 0.0)
            else:
                attack_s, release_s = (0.002, 0.008) if seg.kind == "burst" else (0.01, 0.02)
                table[i] = (seg.start, seg.n, level, _KIND_BAND, low, high, 0.0, attack_s, release_s)

        return ClipPlan(
            length=total,
            scale=float(scale),
            noise_scale=float(noise_scale),
            clip_seed=int(seed + speaker * 7919) & 0x7FFFFFFF,
            tracks=tracks,
            noise_table=table,
        )


def pack_plans(plans: List[ClipPlan], l_max: int) -> Dict[str, np.ndarray]:
    """Batch ClipPlans into the render's input arrays (no padding rows)."""
    n = len(plans)
    n_dec = l_max // TRACK_STRIDE + 1
    tracks = np.zeros((n, _N_TRACKS, n_dec), np.float32)
    table = np.zeros((n, MAX_NOISE_SEGMENTS, 9), np.float32)
    scale = np.ones((n,), np.float32)
    noise_scale = np.zeros((n,), np.float32)
    length = np.zeros((n,), np.int64)
    seeds = np.zeros((n,), np.int64)
    for i, plan in enumerate(plans):
        if plan.tracks.shape != (_N_TRACKS, n_dec):
            raise ValueError(f"plan built for different max_samples: {plan.tracks.shape}")
        tracks[i] = plan.tracks
        table[i] = plan.noise_table
        scale[i] = plan.scale
        noise_scale[i] = plan.noise_scale
        length[i] = plan.length
        seeds[i] = plan.clip_seed
    return {"tracks": tracks, "table": table, "scale": scale, "noise_scale": noise_scale,
            "length": length, "seeds": seeds}


@functools.lru_cache(maxsize=None)
def _dft_matrices(n_fft: int = NOISE_FFT) -> Tuple[np.ndarray, ...]:
    """rfft/irfft as matmuls (np.fft conventions); the JAX package's constants."""
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


def clip_noise(seeds: np.ndarray, l_max: int, device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
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
    """A float32 constant as the JAX function rounds it (kept exact in float64)."""
    return float(np.float32(value)) if dtype == torch.float32 else float(value)


@functools.lru_cache(maxsize=None)
def _voiced_constants(harmonics: int, sample_rate: int, device: torch.device) -> torch.Tensor:
    """The voiced kernel's table: the phase step 2 pi / sr, then 1 / sqrt(h)
    for h = 1..harmonics, each rounded to float32 as ``_voiced_plain`` rounds it."""
    table = [2.0 * np.pi / float(sample_rate)] + [1.0 / np.sqrt(h) for h in range(1, harmonics + 1)]
    return torch.from_numpy(np.asarray(table).astype(np.float32)).to(device)


def _voiced_kernel(
    tracks: torch.Tensor,
    scale: torch.Tensor,
    noise_scale: torch.Tensor,
    breath: torch.Tensor,
    *,
    l_max: int,
    harmonics: int,
    sample_rate: int,
) -> torch.Tensor:
    """``_voiced_plain`` in float32 on the card: one launch of
    ``csrc/formant_voiced.cu`` (every sample's harmonic sum in registers)."""
    b, n_tracks, n_dec = tracks.shape
    if n_tracks != _N_TRACKS or (n_dec - 1) * TRACK_STRIDE < l_max:
        raise ValueError(f"tracks {tuple(tracks.shape)} do not cover {l_max} samples")
    if breath.shape != (b, l_max) or scale.shape != (b,) or noise_scale.shape != (b,):
        raise ValueError(f"breath {tuple(breath.shape)}, scale {tuple(scale.shape)} and noise scale "
                         f"{tuple(noise_scale.shape)} do not match {b} clips of {l_max} samples")
    dev = tracks.device
    tracks, scale, noise_scale, breath = (t.contiguous() for t in (tracks, scale, noise_scale, breath))
    out = torch.empty((b, l_max), dtype=torch.float32, device=dev)
    if b and l_max:
        consts = _voiced_constants(harmonics, sample_rate, dev)
        build.launch("formant_voiced", dev,
                     [tracks.data_ptr(), scale.data_ptr(), noise_scale.data_ptr(), breath.data_ptr(),
                      consts.data_ptr(), out.data_ptr()],
                     [b, n_dec, l_max, harmonics, sample_rate])
    return out


def _voiced_plain(
    tracks: torch.Tensor,
    scale: torch.Tensor,
    noise_scale: torch.Tensor,
    breath: torch.Tensor,
    *,
    l_max: int,
    harmonics: int,
    sample_rate: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """
    The render's voiced part as eager elementwise ops, the kernel's plain
    version: upsample the tracks, integrate the phase analytically per run,
    sum the harmonics (Chebyshev sin recurrence, formant resonances, nasal
    zero and murmur, Nyquist gate), then acc * amp + breath * (0.02
    noise_scale) * amp. Every tensor ``dtype``, on one device.
    """
    dev = tracks.device
    sr = float(sample_rate)
    stride = TRACK_STRIDE
    b = tracks.shape[0]

    f0_d = tracks[:, 0]
    ph_d = tracks[:, 1]
    scale_c = scale[:, None]

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
    # the JAX expression tree op for op (x + y * y, 1 / (1 + ...), ...),
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
    return voiced.add_(breath * (_c(0.02, dtype) * noise_scale[:, None]) * amp)


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
    The JAX package's ``_render_impl`` in PyTorch, given the noise draws:
    (B, 8, Ld) tracks, (B, 24, 9) noise table, per-clip scale, noise scale
    and length, breath (B, l_max) and white (B, l_max + 128) -> (B, l_max)
    audio peak-normalized to 0.7, zero past each clip's length. Every tensor
    on one device. ``dtype`` float32 is the JAX function's arithmetic;
    float64 is the reference its float32 rounding is measured against.

    The voiced part (the harmonic sum) is one launch of the hand-written
    kernel ``csrc/formant_voiced.cu`` for CUDA tensors, which render float32
    alone (another ``dtype`` raises), and its plain version
    ``_voiced_plain`` for CPU tensors; the two round at the same points. The
    unvoiced part (framing, the DFT matmuls, the segment envelope, iDFT and
    overlap-add), the mix, the mask and the peak normalisation are eager
    PyTorch on either device.
    """
    tracks, noise_table, scale, noise_scale, breath, white = (
        t.to(dtype) for t in (tracks, noise_table, scale, noise_scale, breath, white))
    dev = tracks.device
    sr = float(sample_rate)
    b = tracks.shape[0]

    # ---- voiced: the harmonic sum ----
    if dev.type == "cpu":
        voiced = _voiced_plain(tracks, scale, noise_scale, breath, l_max=l_max, harmonics=harmonics,
                               sample_rate=sample_rate, dtype=dtype)
    elif dev.type != "cuda":
        raise ValueError(f"render: unsupported device {dev}")
    elif dtype != torch.float32:
        raise ValueError(f"render on the card is float32 alone, not {dtype}")
    else:
        voiced = _voiced_kernel(tracks, scale, noise_scale, breath, l_max=l_max, harmonics=harmonics,
                                sample_rate=sample_rate)

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


def _packed_tensors(packed: Mapping[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in packed.items() if k != "seeds"}


def render_batch(
    plans: List[ClipPlan],
    l_max: int = DEFAULT_MAX_SAMPLES,
    harmonics: int = DEFAULT_HARMONICS,
    sample_rate: int = SAMPLE_RATE,
    device: DeviceLike = "cuda",
) -> List[np.ndarray]:
    """Render clip plans on ``device`` -> float32 waveforms in [-1, 1], each its plan's length."""
    if not plans:
        return []
    dev = resolve_device(device)
    packed = pack_plans(plans, l_max)
    t = _packed_tensors(packed, dev)
    breath, white = clip_noise(packed["seeds"], l_max, dev)
    out = render(t["tracks"], t["table"], t["scale"], t["noise_scale"], t["length"], breath, white,
                 l_max=l_max, harmonics=harmonics, sample_rate=sample_rate).cpu().numpy()
    return [out[i, : plans[i].length].astype(np.float32) for i in range(len(plans))]


def center_place(clip: torch.Tensor, lengths: torch.Tensor, target: int) -> torch.Tensor:
    """(B, target) left-aligned clips -> centered (the pad-only validation
    placement of ``AugmentedAudioGenerator.execute_augment_batch``)."""
    offset = (target - lengths) // 2
    idx = torch.arange(target, device=clip.device)[None, :] - offset[:, None]
    valid = (idx >= 0) & (idx < lengths[:, None])
    gathered = torch.gather(clip, 1, torch.clamp(idx, 0, target - 1))
    return torch.where(valid, gathered, torch.zeros((), dtype=clip.dtype, device=clip.device))


@torch.no_grad()
def fused_features_batch(
    plans: List[ClipPlan],
    net: Any,
    generator: Optional[torch.Generator],
    noise_bank: torch.Tensor,
    impulse_bank: torch.Tensor,
    config: Any,
    pad_only: bool = False,
    l_max: int = DEFAULT_MAX_SAMPLES,
    harmonics: int = DEFAULT_HARMONICS,
    sample_rate: int = SAMPLE_RATE,
    clip_samples: Optional[int] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, int]:
    """
    One plans -> features batch on the net's device; returns the (B, 16, 96)
    device tensor (not synchronised) and the row count.

    The rendered waveform is rescaled from the renderer's 0.7 peak to the
    1.0 peak the augment chain sees on the host path. ``pad_only`` centres
    each clip; otherwise each clip draws a row of the device-resident noise
    and impulse banks and goes through ``augment_batch``. The draws come from
    ``generator`` (on the net's device); ``noise`` (breath, white) and
    ``draws`` (``augment.draw_augment``'s, plus "noise_rows" and
    "impulse_rows") inject them instead.
    """
    from heybuddy_tpu_torch.models.featurizer import featurize_batch
    from heybuddy_tpu_torch.ops.augment import augment_batch, draw_augment

    dev = next(net.parameters()).device
    clip_samples = clip_samples or CLIP_SAMPLES
    with span("formant/pack"):
        packed = pack_plans(plans, l_max)
        t = _packed_tensors(packed, dev)
    with span("formant/render"):
        breath, white = noise if noise is not None else clip_noise(packed["seeds"], l_max, dev)
        audio = render(t["tracks"], t["table"], t["scale"], t["noise_scale"], t["length"], breath, white,
                       l_max=l_max, harmonics=harmonics, sample_rate=sample_rate)
        del breath, white
    with span("augment/batch"):
        clip = audio[:, :clip_samples] * (1.0 / 0.7)
        lengths = torch.clamp(t["length"], max=clip_samples)
        if pad_only:
            staged = center_place(clip, lengths, clip_samples)
        else:
            b = clip.shape[0]
            if draws is None:
                draws = draw_augment(generator, b, clip_samples, config, dev)
                draws["noise_rows"] = torch.randint(0, noise_bank.shape[0], (b,), generator=generator, device=dev)
                draws["impulse_rows"] = torch.randint(0, impulse_bank.shape[0], (b,), generator=generator,
                                                      device=dev)
            staged = augment_batch(clip, lengths, noise_bank[draws["noise_rows"]],
                                   impulse_bank[draws["impulse_rows"]], config, draws=draws)
    with span("featurizer/featurize_batch"):
        return featurize_batch(net, staged * 32767.0), len(plans)
