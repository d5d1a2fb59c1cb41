"""The augmentation chain, a frozen copy in float32.

Per clip: seven-band EQ and tanh distortion; per batch: a resampling pitch
shift; per clip: band-stop, coloured noise, gain; then placement at a random
offset (or across a window edge), background noise at a random SNR and
impulse-response reverb, then a clip to [-1, 1]. Every random value of a
batch is drawn by ``draw_augment`` from one generator, in the published
order, shapes and ranges; ``augment_batch`` applies them. The rFFT-domain
filters and the float32 rounding points are the published chain's.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
CLIP_SAMPLES = 23040
Draws = Dict[str, torch.Tensor]


class AugmentConfig(NamedTuple):
    """The published defaults of the chain."""

    seven_band_prob: float = 0.25
    seven_band_gain_db: float = 6.0
    tanh_distortion_prob: float = 0.25
    tanh_min_distortion: float = 1e-4
    tanh_max_distortion: float = 0.1
    pitch_shift_prob: float = 0.25
    pitch_shift_semitones: int = 3
    band_stop_prob: float = 0.25
    colored_noise_prob: float = 0.25
    colored_noise_min_snr_db: float = 10.0
    colored_noise_max_snr_db: float = 30.0
    colored_noise_min_f_decay: float = -1.0
    colored_noise_max_f_decay: float = 2.0
    background_noise_prob: float = 0.75
    background_noise_min_snr_db: float = -10.0
    background_noise_max_snr_db: float = 15.0
    gain_prob: float = 1.0
    gain_min_db: float = -18.0
    gain_max_db: float = 6.0
    reverb_prob: float = 0.75
    target_samples: int = CLIP_SAMPLES
    sample_rate: int = SAMPLE_RATE
    placement: str = "random"
    edge_min_visible: float = 0.30
    edge_max_visible: float = 0.80


def draw_augment(
    generator: torch.Generator, b: int, t: int, config: AugmentConfig, device: torch.device
) -> Draws:
    """Every random value ``augment_batch`` needs for a (b, t) batch, on
    ``device`` from ``generator``: the published shapes and ranges, only for the
    stages whose probability is above 0. Masks are "apply" booleans: (b, 1)
    per clip, () for the per-batch pitch shift. The pitch shift's semitone
    draw is kept as its resampling ratio 2^(s/12), computed once here, so that
    every device applies the same ratio (23040 positions scale by it)."""
    cfg = config

    def uniform(shape: Tuple[int, ...], lo: float, hi: float) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo

    def mask(prob: float, shape: Tuple[int, ...] = (b, 1)) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=device) < prob

    d: Draws = {}
    if cfg.seven_band_prob > 0:
        d["eq_apply"] = mask(cfg.seven_band_prob)
        d["eq_gains_db"] = uniform((b, 7), -cfg.seven_band_gain_db, cfg.seven_band_gain_db)
    if cfg.tanh_distortion_prob > 0:
        d["tanh_apply"] = mask(cfg.tanh_distortion_prob)
        d["tanh_amount"] = uniform((b, 1), cfg.tanh_min_distortion, cfg.tanh_max_distortion)
    if cfg.pitch_shift_prob > 0:
        d["pitch_apply"] = mask(cfg.pitch_shift_prob, ())
        semitones = uniform((), -float(cfg.pitch_shift_semitones), float(cfg.pitch_shift_semitones))
        d["pitch_ratio"] = 2.0 ** (semitones / 12.0)
    if cfg.band_stop_prob > 0:
        d["band_stop_apply"] = mask(cfg.band_stop_prob)
        d["band_stop_center"] = 2.0 ** uniform((b, 1), float(np.log2(200.0)), float(np.log2(4000.0)))
        d["band_stop_fraction"] = uniform((b, 1), 0.5, 1.99)
    if cfg.colored_noise_prob > 0:
        d["colored_apply"] = mask(cfg.colored_noise_prob)
        d["colored_white"] = torch.randn((b, t), generator=generator, device=device)
        d["colored_decay"] = uniform((b, 1), cfg.colored_noise_min_f_decay, cfg.colored_noise_max_f_decay)
        d["colored_snr_db"] = uniform((b, 1), cfg.colored_noise_min_snr_db, cfg.colored_noise_max_snr_db)
    if cfg.gain_prob > 0:
        d["gain_apply"] = mask(cfg.gain_prob)
        d["gain_db"] = uniform((b, 1), cfg.gain_min_db, cfg.gain_max_db)
    if cfg.placement == "edge":
        d["edge_fraction"] = uniform((b,), cfg.edge_min_visible, cfg.edge_max_visible)
        d["edge_head"] = mask(0.5, (b,))
    else:
        d["pad_uniform"] = uniform((b,), 0.0, 1.0)
    if cfg.background_noise_prob > 0:
        d["background_apply"] = mask(cfg.background_noise_prob)
        d["background_snr_db"] = uniform((b, 1), cfg.background_noise_min_snr_db, cfg.background_noise_max_snr_db)
    if cfg.reverb_prob > 0:
        d["reverb_apply"] = mask(cfg.reverb_prob)
    return d


def _db_to_amp(db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, db / 20.0)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + 1e-12)


def _freqs(n_freqs: int, sample_rate: int, device: torch.device) -> torch.Tensor:
    return torch.linspace(0.0, sample_rate / 2.0, n_freqs, device=device)


def _roll_rows(audio: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``jnp.roll`` of each row by its own shift: out[i] = audio[(i - shift) mod t]."""
    t = audio.shape[1]
    idx = torch.remainder(torch.arange(t, device=audio.device)[None, :] - shifts[:, None], t)
    return torch.gather(audio, 1, idx)


def random_center_pad(
    audio: torch.Tensor, lengths: torch.Tensor, uniform: torch.Tensor, target_samples: int = CLIP_SAMPLES
) -> torch.Tensor:
    """Each left-aligned clip at an offset uniform over the full free range
    [0, target - length] (``uniform``: (b,) in [0, 1))."""
    free = torch.clamp(target_samples - lengths, min=0)
    offsets = torch.minimum((uniform * (free + 1).to(torch.float32)).to(torch.int64), free)
    return _roll_rows(audio, offsets)


def edge_pad(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    fraction: torch.Tensor,
    head: torch.Tensor,
    target_samples: int = CLIP_SAMPLES,
) -> torch.Tensor:
    """Each clip straddling a window edge: only ``fraction`` of it visible, its
    head flush with the window's end (``head`` true) or its tail flush with
    the window's start."""
    visible = torch.minimum(
        torch.clamp((fraction * lengths.to(torch.float32)).to(torch.int64), min=1),
        torch.clamp(lengths - 1, min=1),
    )
    idx = torch.arange(target_samples, device=audio.device)[None, :]
    zero = torch.zeros((), dtype=audio.dtype, device=audio.device)
    masked_head = torch.where(idx >= (target_samples - visible)[:, None],
                              _roll_rows(audio, target_samples - visible), zero)
    masked_tail = torch.where(idx < visible[:, None], _roll_rows(audio, -(lengths - visible)), zero)
    return torch.where(head[:, None], masked_head, masked_tail)


def seven_band_eq(audio: torch.Tensor, gains_db: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """7-band parametric EQ as a smooth log-frequency gain curve in the rFFT domain."""
    t = audio.shape[1]
    n_freqs = t // 2 + 1
    centers = np.geomspace(40.0, 0.45 * sample_rate, 7).astype(np.float32)
    log_centers = torch.log(torch.from_numpy(centers).to(audio.device))
    log_f = torch.log(torch.clamp(_freqs(n_freqs, sample_rate, audio.device), min=1.0))
    bandwidth = (log_centers[1] - log_centers[0]) * 0.7
    weights = torch.exp(-0.5 * ((log_f[:, None] - log_centers[None, :]) / bandwidth) ** 2)
    weights = weights / (weights.sum(dim=1, keepdim=True) + 1e-9)
    response = _db_to_amp((weights @ gains_db.T).T)  # (b, n_freqs)
    return torch.fft.irfft(torch.fft.rfft(audio, dim=-1) * response, n=t, dim=-1)


def tanh_distortion(audio: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """Tanh waveshaping with RMS restoration (``amount``: (b, 1))."""
    gain_ = 1.0 + 20.0 * amount
    rms_before = _rms(audio)
    distorted = torch.tanh(audio * gain_ / (rms_before + 1e-9) * 0.5)
    return distorted * rms_before / (_rms(distorted) + 1e-9)


def pitch_shift(
    audio: torch.Tensor, lengths: torch.Tensor, ratio: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resampling pitch shift of the whole batch by ``ratio`` (a 0-d tensor,
    2^(semitones/12)): linear interpolation at a constant-rate grid, silence
    past the source window, the lengths rescaled by 1 / ratio."""
    t = audio.shape[1]
    positions = torch.arange(t, dtype=torch.float32, device=audio.device) * ratio
    in_range = positions <= (t - 1.0)
    positions = torch.clamp(positions, max=t - 1.0)
    lower = torch.floor(positions).to(torch.int64)
    frac = positions - lower.to(torch.float32)
    upper = torch.clamp(lower + 1, max=t - 1)
    out = (audio[:, lower] * (1.0 - frac) + audio[:, upper] * frac) * in_range[None, :]
    new_lengths = torch.clamp(torch.ceil(lengths.to(torch.float32) / ratio), max=float(t)).to(lengths.dtype)
    return out, new_lengths


def band_stop(
    audio: torch.Tensor, center: torch.Tensor, fraction: torch.Tensor, sample_rate: int = SAMPLE_RATE
) -> torch.Tensor:
    """A smooth band-stop notch in the rFFT domain (``center``, ``fraction``: (b, 1))."""
    t = audio.shape[1]
    bandwidth = center * fraction
    low, high = center - bandwidth / 2.0, center + bandwidth / 2.0
    freqs = _freqs(t // 2 + 1, sample_rate, audio.device)[None, :]
    edge = torch.clamp(bandwidth * 0.05, min=10.0)
    stop = torch.sigmoid((freqs - low) / edge) * torch.sigmoid((high - freqs) / edge)
    return torch.fft.irfft(torch.fft.rfft(audio, dim=-1) * (1.0 - stop), n=t, dim=-1)


def colored_noise(
    audio: torch.Tensor,
    white: torch.Tensor,
    decay: torch.Tensor,
    snr_db: torch.Tensor,
    sample_rate: int = SAMPLE_RATE,
) -> torch.Tensor:
    """Add ``white`` shaped by f^(-decay/2) at ``snr_db`` below the clip's RMS."""
    t = audio.shape[1]
    freqs = _freqs(t // 2 + 1, sample_rate, audio.device)[None, :]
    shaping = torch.where(freqs > 0, torch.clamp(freqs, min=1.0) ** (-decay / 2.0), torch.zeros((), device=audio.device))
    noise = torch.fft.irfft(torch.fft.rfft(white, dim=-1) * shaping, n=t, dim=-1)
    target_noise_rms = _rms(audio) / _db_to_amp(snr_db)
    return audio + noise * target_noise_rms / (_rms(noise) + 1e-9)


def background_noise(audio: torch.Tensor, noise: torch.Tensor, snr_db: torch.Tensor) -> torch.Tensor:
    """Mix background clips at ``snr_db`` (torchaudio add_noise semantics)."""
    target_noise_rms = _rms(audio) / _db_to_amp(snr_db)
    return audio + noise * target_noise_rms / (_rms(noise) + 1e-9)


def gain(audio: torch.Tensor, gain_db: torch.Tensor) -> torch.Tensor:
    return audio * _db_to_amp(gain_db)


def reverb(audio: torch.Tensor, impulse: torch.Tensor) -> torch.Tensor:
    """Full FFT convolution with each clip's (peak-normalized) impulse
    response, truncated to the clip length and RMS-restored."""
    t = audio.shape[1]
    fft_len = 1
    while fft_len < t + impulse.shape[-1] - 1:
        fft_len *= 2
    impulse = impulse / (torch.amax(torch.abs(impulse), dim=-1, keepdim=True) + 1e-9)
    spec = torch.fft.rfft(audio, n=fft_len, dim=-1) * torch.fft.rfft(impulse, n=fft_len, dim=-1)
    wet = torch.fft.irfft(spec, n=fft_len, dim=-1)[:, :t]
    return wet * _rms(audio) / (_rms(wet) + 1e-9)


def _maybe(
    prob: float, apply: Optional[torch.Tensor], transform: Callable[[], torch.Tensor], original: torch.Tensor
) -> torch.Tensor:
    """``transform()`` where ``apply``; computed only when ``prob`` > 0."""
    if prob <= 0.0:
        return original
    if prob >= 1.0:
        return transform()
    return torch.where(apply, transform(), original)


@torch.no_grad()
def augment_batch(
    audio: torch.Tensor,
    lengths: torch.Tensor,
    noise: torch.Tensor,
    impulse: torch.Tensor,
    config: AugmentConfig = AugmentConfig(),
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """
    The augmentation chain over one batch, on the batch's device.

    ``audio``: (b, target_samples) float32 in [-1, 1], left-aligned and
    zero-padded; ``lengths``: (b,) true lengths; ``noise``: (b,
    target_samples) background clips (all zeros disable mixing); ``impulse``:
    (b, ir_len) impulse responses (all zeros disable reverb). The draws are
    ``draws``, or else drawn from ``generator``. Returns (b, target_samples)
    clipped to [-1, 1]. Stage order: per-clip EQ / distortion -> batched
    pitch / band-stop / colored noise / gain -> placement -> background noise
    -> reverb.
    """
    cfg = config
    if draws is None:
        draws = draw_augment(generator, audio.shape[0], audio.shape[1], cfg, audio.device)
    d = draws
    sr = cfg.sample_rate

    x = _maybe(cfg.seven_band_prob, d.get("eq_apply"), lambda: seven_band_eq(audio, d["eq_gains_db"], sr), audio)
    x = _maybe(cfg.tanh_distortion_prob, d.get("tanh_apply"), lambda: tanh_distortion(x, d["tanh_amount"]), x)
    if cfg.pitch_shift_prob > 0.0:
        # one per-batch draw decides both the audio and its lengths, so the
        # placement below never sees an audio/length mismatch
        shifted, shifted_lengths = pitch_shift(x, lengths, d["pitch_ratio"])
        if cfg.pitch_shift_prob >= 1.0:
            x, lengths = shifted, shifted_lengths
        else:
            x = torch.where(d["pitch_apply"], shifted, x)
            lengths = torch.where(d["pitch_apply"], shifted_lengths, lengths)
    x = _maybe(cfg.band_stop_prob, d.get("band_stop_apply"),
               lambda: band_stop(x, d["band_stop_center"], d["band_stop_fraction"], sr), x)
    x = _maybe(cfg.colored_noise_prob, d.get("colored_apply"),
               lambda: colored_noise(x, d["colored_white"], d["colored_decay"], d["colored_snr_db"], sr), x)
    x = _maybe(cfg.gain_prob, d.get("gain_apply"), lambda: gain(x, d["gain_db"]), x)

    if cfg.placement == "edge":
        x = edge_pad(x, lengths, d["edge_fraction"], d["edge_head"], cfg.target_samples)
    else:
        x = random_center_pad(x, lengths, d["pad_uniform"], cfg.target_samples)

    if cfg.background_noise_prob > 0.0:
        has_noise = torch.any(torch.abs(noise) > 0)
        mixed = _maybe(cfg.background_noise_prob, d.get("background_apply"),
                       lambda: background_noise(x, noise, d["background_snr_db"]), x)
        x = torch.where(has_noise, mixed, x)
    if cfg.reverb_prob > 0.0:
        has_ir = torch.any(torch.abs(impulse) > 0)
        x = torch.where(has_ir, _maybe(cfg.reverb_prob, d.get("reverb_apply"), lambda: reverb(x, impulse), x), x)
    return torch.clamp(x, -1.0, 1.0)