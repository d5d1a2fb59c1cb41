"""
Device-resident formant TTS: plan on the host, render on the card.

Counterpart of the JAX package's ``models/formant_device.py``:

* the **host** plans (``DeviceFormantPlanner``, numpy: the host
  synthesizer's own segment plan, formant / F0 tracks and phase at knots
  64 samples apart, a batch of clips as arrays), so a ``ClipPlan`` is
  bit-equal to the JAX package's one-clip planner's;
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
import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


@functools.lru_cache(maxsize=None)
def _walk_grid(m: int) -> np.ndarray:
    """The f0 walk's knots on [0, 1] (``_f0_track``'s ``np.linspace``), read only."""
    grid = np.linspace(0, 1, m)
    grid.flags.writeable = False
    return grid


@dataclass
class _ClipDraft:
    """One clip's per-clip stage: its segments with their sample extents and
    every draw of its generator, taken in the host synthesizer's order."""

    segments: List[Any]      # the synthesizer's _Segments, start and n set
    total: int               # samples
    f0: float                # base f0, Hz
    scale: float
    noise_scale: float
    clip_seed: int
    color: List[float]       # the formant coloration (3)
    walk: np.ndarray         # the f0 walk's standard normals (total // 160, at least 2)
    phase0: float            # the phase's start


# clips whose knot grids are evaluated together: a (32, 751) float64 array
# stays in a core's L2 cache (at 128 rows the same work takes 2.5x as long)
_TRACK_ROWS = 32
# segment kinds as the batch tables' codes, and the voiced envelope's attack
# and release seconds by code (1.0 where a kind has no envelope)
_KINDS = {"vowel": 0, "nasal": 1, "liquid": 2, "fricative": 3, "closure": 4, "burst": 5, "aspiration": 6, "gap": 7}
_ENV_ATTACK = np.array([0.018, 0.012, 0.012, 0.01, 0.01, 1.0, 1.0, 1.0])
_ENV_RELEASE = np.array([0.02, 0.015, 0.015, 0.01, 0.01, 1.0, 1.0, 1.0])


class DeviceFormantPlanner:
    """Text -> :class:`ClipPlan` using the host synthesizer's own planning.

    ``plan_batch`` plans clips together: per clip in Python what cannot be
    batched (the segments, their extents, the fallback tests and every draw
    of the clip's own generator), then the tracks of ``_TRACK_ROWS`` clips at
    a time as arrays on their shared (B, n_dec) knot grid, each knot with the
    same float64 arithmetic in the same order as the host synthesizer's
    ``_build_tracks`` / ``_f0_track`` evaluated at it. A plan is bit-equal to
    the one-clip evaluation, alone or at any index of any batch.
    """

    def __init__(self, sample_rate: int = SAMPLE_RATE, max_samples: int = DEFAULT_MAX_SAMPLES) -> None:
        assert max_samples % TRACK_STRIDE == 0
        self.sample_rate = sample_rate
        self.max_samples = max_samples
        self.n_dec = max_samples // TRACK_STRIDE + 1
        self._positions = np.arange(self.n_dec, dtype=np.float64) * TRACK_STRIDE   # the knots' samples
        # rows' knots and formant control points are laid end to end, row r
        # at r * _row_span, for one interpolation over the batch (integer
        # sample positions: the offsets are exact)
        self._row_span = float(2 ** (max_samples.bit_length() + 2))
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
        ``FormantSynthesizer.synthesize``. A batch of one."""
        return self.plan_batch([text], [speaker], [length_scale], [noise_scale], [seed], [speaker_params])[0]

    def plan_batch(
        self,
        texts: Sequence[str],
        speakers: Sequence[int],
        length_scales: Sequence[float],
        noise_scales: Sequence[float],
        seeds: Sequence[Optional[int]],
        speaker_params: Sequence[Optional[Tuple[float, float]]],
    ) -> List[Optional[ClipPlan]]:
        """One plan per clip, in order, each as ``plan`` builds it, or None
        where the clip needs the host fallback. The G2P runs once for each
        distinct word of the call. A plan's arrays are row views of the
        batch's."""
        with span("formant/plan/segments"):
            lexicon: Dict[str, List[str]] = {}
            drafts = [self._draft(*clip, lexicon)
                      for clip in zip(texts, speakers, length_scales, noise_scales, seeds, speaker_params)]
        plans: List[Optional[ClipPlan]] = [None] * len(drafts)
        kept = [i for i, d in enumerate(drafts) if d is not None]
        with span("formant/plan/tracks"):
            for c0 in range(0, len(kept), _TRACK_ROWS):
                chunk = kept[c0:c0 + _TRACK_ROWS]
                tracks, tables = self._tracks([drafts[i] for i in chunk])
                for row, i in enumerate(chunk):
                    d = drafts[i]
                    plans[i] = ClipPlan(length=d.total, scale=float(d.scale), noise_scale=float(d.noise_scale),
                                        clip_seed=d.clip_seed, tracks=tracks[row], noise_table=tables[row])
        return plans

    def _draft(
        self,
        text: str,
        speaker: int,
        length_scale: float,
        noise_scale: float,
        seed: Optional[int],
        speaker_params: Optional[Tuple[float, float]],
        lexicon: Dict[str, List[str]],
    ) -> Optional[_ClipDraft]:
        """A clip's segments and draws, or None for the host fallback."""
        if seed is None:
            seed = int.from_bytes(hashlib.md5(text.encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed + speaker * 7919)
        f0, scale = speaker_params or self.synth._speaker(speaker)
        sr = self.sample_rate

        segments = self.synth._plan(text, length_scale, noise_scale, rng, lexicon)
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
        if sum(1 for s in segments if s.noise is not None and s.n > 0) > MAX_NOISE_SEGMENTS:
            return None

        # the host synthesizer's draws in its order: the formant coloration
        # (_build_tracks), the f0 walk (_f0_track), the phase's start
        color = 1.0 + noise_scale * 0.03 * rng.standard_normal(3)
        walk = rng.standard_normal(max(total // 160, 2))
        phase0 = rng.uniform(0, 2 * np.pi)
        return _ClipDraft(segments, total, f0, scale, noise_scale, int(seed + speaker * 7919) & 0x7FFFFFFF,
                          color.tolist(), walk, phase0)

    def _tracks(self, drafts: List[_ClipDraft]) -> Tuple[np.ndarray, np.ndarray]:
        """(B, 8, n_dec) tracks and (B, MAX_NOISE_SEGMENTS, 9) noise tables
        of the drafts: ``_build_tracks`` and ``_f0_track`` at the knots, the
        phase by trapezoids between them (the device integrates the linearly
        interpolated f0)."""
        sr, b, n_dec, span_r, pos = self.sample_rate, len(drafts), self.n_dec, self._row_span, self._positions

        # ---- the segments as (M,) tables, rows one after another ----
        segs = [seg for d in drafts for seg in d.segments]
        per_row = np.asarray([len(d.segments) for d in drafts])
        row = np.repeat(np.arange(b), per_row)
        first = np.cumsum(per_row) - per_row            # each row's first segment
        # per segment: start, n, kind, amp, has targets, stressed, nasal zero,
        # has a locus; first targets (a murmur without any: _build_tracks'
        # default), last targets, locus
        fields: List[Any] = []
        add, locus_of = fields.extend, self.synth._segment_locus
        for seg in segs:
            tg, lc = seg.targets, locus_of(seg)
            add((seg.start, seg.n, _KINDS[seg.kind], seg.amp, bool(tg), seg.stress, seg.anti_formant, lc is not None))
            add(tg[0] if tg else (300.0, 1400.0, 2500.0))
            add(tg[-1] if tg else (0.0, 0.0, 0.0))
            add(lc or (0.0, 0.0, 0.0))
        table = np.array(fields, np.float64).reshape(len(segs), 17)
        start, n, kind = (table[:, i].astype(np.int64) for i in range(3))
        amp, anti = table[:, 3], table[:, 6]
        has_tg, stressed, has_locus = table[:, 4] > 0, table[:, 5] > 0, table[:, 7] > 0
        tg_first, tg_last, locus = table[:, 8:11], table[:, 11:14], table[:, 14:17]
        last = first + per_row - 1                      # and its last
        has_prev = np.ones(len(segs), bool)
        has_prev[first] = False
        has_next = np.ones(len(segs), bool)
        has_next[last] = False
        prev = np.maximum(np.arange(len(segs)) - 1, 0)
        nxt = np.minimum(np.arange(len(segs)) + 1, len(segs) - 1)

        vowel = (kind == _KINDS["vowel"]) & has_tg
        tract = ((kind == _KINDS["nasal"]) | (kind == _KINDS["liquid"])) & has_tg
        murmur = ((kind == _KINDS["fricative"]) | (kind == _KINDS["closure"])) & (amp > 0)
        env_amp = np.where(vowel | tract | murmur, amp, 0.0)
        nasal_kind = kind == _KINDS["nasal"]
        nasal_seg = tract & nasal_kind
        end_on = vowel & has_next & nasal_kind[nxt]     # a vowel before a nasal
        start_on = vowel & has_prev & nasal_kind[prev]  # a vowel after one

        # ---- knots a segment holds: [ceil(start / 64), ceil((start + n) / 64)) ----
        k0 = -(-start // TRACK_STRIDE)
        k1 = -(-(start + n) // TRACK_STRIDE)

        def knots(rows: np.ndarray, first_k: np.ndarray, stop_k: np.ndarray) -> Tuple[np.ndarray, ...]:
            """Knots [first_k, stop_k) of each range's row, range after range:
            their knot numbers, flat indices into (B * n_dec), and the ranges' lengths."""
            lens = stop_k - first_k
            k = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens - first_k, lens)
            return k, k + np.repeat(rows * n_dec, lens), lens

        # ---- voiced envelope ----
        at = np.flatnonzero(vowel | tract | murmur)
        k, flat, lens = knots(row[at], k0[at], k1[at])
        t_axis = k * float(TRACK_STRIDE) - np.repeat(start[at], lens)   # samples into the segment
        att = np.minimum(t_axis / np.repeat(_ENV_ATTACK[kind[at]] * sr, lens), 1.0)
        rel = np.minimum((np.repeat(n[at] - 1.0, lens) - t_axis) / np.repeat(_ENV_RELEASE[kind[at]] * sr, lens), 1.0)
        voiced_amp = np.zeros(b * n_dec)
        voiced_amp[flat] = np.repeat(amp[at], lens) * att * np.clip(rel, 0, 1)

        # ---- nasalization and the nasal zero: nasals, then the vowel ramps ----
        nasal = np.zeros(b * n_dec, np.float32)
        zero_f = np.full(b * n_dec, 1500.0, np.float32)
        at = np.flatnonzero(nasal_seg)
        _, flat, lens = knots(row[at], k0[at], k1[at])
        nasal[flat] = 1.0
        zero_f[flat] = np.repeat(anti[at], lens)
        for on, reach, ramp_from, ramp_by, zero_of in (
            (end_on, int(0.07 * sr), 0.0, 0.9, nxt),      # the last `reach` samples, 0 -> 0.9
            (start_on, int(0.045 * sr), 0.75, -0.75, prev),  # the first ones, 0.75 -> 0
        ):
            if not on.any():
                continue
            at = np.flatnonzero(on)
            width = np.minimum(reach, n[at])
            if ramp_from == 0.0:
                lo = start[at] + n[at] - width
                k, flat, lens = knots(row[at], -(-lo // TRACK_STRIDE), k1[at])
            else:
                lo = start[at]
                k, flat, lens = knots(row[at], k0[at], -(-(lo + width) // TRACK_STRIDE))
            ramp = (ramp_from + ramp_by * (k * float(TRACK_STRIDE) - np.repeat(lo, lens))
                    / np.repeat(np.maximum(width - 1.0, 1.0), lens)).astype(np.float32)
            nasal[flat] = np.maximum(nasal[flat], ramp)
            zero_f[flat] = np.repeat(anti[zero_of[at]], lens)

        # ---- formant control points (s, s + trans, s + n - trans, s + n - 1 a vowel) ----
        color = np.asarray([d.color for d in drafts], np.float64)[row]
        first_c = tg_first * color
        last_c = tg_last * color
        lp, ln = locus[prev], locus[nxt]
        onset = np.where((has_prev & has_locus[prev])[:, None], lp + 0.45 * (first_c - lp), first_c)
        offset = np.where((has_next & has_locus[nxt])[:, None], ln + 0.45 * (last_c - ln), last_c)
        trans = np.minimum(int(0.045 * sr), n // 3)
        cp_t = np.stack([start, start + trans, start + n - trans, start + n - 1], axis=1)
        cp_t[~vowel, 1] = (start + n - 1)[~vowel]
        cp_f = np.stack([onset, first_c, last_c, offset], axis=1)
        cp_f[tract, :2] = first_c[tract, None]
        cp_f[murmur, :2] = tg_first[murmur, None]
        used = np.zeros((len(segs), 4), bool)
        used[vowel] = True
        used[tract | murmur, :2] = True
        cp_row = np.broadcast_to(row[:, None], used.shape)[used]
        cp_t, cp_f = cp_t[used], cp_f[used]
        empty = np.flatnonzero(np.bincount(cp_row, minlength=b) == 0)
        if len(empty):      # a row with no voiced segment: one point, (500, 1500, 2500)
            order = np.argsort(np.concatenate([cp_row, empty]), kind="stable")
            cp_row = np.concatenate([cp_row, empty])[order]
            cp_t = np.concatenate([cp_t, np.zeros(len(empty), np.int64)])[order]
            cp_f = np.concatenate([cp_f, np.tile([500.0, 1500.0, 2500.0], (len(empty), 1))])[order]
        # strictly increasing within a row: t_i = max(t_i, t_(i-1) + 1), an
        # integer cummax of t_i - i; rows apart by span_r
        per_cp_row = np.bincount(cp_row, minlength=b)
        cp_first = np.cumsum(per_cp_row) - per_cp_row
        local = np.arange(len(cp_t)) - cp_first[cp_row]
        base = cp_row * int(span_r)
        cp_t = np.maximum.accumulate(base + cp_t - local) - base + local
        # one interpolation for the batch: each row's points at r * span_r,
        # a flat point either side of them
        slots = np.arange(len(cp_t)) + 2 * cp_row + 1
        xp = np.empty(len(cp_t) + 2 * b)
        fp = np.empty((len(cp_t) + 2 * b, 3))
        xp[slots] = (base + cp_t).astype(np.float64)
        fp[slots] = cp_f
        left, right = cp_first + 2 * np.arange(b), cp_first + per_cp_row + 2 * np.arange(b) + 1
        rows_at = np.arange(b) * span_r
        xp[left], fp[left] = rows_at - 0.25 * span_r, fp[left + 1]
        xp[right], fp[right] = rows_at + 0.5 * span_r, fp[right - 1]
        # knots past a row's last point take its value: interpolate up to it
        last_cp = cp_first + per_cp_row - 1
        k, flat, lens = knots(np.arange(b), np.zeros(b, np.int64),
                              np.minimum(cp_t[last_cp] // TRACK_STRIDE + 1, n_dec))
        knot_x = k * float(TRACK_STRIDE) + np.repeat(rows_at, lens)
        formants = []
        for column in range(3):
            track = np.repeat(cp_f[last_cp, column], n_dec)
            track[flat] = np.interp(knot_x, xp, fp[:, column])
            formants.append(track)
        f1, f2, f3 = formants

        # ---- f0: declination, final fall, stress accents, jitter (in place,
        # each product and sum the host synthesizer's) ----
        totals = np.asarray([d.total for d in drafts])
        t = pos / np.maximum(totals - 1, 1).astype(np.float64)[:, None]
        f0 = t * 0.18
        np.subtract(1.08, f0, out=f0)
        f0 *= np.asarray([d.f0 for d in drafts], np.float64)[:, None]
        fall = t - 0.85
        fall /= 0.15
        np.clip(fall, 0, 1, out=fall)
        fall *= 0.08
        np.subtract(1.0, fall, out=fall)
        f0 *= fall
        accent = np.flatnonzero((kind == _KINDS["vowel"]) & stressed)
        rank = np.arange(len(accent)) - np.searchsorted(accent, first)[row[accent]]
        for nth in range(int(rank.max()) + 1 if len(accent) else 0):
            at = accent[rank == nth]
            x = pos - (start[at] + n[at] / 2)[:, None]
            x /= (np.maximum(n[at], 1) * 1.2)[:, None]
            bump = x * -4.0
            bump *= x
            np.exp(bump, out=bump)
            bump *= 0.10
            bump += 1.0
            if len(at) == b:
                f0 *= bump
            else:
                f0[row[at]] *= bump
        lengths = [len(d.walk) for d in drafts]
        walks = np.zeros((b, max(lengths)))
        for r, d in enumerate(drafts):
            walks[r, : lengths[r]] = d.walk
        # zero draws past a walk's end repeat its last value: the max is the walk's
        walks = np.cumsum(walks, axis=1)
        walks /= np.abs(walks).max(axis=1, keepdims=True) + 1e-9
        # past t = 1 the interpolation takes the walk's last value
        jitter = np.repeat(walks[np.arange(b), np.asarray(lengths) - 1][:, None], n_dec, axis=1)
        upto = np.minimum((totals - 1) // TRACK_STRIDE + 1, n_dec)
        for r, m in enumerate(lengths):
            jitter[r, : upto[r]] = np.interp(t[r, : upto[r]], _walk_grid(m), walks[r, :m])
        jitter *= (np.asarray([d.noise_scale for d in drafts], np.float64) * 0.012)[:, None]
        jitter += 1.0
        f0 *= jitter

        # ---- phase: trapezoids between the knots ----
        phase = np.empty((b, n_dec))
        phase[:, 0] = 0.0
        steps = f0[:, :-1] + f0[:, 1:]
        steps *= 0.5 * TRACK_STRIDE
        np.cumsum(steps, axis=1, out=phase[:, 1:])
        phase *= 2.0 * np.pi / sr
        phase += np.asarray([d.phase0 for d in drafts])[:, None]

        tracks = np.empty((b, _N_TRACKS, n_dec), np.float32)
        for k, track in enumerate((f0, phase, f1, f2, f3, voiced_amp, nasal, zero_f)):
            tracks[:, k] = track.reshape(b, n_dec)

        tables = np.zeros((b, MAX_NOISE_SEGMENTS, 9), np.float32)
        tables[:, :, 1] = 1.0   # n: avoid 0-division on unused rows
        tables[:, :, 7] = 0.01  # attack
        tables[:, :, 8] = 0.01  # release
        at, values = [], []
        for r, d in enumerate(drafts):
            i = 0
            for seg in d.segments:
                if seg.noise is None or seg.n <= 0:
                    continue
                low, high, level = seg.noise
                if seg.kind == "aspiration":
                    tg = seg.targets[0] if seg.targets else (500.0, 1500.0, 2500.0)
                    values.append((seg.start, seg.n, level, _KIND_ASPIRATION, tg[0], tg[1], tg[2], 0.0, 0.0))
                else:
                    attack_s, release_s = (0.002, 0.008) if seg.kind == "burst" else (0.01, 0.02)
                    values.append((seg.start, seg.n, level, _KIND_BAND, low, high, 0.0, attack_s, release_s))
                at.append((r, i))
                i += 1
        if at:
            idx = np.asarray(at)
            tables[idx[:, 0], idx[:, 1]] = np.asarray(values)
        return tracks, tables


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
