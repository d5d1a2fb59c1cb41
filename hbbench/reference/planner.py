"""The formant voice's planner, written out again: text, speaker, speed,
breathiness and seed -> the render's inputs of one clip (decimated tracks of
f0, phase, three formants, voiced amplitude, nasalization and the nasal
zero, and a table of noise segments), or None where a clip is longer than
``max_samples`` or has more than ``MAX_NOISE_SEGMENTS`` noise segments.

Segments from the phones with jittered durations; formant tracks
interpolated between control points that bend toward each consonant's locus;
voiced envelopes; nasalization ramps; a declining f0 with stress accents, a
final fall and a low-passed random walk; the phase integrated by trapezoids
between the 64-sample knots. A batch's clip ``j`` has the seed
``batch_seed * 31 + j`` and blends two speakers' (f0, vocal-tract scale).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from hbbench.reference.g2p import word_phones

SAMPLE_RATE = 16000
TRACK_STRIDE = 64
MAX_NOISE_SEGMENTS = 24
DEFAULT_MAX_SAMPLES = 48000
_KIND_BAND = 0.0
_KIND_ASPIRATION = 1.0

# (F1, F2, F3) vowel targets in Hz; diphthongs carry two targets.
_VOWELS: Dict[str, Tuple[Tuple[float, float, float], ...]] = {
    "AA": ((730, 1090, 2440),),
    "AE": ((660, 1720, 2410),),
    "AH": ((640, 1190, 2390),),
    "AO": ((570, 840, 2410),),
    "EH": ((530, 1840, 2480),),
    "ER": ((490, 1350, 1690),),
    "IH": ((390, 1990, 2550),),
    "IY": ((270, 2290, 3010),),
    "UH": ((440, 1020, 2240),),
    "UW": ((300, 870, 2240),),
    "OW": ((570, 840, 2410), (300, 870, 2240)),
    "AY": ((730, 1090, 2440), (270, 2290, 3010)),
    "EY": ((530, 1840, 2480), (270, 2290, 3010)),
    "OY": ((570, 840, 2410), (270, 2290, 3010)),
    "AW": ((730, 1090, 2440), (300, 870, 2240)),
}

# Noise band (low, high) Hz and relative level for fricatives.
_FRICATIVES: Dict[str, Tuple[float, float, float]] = {
    "S": (4000, 8000, 0.6),
    "SH": (2000, 6000, 0.6),
    "F": (1500, 7000, 0.35),
    "TH": (1400, 7000, 0.3),
    "Z": (4000, 8000, 0.5),
    "ZH": (2000, 6000, 0.5),
    "V": (1000, 5000, 0.35),
    "DH": (1000, 5000, 0.3),
    "HH": (500, 4000, 0.3),
}

_STOPS: Dict[str, Tuple[float, float, bool]] = {
    # burst center Hz, burst bandwidth, voiced
    "P": (800, 1500, False), "B": (800, 1500, True),
    "T": (4000, 3000, False), "D": (4000, 3000, True),
    "K": (2000, 2000, False), "G": (2000, 2000, True),
    "CH": (3000, 3000, False), "JH": (3000, 3000, True),
}

# Nasal murmur poles + anti-formant (spectral zero) frequency by place
# (Klatt-style: zero sits BETWEEN murmur resonances, not on one).
_NASALS: Dict[str, Tuple[Tuple[float, float, float], float]] = {
    "M": ((250, 1100, 2300), 800.0),
    "N": ((250, 1500, 2500), 1900.0),
    "NG": ((250, 2000, 2600), 3000.0),
}

_LIQUIDS: Dict[str, Tuple[float, float, float]] = {
    "L": (360, 1300, 2700),
    "R": (330, 1100, 1500),
    "W": (300, 700, 2200),
    "Y": (270, 2200, 3000),
}

# Place-of-articulation formant loci that coarticulation transitions bend
# toward (locus theory: F2 onset = locus + k * (F2_vowel - locus)).
_LOCI: Dict[str, Tuple[float, float, float]] = {}
for _ph in ("P", "B", "M", "W", "F", "V"):       # labial
    _LOCI[_ph] = (250.0, 800.0, 2200.0)
for _ph in ("T", "D", "N", "S", "Z", "L"):        # alveolar
    _LOCI[_ph] = (250.0, 1800.0, 2600.0)
for _ph in ("K", "G", "NG"):                       # velar
    _LOCI[_ph] = (250.0, 2100.0, 2400.0)
for _ph in ("SH", "ZH", "CH", "JH", "Y"):          # palatal
    _LOCI[_ph] = (270.0, 2100.0, 2900.0)
for _ph in ("R",):
    _LOCI[_ph] = (330.0, 1100.0, 1500.0)
for _ph in ("TH", "DH"):                            # dental
    _LOCI[_ph] = (280.0, 1600.0, 2600.0)

_VOICED_CONS = {"B", "D", "G", "JH", "Z", "ZH", "V", "DH", "M", "N", "NG",
                "L", "R", "W", "Y"}

# Intrinsic vowel duration factors: low vowels are longer, high lax vowels
# shorter (a primary cue for pairs like "buddy" AH vs "body" AA whose
# formant targets nearly coincide).
_VOWEL_DUR: Dict[str, float] = {
    "AA": 1.25, "AE": 1.15, "AO": 1.15, "AH": 0.9, "EH": 0.95,
    "IH": 0.85, "UH": 0.85, "IY": 1.0, "UW": 1.0, "ER": 1.05,
}


@dataclass
class _Segment:
    """One acoustic segment of the utterance plan."""

    phone: str
    kind: str                 # vowel|nasal|liquid|fricative|closure|burst|aspiration|gap
    dur: float                # seconds
    targets: Tuple[Tuple[float, float, float], ...] = ()
    amp: float = 1.0          # voiced amplitude
    noise: Optional[Tuple[float, float, float]] = None  # (low, high, level)
    stress: bool = False
    anti_formant: float = 0.0  # nasal zero frequency (0 = none)
    # filled during rendering
    start: int = 0
    n: int = 0




class _Synth:
    """The planning half of the formant synthesizer."""

    sample_rate = SAMPLE_RATE

    def _speaker(self, seed: int) -> Tuple[float, float]:
        """(f0 base Hz, formant scale) derived deterministically from a seed."""
        digest = hashlib.md5(f"spk{seed}".encode()).digest()
        f0 = 95.0 + (digest[0] / 255.0) * 130.0       # 95 - 225 Hz
        scale = 0.88 + (digest[1] / 255.0) * 0.28     # vocal tract length factor
        return f0, scale

    # ------------------------------------------------------------------ plan

    def _plan(self, text: str, length_scale: float, noise_scale: float,
              rng: np.random.Generator) -> List[_Segment]:
        """Phones -> context-dependent segment sequence with durations."""
        words = text.split()
        segments: List[_Segment] = []
        for wi, word in enumerate(words):
            phones = word_phones(word)
            if not phones:
                continue
            # English trochaic bias: stress the word's first vowel.
            first_vowel = next((i for i, p in enumerate(phones) if p in _VOWELS), -1)
            last_word = wi == len(words) - 1
            for pi, ph in enumerate(phones):
                nxt = phones[pi + 1] if pi + 1 < len(phones) else None
                final = last_word and pi >= len(phones) - 2
                jit = max(1.0 + noise_scale * 0.15 * rng.standard_normal(), 0.5)
                if ph in _VOWELS:
                    stress = pi == first_vowel
                    dur = (0.13 if stress else 0.085) * length_scale * jit
                    dur *= _VOWEL_DUR.get(ph, 1.0)
                    if len(_VOWELS[ph]) > 1:
                        dur *= 1.3
                    if nxt in _VOICED_CONS or nxt is None:
                        dur *= 1.2   # pre-voicing / open-syllable lengthening
                    if final:
                        dur *= 1.25  # phrase-final lengthening
                    segments.append(_Segment(ph, "vowel", dur, _VOWELS[ph],
                                             amp=1.0, stress=stress))
                elif ph in _NASALS:
                    formants, zero = _NASALS[ph]
                    dur = (0.09 if nxt is None else 0.075) * length_scale * jit
                    segments.append(_Segment(ph, "nasal", dur, (formants,),
                                             amp=0.6, anti_formant=zero))
                elif ph in _LIQUIDS:
                    dur = 0.07 * length_scale * jit
                    segments.append(_Segment(ph, "liquid", dur, (_LIQUIDS[ph],),
                                             amp=0.8))
                elif ph in _FRICATIVES:
                    low, high, level = _FRICATIVES[ph]
                    voiced = ph in ("Z", "ZH", "V", "DH")
                    dur = (0.105 if ph in ("S", "SH") else 0.08) * length_scale * jit
                    if voiced:
                        dur *= 0.85
                    segments.append(_Segment(
                        ph, "fricative", dur, ((300, 1400, 2500),),
                        amp=0.45 if voiced else 0.0, noise=(low, high, level)))
                elif ph in _STOPS:
                    center, bw, voiced = _STOPS[ph]
                    prev = phones[pi - 1] if pi > 0 else None
                    if (ph in ("D", "T") and prev in _VOWELS and nxt in _VOWELS):
                        # American English flapping: intervocalic /d/,/t/ are
                        # a ~25 ms tap — a brief weak closure, no real burst.
                        # Keeps "buddy" realistic while maximally distinct
                        # from the long loud nasal murmur of "bunny".
                        segments.append(_Segment(
                            ph, "closure", 0.025 * length_scale,
                            ((240, 1800, 2600),), amp=0.3))
                        segments.append(_Segment(
                            ph, "burst", 0.006 * length_scale, (_LOCI[ph],),
                            amp=0.0, noise=(center - bw / 2, center + bw / 2, 0.3)))
                        continue
                    closure = (0.04 if voiced else 0.055) * length_scale
                    # Voiced-closure prevoicing is a VOICE BAR: glottal energy
                    # through closed articulators, low-frequency only — no
                    # F2/F3 energy, which is exactly what distinguishes a /d/
                    # closure from an /n/ murmur (the "buddy"/"bunny" cue).
                    segments.append(_Segment(
                        ph, "closure", closure, ((180, 250, 2800),),
                        amp=0.12 if voiced else 0.0))
                    segments.append(_Segment(
                        ph, "burst", 0.02 * length_scale, (_LOCI[ph],),
                        amp=0.0, noise=(center - bw / 2, center + bw / 2, 0.65)))
                    if ph in ("CH", "JH"):  # affricate frication tail
                        segments.append(_Segment(
                            ph, "fricative", 0.06 * length_scale,
                            (_LOCI[ph],), amp=0.3 if voiced else 0.0,
                            noise=(2000, 6000, 0.5)))
                    elif not voiced and (pi == 0 or nxt in _VOWELS):
                        # aspirated VOT before a vowel / word-initially
                        segments.append(_Segment(
                            ph, "aspiration", 0.045 * length_scale,
                            _VOWELS.get(nxt or "", ((500, 1500, 2500),)),
                            amp=0.0, noise=(400, 6000, 0.3)))
                else:  # unknown phone: schwa-ish
                    segments.append(_Segment(ph, "vowel", 0.07 * length_scale,
                                             ((500, 1500, 2500),), amp=0.5))
            # short inter-word gap: connected speech, not isolated words
            if not last_word:
                segments.append(_Segment("", "gap",
                                         0.035 * length_scale * jit))
        return segments

    # ------------------------------------------------------- track building

    @staticmethod
    def _segment_locus(seg: Optional[_Segment]) -> Optional[Tuple[float, float, float]]:
        if seg is None or seg.kind == "gap":
            return None
        if seg.phone in _LOCI:
            return _LOCI[seg.phone]
        if seg.targets:
            return seg.targets[0]
        return None

    def _build_tracks(self, segments: List[_Segment], total: int,
                      rng: np.random.Generator, noise_scale: float,
                      positions: Optional[np.ndarray] = None):
        """F1/F2/F3, voiced amp, nasalization and zero tracks, evaluated at
        ``positions`` (sorted sample indices; default every sample). The
        device planner passes a 64x-decimated grid — evaluating only there is
        what makes host planning ~10x cheaper than full-rate rendering."""
        sr = self.sample_rate
        pos = (np.arange(total, dtype=np.float64) if positions is None
               else np.asarray(positions, dtype=np.float64))
        # control points for formants: (sample, f1, f2, f3)
        cp_t: List[float] = []
        cp_f: List[Tuple[float, float, float]] = []

        def add_cp(t: float, f: Tuple[float, float, float]) -> None:
            # keep strictly increasing for np.interp
            if cp_t and t <= cp_t[-1]:
                t = cp_t[-1] + 1.0
            cp_t.append(t)
            cp_f.append(f)

        def span_of(lo: float, hi: float) -> "tuple[int, int]":
            """Index range of positions falling in [lo, hi)."""
            j = np.searchsorted(pos, [lo, hi], side="left")
            return int(j[0]), int(j[1])

        def ramp_vals(lo: float, hi_n: float, v0: float, v1: float,
                      j0: int, j1: int) -> np.ndarray:
            """Linear v0->v1 over sample offsets 0..hi_n-1 (matches
            np.linspace(v0, v1, hi_n) indexed at pos-lo)."""
            denom = max(hi_n - 1.0, 1.0)
            return (v0 + (v1 - v0) * (pos[j0:j1] - lo) / denom).astype(np.float32)

        # per-utterance random formant coloration (speaker idiosyncrasy)
        color = 1.0 + noise_scale * 0.03 * rng.standard_normal(3)

        voiced_amp = np.zeros(len(pos), dtype=np.float32)
        nasal = np.zeros(len(pos), dtype=np.float32)    # nasalization 0..1
        zero_f = np.full(len(pos), 1500.0, dtype=np.float32)  # anti-formant Hz

        def envelope(s: int, n: int, amp: float, att_s: float, rel_s: float) -> None:
            j0, j1 = span_of(s, s + n)
            if j1 <= j0:
                return
            t_axis = pos[j0:j1] - s
            att = np.minimum(t_axis / (att_s * sr), 1.0)
            rel = np.minimum((n - 1 - t_axis) / (rel_s * sr), 1.0)
            voiced_amp[j0:j1] = amp * att * np.clip(rel, 0, 1)

        mix = 0.45  # locus-onset mixing coefficient (locus equations)
        for i, seg in enumerate(segments):
            if seg.n == 0:
                continue
            s, n = seg.start, seg.n
            prev_seg = segments[i - 1] if i > 0 else None
            next_seg = segments[i + 1] if i + 1 < len(segments) else None
            if seg.kind == "vowel" and seg.targets:
                targets = [np.asarray(tg, dtype=np.float64) * color
                           for tg in seg.targets]
                if len(targets) == 1:
                    targets = [targets[0], targets[0]]
                on = np.asarray(targets[0])
                off = np.asarray(targets[-1])
                locus_in = self._segment_locus(prev_seg)
                locus_out = self._segment_locus(next_seg)
                if locus_in is not None:
                    on = np.asarray(locus_in) + mix * (on - np.asarray(locus_in))
                if locus_out is not None:
                    off = np.asarray(locus_out) + mix * (off - np.asarray(locus_out))
                trans = min(int(0.045 * sr), n // 3)
                add_cp(s, tuple(on))
                add_cp(s + trans, tuple(targets[0]))
                add_cp(s + n - trans, tuple(targets[-1]))
                add_cp(s + n - 1, tuple(off))
                # ramp attack/release inside the segment
                envelope(s, n, seg.amp, 0.018, 0.02)
                # nasalize vowel edges adjacent to nasals
                if next_seg is not None and next_seg.kind == "nasal":
                    span = min(int(0.07 * sr), n)
                    j0, j1 = span_of(s + n - span, s + n)
                    nasal[j0:j1] = np.maximum(
                        nasal[j0:j1],
                        ramp_vals(s + n - span, span, 0.0, 0.9, j0, j1))
                    zero_f[j0:j1] = next_seg.anti_formant
                if prev_seg is not None and prev_seg.kind == "nasal":
                    span = min(int(0.045 * sr), n)
                    j0, j1 = span_of(s, s + span)
                    nasal[j0:j1] = np.maximum(
                        nasal[j0:j1], ramp_vals(s, span, 0.75, 0.0, j0, j1))
                    zero_f[j0:j1] = prev_seg.anti_formant
            elif seg.kind in ("nasal", "liquid") and seg.targets:
                tg = tuple(np.asarray(seg.targets[0], dtype=np.float64) * color)
                add_cp(s, tg)
                add_cp(s + n - 1, tg)
                envelope(s, n, seg.amp, 0.012, 0.015)
                if seg.kind == "nasal":
                    j0, j1 = span_of(s, s + n)
                    nasal[j0:j1] = 1.0
                    zero_f[j0:j1] = seg.anti_formant
            elif seg.kind in ("fricative", "closure") and seg.amp > 0:
                # voiced murmur under voiced fricatives / closure prevoicing
                tg = seg.targets[0] if seg.targets else (300, 1400, 2500)
                add_cp(s, tuple(np.asarray(tg, dtype=np.float64)))
                add_cp(s + n - 1, tuple(np.asarray(tg, dtype=np.float64)))
                envelope(s, n, seg.amp, 0.01, 0.01)

        if not cp_t:
            add_cp(0, (500.0, 1500.0, 2500.0))
        cps = np.asarray(cp_t)
        cf = np.asarray(cp_f)
        f1 = np.interp(pos, cps, cf[:, 0]).astype(np.float32)
        f2 = np.interp(pos, cps, cf[:, 1]).astype(np.float32)
        f3 = np.interp(pos, cps, cf[:, 2]).astype(np.float32)
        return f1, f2, f3, voiced_amp, nasal, zero_f

    def _f0_track(self, segments: List[_Segment], total: int, f0: float,
                  rng: np.random.Generator, noise_scale: float,
                  positions: Optional[np.ndarray] = None) -> np.ndarray:
        """Declining F0 with stress accents and a phrase-final fall, evaluated
        at ``positions`` (default every sample). The jitter walk's length
        depends on ``total`` only, so decimated and full evaluations sample
        the same underlying contour (and consume the same rng draws)."""
        pos = (np.arange(total, dtype=np.float64) if positions is None
               else np.asarray(positions, dtype=np.float64))
        t = pos / max(total - 1, 1)
        track = f0 * (1.08 - 0.18 * t)          # declination
        track *= 1.0 - 0.08 * np.clip((t - 0.85) / 0.15, 0, 1)  # final fall
        # stress accents: smooth +10% bumps centered on stressed vowels
        for seg in segments:
            if seg.kind == "vowel" and seg.stress and seg.n > 0:
                center = seg.start + seg.n / 2
                width = max(seg.n, 1) * 1.2
                x = (pos - center) / width
                track *= 1.0 + 0.10 * np.exp(-4.0 * x * x)
        # slow jitter (random walk, low-passed)
        walk = np.cumsum(rng.standard_normal(max(total // 160, 2)))
        walk = walk / (np.abs(walk).max() + 1e-9)
        jitter = np.interp(t, np.linspace(0, 1, len(walk)), walk)
        track *= 1.0 + noise_scale * 0.012 * jitter
        return track.astype(np.float64)


_SYNTH = _Synth()


def speaker(seed: int) -> Tuple[float, float]:
    return _SYNTH._speaker(seed)


def plan(text: str, speaker_id: int, length_scale: float, noise_scale: float, seed: int,
         speaker_params: Tuple[float, float], max_samples: int = DEFAULT_MAX_SAMPLES) -> Optional[Dict[str, object]]:
    """One clip's render inputs (``length``, ``scale``, ``noise_scale``,
    ``clip_seed``, ``tracks`` (8, Ld) float32, ``noise_table`` (24, 9) float32)."""
    synth, sr = _SYNTH, SAMPLE_RATE
    rng = np.random.default_rng(seed + speaker_id * 7919)
    f0, scale = speaker_params
    segments = synth._plan(text, length_scale, noise_scale, rng)
    if not segments:
        return None
    cursor = 0
    for seg in segments:
        seg.start = cursor
        seg.n = max(int(seg.dur * sr), 1)
        cursor += seg.n
    total = cursor + int(0.02 * sr)
    if total > max_samples:
        return None
    noise_segments = [s for s in segments if s.noise is not None and s.n > 0]
    if len(noise_segments) > MAX_NOISE_SEGMENTS:
        return None
    positions = np.arange(max_samples // TRACK_STRIDE + 1, dtype=np.float64) * TRACK_STRIDE
    f1, f2, f3, amp, nasal, zero_f = synth._build_tracks(segments, total, rng, noise_scale, positions=positions)
    f0_track = synth._f0_track(segments, total, f0, rng, noise_scale, positions=positions)
    steps = (f0_track[:-1] + f0_track[1:]) * (0.5 * TRACK_STRIDE)
    phase = rng.uniform(0, 2 * np.pi) + (2.0 * np.pi / sr) * np.concatenate([[0.0], np.cumsum(steps)])
    tracks = np.stack([f0_track.astype(np.float32), phase.astype(np.float32), f1, f2, f3,
                       np.where(positions < total, amp, 0.0).astype(np.float32),
                       np.where(positions < total, nasal, 0.0).astype(np.float32), zero_f])
    table = np.zeros((MAX_NOISE_SEGMENTS, 9), np.float32)
    table[:, 1] = 1.0
    table[:, 7] = 0.01
    table[:, 8] = 0.01
    for i, seg in enumerate(noise_segments):
        low, high, level = seg.noise
        if seg.kind == "aspiration":
            tg = seg.targets[0] if seg.targets else (500.0, 1500.0, 2500.0)
            table[i] = (seg.start, seg.n, level, _KIND_ASPIRATION, tg[0], tg[1], tg[2], 0.0, 0.0)
        else:
            attack_s, release_s = (0.002, 0.008) if seg.kind == "burst" else (0.01, 0.02)
            table[i] = (seg.start, seg.n, level, _KIND_BAND, low, high, 0.0, attack_s, release_s)
    return {"length": total, "scale": float(scale), "noise_scale": float(noise_scale),
            "clip_seed": int(seed + speaker_id * 7919) & 0x7FFFFFFF, "tracks": tracks, "noise_table": table}


def batch_clip(text: str, speakers: Tuple[int, int], slerp_weight: float, length_scale: float,
               noise_scale: float, batch_seed: int, j: int) -> Optional[Dict[str, object]]:
    """Clip ``j`` of a planned batch: the two speakers blended, the batch's seed."""
    (fa, sa), (fb, sb) = speaker(speakers[0]), speaker(speakers[1])
    params = (fa * (1.0 - slerp_weight) + fb * slerp_weight, sa * (1.0 - slerp_weight) + sb * slerp_weight)
    return plan(text, speakers[0] * 104729 + speakers[1], length_scale, noise_scale, batch_seed * 31 + j, params)
