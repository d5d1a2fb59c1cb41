"""
Offline formant speech synthesizer (deterministic fallback TTS).

A copy of the JAX package's ``models/formant.py`` (numpy only): for the same
text, speaker, settings and seed the audio is bit-equal to the JAX
package's. ``FORMANT_VERSION`` is the synthesis tag of the caches' space
sidecar (``data/space.py``).

The reference depends on a hosted pretrained Piper/VITS checkpoint
(piper/pretrained.py:36). When no checkpoint is available (air-gapped
deployments, CI), this module synthesizes intelligible-enough, word-dependent
audio from the rule G2P's ARPAbet phonemes using classic source-filter
synthesis. It is NOT a neural TTS — its purpose is to make the full training
pipeline (synthesize -> augment -> featurize -> train) runnable and
*meaningful* end-to-end with zero downloaded assets.

v2 articulation model (round 3): the round-2 analysis showed the vowel-only
acoustics capped how far a minimal pair like "buddy"/"bunny" could separate
in embedding space, so consonant realization now carries the cues real
listeners (and real spectrogram embeddings) use:

* **Coarticulation** — formant tracks are continuous over the utterance and
  bend toward each consonant's place-of-articulation locus at segment
  boundaries (locus equations), so /d/ and /n/ imprint different F2
  transitions on the surrounding vowels even where their own segments are
  short.
* **Nasal anti-formants** — nasal murmurs carry a place-dependent spectral
  zero, and vowels adjacent to nasals are progressively nasalized (ramped
  anti-formant + murmur resonance), the primary /d/-vs-/n/ cue.
* **Voice onset time** — unvoiced stops get word-initial aspiration shaped by
  the following vowel's formants; voiced stops get closure prevoicing.
* **Prosody** — pitch declination, stress accents (first vowel per word),
  phrase-final lengthening and F0 fall; one continuous-phase harmonic source
  over the whole utterance (no per-phone phase resets/clicks).

Speaker / rate / pitch diversity knobs mirror the VITS settings grid
(slerp weights x length scales x noise scales).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from heybuddy_tpu_torch.constants import SAMPLE_RATE
from heybuddy_tpu_torch.text.phonemizer import get_phonemizer

__all__ = ["FormantSynthesizer", "FORMANT_VERSION"]

# Bump when synthesis output changes: cached artifacts keyed on rendered
# audio (e.g. quality-harness stream waveforms) use it to invalidate.
FORMANT_VERSION = 2

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


class FormantSynthesizer:
    """Deterministic text -> 16 kHz float32 waveform synthesis."""

    def __init__(self, sample_rate: int = SAMPLE_RATE) -> None:
        self.sample_rate = sample_rate
        self.phonemizer = get_phonemizer()

    def _speaker(self, seed: int) -> Tuple[float, float]:
        """(f0 base Hz, formant scale) derived deterministically from a seed."""
        digest = hashlib.md5(f"spk{seed}".encode()).digest()
        f0 = 95.0 + (digest[0] / 255.0) * 130.0       # 95 - 225 Hz
        scale = 0.88 + (digest[1] / 255.0) * 0.28     # vocal tract length factor
        return f0, scale

    # ------------------------------------------------------------------ plan

    def _plan(self, text: str, length_scale: float, noise_scale: float,
              rng: np.random.Generator,
              lexicon: Optional[Dict[str, List[str]]] = None) -> List[_Segment]:
        """Phones -> context-dependent segment sequence with durations.
        ``lexicon`` memoizes the G2P's phones by word for the calls that
        share it (the device planner's batch)."""
        words = text.split()
        segments: List[_Segment] = []
        for wi, word in enumerate(words):
            if lexicon is None:
                phones = self.phonemizer.word_phones(word)
            else:
                phones = lexicon.get(word)
                if phones is None:
                    phones = lexicon[word] = self.phonemizer.word_phones(word)
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
                      rng: np.random.Generator, noise_scale: float):
        """F1/F2/F3, voiced amp, nasalization and zero tracks at every sample.
        The device planner (``formant_device.DeviceFormantPlanner``) evaluates
        the same tracks at its knots, a batch of clips at a time."""
        sr = self.sample_rate
        pos = np.arange(total, dtype=np.float64)
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
                  rng: np.random.Generator, noise_scale: float) -> np.ndarray:
        """Declining F0 with stress accents and a phrase-final fall at every
        sample. The jitter walk's length depends on ``total`` only, so the
        device planner's knots sample the same contour (and the same draws)."""
        pos = np.arange(total, dtype=np.float64)
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

    # ------------------------------------------------------------- rendering

    def _render_voiced(self, f0_track: np.ndarray, f1: np.ndarray,
                       f2: np.ndarray, f3: np.ndarray, amp: np.ndarray,
                       nasal: np.ndarray, zero_f: np.ndarray, scale: float,
                       rng: np.random.Generator) -> np.ndarray:
        """One continuous-phase harmonic source filtered by the moving tract."""
        total = len(f0_track)
        out = np.zeros(total, dtype=np.float64)
        if not np.any(amp > 0):
            return out
        sr = self.sample_rate
        phase = 2 * np.pi * np.cumsum(f0_track) / sr + rng.uniform(0, 2 * np.pi)
        f0_max = float(f0_track.max())
        n_harmonics = max(int(sr / 2 / f0_max) - 1, 2)
        f1s, f2s, f3s = f1 * scale, f2 * scale, f3 * scale
        zs = zero_f * scale
        bw1 = 80 + 0.08 * f1s + 160.0 * nasal   # nasalization widens F1
        bw2 = 80 + 0.08 * f2s
        bw3 = 80 + 0.08 * f3s
        murmur = 0.5 * nasal
        # nasal murmurs are low-pass tilted: damp the upper resonances in
        # proportion to nasalization (murmurs radiate through the nose), but
        # keep the mid poles audible — the murmur's mid-frequency energy is
        # what distinguishes it from a voiced-stop voice bar in log-mel.
        g2 = 0.6 * (1.0 - 0.35 * nasal)
        g3 = 0.3 * (1.0 - 0.35 * nasal)
        # sin(h*phase) via the Chebyshev recurrence
        #   sin(h\phi) = 2 cos(\phi) sin((h-1)\phi) - sin((h-2)\phi)
        # — two fused multiply-adds per harmonic instead of a transcendental
        # over the whole track. Combined with reciprocal hoisting and the
        # nasal-term skip below this is the host pipeline's hot loop; every
        # change stays numerically equivalent (|err| ~1e-9 relative, far
        # below the f32 feature pipeline's resolution).
        # The loop body runs in float32: twice the SIMD lanes for the
        # division-bound Lorentzians, with the phase-sensitive pieces
        # (cumulative phase, first sin/cos) still computed in f64 before the
        # cast. The f32 recurrence drifts by ~n_harmonics*eps and the f32
        # envelope accumulates ~1e-5 relative error — -100 dB, far below the
        # augmentation noise floor and the f32 feature pipeline's resolution.
        f32 = np.float32
        two_cos = (2.0 * np.cos(phase)).astype(f32)
        sin_prev = np.zeros(total, dtype=f32)  # sin(0)
        sin_h = np.sin(phase).astype(f32)
        f0_32 = f0_track.astype(f32)
        f1s, f2s, f3s = f1s.astype(f32), f2s.astype(f32), f3s.astype(f32)
        inv_bw1 = (1.0 / bw1).astype(f32)
        inv_bw2 = (1.0 / bw2).astype(f32)
        inv_bw3 = (1.0 / bw3).astype(f32)
        g2, g3 = g2.astype(f32), g3.astype(f32)
        any_nasal = bool(np.any(nasal > 0))
        nasal_gain = (0.85 * nasal).astype(f32)
        murmur = murmur.astype(f32)
        zs_32 = zs.astype(f32)
        mur_center = f32(280.0 * scale)
        acc = np.zeros(total, dtype=f32)
        for h in range(1, n_harmonics + 1):
            freq = f32(h) * f0_32
            x1 = (freq - f1s) * inv_bw1
            x2 = (freq - f2s) * inv_bw2
            x3 = (freq - f3s) * inv_bw3
            env = (
                1.0 / (f32(1.0) + x1 * x1)
                + g2 / (f32(1.0) + x2 * x2)
                + g3 / (f32(1.0) + x3 * x3)
            )
            if any_nasal:
                # nasal spectral zero + low murmur resonance
                xz = (freq - zs_32) * f32(1.0 / 300.0)
                env *= f32(1.0) - nasal_gain / (f32(1.0) + xz * xz)
                xm = (freq - mur_center) * f32(1.0 / 120.0)
                env += murmur / (f32(1.0) + xm * xm)
            acc += env * (sin_h * f32(1.0 / np.sqrt(h)))
            sin_prev, sin_h = sin_h, two_cos * sin_h - sin_prev
        out = acc.astype(np.float64)
        return out * amp

    def _noise_burst(self, n: int, low: float, high: float, level: float,
                     rng: np.random.Generator,
                     attack_s: float = 0.01, release_s: float = 0.02) -> np.ndarray:
        white = rng.standard_normal(n)
        spectrum = np.fft.rfft(white)
        freqs = np.fft.rfftfreq(n, 1.0 / self.sample_rate)
        band = (freqs >= low) & (freqs <= high)
        spectrum[~band] *= 0.05
        shaped = np.fft.irfft(spectrum, n)
        shaped = shaped / (np.abs(shaped).max() + 1e-9) * level
        t = np.arange(n) / self.sample_rate
        dur = n / self.sample_rate
        attack = np.minimum(t / attack_s, 1.0)
        release = np.clip((dur - t) / release_s, 0, 1)
        return shaped * attack * release

    def _formant_noise(self, n: int, targets: Tuple[Tuple[float, float, float], ...],
                       level: float, scale: float,
                       rng: np.random.Generator) -> np.ndarray:
        """Aspiration: noise shaped by the following vowel's formants."""
        white = rng.standard_normal(n)
        spectrum = np.fft.rfft(white)
        freqs = np.fft.rfftfreq(n, 1.0 / self.sample_rate)
        tg = targets[0] if targets else (500, 1500, 2500)
        env = np.zeros_like(freqs)
        for fc, g in zip(tg, (1.0, 0.7, 0.4)):
            bw = 150.0 + 0.1 * fc
            env += g / (1.0 + ((freqs - fc * scale) / bw) ** 2)
        shaped = np.fft.irfft(spectrum * env, n)
        peak = np.abs(shaped).max() + 1e-9
        t = np.arange(n) / self.sample_rate
        fade = np.clip((n / self.sample_rate - t) / (n / self.sample_rate), 0.2, 1.0)
        return shaped / peak * level * fade

    # ------------------------------------------------------------------ api

    def synthesize(
        self,
        text: str,
        speaker: int = 0,
        length_scale: float = 1.0,
        noise_scale: float = 0.667,
        seed: Optional[int] = None,
        speaker_params: Optional[Tuple[float, float]] = None,
    ) -> np.ndarray:
        """Synthesize ``text`` to a float32 waveform in [-1, 1].

        ``speaker_params``: explicit (f0 base Hz, vocal-tract scale),
        overriding the ``speaker``-derived voice — the formant equivalent of
        the reference's slerp-interpolated VITS speaker embeddings
        (pretrained.py:359-368): callers blend two speakers' params and pass
        the result here.
        """
        if seed is None:
            seed = int.from_bytes(hashlib.md5(text.encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed + speaker * 7919)
        f0, scale = speaker_params or self._speaker(speaker)
        sr = self.sample_rate

        segments = self._plan(text, length_scale, noise_scale, rng)
        if not segments:
            return np.zeros(sr // 10, dtype=np.float32)
        # assign sample extents
        cursor = 0
        for seg in segments:
            seg.start = cursor
            seg.n = max(int(seg.dur * sr), 1)
            cursor += seg.n
        total = cursor + int(0.02 * sr)

        f1, f2, f3, amp, nasal, zero_f = self._build_tracks(
            segments, total, rng, noise_scale)
        f0_track = self._f0_track(segments, total, f0, rng, noise_scale)
        audio = self._render_voiced(f0_track, f1, f2, f3, amp, nasal, zero_f,
                                    scale, rng)

        # breathiness: low-level aspiration under voiced regions
        if noise_scale > 0:
            breath = rng.standard_normal(total) * 0.02 * noise_scale
            audio += breath * amp

        # unvoiced components
        for seg in segments:
            if seg.noise is None or seg.n <= 0:
                continue
            low, high, level = seg.noise
            if seg.kind == "aspiration":
                piece = self._formant_noise(seg.n, seg.targets, level, scale, rng)
            elif seg.kind == "burst":
                piece = self._noise_burst(seg.n, low * scale, high * scale,
                                          level, rng, attack_s=0.002,
                                          release_s=0.008)
            else:
                piece = self._noise_burst(seg.n, low * scale, high * scale,
                                          level, rng)
            audio[seg.start:seg.start + seg.n] += piece

        peak = np.abs(audio).max() + 1e-9
        return (audio / peak * 0.7).astype(np.float32)
