"""
TTS engine: batched speech synthesis for training-sample generation.

Counterpart of the JAX package's ``models/tts.py``, with the same call
contract: ``tts(texts, num_samples, ...) -> List[(text, int16 16 kHz audio)]``
with weighted text sampling, a cycling settings grid (slerp weights x length
scales x noise scales x noise-scale-ws), cycling speaker pairs blended by the
slerp weight, and peak-normalized int16 output. For the same arguments and
seed the texts, the grids and (host backend) the audio are the JAX package's.

Backends behind the same interface:

* :class:`FormantTTS` — the numpy formant synthesizer (``models/formant.py``)
  on a pool of host threads, the default.
* :class:`DeviceFormantTTS` ("formant-device") — the same synthesis planned
  on the host and rendered on ``device`` (``models/formant_device.py``); its
  plans also feed the fused plans -> features path.
* :class:`VitsTTS` raises: the VITS backend needs a Piper checkpoint, and
  none is ported.

``trim_silence`` cuts synthesis silence with the shared VAD (``models/vad.py``).
"""

from __future__ import annotations

import itertools
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from heybuddy_tpu_torch.constants import (
    DEFAULT_TTS_LENGTH_SCALES,
    DEFAULT_TTS_NOISE_SCALE_WEIGHTS,
    DEFAULT_TTS_NOISE_SCALES,
    DEFAULT_TTS_SLERP_WEIGHTS,
    SAMPLE_RATE,
)
from heybuddy_tpu_torch.device import DeviceLike
from heybuddy_tpu_torch.models.formant import FormantSynthesizer
from heybuddy_tpu_torch.text.phonemizer import get_phonemizer
from heybuddy_tpu_torch.utils.audio_io import resample_audio

__all__ = [
    "BaseTTS",
    "FormantTTS",
    "DeviceFormantTTS",
    "VitsTTS",
    "get_tts_model",
    "SAMPLING_VERSION",
]

TextsType = Union[str, List[str], List[Tuple[str, float]]]

# Version of the sampling contract feeding feature caches (speaker/settings
# grid traversal), the JAX package's: chunked generation advances the grid
# offsets per batch since version 2.
SAMPLING_VERSION = 2


class BaseTTS:
    """Shared sampling/grid logic; subclasses implement ``synthesize_batch``."""

    sample_rate = SAMPLE_RATE

    def __init__(self) -> None:
        # the selected G2P changes the rendered audio, so it is part of the
        # caches' provenance tag (data/space.py tts_provenance)
        self.phonemizer = get_phonemizer()

    # subclass hooks ------------------------------------------------------------
    def synthesize_batch(
        self,
        texts: List[str],
        speakers: List[Tuple[int, int]],
        slerp_weight: float,
        length_scale: float,
        noise_scale: float,
        noise_scale_w: float,
        seed: int,
    ) -> List[np.ndarray]:
        raise NotImplementedError

    @property
    def num_speakers(self) -> int:
        raise NotImplementedError

    def plan_batch(
        self,
        texts: List[str],
        speakers: List[Tuple[int, int]],
        slerp_weight: float,
        length_scale: float,
        noise_scale: float,
        noise_scale_w: float,
        seed: int,
    ) -> List[Any]:
        """Device ClipPlans for the fused pipeline (backends that support it)."""
        raise NotImplementedError(f"{type(self).__name__} does not support the fused plan pipeline")

    # ---------------------------------------------------------------------------

    def trim_silence(self, sample: np.ndarray, threshold: float = 0.05) -> np.ndarray:
        from heybuddy_tpu_torch.models.vad import get_vad_model

        return get_vad_model(device=getattr(self, "device", "cuda")).trim(sample, threshold=threshold)

    def __call__(
        self,
        texts: TextsType,
        num_samples: Optional[int] = None,
        batch_size: int = 1,
        slerp_weights: Sequence[float] = DEFAULT_TTS_SLERP_WEIGHTS,
        length_scales: Sequence[float] = DEFAULT_TTS_LENGTH_SCALES,
        noise_scales: Sequence[float] = DEFAULT_TTS_NOISE_SCALES,
        noise_scale_ws: Sequence[float] = DEFAULT_TTS_NOISE_SCALE_WEIGHTS,
        max_speakers: Optional[int] = None,
        target_sample_rate: Optional[int] = None,
        trim_silence: bool = False,
        seed: Optional[int] = None,
        settings_offset: int = 0,
        speakers_offset: int = 0,
        as_plans: bool = False,
    ) -> List[Tuple[str, Any]]:
        """Generate speech samples.

        ``as_plans=True`` (backends implementing ``plan_batch``) returns
        device ClipPlans — or host float32 audio for clips the device cannot
        express — instead of int16 PCM; it requires the native sample rate
        and no silence trimming.

        The speaker/settings grids restart at the given offsets on every
        call: callers that chunk one generation into several calls advance
        ``settings_offset`` (one per batch) and ``speakers_offset`` (one per
        clip), as ``SpeechSampleGenerator`` does.
        """
        if not isinstance(texts, list):
            texts = [texts]
        weighted: List[Tuple[str, float]] = [t if isinstance(t, tuple) else (t, 1.0) for t in texts]
        if num_samples is None:
            num_samples = len(weighted)
        target_sample_rate = target_sample_rate or self.sample_rate
        if as_plans and (trim_silence or target_sample_rate != self.sample_rate):
            raise ValueError("as_plans requires the native sample rate and trim_silence=False")

        n_speakers = self.num_speakers
        if max_speakers is not None:
            n_speakers = min(n_speakers, max_speakers)

        # grids as index math: position p of the speaker grid is the pair
        # (p // n, p % n); settings tuple b of the product grid likewise
        settings_grid = list(itertools.product(slerp_weights, length_scales, noise_scales, noise_scale_ws))
        rng = random.Random(seed)

        batch_size = max(batch_size, 1)
        num_batches = (num_samples + batch_size - 1) // batch_size
        samples: List[Tuple[str, Any]] = []
        phrases = [t for t, _ in weighted]
        probabilities = [p for _, p in weighted]

        for i in range(num_batches):
            this_batch = max(min(batch_size, num_samples - i * batch_size), 1)
            base = speakers_offset + i * batch_size
            speakers = [
                (((base + j) // n_speakers) % n_speakers, (base + j) % n_speakers) for j in range(this_batch)
            ]
            slerp_weight, length_scale, noise_scale, noise_scale_w = settings_grid[
                (settings_offset + i) % len(settings_grid)
            ]
            batch_texts = rng.choices(phrases, weights=probabilities, k=this_batch)
            batch_seed = (seed or 0) * 100003 + i

            if as_plans:
                items = self.plan_batch(
                    batch_texts, speakers, slerp_weight, length_scale, noise_scale, noise_scale_w, seed=batch_seed
                )
                samples.extend(zip(batch_texts, items))
                continue

            audio_batch = self.synthesize_batch(
                batch_texts, speakers, slerp_weight, length_scale, noise_scale, noise_scale_w, seed=batch_seed
            )
            for text, clip in zip(batch_texts, audio_batch):
                if self.sample_rate != target_sample_rate:
                    clip = resample_audio(clip, self.sample_rate, target_sample_rate)
                # peak-normalize into int16
                peak = max(0.01, float(np.abs(clip).max()))
                pcm = np.clip(clip * (32767.0 / peak), -32768, 32767).astype(np.int16)
                pcm = np.trim_zeros(pcm)
                if trim_silence:
                    pcm = self.trim_silence(pcm.astype(np.float32) / 32768.0)
                    pcm = np.clip(pcm * 32767.0, -32768, 32767).astype(np.int16)
                samples.append((text, pcm))
        return samples


def _blend_speaker_params(synth: Any, s1: int, s2: int, w: float) -> Tuple[float, float]:
    """Interpolate two formant speakers' (f0 base, vocal-tract scale)."""
    fa, sa = synth._speaker(s1)
    fb, sb = synth._speaker(s2)
    return (fa * (1.0 - w) + fb * w, sa * (1.0 - w) + sb * w)


def _clip_tasks(
    synth: FormantSynthesizer, texts: List[str], speakers: List[Tuple[int, int]], slerp_weight: float, seed: int
) -> List[Tuple[str, int, Tuple[float, float], int]]:
    """(text, speaker id, blended voice, clip seed) of each clip of a batch."""
    return [
        (text, s1 * 104729 + s2, _blend_speaker_params(synth, s1, s2, slerp_weight), seed * 31 + j)
        for j, (text, (s1, s2)) in enumerate(zip(texts, speakers))
    ]


class FormantTTS(BaseTTS):
    """Offline formant-synthesis backend (the default)."""

    def __init__(self, num_speakers: int = 904) -> None:
        super().__init__()
        self.synth = FormantSynthesizer()
        self._num_speakers = num_speakers
        self._pool = None

    @property
    def num_speakers(self) -> int:
        return self._num_speakers

    def _executor(self, workers: int):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="heybuddy-tts")
        return self._pool

    def synthesize_batch(
        self,
        texts: List[str],
        speakers: List[Tuple[int, int]],
        slerp_weight: float,
        length_scale: float,
        noise_scale: float,
        noise_scale_w: float,
        seed: int,
    ) -> List[np.ndarray]:
        tasks = _clip_tasks(self.synth, texts, speakers, slerp_weight, seed)

        def render(task: Tuple[str, int, Tuple[float, float], int]) -> np.ndarray:
            text, speaker, params, clip_seed = task
            return self.synth.synthesize(
                text, speaker=speaker, length_scale=length_scale, noise_scale=noise_scale,
                seed=clip_seed, speaker_params=params,
            )

        # Each clip renders from its own seed, so the threads' results equal
        # the serial ones (collected in submission order). The threads run
        # numpy only; no CUDA call leaves the caller's thread.
        # HEYBUDDY_TTS_THREADS overrides the count; 1 renders serially.
        env = os.environ.get("HEYBUDDY_TTS_THREADS", "").strip()
        workers = int(env) if env else min(os.cpu_count() or 1, 8)
        if workers > 1 and len(tasks) > 1:
            return list(self._executor(workers).map(render, tasks))
        return [render(t) for t in tasks]


class DeviceFormantTTS(BaseTTS):
    """The formant backend planned on the host and rendered on ``device`` ("formant-device").

    Planning is numpy-only; the render runs on the caller's thread. Clips
    longer than ``max_samples`` or with too many noise segments fall back to
    the host renderer.
    """

    def __init__(
        self,
        num_speakers: int = 904,
        max_samples: Optional[int] = None,
        harmonics: Optional[int] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        super().__init__()
        from heybuddy_tpu_torch.models.formant_device import (
            DEFAULT_HARMONICS,
            DEFAULT_MAX_SAMPLES,
            DeviceFormantPlanner,
        )

        self.planner = DeviceFormantPlanner(max_samples=max_samples or DEFAULT_MAX_SAMPLES)
        self.harmonics = harmonics or DEFAULT_HARMONICS
        self.device = device
        self._host = FormantSynthesizer()
        self._num_speakers = num_speakers

    @property
    def num_speakers(self) -> int:
        return self._num_speakers

    def synthesize_batch(
        self,
        texts: List[str],
        speakers: List[Tuple[int, int]],
        slerp_weight: float,
        length_scale: float,
        noise_scale: float,
        noise_scale_w: float,
        seed: int,
    ) -> List[np.ndarray]:
        from heybuddy_tpu_torch.models.formant_device import render_batch

        items = self.plan_batch(texts, speakers, slerp_weight, length_scale, noise_scale, noise_scale_w, seed)
        device_idx = [i for i, p in enumerate(items) if not isinstance(p, np.ndarray)]
        rendered = render_batch(
            [items[i] for i in device_idx], l_max=self.planner.max_samples, harmonics=self.harmonics,
            device=self.device,
        )
        out: List[Any] = list(items)
        for i, clip in zip(device_idx, rendered):
            out[i] = clip
        return out

    def plan_batch(
        self,
        texts: List[str],
        speakers: List[Tuple[int, int]],
        slerp_weight: float,
        length_scale: float,
        noise_scale: float,
        noise_scale_w: float,
        seed: int,
    ) -> List[Any]:
        """Per-clip ClipPlans; clips the device renderer cannot express come
        back as host-rendered float32 audio instead (consumers dispatch on
        the type)."""
        items: List[Any] = []
        for text, speaker, params, clip_seed in _clip_tasks(self._host, texts, speakers, slerp_weight, seed):
            plan = self.planner.plan(
                text, speaker=speaker, length_scale=length_scale, noise_scale=noise_scale, seed=clip_seed,
                speaker_params=params,
            )
            if plan is None:
                items.append(self._host.synthesize(
                    text, speaker=speaker, length_scale=length_scale, noise_scale=noise_scale, seed=clip_seed,
                    speaker_params=params,
                ))
            else:
                items.append(plan)
        return items


class VitsTTS(BaseTTS):
    """The VITS backend: not ported (it needs a Piper checkpoint)."""

    def __init__(self, *_args: Any, **_kwargs: Any) -> None:
        raise NotImplementedError(
            "the VITS TTS backend needs a checkpoint (HEYBUDDY_TTS_CHECKPOINT) and is not ported to "
            "heybuddy_tpu_torch; use the formant or formant-device backend"
        )


_GLOBAL_TTS: Dict[Tuple[str, str], BaseTTS] = {}


def get_tts_model(backend: Optional[str] = None, device: DeviceLike = "cuda", **kwargs: Any) -> BaseTTS:
    """
    Shared TTS instance per backend. Resolution as in the JAX package:
    explicit arg > HEYBUDDY_TTS_BACKEND > "vits" if a checkpoint exists >
    "formant". "formant-device" instances are kept per ``device``.
    """
    backend = backend or os.environ.get("HEYBUDDY_TTS_BACKEND")
    if backend is None:
        ckpt = os.environ.get("HEYBUDDY_TTS_CHECKPOINT")
        backend = "vits" if (ckpt and os.path.exists(ckpt)) else "formant"
    if backend == "device":
        backend = "formant-device"
    key = (backend, str(device) if backend == "formant-device" else "")
    if key not in _GLOBAL_TTS:
        if backend == "vits":
            _GLOBAL_TTS[key] = VitsTTS(**kwargs)
        elif backend == "formant-device":
            _GLOBAL_TTS[key] = DeviceFormantTTS(device=device, **kwargs)
        else:
            _GLOBAL_TTS[key] = FormantTTS(**kwargs)
    return _GLOBAL_TTS[key]
