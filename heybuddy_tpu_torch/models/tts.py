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
* :class:`VitsTTS` ("vits") — the VITS synthesizer (``models/vits``) on
  ``device``: a Piper checkpoint from ``HEYBUDDY_TTS_CHECKPOINT`` (``.pt`` or
  ``.safetensors``; an optional voice config JSON at ``HEYBUDDY_TTS_CONFIG``
  supplies the phoneme-id and speaker maps), or, without one, seeded random
  weights and a warning. Texts are phonemized by the rule G2P and mapped
  ARPAbet -> IPA -> ids.

``trim_silence`` cuts synthesis silence with the shared VAD (``models/vad.py``).
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    DEFAULT_TTS_LENGTH_SCALES,
    DEFAULT_TTS_NOISE_SCALE_WEIGHTS,
    DEFAULT_TTS_NOISE_SCALES,
    DEFAULT_TTS_SLERP_WEIGHTS,
    SAMPLE_RATE,
)
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.formant import FormantSynthesizer
from heybuddy_tpu_torch.text.phonemizer import get_phonemizer
from heybuddy_tpu_torch.utils.audio_io import resample_audio
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.profiling import span

__all__ = [
    "BaseTTS",
    "FormantTTS",
    "DeviceFormantTTS",
    "VitsTTS",
    "get_tts_model",
    "arpabet_to_ipa",
    "SAMPLING_VERSION",
]

TextsType = Union[str, List[str], List[Tuple[str, float]]]

# Version of the sampling contract feeding feature caches (speaker/settings
# grid traversal), the JAX package's: chunked generation advances the grid
# offsets per batch since version 2.
SAMPLING_VERSION = 2

# ARPAbet -> espeak-style IPA used by Piper voices
_ARPA_TO_IPA: Dict[str, str] = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "EH": "ɛ", "ER": "ɚ", "EY": "eɪ", "IH": "ɪ", "IY": "i", "OW": "oʊ",
    "OY": "ɔɪ", "UH": "ʊ", "UW": "u",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpabet_to_ipa(phones: List[List[str]]) -> str:
    """Word-phone lists -> IPA string with spaces between words."""
    words = ["".join(_ARPA_TO_IPA.get(p, "") for p in word) for word in phones]
    return " ".join(w for w in words if w)


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
            with span("tts/resample"):  # resample, normalise, int16, trim
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


# A formant clip's voice, in ``DeviceFormantPlanner.plan_batch``'s column order:
# (text, speaker id, length scale, noise scale, clip seed, blended (f0, scale)).
ClipVoice = Tuple[str, int, float, float, int, Tuple[float, float]]


def _clip_tasks(
    synth: FormantSynthesizer, texts: List[str], speakers: List[Tuple[int, int]], slerp_weight: float,
    length_scale: float, noise_scale: float, seed: int,
) -> List[ClipVoice]:
    """The voice of each clip of a batch."""
    return [
        (text, s1 * 104729 + s2, length_scale, noise_scale, seed * 31 + j,
         _blend_speaker_params(synth, s1, s2, slerp_weight))
        for j, (text, (s1, s2)) in enumerate(zip(texts, speakers))
    ]


def _synthesize_voice(synth: FormantSynthesizer, voice: ClipVoice) -> np.ndarray:
    """A clip rendered by the host synthesizer."""
    text, speaker, length_scale, noise_scale, clip_seed, params = voice
    return synth.synthesize(text, speaker=speaker, length_scale=length_scale, noise_scale=noise_scale,
                            seed=clip_seed, speaker_params=params)


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
        tasks = _clip_tasks(self.synth, texts, speakers, slerp_weight, length_scale, noise_scale, seed)
        render = functools.partial(_synthesize_voice, self.synth)
        # Each clip renders from its own seed, so the threads' results equal
        # the serial ones (collected in submission order). The threads run
        # numpy only; no CUDA call leaves the caller's thread.
        # HEYBUDDY_TTS_THREADS overrides the count; 1 renders serially.
        env = os.environ.get("HEYBUDDY_TTS_THREADS", "").strip()
        workers = int(env) if env else min(os.cpu_count() or 1, 8)
        if workers > 1 and len(tasks) > 1:
            return list(self._executor(workers).map(render, tasks))
        return [render(t) for t in tasks]


# the "formant-device" backend's batch where the caller sets none: it renders a batch a call
DEVICE_TTS_BATCH = 128


class DeviceFormantTTS(BaseTTS):
    """The formant backend planned on the host and rendered on ``device`` ("formant-device").

    Planning is numpy-only; the render runs on the caller's thread. Clips
    longer than ``max_samples`` or with too many noise segments fall back to
    the host renderer: ``plan_voices`` and ``render_items`` hold that rule for
    the generator's batches and the embedding pretrainer's clip pool alike.
    Counters over every ``plan_voices`` call, the pretrainer's included:
    ``clips_planned`` (device plans) and ``clips_host_fallback`` (clips
    rendered on the host instead).
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
        self.clips_planned = self.clips_host_fallback = 0

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
        return self.render_items(
            self.plan_batch(texts, speakers, slerp_weight, length_scale, noise_scale, noise_scale_w, seed))

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
        """``plan_voices`` of a generator batch's clips."""
        with span("formant/plan"):
            return self.plan_voices(
                _clip_tasks(self._host, texts, speakers, slerp_weight, length_scale, noise_scale, seed))

    def voice(
        self, text: str, speakers: Tuple[int, int], slerp_weight: float, length_scale: float, noise_scale: float,
        seed: int,
    ) -> ClipVoice:
        """The voice of a one-clip batch's clip."""
        return _clip_tasks(self._host, [text], [speakers], slerp_weight, length_scale, noise_scale, seed)[0]

    def plan_voices(self, voices: List[ClipVoice]) -> List[Any]:
        """Per-clip ClipPlans, planned together; clips the device renderer
        cannot express come back as host-rendered float32 audio instead
        (consumers dispatch on the type)."""
        plans = self.planner.plan_batch(*zip(*voices))
        items = [_synthesize_voice(self._host, voice) if plan is None else plan
                 for voice, plan in zip(voices, plans)]
        fallback = sum(plan is None for plan in plans)
        self.clips_planned += len(plans) - fallback
        self.clips_host_fallback += fallback
        return items

    def render_items(self, items: List[Any]) -> List[np.ndarray]:
        """``plan_voices``' items as audio: the plans rendered in one batch on
        ``device``, each back in its place among the host-rendered clips."""
        from heybuddy_tpu_torch.models.formant_device import render_batch

        rendered = iter(render_batch([p for p in items if not isinstance(p, np.ndarray)],
                                     l_max=self.planner.max_samples, harmonics=self.harmonics, device=self.device))
        return [p if isinstance(p, np.ndarray) else next(rendered) for p in items]


class VitsTTS(BaseTTS):
    """
    The VITS backend on ``device``. The weights come from ``checkpoint_path``
    or ``HEYBUDDY_TTS_CHECKPOINT`` (``import_torch_checkpoint``); without a
    file, ``init_params`` from a CPU generator seeded with 0 (random
    weights make noise-like audio: the formant backends are the offline
    voices). A batch pads its ids to a multiple of 16 and synthesizes into a
    static frame budget, ``max_frames`` = 64 * ceil(2 t_x max(length scale, 1) / 64),
    which clips the longest clips as the JAX backend does; its noise comes
    from a generator on ``device`` seeded with the batch seed.

    Counters over every batch synthesized: ``frames_budgeted`` (b x
    max_frames a batch), ``frames_used`` (the frames of the clips' audio)
    and ``clips_clipped`` (clips that fill the budget: those it cut, and any
    that fit it exactly). Each batch is the spans ``vits/inputs`` (ids,
    speaker slerp, budget, the upload), ``vits/infer`` and ``vits/download``
    (the audio's copy back).
    """

    model_sample_rate = 22050

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        config_path: Optional[str] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        super().__init__()
        from heybuddy_tpu_torch.models.vits import Vits, VitsConfig, import_torch_checkpoint, init_params
        from heybuddy_tpu_torch.text.piper_maps import piper_phoneme_id_map, piper_speaker_id_map

        self.device = resolve_device(device)
        self.config = VitsConfig()
        self.sample_rate = self.model_sample_rate
        checkpoint_path = checkpoint_path or os.environ.get("HEYBUDDY_TTS_CHECKPOINT")
        config_path = config_path or os.environ.get("HEYBUDDY_TTS_CONFIG")

        # the piper-phonemize tables, unless the voice's own config has them
        self.phoneme_id_map: Dict[str, List[int]] = dict(piper_phoneme_id_map())
        self.speaker_id_map: Dict[str, int] = dict(piper_speaker_id_map())
        if config_path and os.path.exists(config_path):
            with open(config_path) as f:
                voice_config = json.load(f)
            self.phoneme_id_map = voice_config.get("phoneme_id_map", self.phoneme_id_map)
            self.speaker_id_map = voice_config.get("speaker_id_map", self.speaker_id_map)
            self.sample_rate = voice_config.get("audio", {}).get("sample_rate", self.model_sample_rate)

        if checkpoint_path and os.path.exists(checkpoint_path):
            self.model = import_torch_checkpoint(checkpoint_path, self.config, self.device)
            logger.info(f"Loaded VITS checkpoint from {checkpoint_path}")
        else:
            logger.warning(
                "No VITS checkpoint found; using random weights (noise audio). "
                "Set HEYBUDDY_TTS_CHECKPOINT, or use the formant backend."
            )
            params = init_params(torch.Generator().manual_seed(0), self.config)
            self.model = Vits.from_jax_params(params, self.config, device=self.device)
        self.model.eval()
        self._speaker_table = self.model.emb_g.weight.detach().cpu().numpy()
        self.frames_budgeted = self.frames_used = self.clips_clipped = 0

    @property
    def num_speakers(self) -> int:
        return self.config.n_speakers

    def resolve_speaker(self, speaker: Any) -> int:
        """Speaker NAME (e.g. LibriTTS "3922") or integer id -> integer id."""
        if isinstance(speaker, str) and not speaker.isdigit():
            raise KeyError(f"Unknown speaker name {speaker!r}")
        if isinstance(speaker, str):
            return int(self.speaker_id_map.get(speaker, speaker))
        return int(speaker)

    def phonemize_ids(self, text: str) -> List[int]:
        """Text -> ids interspersed with pad, between BOS and EOS (Piper's convention)."""
        ipa = arpabet_to_ipa([self.phonemizer.word_phones(w) for w in text.split()])
        ids: List[int] = list(self.phoneme_id_map.get("^", [1]))
        pad = self.phoneme_id_map.get("_", [0])
        for char in ipa:
            if char in self.phoneme_id_map:
                ids.extend(self.phoneme_id_map[char])
                ids.extend(pad)
        ids.extend(self.phoneme_id_map.get("$", [2]))
        return ids

    @staticmethod
    def _slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
        a_norm = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-9)
        b_norm = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-9)
        dot = np.clip((a_norm * b_norm).sum(-1), -1.0, 1.0)
        if (np.abs(dot) > 0.9995).any():
            return (1 - t) * a + t * b
        theta = np.arccos(dot)
        s1 = np.sin(theta - theta * t) / np.sin(theta)
        s2 = np.sin(theta * t) / np.sin(theta)
        return s1[..., None] * a + s2[..., None] * b

    def batch_inputs(
        self, texts: List[str], speakers: List[Tuple[int, int]], slerp_weight: float, length_scale: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """(ids (b, t_x) zero-padded to a multiple of 16, lengths, speaker vectors, max_frames)."""
        id_lists = [self.phonemize_ids(t) for t in texts]
        lengths = np.array([len(ids) for ids in id_lists], dtype=np.int32)
        t_x = int(np.ceil(max(lengths) / 16) * 16)
        ids = np.zeros((len(texts), t_x), dtype=np.int32)
        for i, lst in enumerate(id_lists):
            ids[i, : len(lst)] = lst
        s1 = self._speaker_table[[s[0] for s in speakers]]
        s2 = self._speaker_table[[s[1] for s in speakers]]
        speaker_embedding = self._slerp(s1, s2, slerp_weight).astype(np.float32)
        max_frames = int(np.ceil(t_x * 2 * max(length_scale, 1.0) / 64) * 64)
        return ids, lengths, speaker_embedding, max_frames

    @torch.no_grad()
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
        dev = self.device
        with span("vits/inputs"):
            ids, lengths, speaker_embedding, max_frames = self.batch_inputs(
                texts, speakers, slerp_weight, length_scale)
            args = (torch.from_numpy(ids).long().to(dev), torch.from_numpy(lengths).to(dev),
                    torch.from_numpy(speaker_embedding).to(dev))
            generator = torch.Generator(device=dev).manual_seed(seed)
        audio, audio_lengths = self.model.infer(
            *args, noise_scale=noise_scale, length_scale=length_scale, noise_scale_w=noise_scale_w,
            max_frames=max_frames, generator=generator,
        )
        with span("vits/download"):
            audio_np = audio.cpu().numpy()
            audio_lengths_np = audio_lengths.cpu().numpy()
        budget = max_frames * self.config.hop_samples
        self.frames_budgeted += len(texts) * max_frames
        self.frames_used += int(audio_lengths_np.sum()) // self.config.hop_samples
        self.clips_clipped += int((audio_lengths_np == budget).sum())
        return [audio_np[i, : int(n)] for i, n in enumerate(audio_lengths_np)]


_GLOBAL_TTS: Dict[Tuple[str, str], BaseTTS] = {}


def resolve_tts_backend(backend: Optional[str] = None) -> str:
    """The TTS backend, as the JAX package resolves it (every user of the name
    asks this): explicit arg > ``HEYBUDDY_TTS_BACKEND`` > "vits" if
    ``HEYBUDDY_TTS_CHECKPOINT`` names a file > "formant"; "device" is "formant-device"."""
    backend = backend or os.environ.get("HEYBUDDY_TTS_BACKEND")
    if backend is None:
        ckpt = os.environ.get("HEYBUDDY_TTS_CHECKPOINT")
        backend = "vits" if (ckpt and os.path.exists(ckpt)) else "formant"
    return "formant-device" if backend == "device" else backend


def get_tts_model(backend: Optional[str] = None, device: DeviceLike = "cuda", **kwargs: Any) -> BaseTTS:
    """Shared TTS instance of ``resolve_tts_backend(backend)``; "formant-device"
    and "vits" instances are kept per ``device``."""
    backend = resolve_tts_backend(backend)
    key = (backend, str(device) if backend in ("formant-device", "vits") else "")
    if key not in _GLOBAL_TTS:
        if backend == "vits":
            _GLOBAL_TTS[key] = VitsTTS(device=device, **kwargs)
        elif backend == "formant-device":
            _GLOBAL_TTS[key] = DeviceFormantTTS(device=device, **kwargs)
        else:
            _GLOBAL_TTS[key] = FormantTTS(**kwargs)
    return _GLOBAL_TTS[key]
