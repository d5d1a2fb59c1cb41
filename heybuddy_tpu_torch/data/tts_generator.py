"""
TTS training-sample generator.

Counterpart of the JAX package's ``data/tts_generator.py`` (numpy and the
host TTS only): wraps the TTS engine as a streaming sample generator
producing positive or phonetically-adversarial speech, with "{phrase}.
{word}" phrase augmentation weighting (probability mass split across 100 lead
words). For the same arguments the texts, grid offsets and seeds of every
batch are the JAX package's. ``device`` is where the "formant-device"
backend renders.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from heybuddy_tpu_torch.constants import (
    DEFAULT_ADVERSARIAL_PHRASES,
    DEFAULT_AUGMENT_PHRASE_PROB,
    DEFAULT_AUGMENT_PHRASE_WORDS,
    DEFAULT_TTS_BATCH_SIZE,
    DEFAULT_TTS_LENGTH_SCALES,
    DEFAULT_TTS_NOISE_SCALE_WEIGHTS,
    DEFAULT_TTS_NOISE_SCALES,
    DEFAULT_TTS_SLERP_WEIGHTS,
    SAMPLE_RATE,
)
from heybuddy_tpu_torch.device import DeviceLike
from heybuddy_tpu_torch.utils.profiling import span

__all__ = ["SpeechSampleGenerator"]


class SpeechSampleGenerator:
    """Streaming positive / adversarial speech sample generator."""

    def __init__(
        self,
        phrase: Union[str, List[str]],
        adversarial: bool = False,
        num_adversarial_texts: int = DEFAULT_ADVERSARIAL_PHRASES,
        custom_adversarial_texts: Optional[Sequence[str]] = None,
        additional_phrases: Optional[Sequence[str]] = None,
        batch_size: int = DEFAULT_TTS_BATCH_SIZE,
        slerp_weights: Sequence[float] = DEFAULT_TTS_SLERP_WEIGHTS,
        length_scales: Sequence[float] = DEFAULT_TTS_LENGTH_SCALES,
        noise_scales: Sequence[float] = DEFAULT_TTS_NOISE_SCALES,
        noise_scale_ws: Sequence[float] = DEFAULT_TTS_NOISE_SCALE_WEIGHTS,
        phrase_augment_prob: float = DEFAULT_AUGMENT_PHRASE_PROB,
        phrase_augment_words: Sequence[str] = tuple(DEFAULT_AUGMENT_PHRASE_WORDS),
        max_speakers: Optional[int] = None,
        target_sample_rate: int = SAMPLE_RATE,
        tts_backend: Optional[str] = None,
        seed: Optional[int] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        if isinstance(phrase, list):
            self.phrase = phrase[0]
            self.additional_phrases = list(phrase[1:]) + list(additional_phrases or [])
        else:
            self.phrase = phrase
            self.additional_phrases = list(additional_phrases or [])
        self.adversarial = adversarial
        self.num_adversarial_texts = num_adversarial_texts
        self.custom_adversarial_texts = custom_adversarial_texts
        self.batch_size = batch_size
        self.slerp_weights = tuple(slerp_weights)
        self.length_scales = tuple(length_scales)
        self.noise_scales = tuple(noise_scales)
        self.noise_scale_ws = tuple(noise_scale_ws)
        self.phrase_augment_prob = phrase_augment_prob
        self.phrase_augment_words = list(phrase_augment_words)
        self.max_speakers = max_speakers
        self.target_sample_rate = target_sample_rate
        self.tts_backend = tts_backend
        self.seed = seed
        self.device = device
        self._adversarial_texts: Optional[List[str]] = None
        self._model = None

    @property
    def model(self) -> Any:
        if self._model is None:
            from heybuddy_tpu_torch.models.tts import get_tts_model

            self._model = get_tts_model(backend=self.tts_backend, device=self.device)
        return self._model

    def get_adversarial_texts(self) -> List[str]:
        """The adversarial prompt list (custom texts first, then generated ones)."""
        if self._adversarial_texts is None:
            custom = list(self.custom_adversarial_texts or [])
            to_generate = max(self.num_adversarial_texts - len(custom), 0)
            if to_generate > 0:
                from heybuddy_tpu_torch.text.adversarial import get_adversarial_text_generator

                generator = get_adversarial_text_generator()
                custom += list(generator(self.phrase, num_samples=to_generate, seed=self.seed))
            texts = [t for t in custom if t not in self.additional_phrases and t != self.phrase]
            assert texts, "No adversarial texts generated"
            self._adversarial_texts = texts
        return self._adversarial_texts

    def get_texts(self) -> List[Tuple[str, float]]:
        """Weighted prompt list incl. phrase augmentation."""
        if self.adversarial:
            unaugmented = self.get_adversarial_texts()
        else:
            unaugmented = [self.phrase] + self.additional_phrases

        augmented: List[Tuple[str, float]] = []
        if self.phrase_augment_prob > 0.0 and self.phrase_augment_words:
            weight = self.phrase_augment_prob / (len(unaugmented) * len(self.phrase_augment_words))
            for phrase in unaugmented:
                for word in self.phrase_augment_words:
                    augmented.append((f"{phrase}. {word}", weight))

        return [(u, 1.0) for u in unaugmented] + augmented

    def __call__(self, num_samples: int, yield_plans: bool = False,
                 **kwargs: Any) -> Iterator[Dict[str, Any]]:
        """Yield ``{"audio": {"array", "sampling_rate"}, "phrase"}`` samples;
        with ``yield_plans=True`` (device TTS backends), ``{"plan", "phrase"}``
        dicts for the fused device pipeline — clips the device cannot express
        arrive as float32 audio dicts instead, so consumers must handle both.

        Generation is chunked one batch per model call to bound host RAM, and
        the model restarts its speaker/settings grids per call, so the grid
        offsets MUST advance with the batch index — without them every batch
        rendered speaker pair (0, 0) at the first settings tuple, flattening
        all TTS diversity out of every feature cache (found round 3; the same
        iterator-restart contract previously collapsed embeddings v1-v5).
        """
        texts = self.get_texts()
        total_batches = int(np.ceil(num_samples / self.batch_size))
        generated = 0
        for i in range(total_batches):
            batch_samples = min(num_samples - i * self.batch_size, self.batch_size)
            with span("tts/samples"):  # the batch's text and speaker draws and its model call
                batch = self.model(
                    texts=texts,
                    num_samples=batch_samples,
                    batch_size=self.batch_size,
                    slerp_weights=self.slerp_weights,
                    length_scales=self.length_scales,
                    noise_scales=self.noise_scales,
                    noise_scale_ws=self.noise_scale_ws,
                    max_speakers=self.max_speakers,
                    target_sample_rate=self.target_sample_rate,
                    seed=None if self.seed is None else self.seed + i,
                    settings_offset=i,
                    speakers_offset=i * self.batch_size,
                    as_plans=yield_plans,
                )
            for text, audio in batch:
                generated += 1
                if yield_plans and not isinstance(audio, np.ndarray):
                    yield {"plan": audio, "phrase": text}
                else:
                    yield {
                        "audio": {
                            "array": audio,
                            "sampling_rate": self.target_sample_rate,
                        },
                        "phrase": text,
                    }
