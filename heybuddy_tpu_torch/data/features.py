"""
The classifier's feature caches for a wake phrase: the cache half of the JAX
package's ``data/features.py``.

``TrainingFeaturesGenerator`` names each cache as the JAX package does
(``safe_name(phrase)`` plus ``-adversarial`` / ``-partial`` / ``-testing`` /
``-validation`` / ``-clean-offset`` / ``-reverb``, the stream-window and
negative-speech names), drops a cache whose space sidecar is stale
(``data/space.py``), and returns a
``PrecalculatedDatasetIterator`` over a cache that holds at least the rows
asked for, stamping its sidecar. A cache that is missing or short raises
``MissingFeaturesError``: generating features (TTS, then augmentation, then
featurization) is not ported yet, and the port never fills a cache with
anything else. The generation options (augmentation, TTS backend, adversarial
texts) are accepted and kept, as the JAX package keeps them for generation.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Union

from heybuddy_tpu_torch.constants import RUNTIME_WINDOW_STRIDE, SAMPLE_RATE
from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator, get_default_dataset_dir
from heybuddy_tpu_torch.data.space import active_space, check_cache_space, write_space_sidecar
from heybuddy_tpu_torch.device import DeviceLike
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.npy import AppendableNpyFile
from heybuddy_tpu_torch.utils.strings import safe_name

__all__ = ["TrainingFeaturesGenerator", "MissingFeaturesError"]


class MissingFeaturesError(RuntimeError):
    """A feature cache holds fewer rows than asked for, and generation is not ported."""


def _texts_sidecar_path(npy_path: str) -> str:
    return os.path.splitext(npy_path)[0] + ".texts.json"


def _remove_cache(npy_path: str) -> None:
    """Remove a stale cache .npy together with its texts sidecar."""
    os.remove(npy_path)
    sidecar = _texts_sidecar_path(npy_path)
    if os.path.exists(sidecar):
        os.remove(sidecar)


class TrainingFeaturesGenerator:
    """The feature caches of a wake phrase, read from ``directory``."""

    def __init__(
        self,
        phrase: Union[str, List[str]],
        directory: Optional[str] = None,
        augment_config: Optional[Any] = None,
        seed: int = 0,
        tts_backend: Optional[str] = None,
        device: DeviceLike = "cuda",
        **generator_kwargs: Any,
    ) -> None:
        self.phrase = phrase
        self.phrase_key = phrase if isinstance(phrase, str) else " ".join(phrase)
        self.directory = directory or get_default_dataset_dir()
        self.augment_config = augment_config
        self.seed = seed
        self.tts_backend = tts_backend
        self.device = device
        self.generator_kwargs = generator_kwargs

    def _cache_name(
        self, adversarial: bool, testing: bool, validation: bool, partial: bool = False
    ) -> str:
        name = safe_name(self.phrase_key)
        if adversarial:
            name += "-adversarial"
        if partial:
            name += "-partial"
        if testing:
            name += "-testing"
        if validation:
            name += "-validation"
        return name

    def _cached(self, name: str, num_samples: int, kind: str, seed: Optional[int] = None) -> PrecalculatedDatasetIterator:
        """The iterator over cache ``name`` when it holds ``num_samples`` rows; raises otherwise."""
        path = os.path.join(self.directory, f"{name}.npy")
        if os.path.exists(path) and not check_cache_space(path, self.tts_backend, self.device):
            _remove_cache(path)
        existing = len(AppendableNpyFile(path)) if os.path.exists(path) else 0
        if existing < num_samples:
            raise MissingFeaturesError(
                f"feature cache {path} holds {existing} rows of {kind} features but "
                f"{num_samples} are needed ({num_samples - existing} missing). Generating "
                "features (TTS, ROADMAP Queue 1 item 13, and augmentation, item 8) is not "
                "ported yet: build the cache with the JAX package's generator or the port's "
                "featurizer, or ask for fewer samples."
            )
        write_space_sidecar(path, active_space(self.tts_backend, self.device))
        logger.info(f"Using {num_samples} cached {kind} features for '{name}'")
        return PrecalculatedDatasetIterator(
            name, directory=self.directory, seed=self.seed if seed is None else seed
        )

    def _get_features(
        self,
        num_samples: int,
        adversarial: bool,
        testing: bool,
        validation: bool,
        adversarial_phrases: Optional[int] = None,
    ) -> PrecalculatedDatasetIterator:
        kind = ("pad-only validation" if validation else "augmented") + (
            " adversarial" if adversarial else " positive"
        )
        return self._cached(self._cache_name(adversarial, testing, validation), num_samples, kind)

    def get_training_features(
        self,
        num_samples: int,
        adversarial: bool = False,
        adversarial_phrases: Optional[int] = None,
        testing: bool = False,
    ) -> PrecalculatedDatasetIterator:
        """Augmented training (or testing) features."""
        return self._get_features(num_samples, adversarial, testing, False, adversarial_phrases)

    def get_validation_features(self, num_samples: int, testing: bool = False) -> PrecalculatedDatasetIterator:
        """Pad-only positive validation features (``testing``: the disjoint held-out cache)."""
        return self._get_features(num_samples, adversarial=False, testing=testing, validation=True)

    def get_partial_phrase_features(
        self,
        num_samples: int,
        adversarial: bool = False,
        testing: bool = False,
        min_visible: Optional[float] = None,
        max_visible: Optional[float] = None,
        adversarial_phrases: Optional[int] = None,
    ) -> PrecalculatedDatasetIterator:
        """Sliding-offset partial views of the phrase (or its adversaries), labeled negative."""
        name = self._cache_name(adversarial, testing, False, partial=True)
        return self._cached(name, num_samples, "partial-view")

    def get_clean_offset_features(
        self,
        num_samples: int,
        adversarial: bool = False,
        testing: bool = False,
        adversarial_phrases: Optional[int] = None,
    ) -> PrecalculatedDatasetIterator:
        """Unaugmented clips at random window offsets."""
        name = self._cache_name(adversarial, testing, False) + "-clean-offset"
        return self._cached(name, num_samples, "clean-offset")

    def get_reverb_positive_features(self, num_samples: int, testing: bool = False) -> PrecalculatedDatasetIterator:
        """Reverb-only positives."""
        name = self._cache_name(False, testing, False) + "-reverb"
        return self._cached(name, num_samples, "reverb-positive")

    def get_stream_window_features(
        self,
        num_samples: int,
        adversarial: bool = False,
        seed: Optional[int] = None,
        collision: bool = False,
    ) -> PrecalculatedDatasetIterator:
        """Sliding-window negatives of a continuous stream, rows in temporal order."""
        if collision and adversarial:
            raise ValueError("collision and adversarial are mutually exclusive")
        seed = self.seed if seed is None else seed
        kind = "collision-stream" if collision else "adversarial-stream" if adversarial else "speech-stream"
        slug = safe_name(self.phrase_key)
        name = f"{slug}-{kind}-{seed}" if (adversarial or collision) else f"negative-{kind}-{seed}-x{slug}"
        iterator = self._cached(name, num_samples, f"{kind} window", seed=seed)
        # rows in temporal order at the runtime stride: gate-aware consumers
        # (the trainer's validation) count fires per true stream hour
        iterator.stream_stride_seconds = RUNTIME_WINDOW_STRIDE / SAMPLE_RATE
        return iterator

    def get_negative_speech_features(
        self, num_samples: int, num_texts: int = 400, seed: Optional[int] = None
    ) -> PrecalculatedDatasetIterator:
        """Ordinary-speech negatives, shared across wake phrases."""
        seed = self.seed if seed is None else seed
        return self._cached(f"negative-speech-{num_texts}-{seed}", num_samples, "negative-speech", seed=seed)
