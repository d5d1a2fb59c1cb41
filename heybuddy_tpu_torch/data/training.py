"""
Threaded batch assembly for the wake-word trainer, and its device-resident plan.

Counterpart of the JAX package's ``data/training.py``: N daemon producer
threads each assemble ``(x, y)`` numpy batches from (positive x bs, negative
x bs) dataset iterators onto a bounded queue; the consumer iterates with a
timeout and restarts dead producers. ``DeviceBatchPlan`` serves the same
sources as per-source row indices into pools the trainer uploads to the
device once. The factories (``default``, ``validation``, ``testing``,
``all``) wire the phrase's feature caches (``data/features.py``) and the
hosted negative sets together, with the JAX package's names, defaults and
space checks; ``device`` (in the feature options) names the featurizer whose
space is active.

Under a mesh of several ranks the ranks serve what JAX's one program
serves: ``train --mesh`` builds every source that takes no seed of its own
(the hosted negative sets, ``--training-dataset``) with a seed that rank 0
drew (``negative_seed``), so the device-resident plan draws the same indices
on every rank; and with ``mesh`` set on an iterator, the threaded host path,
whose batch order follows its threads' timing, runs its threads on rank 0
alone and gives every rank rank 0's batches.
"""

from __future__ import annotations

import os
import queue
import threading
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from heybuddy_tpu_torch.constants import (
    DEFAULT_ADVERSARIAL_BATCH_SIZE,
    DEFAULT_ADVERSARIAL_PHRASES,
    DEFAULT_ADVERSARIAL_SAMPLES,
    DEFAULT_BATCH_THREADS,
    DEFAULT_NEGATIVE_BATCH_SIZE,
    DEFAULT_PARTIAL_BATCH_SIZE,
    DEFAULT_POSITIVE_BATCH_SIZE,
    DEFAULT_POSITIVE_SAMPLES,
    DEFAULT_TESTING_ADVERSARIAL_SAMPLES,
    DEFAULT_TESTING_POSITIVE_SAMPLES,
    DEFAULT_VALIDATION_NEGATIVE_BATCH_SIZE,
    DEFAULT_VALIDATION_POSITIVE_BATCH_SIZE,
    DEFAULT_VALIDATION_SAMPLES,
)
from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
from heybuddy_tpu_torch.data.precalculated import (
    PrecalculatedDatasetIterator,
    PrecalculatedTrainingDatasetLarge,
    PrecalculatedTrainingDatasetMedium,
    PrecalculatedValidationDataset,
    get_default_dataset_dir,
)
from heybuddy_tpu_torch.data.space import hosted_sets_compatible
from heybuddy_tpu_torch.device import DeviceLike
from heybuddy_tpu_torch.parallel.mesh import Mesh, broadcast_batch
from heybuddy_tpu_torch.utils.log import logger

__all__ = [
    "TrainingDatasetIterator",
    "WakeWordTrainingDatasetIterator",
    "DeviceBatchPlan",
]

Batch = Tuple[np.ndarray, np.ndarray]
DatasetSpec = Tuple[PrecalculatedDatasetIterator, int]


class DeviceBatchPlan:
    """
    Device-resident serving plan for a WakeWordTrainingDatasetIterator whose
    sources are all index-addressable arrays: ``pools`` hold each source's
    exclude-filtered feature rows (the trainer uploads them to the device
    once, and re-uses the uploads across training stages), and ``sample()`` returns
    per-source row indices with the same shuffled-cursor wraparound semantics
    as the threaded take() path. Batch-size changes between stages
    (multiply_batch_size) are picked up live from the iterator's spec lists.
    """

    def __init__(
        self,
        iterator: "WakeWordTrainingDatasetIterator",
        specs: List[Tuple[PrecalculatedDatasetIterator, int, float]],
    ) -> None:
        # weak: the trainer caches plans keyed by iterator identity with
        # weakref eviction — a strong reference here would pin the iterator
        # (and its device pools) forever
        self._iterator_ref = weakref.ref(iterator)
        self.sources: List[Tuple[PrecalculatedDatasetIterator, float]] = [
            (ds, label) for ds, _, label in specs
        ]
        pool_cache: Dict[int, np.ndarray] = {}
        self.pools: List[np.ndarray] = []
        for ds, _ in self.sources:
            if id(ds) not in pool_cache:
                pool_cache[id(ds)] = ds.resident_features()
            self.pools.append(pool_cache[id(ds)])

    @property
    def labels(self) -> Tuple[float, ...]:
        return tuple(label for _, label in self.sources)

    def counts(self) -> Tuple[int, ...]:
        iterator = self._iterator_ref()
        if iterator is None:
            raise RuntimeError("DeviceBatchPlan outlived its training iterator")
        by_id = {
            id(ds): bs
            for ds, bs in list(iterator.positive) + list(iterator.negative)
        }
        return tuple(by_id[id(ds)] for ds, _ in self.sources)

    def sample(self) -> Tuple[np.ndarray, ...]:
        counts = self.counts()
        return tuple(
            ds.take_indices(bs, len(pool))
            for (ds, _), pool, bs in zip(self.sources, self.pools, counts)
        )


class TrainingDatasetIterator:
    """Bounded-queue batch producer/consumer. With ``mesh`` set the producers
    run on rank 0 alone and every rank yields rank 0's batches."""

    mesh: Optional[Mesh] = None

    def __init__(
        self,
        max_samples: Optional[int] = None,
        num_batch_threads: int = 2,
        max_queued_batches: int = 100,
        start: bool = False,
    ) -> None:
        self.total_yielded_samples = 0
        self.max_samples = max_samples
        self.num_batch_threads = num_batch_threads
        self.queue: "queue.Queue[Batch]" = queue.Queue(max_queued_batches)
        self.threads: List[Tuple[threading.Thread, threading.Event]] = []
        self.started = False
        if start:
            self.start()

    def metadata(self) -> Dict[str, Any]:
        return {
            "max_samples": self.max_samples,
            "num_batch_threads": self.num_batch_threads,
        }

    def start(self) -> None:
        if self.started or (self.mesh is not None and self.mesh.rank != 0):
            return
        self.started = True
        logger.info(f"Starting batch generation with {self.num_batch_threads} threads")
        for _ in range(self.num_batch_threads):
            stop_event = threading.Event()
            thread = threading.Thread(target=self._generate_batches, args=(stop_event,), daemon=True)
            thread.start()
            self.threads.append((thread, stop_event))

    def check_restart(self) -> None:
        """Restart any dead producer thread."""
        if not self.started:
            self.start()
            return
        for i, (thread, event) in enumerate(self.threads):
            if not thread.is_alive():
                logger.warning(f"Batch generation thread {i} has stopped, restarting")
                event.clear()
                new_thread = threading.Thread(
                    target=self._generate_batches, args=(event,), daemon=True
                )
                new_thread.start()
                self.threads[i] = (new_thread, event)

    def stop(self) -> None:
        for _, stop_event in self.threads:
            stop_event.set()
        for thread, _ in self.threads:
            thread.join(timeout=5)
        self.threads.clear()
        with self.queue.mutex:
            self.queue.queue.clear()
        self.started = False

    def iterate(self) -> Iterator[Batch]:
        if self.mesh is None:
            yield from self._iterate_queue()
            return
        batches = self._iterate_queue() if self.mesh.rank == 0 else None
        while True:
            batch = broadcast_batch(None if batches is None else next(batches, None), self.mesh)
            if batch is None:
                return
            yield batch

    def _iterate_queue(self) -> Iterator[Batch]:
        yielded = 0
        while True:
            try:
                item = self.queue.get(timeout=1)
                yielded += 1
                self.total_yielded_samples += 1
                yield item
                if self.max_samples is not None and yielded >= self.max_samples:
                    break
                if self.total_yielded_samples % 10 == 0:
                    self.check_restart()
            except queue.Empty:
                self.check_restart()

    def __iter__(self) -> Iterator[Batch]:
        return self.iterate()

    def _generate_batches(self, stop_event: threading.Event) -> None:
        raise NotImplementedError


class WakeWordTrainingDatasetIterator(TrainingDatasetIterator):
    """
    Assembles (positive, negative) feature batches with labels and wires the
    phrase's caches and the hosted sets together through the factory
    classmethods.
    """

    def __init__(
        self,
        max_samples: Optional[int] = None,
        num_batch_threads: int = 2,
        max_queued_batches: int = 100,
        start: bool = False,
        positive: Optional[List[DatasetSpec]] = None,
        negative: Optional[List[DatasetSpec]] = None,
    ) -> None:
        super().__init__(
            max_samples=max_samples,
            num_batch_threads=num_batch_threads,
            max_queued_batches=max_queued_batches,
            start=start,
        )
        positive = positive or []
        negative = negative or []
        assert positive or negative, "At least one positive or negative dataset is required"
        self.positive = positive
        self.negative = negative

    def metadata(self) -> Dict[str, Any]:
        return {
            **super().metadata(),
            "positive": [
                {"length": len(ds), "batch_size": bs, "metadata": ds.metadata()}
                for ds, bs in self.positive
            ],
            "negative": [
                {"length": len(ds), "batch_size": bs, "metadata": ds.metadata()}
                for ds, bs in self.negative
            ],
        }

    def summary(self) -> str:
        lines = [f"Total batches yielded: {self.total_yielded_samples}"]
        for label, specs in (("Positive", self.positive), ("Negative", self.negative)):
            for i, (dataset, batch_size) in enumerate(specs):
                taken, unique = dataset.total_taken, len(dataset)
                lines.append(
                    f"{label} dataset {i + 1}: {taken} samples taken out of {unique} unique "
                    f"samples ({batch_size} per batch, {taken / max(unique, 1):.2%} seen)"
                )
        return "\n".join(lines)

    def device_plan(self, max_bytes: int) -> Optional["DeviceBatchPlan"]:
        """Device-resident serving plan, or None when any source cannot be
        index-served (non-array dataset) or the pools exceed ``max_bytes``.

        The trainer uploads each source's resident_features() to the device
        once; every step then sends only per-source row indices (a few KB)
        instead of the assembled feature batch (4.4 MB at the default
        composition of 50 + 50 + 1000 rows)."""
        specs: List[Tuple[Any, int, float]] = [
            (ds, bs, 1.0) for ds, bs in self.positive
        ] + [(ds, bs, 0.0) for ds, bs in self.negative]
        specs = [(ds, bs, label) for ds, bs, label in specs if bs > 0 and len(ds) > 0]
        if not specs:
            return None
        total = 0
        for ds, _, _ in specs:
            if not isinstance(ds, PrecalculatedDatasetIterator):
                return None
            total += ds.resident_nbytes()
        if total > max_bytes:
            logger.info(
                f"training data too large for device residency "
                f"({total / 1e9:.2f} GB > {max_bytes / 1e9:.2f} GB budget); "
                "streaming host batches instead"
            )
            return None
        return DeviceBatchPlan(self, specs)

    def multiply_batch_size(self, ratio: float) -> None:
        restart = self.started
        if self.started:
            self.stop()
        self.positive = [(ds, max(1, int(bs * ratio))) for ds, bs in self.positive]
        self.negative = [(ds, max(1, int(bs * ratio))) for ds, bs in self.negative]
        if restart:
            self.start()

    def half_batch_size(self) -> None:
        self.multiply_batch_size(0.5)

    def double_batch_size(self) -> None:
        self.multiply_batch_size(2)

    def _generate_batches(self, stop_event: threading.Event) -> None:
        while not stop_event.is_set():
            samples: List[np.ndarray] = []
            labels: List[np.ndarray] = []
            for dataset, n in self.positive:
                samples.append(dataset.take(n))
                labels.append(np.ones(samples[-1].shape[0], dtype=np.float32))
            for dataset, n in self.negative:
                samples.append(dataset.take(n))
                labels.append(np.zeros(samples[-1].shape[0], dtype=np.float32))

            x = np.concatenate(samples).astype(np.float32)
            y = np.concatenate(labels)
            if x.shape[0] != y.shape[0]:
                n_min = min(x.shape[0], y.shape[0])
                x, y = x[:n_min], y[:n_min]

            while self.queue.full():
                if stop_event.is_set():
                    return
                stop_event.wait(0.1)
            self.queue.put((x, y))

    # --- factories ---------------------------------------------------------------

    @classmethod
    def default(
        cls,
        phrase: Union[str, List[str]],
        positive_samples: int = DEFAULT_POSITIVE_SAMPLES,
        adversarial_samples: int = DEFAULT_ADVERSARIAL_SAMPLES,
        adversarial_phrases: int = DEFAULT_ADVERSARIAL_PHRASES,
        positive_batch_size: int = DEFAULT_POSITIVE_BATCH_SIZE,
        adversarial_batch_size: int = DEFAULT_ADVERSARIAL_BATCH_SIZE,
        negative_batch_size: int = DEFAULT_NEGATIVE_BATCH_SIZE,
        partial_samples: int = 0,
        partial_batch_size: int = DEFAULT_PARTIAL_BATCH_SIZE,
        stream_negative_samples: int = 0,
        collision_negative_samples: int = 0,
        clean_positive_samples: int = 0,
        reverb_positive_samples: int = 0,
        num_batch_threads: int = DEFAULT_BATCH_THREADS,
        large_negative_dataset: bool = False,
        synthetic_negative_samples: int = 0,
        testing: bool = False,
        negative_seed: Optional[int] = None,
        **feature_kwargs: Any,
    ) -> "WakeWordTrainingDatasetIterator":
        """Training (or testing) iterator: the phrase's cached positives/adversarials + hosted negatives
        (shuffled from ``negative_seed``; fresh entropy without one, as in the JAX package)."""
        generator = TrainingFeaturesGenerator(phrase=phrase, **feature_kwargs)
        positive = generator.get_training_features(
            positive_samples,
            adversarial=False,
            testing=testing,
        )
        adversarial = generator.get_training_features(
            adversarial_samples,
            adversarial=True,
            adversarial_phrases=adversarial_phrases,
            testing=testing,
        )
        positive_specs: List[DatasetSpec] = [
            (positive, positive_batch_size),
        ]
        negative_specs: List[DatasetSpec] = [
            (adversarial, adversarial_batch_size),
        ]
        if clean_positive_samples > 0 and not testing:
            # Unaugmented positives, centered (pad-only) and at random window
            # offsets, with the symmetric hard negative (clean near-collisions
            # at random offsets) in the same block so the pair stays together.
            clean_bs = max(positive_batch_size // 2, 1)
            clean = generator.get_validation_features(clean_positive_samples)
            clean_offset = generator.get_clean_offset_features(clean_positive_samples)
            positive_specs.append((clean, clean_bs))
            positive_specs.append((clean_offset, clean_bs))
            clean_offset_adv = generator.get_clean_offset_features(
                clean_positive_samples,
                adversarial=True,
                adversarial_phrases=adversarial_phrases,
            )
            negative_specs.append((clean_offset_adv, clean_bs))
        if reverb_positive_samples > 0 and not testing:
            # Reverb-only positives: a mode the stacked augment chain rarely
            # emits in isolation.
            reverb = generator.get_reverb_positive_features(reverb_positive_samples)
            positive_specs.append((reverb, max(positive_batch_size // 2, 1)))
        if partial_samples > 0:
            # Sliding-offset partial views of the wake phrase AND of its
            # phonetic adversaries, labeled negative.
            partial = generator.get_partial_phrase_features(partial_samples, testing=testing)
            partial_adv = generator.get_partial_phrase_features(
                partial_samples,
                adversarial=True,
                adversarial_phrases=adversarial_phrases,
                testing=testing,
            )
            negative_specs.append((partial, partial_batch_size))
            negative_specs.append((partial_adv, partial_batch_size))
        if negative_batch_size > 0:
            negative = cls._hosted_negative(
                phrase, large=large_negative_dataset, device=feature_kwargs.get("device", "cuda"),
                seed=negative_seed,
            )
            if negative is not None:
                negative_specs.append((negative, negative_batch_size))
            elif synthetic_negative_samples <= 0:
                logger.warning(
                    "No ordinary-speech negatives available; the model will only "
                    "separate the wake phrase from its phonetic adversaries. "
                    "Use --synthetic-negative-samples for offline FP control."
                )
        if synthetic_negative_samples > 0 and not testing:
            synthetic = generator.get_negative_speech_features(synthetic_negative_samples)
            negative_specs.append((synthetic, max(negative_batch_size, adversarial_batch_size)))
        if stream_negative_samples > 0 and not testing:
            # Sliding-window negatives from continuous speech/adversarial
            # streams: the distribution the deployed runtime scores.
            speech_stream = generator.get_stream_window_features(stream_negative_samples)
            adv_stream = generator.get_stream_window_features(
                max(stream_negative_samples // 2, 1), adversarial=True
            )
            stream_bs = max(partial_batch_size, adversarial_batch_size)
            negative_specs.append((speech_stream, stream_bs))
            negative_specs.append((adv_stream, stream_bs))
        if collision_negative_samples > 0 and not testing:
            # Near-collision vocabulary embedded in word salads.
            collision_stream = generator.get_stream_window_features(
                collision_negative_samples, collision=True
            )
            negative_specs.append(
                (collision_stream, max(partial_batch_size, adversarial_batch_size))
            )
        return cls(
            num_batch_threads=num_batch_threads,
            positive=positive_specs,
            negative=negative_specs,
        )

    @classmethod
    def testing(cls, phrase: Union[str, List[str]], **kwargs: Any) -> "WakeWordTrainingDatasetIterator":
        kwargs.setdefault("positive_samples", DEFAULT_TESTING_POSITIVE_SAMPLES)
        kwargs.setdefault("adversarial_samples", DEFAULT_TESTING_ADVERSARIAL_SAMPLES)
        kwargs.setdefault("negative_batch_size", 0)
        max_samples = kwargs.pop("max_samples", None)
        iterator = cls.default(phrase, testing=True, **kwargs)
        if max_samples is None:
            # one full pass over the testing set per eval
            max_samples = max(
                kwargs["positive_samples"] // kwargs.get("positive_batch_size", DEFAULT_POSITIVE_BATCH_SIZE),
                kwargs["adversarial_samples"] // kwargs.get("adversarial_batch_size", DEFAULT_ADVERSARIAL_BATCH_SIZE),
                1,
            )
        iterator.max_samples = max_samples
        return iterator

    @classmethod
    def validation(
        cls,
        phrase: Union[str, List[str]],
        validation_samples: int = DEFAULT_VALIDATION_SAMPLES,
        positive_batch_size: int = DEFAULT_VALIDATION_POSITIVE_BATCH_SIZE,
        negative_batch_size: int = DEFAULT_VALIDATION_NEGATIVE_BATCH_SIZE,
        num_batch_threads: int = 2,
        stream_negative_samples: int = 0,
        negative_seed: Optional[int] = None,
        **feature_kwargs: Any,
    ) -> "WakeWordTrainingDatasetIterator":
        """Validation iterator: pad-only positives + hosted negative validation set
        (shuffled from ``negative_seed``; fresh entropy without one).

        ``stream_negative_samples`` adds sliding-window negatives from a
        continuous synthetic speech stream (fresh seed, disjoint from the
        training stream windows). Without hosted sets the validation
        iterator would otherwise have NO negatives, so the trainer's dynamic
        negative-weight controller never engages in air-gapped runs.
        """
        generator = TrainingFeaturesGenerator(phrase=phrase, **feature_kwargs)
        # testing=True draws from the disjoint testing-validation cache
        # (fresh TTS seeds): the plain validation cache doubles as
        # clean-positive TRAINING coverage (default()'s clean_positive_samples
        # path), so validating on it would leak train positives into the
        # fp-per-hour control loop's recall metric.
        positive = generator.get_validation_features(validation_samples, testing=True)
        positive_specs: List[DatasetSpec] = [(positive, positive_batch_size)]
        negative_specs: List[DatasetSpec] = []
        if hosted_sets_compatible(
            "validation negatives",
            local_path=os.path.join(get_default_dataset_dir(), "validation.npy"),
            device=feature_kwargs.get("device", "cuda"),
        ):
            try:
                negative_specs.append((PrecalculatedValidationDataset(seed=negative_seed), negative_batch_size))
            except FileNotFoundError as ex:
                logger.warning(f"Hosted validation negatives unavailable: {ex}")
        if stream_negative_samples > 0:
            stream = generator.get_stream_window_features(
                stream_negative_samples, seed=generator.seed + 7700
            )
            negative_specs.append((stream, negative_batch_size))
        iterator = cls(
            num_batch_threads=num_batch_threads,
            positive=positive_specs,
            negative=negative_specs,
        )
        # one full pass over the validation set per eval
        negative_count = max((len(spec[0]) for spec in negative_specs), default=0)
        iterator.max_samples = max(
            negative_count // max(negative_batch_size, 1),
            validation_samples // max(positive_batch_size, 1),
            1,
        )
        return iterator

    @classmethod
    def all(
        cls,
        phrase: Union[str, List[str]],
        validation_samples: int = DEFAULT_VALIDATION_SAMPLES,
        testing_positive_samples: int = DEFAULT_TESTING_POSITIVE_SAMPLES,
        testing_adversarial_samples: int = DEFAULT_TESTING_ADVERSARIAL_SAMPLES,
        **kwargs: Any,
    ) -> Tuple[
        "WakeWordTrainingDatasetIterator",
        Optional["WakeWordTrainingDatasetIterator"],
        Optional["WakeWordTrainingDatasetIterator"],
    ]:
        """Build (training, validation, testing) from one set of options."""
        feature_kwargs = {
            k: v
            for k, v in kwargs.items()
            if k
            not in {
                "positive_samples",
                "adversarial_samples",
                "adversarial_phrases",
                "positive_batch_size",
                "adversarial_batch_size",
                "negative_batch_size",
                "partial_samples",
                "partial_batch_size",
                "stream_negative_samples",
                "num_batch_threads",
                "large_negative_dataset",
                "synthetic_negative_samples",
            }
        }
        training = cls.default(phrase, **kwargs)
        validation = None
        testing = None
        if validation_samples > 0:
            # When training uses stream-window negatives, validate against the
            # same distribution (fresh seed) so the dynamic negative-weight
            # controller regulates the actual operating metric offline.
            stream_validation = min(kwargs.get("stream_negative_samples", 0), 2000)
            validation = cls.validation(
                phrase,
                validation_samples=validation_samples,
                stream_negative_samples=stream_validation,
                **feature_kwargs,
            )
        if testing_positive_samples > 0 or testing_adversarial_samples > 0:
            testing = cls.testing(
                phrase,
                positive_samples=testing_positive_samples,
                adversarial_samples=testing_adversarial_samples,
                **feature_kwargs,
            )
        return training, validation, testing

    @staticmethod
    def _hosted_negative(
        phrase: Union[str, List[str]], large: bool = False, device: DeviceLike = "cuda", seed: Optional[int] = None
    ) -> Optional[PrecalculatedDatasetIterator]:
        hosted_name = "training-large.npy" if large else "training-medium.npy"
        if not hosted_sets_compatible(
            "training negatives",
            local_path=os.path.join(get_default_dataset_dir(), hosted_name),
            device=device,
        ):
            return None
        exclude = phrase if isinstance(phrase, str) else " ".join(phrase)
        dataset_cls = PrecalculatedTrainingDatasetLarge if large else PrecalculatedTrainingDatasetMedium
        try:
            return dataset_cls(exclude_phrase=exclude, seed=seed)
        except FileNotFoundError as ex:
            logger.warning(f"Hosted negative dataset unavailable: {ex}")
            return None
