"""
Training-features orchestrator: TTS -> augment -> featurize -> cached shards.

Counterpart of the JAX package's ``data/features.py``.
``TrainingFeaturesGenerator`` generates (phrase, count) feature sets on
demand and caches them as ``.npy`` files named as the JAX package names them
(``safe_name(phrase)`` plus ``-adversarial`` / ``-partial`` / ``-testing`` /
``-validation`` / ``-clean-offset`` / ``-reverb``, the negative-speech and
stream-window names). A cache is topped up, never regenerated: the rows
already there stay, and the missing ones are generated with seeds keyed off
the existing count, each cache kind in its own ``_SEED_NAMESPACE`` block. A
cache whose space sidecar is stale (``data/space.py``) is dropped first.

Two routes, as in JAX, by the backend ``models/tts.resolve_tts_backend`` names:

* classic (the host ``formant`` and the ``vits`` backends): render ->
  ``AugmentedAudioGenerator`` (``augment_batch`` on ``device``, or centring
  for pad-only caches) -> ``SpeechEmbeddings.featurize_device`` (K1 -> K2 on
  the card);
* fused (``formant-device`` with ``HEYBUDDY_FUSED_TTS`` not "0"): host plans
  -> ``fused_features_batch`` (render -> augment or centring -> K1 -> K2,
  the audio never leaving the device), with device-resident noise and
  impulse banks; clips the device cannot express (``DeviceFormantTTS``
  decides) go the classic route.

Both feed one loop, ``_featurize_batches``: batch i is dispatched before
batch i-1 is drained (``_drain``), so the host's work overlaps the device's.

The stream-window caches are synthesised as continuous streams
(``data/streams.py``) and featurized a segment of up to 1024 overlapping
windows at a time, each segment uploaded once and read by K1 in place, in a
loop of their own: their rows are stored unrepaired, as in JAX.

Each stream logs how many featurize calls it made (fused batches, host
fallback clips, stream segments), which is what the card's launch counts
follow.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    CLIP_SAMPLES,
    DEFAULT_FEATURE_BATCH_SIZE,
    DEFAULT_PARTIAL_MAX_VISIBLE,
    DEFAULT_PARTIAL_MIN_VISIBLE,
    RUNTIME_WINDOW_STRIDE,
    SAMPLE_RATE,
)
from heybuddy_tpu_torch.data.augmented import AugmentedAudioGenerator, NoiseProvider
from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator, get_default_dataset_dir
from heybuddy_tpu_torch.data.space import active_space, check_cache_space, write_space_sidecar
from heybuddy_tpu_torch.data.tts_generator import SpeechSampleGenerator
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.tts import DEVICE_TTS_BATCH, get_tts_model, resolve_tts_backend
from heybuddy_tpu_torch.ops.augment import AugmentConfig, seeded_generator
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.npy import AppendableNpyFile
from heybuddy_tpu_torch.utils.profiling import span
from heybuddy_tpu_torch.utils.strings import safe_name

__all__ = ["TrainingFeaturesGenerator", "autoconfigure_batch_sizes"]

# Disjoint seed-offset block per cache kind (train=0 / testing=1, partial=2/3,
# clean-offset=4/5, negative-speech=6, validation=7 / testing-validation=8,
# reverb-positive=9/10, reverb-collision=11/12), the JAX package's: no cache
# grown to any realistic size reaches another kind's TTS / augment seeds.
_SEED_NAMESPACE = 10_000_000


def _texts_sidecar_path(npy_path: str) -> str:
    return os.path.splitext(npy_path)[0] + ".texts.json"


def _merge_texts_sidecar(npy_path: str, texts: List[str]) -> None:
    """Record the exact adversarial text pool rendered into a cache,
    union-merged so that top-ups (other chunk seeds, other pools) extend it."""
    path = _texts_sidecar_path(npy_path)
    merged = set(texts)
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged |= set(json.load(f))
        except (OSError, ValueError):
            pass
    with open(path, "w") as f:
        json.dump(sorted(merged), f)


def _remove_cache(npy_path: str) -> None:
    """Remove a stale cache .npy together with its texts sidecar."""
    os.remove(npy_path)
    sidecar = _texts_sidecar_path(npy_path)
    if os.path.exists(sidecar):
        os.remove(sidecar)


def autoconfigure_batch_sizes(device: DeviceLike = "cuda") -> Dict[str, int]:
    """
    Resource-tiered batch sizes, the JAX package's tiers: host RAM bounds
    the TTS and augment staging, device memory (``torch.cuda``'s total for a
    CUDA ``device``) the featurization batch.
    """
    ram_gib = 16.0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    ram_gib = int(line.split()[1]) / (1024 ** 2)
                    break
    except OSError:
        pass

    hbm_gib = 16.0
    hbm_measured = False
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        hbm_gib = torch.cuda.get_device_properties(dev).total_memory / (1024 ** 3)
        hbm_measured = True

    if ram_gib < 8:
        host_tier = {"tts_batch_size": 4, "augment_batch_size": 32}
    elif ram_gib < 16:
        host_tier = {"tts_batch_size": 8, "augment_batch_size": 64}
    else:
        host_tier = {"tts_batch_size": 8, "augment_batch_size": 128}

    if hbm_gib < 8:
        embed = 512
    elif hbm_gib < 12 or ram_gib < 8:
        embed = 2048
    elif ram_gib < 16:
        embed = 4096
    elif ram_gib < 24:
        embed = 8192
    elif hbm_measured and hbm_gib >= 15.0:
        embed = 16384
    else:  # no device memory to read (the CPU): the 8192 tier, as in JAX
        embed = 8192
    return {**host_tier, "embed_batch_size": embed}


class TrainingFeaturesGenerator:
    """Generate-and-cache classifier features for a wake phrase on ``device``."""

    def __init__(
        self,
        phrase: Union[str, List[str]],
        directory: Optional[str] = None,
        augment_config: AugmentConfig = AugmentConfig(),
        embed_batch_size: Optional[int] = None,
        tts_batch_size: Optional[int] = None,
        augment_batch_size: Optional[int] = None,
        seed: int = 0,
        tts_backend: Optional[str] = None,
        device: DeviceLike = "cuda",
        **generator_kwargs: Any,
    ) -> None:
        auto = autoconfigure_batch_sizes(device)
        if tts_batch_size is None and resolve_tts_backend(tts_backend) == "formant-device":
            tts_batch_size = DEVICE_TTS_BATCH
        self.phrase = phrase
        self.phrase_key = phrase if isinstance(phrase, str) else " ".join(phrase)
        self.directory = directory or get_default_dataset_dir()
        self.augment_config = augment_config
        self.embed_batch_size = embed_batch_size or auto["embed_batch_size"]
        self.tts_batch_size = tts_batch_size or auto["tts_batch_size"]
        self.augment_batch_size = augment_batch_size or auto["augment_batch_size"]
        self.seed = seed
        self.tts_backend = tts_backend
        self.device = device
        self.generator_kwargs = generator_kwargs
        self._noise_provider: Optional[NoiseProvider] = None
        self._fused_bank_tensors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def noise_provider(self) -> NoiseProvider:
        if self._noise_provider is None:
            self._noise_provider = NoiseProvider(
                seed=self.seed,
                use_remote=self.augment_config.background_noise_prob > 0 or self.augment_config.reverb_prob > 0,
            )
        return self._noise_provider

    def _cache_name(self, adversarial: bool, testing: bool, validation: bool, partial: bool = False) -> str:
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

    def _embeddings(self) -> Any:
        from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings

        return get_speech_embeddings(device=self.device)

    def _drain(self, pending: Tuple[torch.Tensor, int], store: AppendableNpyFile, room: int) -> int:
        """Append up to ``room`` rows of a dispatched batch to ``store``; returns the rows written."""
        device_arr, n_real = pending
        take = min(n_real, room)
        if take <= 0:
            return 0
        with span("features/drain/copy"):  # waits for the kernels queued before the copy, then copies
            feats = device_arr[:take].cpu().numpy()
        with span("features/drain/write"):
            if np.isnan(feats).any():
                embeddings = self._embeddings()
                feats = embeddings._repair_nan(feats, embeddings.generator)
            store.append(feats.astype(np.float32))
        return take

    def _featurize_batches(
        self, items: Iterable[Any], batch_size: int, dispatch: Callable[[List[Any], int], Tuple[torch.Tensor, int]],
        store: AppendableNpyFile, limit: int,
    ) -> Tuple[int, int]:
        """Featurize ``items`` into ``store`` in batches of ``batch_size`` up to
        ``limit`` rows; returns (rows written, batches dispatched). Batch i is
        dispatched (``dispatch(batch, i)``) before batch i-1 is drained; a
        short last batch only after the pending one. Nothing more is drawn
        from ``items`` once ``limit`` rows are written."""
        written = dispatched = 0
        batch: List[Any] = []
        pending: Optional[Tuple[torch.Tensor, int]] = None
        for item in items:
            batch.append(item)
            if len(batch) < batch_size:
                continue
            current = dispatch(batch, dispatched)
            dispatched += 1
            batch = []
            if pending is not None:
                written += self._drain(pending, store, limit - written)
            pending = current
            if written >= limit:
                return written, dispatched
        if pending is not None:
            written += self._drain(pending, store, limit - written)
        if batch and written < limit:
            written += self._drain(dispatch(batch, dispatched), store, limit - written)
            dispatched += 1
        return written, dispatched

    def _featurize_stream(
        self,
        samples: Iterator[Dict[str, Any]],
        pad_only: bool,
        store: AppendableNpyFile,
        limit: int,
        seed_offset: int = 0,
        config: Optional[AugmentConfig] = None,
    ) -> int:
        """Augment + embed a sample stream into ``store`` in batches of
        ``embed_batch_size``; returns rows written."""
        augmenter = AugmentedAudioGenerator(
            samples,
            config=config or self.augment_config,
            batch_size=self.augment_batch_size,
            noise_provider=self.noise_provider,
            pad_only=pad_only,
            seed=self.seed + seed_offset,
            device=self.device,
        )
        embeddings = self._embeddings()
        written, calls = self._featurize_batches(
            (sample["audio"]["array"] for sample in augmenter()), self.embed_batch_size,
            lambda batch, _: embeddings.featurize_device(np.stack(batch)), store, limit,
        )
        logger.info(f"Featurized {written} clips into {os.path.basename(store.path)} in {calls} featurize "
                    f"call(s) of up to {self.embed_batch_size}")
        return written

    def _fused_banks(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident noise / impulse banks of the fused path, built once
        (``HEYBUDDY_NOISE_BANK`` rows, default 512)."""
        if self._fused_bank_tensors is None:
            bank = int(os.environ.get("HEYBUDDY_NOISE_BANK", "512"))
            cfg = self.augment_config
            if cfg.background_noise_prob > 0:
                noise = self.noise_provider.noise_batch(bank, cfg.target_samples)
            else:
                noise = np.zeros((1, cfg.target_samples), np.float32)
            if cfg.reverb_prob > 0:
                impulse = self.noise_provider.impulse_batch(bank)
            else:
                impulse = np.zeros((1, 256), np.float32)
            dev = resolve_device(self.device)
            self._fused_bank_tensors = (torch.from_numpy(noise).to(dev), torch.from_numpy(impulse).to(dev))
        return self._fused_bank_tensors

    def _featurize_plan_stream(
        self,
        samples: Iterator[Dict[str, Any]],
        pad_only: bool,
        store: AppendableNpyFile,
        limit: int,
        seed_offset: int = 0,
        config: Optional[AugmentConfig] = None,
    ) -> int:
        """The fused path: ClipPlan samples render + augment + featurize on the
        device in batches of ``HEYBUDDY_FUSED_TTS_BATCH`` (default: the augment
        batch size, at least 512); host-rendered fallback clips go through the
        classic path at the end."""
        from heybuddy_tpu_torch.models.formant_device import fused_features_batch

        embeddings = self._embeddings()
        tts = get_tts_model(backend=self.tts_backend, device=self.device)
        noise_bank, impulse_bank = self._fused_banks()
        cfg = config or self.augment_config
        dev = resolve_device(self.device)
        batch_size = int(os.environ.get("HEYBUDDY_FUSED_TTS_BATCH", "0")) or max(self.augment_batch_size, 512)
        fallback: List[Dict[str, Any]] = []

        def plans() -> Iterator[Any]:
            for sample in samples:
                if "plan" in sample:
                    yield sample["plan"]
                else:
                    fallback.append(sample)

        def dispatch(batch_plans: List[Any], index: int) -> Tuple[torch.Tensor, int]:
            # a stream of its own, apart from the classic augmenter's (seed, batch)
            generator = seeded_generator(dev, self.seed + seed_offset, 777, index)
            with span("features/batch"):
                return fused_features_batch(
                    batch_plans, embeddings.net, generator, noise_bank, impulse_bank, cfg, pad_only=pad_only,
                    l_max=tts.planner.max_samples, harmonics=tts.harmonics, clip_samples=cfg.target_samples,
                )

        written, batches = self._featurize_batches(plans(), batch_size, dispatch, store, limit)
        logger.info(f"Fused {written} clips into {os.path.basename(store.path)} in {batches} batch(es) of up "
                    f"to {batch_size}; {len(fallback)} host-fallback clip(s)")
        if fallback and written < limit:
            written += self._featurize_stream(
                iter(fallback), pad_only=pad_only, store=store, limit=limit - written,
                seed_offset=seed_offset, config=config,
            )
        return written

    def _use_fused_pipeline(self) -> bool:
        """The fused plans -> features path: the device TTS backend and the
        native embedding (an imported ONNX embedding has no K2 to fuse
        into), unless ``HEYBUDDY_FUSED_TTS=0``."""
        if os.environ.get("HEYBUDDY_FUSED_TTS", "1") == "0":
            return False
        return resolve_tts_backend(self.tts_backend) == "formant-device" and self._embeddings().backend == "trunkpool"

    def _speech(self, adversarial: bool, seed: int, **overrides: Any) -> SpeechSampleGenerator:
        """A sample generator of the phrase with the generator options, ``overrides`` applied."""
        kwargs = {**self.generator_kwargs, **overrides}
        return SpeechSampleGenerator(
            self.phrase, adversarial=adversarial, batch_size=self.tts_batch_size, seed=seed,
            tts_backend=self.tts_backend, device=self.device,
            **{k: v for k, v in kwargs.items() if v is not _DROP},
        )

    def _featurize(
        self,
        speech: SpeechSampleGenerator,
        num_samples: int,
        pad_only: bool,
        store: AppendableNpyFile,
        seed_offset: int,
        config: Optional[AugmentConfig] = None,
    ) -> int:
        """``num_samples`` samples of ``speech`` into ``store`` by the fused or the classic route."""
        if self._use_fused_pipeline():
            return self._featurize_plan_stream(
                speech(num_samples, yield_plans=True), pad_only=pad_only, store=store, limit=num_samples,
                seed_offset=seed_offset, config=config,
            )
        return self._featurize_stream(
            speech(num_samples), pad_only=pad_only, store=store, limit=num_samples, seed_offset=seed_offset,
            config=config,
        )

    def generate(
        self,
        num_samples: int,
        adversarial: bool = False,
        pad_only: bool = False,
        store: Optional[AppendableNpyFile] = None,
        adversarial_phrases: Optional[int] = None,
        seed_offset: int = 0,
    ) -> int:
        """Generate ``num_samples`` features into ``store``; returns the rows written."""
        if store is None:
            raise ValueError("generate needs a store")
        with span("features/generate"):
            overrides = {} if adversarial_phrases is None else {"num_adversarial_texts": adversarial_phrases}
            speech = self._speech(adversarial, self.seed + seed_offset, **overrides)
            if adversarial:
                _merge_texts_sidecar(store.path, speech.get_adversarial_texts())
            return self._featurize(speech, num_samples, pad_only, store, seed_offset)

    def _open_store(self, name: str) -> Tuple[str, AppendableNpyFile, int]:
        """The cache ``name`` (a stale one dropped first), its sidecar stamped; returns (path, store, rows)."""
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"{name}.npy")
        if os.path.exists(path) and not check_cache_space(path, self.tts_backend, self.device):
            _remove_cache(path)
        store = AppendableNpyFile(path)
        write_space_sidecar(path, active_space(self.tts_backend, self.device))
        return path, store, len(store)

    def _get_features(
        self,
        num_samples: int,
        adversarial: bool,
        testing: bool,
        validation: bool,
        adversarial_phrases: Optional[int] = None,
    ) -> PrecalculatedDatasetIterator:
        name = self._cache_name(adversarial, testing, validation)
        _, store, existing = self._open_store(name)
        if existing < num_samples:
            missing = num_samples - existing
            logger.info(f"Generating {missing} features for '{name}' ({existing} cached of {num_samples} requested)")
            # validation caches get blocks of their own (7 / 8): the plain
            # validation cache doubles as clean-positive training coverage
            block = (8 if testing else 7) if validation else (1 if testing else 0)
            written = 0
            while written < missing:
                chunk = min(DEFAULT_FEATURE_BATCH_SIZE, missing - written)
                written += self.generate(
                    chunk, adversarial=adversarial, pad_only=validation, store=store,
                    adversarial_phrases=adversarial_phrases,
                    seed_offset=existing + written + _SEED_NAMESPACE * block,
                )
        else:
            logger.info(f"Using {num_samples} cached features for '{name}'")
        return PrecalculatedDatasetIterator(name, directory=self.directory, seed=self.seed)

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

    def adversarial_texts(
        self,
        testing: bool = False,
        validation: bool = False,
        partial: bool = False,
        adversarial_phrases: Optional[int] = None,
    ) -> List[str]:
        """The exact adversarial text pool rendered into a cache kind: its
        ``.texts.json`` sidecar, or for a cache without one the pool of its
        first chunk (exact when the cache was built in one run)."""
        name = self._cache_name(True, testing, validation, partial=partial)
        sidecar = _texts_sidecar_path(os.path.join(self.directory, f"{name}.npy"))
        if os.path.exists(sidecar):
            try:
                with open(sidecar) as f:
                    return list(json.load(f))
            except (OSError, ValueError):
                pass
        if validation:
            block = 8 if testing else 7
        elif partial:
            block = 3 if testing else 2
        else:
            block = 1 if testing else 0
        overrides = {} if adversarial_phrases is None else {"num_adversarial_texts": adversarial_phrases}
        return self._speech(True, self.seed + _SEED_NAMESPACE * block, **overrides).get_adversarial_texts()

    def _generate_kind(
        self,
        name: str,
        num_samples: int,
        kind: str,
        block: int,
        adversarial: bool,
        config: AugmentConfig,
        record_texts: bool = True,
        **overrides: Any,
    ) -> PrecalculatedDatasetIterator:
        """Top up cache ``name`` with augmented clips under ``config`` in seed
        block ``block``; an adversarial cache records its text pool when
        ``record_texts``."""
        path, store, existing = self._open_store(name)
        if existing < num_samples:
            missing = num_samples - existing
            logger.info(f"Generating {missing} {kind} features for '{name}'")
            speech = self._speech(adversarial, self.seed + existing + _SEED_NAMESPACE * block, **overrides)
            if adversarial and record_texts:
                _merge_texts_sidecar(path, speech.get_adversarial_texts())
            self._featurize(speech, missing, False, store, existing + _SEED_NAMESPACE * block, config)
        else:
            logger.info(f"Using {num_samples} cached {kind} features for '{name}'")
        return PrecalculatedDatasetIterator(name, directory=self.directory, seed=self.seed)

    def _text_overrides(self, adversarial: bool, adversarial_phrases: Optional[int]) -> Dict[str, Any]:
        """Generator overrides of a positive / adversarial getter: a positive
        one drops the adversarial-text options, an adversarial one takes
        ``adversarial_phrases``; neither appends "{phrase}. {word}"."""
        overrides: Dict[str, Any] = {"phrase_augment_prob": 0.0}
        if not adversarial:
            overrides.update(custom_adversarial_texts=_DROP, num_adversarial_texts=_DROP)
        elif adversarial_phrases is not None:
            overrides["num_adversarial_texts"] = adversarial_phrases
        return overrides

    def get_partial_phrase_features(
        self,
        num_samples: int,
        adversarial: bool = False,
        testing: bool = False,
        min_visible: Optional[float] = None,
        max_visible: Optional[float] = None,
        adversarial_phrases: Optional[int] = None,
    ) -> PrecalculatedDatasetIterator:
        """Sliding-offset partial views of the phrase (or its adversaries),
        labeled negative: each clip straddles a window edge, only a head or
        tail fraction visible."""
        config = self.augment_config._replace(
            placement="edge",
            edge_min_visible=DEFAULT_PARTIAL_MIN_VISIBLE if min_visible is None else min_visible,
            edge_max_visible=DEFAULT_PARTIAL_MAX_VISIBLE if max_visible is None else max_visible,
        )
        return self._generate_kind(
            self._cache_name(adversarial, testing, False, partial=True), num_samples, "partial-view",
            3 if testing else 2, adversarial, config, **self._text_overrides(adversarial, adversarial_phrases),
        )

    def get_clean_offset_features(
        self,
        num_samples: int,
        adversarial: bool = False,
        testing: bool = False,
        adversarial_phrases: Optional[int] = None,
    ) -> PrecalculatedDatasetIterator:
        """Unaugmented clips at random (fully visible) window offsets."""
        config = self.augment_config._replace(
            seven_band_prob=0.0, tanh_distortion_prob=0.0, pitch_shift_prob=0.0, band_stop_prob=0.0,
            colored_noise_prob=0.0, background_noise_prob=0.0, gain_prob=0.0, reverb_prob=0.0,
            placement="random",
        )
        return self._generate_kind(
            self._cache_name(adversarial, testing, False) + "-clean-offset", num_samples, "clean-offset",
            5 if testing else 4, adversarial, config, **self._text_overrides(adversarial, adversarial_phrases),
        )

    def _reverb_config(self) -> AugmentConfig:
        """Guaranteed reverb and [0, 15] dB background noise, every other distortion off."""
        return self.augment_config._replace(
            seven_band_prob=0.0, tanh_distortion_prob=0.0, pitch_shift_prob=0.0, band_stop_prob=0.0,
            colored_noise_prob=0.0, gain_prob=0.0, background_noise_prob=1.0, background_noise_min_snr_db=0.0,
            background_noise_max_snr_db=15.0, reverb_prob=1.0, placement="random",
        )

    def get_reverb_positive_features(self, num_samples: int, testing: bool = False) -> PrecalculatedDatasetIterator:
        """Reverb-only positives."""
        return self._generate_kind(
            self._cache_name(False, testing, False) + "-reverb", num_samples, "reverb-positive",
            10 if testing else 9, False, self._reverb_config(),
            custom_adversarial_texts=_DROP, num_adversarial_texts=_DROP,
        )

    def get_reverb_collision_features(
        self, num_samples: int, texts: List[str], testing: bool = False
    ) -> PrecalculatedDatasetIterator:
        """Reverb-only collision negatives: ``texts`` rendered with guaranteed
        reverb and [0, 15] dB background noise, every other distortion off."""
        return self._generate_kind(
            self._cache_name(True, testing, False) + "-reverb", num_samples, "reverb-collision",
            12 if testing else 11, True, self._reverb_config(), record_texts=False,
            custom_adversarial_texts=list(texts), num_adversarial_texts=0,
        )

    def get_stream_window_features(
        self,
        num_samples: int,
        adversarial: bool = False,
        seed: Optional[int] = None,
        collision: bool = False,
    ) -> PrecalculatedDatasetIterator:
        """
        Sliding-window negatives of a continuous stream (``data/streams.py``):
        every runtime window position (1.44 s, 0.12 s apart) of ordinary
        speech without the wake phrase's words, of its phonetic near-collisions
        (``adversarial``) or of collision salads (``collision``), rows in
        temporal order, featurized as the runtime sees them (no augmentation).

        Missing rows come in segments of at most ``STREAM_SEGMENT_WINDOWS``
        windows, each seeded by its absolute row offset (so a top-up equals a
        cache generated whole) and uploaded once
        (``SpeechEmbeddings.featurize_stream_device``); segment i + 1 is
        synthesised on the host while the card featurizes segment i.
        """
        from heybuddy_tpu_torch.data.streams import (
            stream_window_count,
            synth_adversarial_stream,
            synth_collision_salad_stream,
            synth_speech_stream,
        )
        from heybuddy_tpu_torch.models.featurizer import STREAM_SEGMENT_WINDOWS

        if collision and adversarial:
            raise ValueError("collision and adversarial are mutually exclusive")
        seed = self.seed if seed is None else seed
        kind = "collision-stream" if collision else "adversarial-stream" if adversarial else "speech-stream"
        slug = safe_name(self.phrase_key)
        name = f"{slug}-{kind}-{seed}" if (adversarial or collision) else f"negative-{kind}-{seed}-x{slug}"
        _, store, existing = self._open_store(name)
        if existing < num_samples:
            missing = num_samples - existing
            logger.info(f"Generating {missing} {kind} window features for '{name}'")
            embeddings = self._embeddings()
            stride = RUNTIME_WINDOW_STRIDE
            written = segments = 0
            # not ``_featurize_batches``: a segment's rows are counted as it is
            # dispatched and stored without ``_drain``'s NaN repair, as in JAX
            pending: Optional[Tuple[torch.Tensor, int]] = None
            while written < missing or pending is not None:
                dispatched = None
                if written < missing:
                    seg_windows = min(missing - written, STREAM_SEGMENT_WINDOWS)
                    seg_seconds = (seg_windows * stride + CLIP_SAMPLES) / SAMPLE_RATE
                    seg_seed = seed + 7919 * (existing + written)
                    # the phrase as one string: JAX passes a multi-phrase list
                    # on, and its streams then fail on list.lower()
                    options = dict(tts_backend=self.tts_backend, device=self.device)
                    if collision:
                        stream = synth_collision_salad_stream(self.phrase_key, seg_seconds / 60.0, seg_seed, **options)
                    elif adversarial:
                        stream = synth_adversarial_stream(self.phrase_key, seg_seconds / 60.0, seg_seed, **options)
                    else:
                        stream = synth_speech_stream(
                            seg_seconds / 60.0, seg_seed, exclude_phrase=self.phrase_key, **options
                        )
                    n = min(stream_window_count(stream), seg_windows)
                    dispatched = embeddings.featurize_stream_device(stream, n, stride)
                    segments += 1
                    written += dispatched[1]
                if pending is not None:
                    device_arr, n_real = pending
                    store.append(device_arr[:n_real].cpu().numpy().astype(np.float32))
                pending = dispatched
            logger.info(f"Featurized {written} stream windows into {os.path.basename(store.path)} in "
                        f"{segments} segment(s) of up to {STREAM_SEGMENT_WINDOWS}")
        else:
            logger.info(f"Using {num_samples} cached {kind} window features for '{name}'")
        iterator = PrecalculatedDatasetIterator(name, directory=self.directory, seed=seed)
        # rows in temporal order at the runtime stride: gate-aware consumers
        # (the trainer's validation) count fires per true stream hour
        iterator.stream_stride_seconds = RUNTIME_WINDOW_STRIDE / SAMPLE_RATE
        return iterator

    def get_negative_speech_features(
        self, num_samples: int, num_texts: int = 400, seed: Optional[int] = None
    ) -> PrecalculatedDatasetIterator:
        """Ordinary-speech negatives from random phrases of the word list
        (the wake phrase's words excluded), shared across wake phrases."""
        seed = self.seed if seed is None else seed
        name = f"negative-speech-{num_texts}-{seed}"
        _, store, existing = self._open_store(name)
        if existing < num_samples:
            from heybuddy_tpu_torch.text.wordlist import WORDS

            rng = np.random.default_rng(seed + 101)
            wake_words = set(self.phrase_key.lower().split())
            vocabulary = sorted(set(WORDS) - wake_words)
            texts: List[str] = []
            for _ in range(num_texts):
                n = int(rng.integers(1, 5))
                texts.append(" ".join(rng.choice(vocabulary, size=n, replace=False)))
            missing = num_samples - existing
            logger.info(f"Generating {missing} negative-speech features for '{name}'")
            speech = SpeechSampleGenerator(
                texts[0], additional_phrases=texts[1:], batch_size=self.tts_batch_size, seed=seed + existing,
                tts_backend=self.tts_backend, device=self.device,
                **{k: v for k, v in self.generator_kwargs.items()
                   if k not in ("custom_adversarial_texts", "num_adversarial_texts")},
            )
            self._featurize(speech, missing, False, store, existing + _SEED_NAMESPACE * 6)
        return PrecalculatedDatasetIterator(name, directory=self.directory, seed=seed)


# an override that removes a generator option instead of setting it
_DROP = object()
