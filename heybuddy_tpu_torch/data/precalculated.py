"""
Memory-mapped precalculated feature stores.

Counterpart of the JAX package's ``data/precalculated.py``: ``.npy`` arrays of
shape ``[n, 16, 96]`` (unlabeled features) or ``[n, 17, 96]`` (labeled: row 17
holds 96 token ids stored as float32), iterated with a shuffled index and a
wraparound ``take(n)``, with token-based exclude-phrase filtering for labeled
negative sets (through the port's ``text/tokens.py``), the index-space
``take_indices`` and ``resident_features`` of the trainer's device-resident
path, and the hosted sets, which use a local file when one is present. The
shuffles draw from ``numpy.random.default_rng(seed)`` exactly as the JAX
package does, so both packages serve the same rows for the same seed.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Set

import numpy as np

from heybuddy_tpu_torch.text.tokens import BERTTokenizer
from heybuddy_tpu_torch.utils.downloads import check_download_file, get_cache_dir
from heybuddy_tpu_torch.utils.log import logger

__all__ = [
    "PrecalculatedDatasetIterator",
    "HostedPrecalculatedDatasetIterator",
    "PrecalculatedTrainingDatasetLarge",
    "PrecalculatedTrainingDatasetMedium",
    "PrecalculatedValidationDataset",
    "get_default_dataset_dir",
]


def get_default_dataset_dir() -> str:
    """Where feature stores live: ``HEYBUDDY_DATASET_DIR``, else the cache's ``precalculated``."""
    return os.environ.get("HEYBUDDY_DATASET_DIR") or get_cache_dir("precalculated")


class PrecalculatedDatasetIterator:
    """
    Iterator over a memory-mapped ``.npy`` feature array with a shuffled index,
    wraparound ``take``, and exclude-phrase filtering for labeled arrays

    ``stream_stride_seconds`` marks a source whose STORED ROW ORDER is the
    temporal order of overlapping sliding windows cut from a continuous
    stream at that stride (``TrainingFeaturesGenerator.
    get_stream_window_features`` sets it to the runtime's 0.12 s). Consumers
    that evaluate whole pools in order (the trainer's device-resident
    validation) use it to count deployment-gated detections per true stream
    hour instead of treating overlapping windows as independent clips.
    """

    stream_stride_seconds: Optional[float] = None

    def __init__(
        self,
        name: str,
        directory: Optional[str] = None,
        exclude_phrase: Optional[str] = None,
        ordered: bool = False,
        labeled: bool = False,
        use_mem_map: bool = True,
        shuffle: bool = True,
        data: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.lock = threading.Lock()
        self.name = name
        self.directory = directory or get_default_dataset_dir()
        self.exclude_phrase = exclude_phrase
        self.ordered = ordered
        self.labeled = labeled
        self.use_mem_map = use_mem_map
        self.index = 0
        self.total_taken = 0
        self._rng = np.random.default_rng(seed)
        self._data: Optional[np.ndarray] = data
        self._indexes: Optional[np.ndarray] = None
        self._exclude_tokens: Optional[Set[int]] = None
        if data is None and not os.path.exists(self.precalculated_path):
            raise FileNotFoundError(
                f"Could not find precalculated features at {self.precalculated_path}."
            )
        if shuffle and not ordered:
            self.shuffle()

    @property
    def precalculated_path(self) -> str:
        return os.path.join(self.directory, f"{self.name}.npy")

    @property
    def precalculated(self) -> np.ndarray:
        if self._data is None:
            self._data = np.load(
                self.precalculated_path, mmap_mode="r" if self.use_mem_map else None
            )
        return self._data

    @property
    def indexes(self) -> np.ndarray:
        if self._indexes is None:
            self._indexes = np.arange(len(self.precalculated))
        return self._indexes

    @property
    def exclude_text(self) -> str:
        if self.exclude_phrase is None:
            return ""
        return re.sub(
            r"\s+", " ", re.sub(r"[^a-zA-Z0-9]", " ", self.exclude_phrase.replace("'", ""))
        ).strip()

    @property
    def exclude_tokens(self) -> Set[int]:
        if self._exclude_tokens is None:
            if self.exclude_phrase is None:
                self._exclude_tokens = set()
            else:
                tokenizer = BERTTokenizer()
                if not tokenizer.is_wordpiece and isinstance(
                    self, HostedPrecalculatedDatasetIterator
                ):
                    # Hosted shards carry real BERT ids; hash-tokenizer ids
                    # never intersect them, so the wake phrase would leak into
                    # the negatives unfiltered.
                    logger.warning(
                        f"Exclude-phrase filtering on hosted dataset '{self.name}' "
                        "is a NO-OP: no BERT vocabulary available, so the offline "
                        "hash tokenizer's ids cannot match the shards' BERT token "
                        "rows. Provide HEYBUDDY_TOKENIZER=<tokenizer.json|vocab.txt> "
                        "to make filtering effective."
                    )
                tokens = tokenizer(self.exclude_text)
                self._exclude_tokens = set(int(t) for t in np.asarray(tokens).flatten() if t != 0)
        return self._exclude_tokens

    @classmethod
    def from_array(
        cls,
        array: np.ndarray,
        name: str,
        directory: Optional[str] = None,
        ordered: bool = False,
        keep_in_memory: bool = False,
        **kwargs: Any,
    ) -> "PrecalculatedDatasetIterator":
        directory = directory or get_default_dataset_dir()
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, f"{name}.npy"), array)
        return cls(
            name,
            directory=directory,
            data=array if keep_in_memory else None,
            ordered=ordered,
            **kwargs,
        )

    def shuffle(self) -> "PrecalculatedDatasetIterator":
        if not self.ordered:
            self._rng.shuffle(self.indexes)
        return self

    # --- device-resident serving (the trainer's device-data plan) -----------

    def resident_nbytes(self) -> int:
        """Bytes resident_features() would occupy, WITHOUT materializing the
        (possibly memory-mapped) array — used to budget-gate device residency."""
        shape = self.precalculated.shape
        rows = shape[1] - (1 if self.labeled else 0)
        return int(len(self.precalculated)) * int(rows) * int(shape[2]) * 4

    def resident_features(self) -> np.ndarray:
        """Fully materialized, exclude-filtered, label-row-stripped feature
        rows for device-resident training: the trainer uploads this ONCE and
        steps gather rows by index on the device. Unlike take(), the exclude
        filter applies up front, so every served index is a valid row (same
        exclusion semantics, no short batches)."""
        data = np.asarray(self.precalculated)
        if self.labeled:
            if self.exclude_phrase is not None and self.exclude_tokens:
                token_rows = data[:, -1, :].astype(np.int64)
                exclude = np.fromiter(self.exclude_tokens, dtype=np.int64)
                mask = ~np.isin(token_rows, exclude).any(axis=1)
                data = data[mask]
            data = data[:, :-1]
        return np.ascontiguousarray(data, dtype=np.float32)

    def take_indices(self, n: int, resident_len: int) -> np.ndarray:
        """Index-space take over a resident_features() array of
        ``resident_len`` rows: the same shuffled-cursor wraparound semantics
        as take(), but yielding row INDICES instead of rows. Keeps its own
        cursor so interleaved take() calls don't corrupt either stream."""
        with self.lock:
            if (
                getattr(self, "_res_order", None) is None
                or len(self._res_order) != resident_len
            ):
                self._res_order = np.arange(resident_len)
                if not self.ordered:
                    self._rng.shuffle(self._res_order)
                self._res_index = 0
            out: List[np.ndarray] = []
            have = 0
            while have < n and resident_len > 0:
                remaining = resident_len - self._res_index
                if remaining <= 0:
                    self._res_index = 0
                    if not self.ordered:
                        self._rng.shuffle(self._res_order)
                    remaining = resident_len
                count = min(n - have, remaining)
                # .copy(): a view would silently change when the wraparound
                # reshuffle below mutates _res_order in place
                out.append(
                    self._res_order[self._res_index : self._res_index + count].copy()
                )
                self._res_index += count
                have += count
            self.total_taken += have
            if not out:
                return np.zeros(0, np.int32)
            return np.concatenate(out).astype(np.int32)

    def take(self, n: int) -> np.ndarray:
        """Take ``n`` rows, wrapping (and reshuffling) at the end of the array."""
        with self.lock:
            batch = self._take_unlocked(n)
        return batch

    def _take_unlocked(self, n: int) -> np.ndarray:
        # Iterative wraparound collection. This must stay loop-based with a
        # pass bound: the old recursive top-up hit RecursionError when the
        # exclude filter discarded (nearly) every row, and the old wraparound
        # arithmetic corrupted self.index for n > len(self), after which
        # every later take() returned short batches.
        chunks: List[np.ndarray] = []
        have = 0
        passes = 0
        while have < n and passes < 32:
            passes += 1
            remaining = len(self.indexes) - self.index
            if remaining <= 0:
                self.index = 0
                self.shuffle()
                remaining = len(self.indexes)
                if remaining <= 0:
                    break
            count = min(n - have, remaining)
            idx = self.indexes[self.index : self.index + count]
            self.index += count
            batch = np.asarray(self.precalculated[idx])
            if self.labeled:
                if self.exclude_phrase is not None and self.exclude_tokens:
                    # Row -1 holds token ids as float32; drop rows sharing any
                    # token with the exclude phrase.
                    token_rows = batch[:, -1, :].astype(np.int64)
                    exclude = np.fromiter(self.exclude_tokens, dtype=np.int64)
                    mask = ~np.isin(token_rows, exclude).any(axis=1)
                    batch = batch[mask]
                batch = batch[:, :-1]
            if batch.shape[0]:
                chunks.append(batch)
                have += batch.shape[0]
        if have < n:
            logger.warning(
                f"'{self.name}': only {have} of {n} requested rows available "
                "(exclude-phrase filtering may discard most of this set)"
            )
        if chunks:
            batch = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        else:
            shape = self.precalculated.shape
            width = shape[1] - (1 if self.labeled else 0)
            batch = np.zeros((0, width, shape[2]), dtype=self.precalculated.dtype)
        batch = batch[:n]
        self.total_taken += batch.shape[0]
        return batch

    def iterate(self) -> Iterator[np.ndarray]:
        while True:
            yield self.take(1)

    def metadata(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "path": self.precalculated_path,
            "shape": tuple(self.precalculated.shape),
            "ordered": self.ordered,
            "labeled": self.labeled,
            "use_mem_map": self.use_mem_map,
        }

    def __len__(self) -> int:
        return len(self.precalculated)


class HostedPrecalculatedDatasetIterator(PrecalculatedDatasetIterator):
    """
    A precalculated dataset hosted remotely: a local file at its path is used
    as it is, otherwise it is downloaded on first use. Download failures
    surface as FileNotFoundError.
    """

    dataset_url: Optional[str] = None
    dataset_sha256: Optional[str] = None

    def __init__(self, name: Optional[str] = None, **kwargs: Any) -> None:
        if self.dataset_url is None:
            raise ValueError(f"{type(self).__name__}.dataset_url is not set")
        resolved_name = name or os.path.splitext(os.path.basename(self.dataset_url))[0]
        directory = kwargs.pop("directory", None) or get_default_dataset_dir()
        path = os.path.join(directory, f"{resolved_name}.npy")
        if not os.path.exists(path):
            try:
                check_download_file(self.dataset_url, path, expected_sha256=self.dataset_sha256)
            except Exception as ex:
                raise FileNotFoundError(
                    f"Hosted dataset {resolved_name} unavailable ({ex}); "
                    "generate features locally or place the .npy at "
                    f"{path}"
                ) from ex
        super().__init__(resolved_name, directory=directory, **kwargs)


class PrecalculatedTrainingDatasetLarge(HostedPrecalculatedDatasetIterator):
    """~46 GB labeled negative training set."""

    dataset_url = (
        "https://huggingface.co/datasets/benjamin-paine/hey-buddy/resolve/main/"
        "precalculated/common/training-large.npy"
    )

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("labeled", True)
        super().__init__("training-large", **kwargs)


class PrecalculatedTrainingDatasetMedium(HostedPrecalculatedDatasetIterator):
    """~25 GB labeled negative training set."""

    dataset_url = (
        "https://huggingface.co/datasets/benjamin-paine/hey-buddy/resolve/main/"
        "precalculated/common/training-medium.npy"
    )

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("labeled", True)
        super().__init__("training-medium", **kwargs)


class PrecalculatedValidationDataset(HostedPrecalculatedDatasetIterator):
    """Hosted labeled negative validation set."""

    dataset_url = (
        "https://huggingface.co/datasets/benjamin-paine/hey-buddy/resolve/main/"
        "precalculated/common/validation.npy"
    )

    def __init__(self, **kwargs: Any) -> None:
        # The hosted validation.npy is labeled [n,17,96] like all hosted sets;
        # without this, 17x96 rows leak through and batch concat fails.
        kwargs.setdefault("labeled", True)
        super().__init__("validation", **kwargs)
