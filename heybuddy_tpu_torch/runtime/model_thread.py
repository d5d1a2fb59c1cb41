"""
Threaded wake-word inference.

Counterpart of the JAX package's ``runtime/model_thread.py``: one model per
thread behind an input and an output queue, results tagged with the
sequence number of their ``put`` so a late result never pairs with a later
chunk, and a load error raised on ``get``. ``listen`` uses it when
``HEYBUDDY_LISTEN_THREADS=1``, and then each worker thread launches its
model's CUDA work itself.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np

from heybuddy_tpu_torch.device import DeviceLike
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.profiling import span

__all__ = ["WakeWordModelThread"]


class WakeWordModelThread:
    """Runs one wake-word model on its own thread, fed through queues."""

    def __init__(self, checkpoint_path: str, threshold: float = 0.5, device: DeviceLike = "cuda") -> None:
        self.checkpoint_path = checkpoint_path
        self.threshold = threshold
        self.device = device
        self.input_queue: "queue.Queue[Optional[Tuple[int, np.ndarray]]]" = queue.Queue()
        self.output_queue: "queue.Queue[Tuple[int, float, float]]" = queue.Queue()
        self.last_duration = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._model: Any = None
        self._load_error: Optional[Exception] = None
        self._seq = 0
        self._thread.start()

    def _load(self) -> Any:
        from heybuddy_tpu_torch.cli import _load_any_model

        return _load_any_model(self.checkpoint_path, device=self.device)

    def run(self) -> None:
        try:
            self._model = self._load()
        except Exception as ex:
            # kept for get() to raise, instead of the caller waiting out its timeout
            self._load_error = ex
            logger.error(f"Failed to load {self.checkpoint_path}: {ex}")
            return
        while not self._stop.is_set():
            try:
                item = self.input_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                break
            seq, audio = item
            start = time.perf_counter()
            try:
                with span("listen/score"):
                    scores = self._model.predict(audio, return_scores=True)
                score = float(scores[0]) if scores else 0.0
            except Exception as ex:
                logger.error(f"Prediction failed for {self.checkpoint_path}: {ex}")
                score = 0.0
            self.last_duration = time.perf_counter() - start
            self.output_queue.put((seq, score, self.last_duration))

    def put(self, audio: np.ndarray) -> None:
        self._seq += 1
        self.input_queue.put((self._seq, audio))

    def get(self, timeout: Optional[float] = None) -> Tuple[float, float]:
        """(score, seconds taken) of the latest ``put``; earlier results that
        arrive late are dropped by their sequence tag."""
        if self._load_error is not None:
            raise RuntimeError(f"model failed to load from {self.checkpoint_path}: {self._load_error}")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            seq, score, duration = self.output_queue.get(timeout=remaining)
            if seq == self._seq:
                return score, duration

    def stop(self) -> None:
        self._stop.set()
        self.input_queue.put(None)
        self._thread.join(timeout=5)
