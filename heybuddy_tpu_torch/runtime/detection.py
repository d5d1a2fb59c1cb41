"""
Detection gating of streaming wake-word scores.

The deployed runtimes score a sliding window every 0.12 s. A true utterance
keeps its score high for several consecutive windows, while most streaming
false positives are single-window spikes. ``ConsecutiveGate`` fires when
``consecutive`` successive scores reach the threshold and then holds off for
``debounce_windows`` strides; ``consecutive=1`` fires on a single window, as
the browser runtime does. The trainer's gate-aware validation counts stream
false accepts with it. Equal to the JAX package's gate on every sequence.
"""

from __future__ import annotations

from typing import Iterable

__all__ = ["ConsecutiveGate", "count_detections"]


class ConsecutiveGate:
    """Fire when ``consecutive`` successive scores reach ``threshold``."""

    def __init__(self, threshold: float = 0.5, consecutive: int = 1, debounce_windows: int = 16) -> None:
        if consecutive < 1:
            raise ValueError(f"consecutive must be >= 1, got {consecutive}")
        self.threshold = float(threshold)
        self.consecutive = int(consecutive)
        self.debounce_windows = int(debounce_windows)
        self.reset()

    def reset(self) -> None:
        self._run = 0
        self._cooldown = 0

    def update(self, score: float) -> bool:
        """Feed one window score; returns True when a detection fires."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return False
        if score >= self.threshold:
            self._run += 1
            if self._run >= self.consecutive:
                self._run = 0
                self._cooldown = self.debounce_windows
                return True
        else:
            self._run = 0
        return False


def count_detections(
    scores: Iterable[float], threshold: float, consecutive: int = 1, debounce_windows: int = 16
) -> int:
    """Detections over a score sequence with the runtime's gating."""
    gate = ConsecutiveGate(threshold=threshold, consecutive=consecutive, debounce_windows=debounce_windows)
    return sum(1 for s in scores if gate.update(float(s)))
