"""
Logging for heybuddy_tpu_torch: one package logger on stderr, level from
``HEYBUDDY_LOG_LEVEL`` (default INFO), colored on a tty. ``unified_logging``
sets its level for a scope and quiets known noisy third-party loggers;
``debug_logger`` is that scope at DEBUG (every command's ``--debug``).
"""

from __future__ import annotations

import logging
import os
import sys
from contextlib import contextmanager
from typing import Iterator, Optional

__all__ = ["logger", "debug_logger", "unified_logging"]

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[35m",
}
_RESET = "\033[0m"


class ColorFormatter(logging.Formatter):
    """Level-colored formatter when attached to a tty; plain otherwise."""

    def __init__(self, use_color: Optional[bool] = None) -> None:
        super().__init__(
            fmt="%(asctime)s [%(name)s] %(levelname)s %(message)s",
            datefmt="%H:%M:%S",
        )
        if use_color is None:
            use_color = sys.stderr.isatty() and os.environ.get("NO_COLOR") is None
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        color = _COLORS.get(record.levelno, "") if self.use_color else ""
        return f"{color}{text}{_RESET}" if color else text


def _build_logger() -> logging.Logger:
    log = logging.getLogger("heybuddy_torch")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(ColorFormatter())
        log.addHandler(handler)
        log.propagate = False
    level = os.environ.get("HEYBUDDY_LOG_LEVEL", "INFO").upper()
    log.setLevel(getattr(logging, level, logging.INFO))
    return log


logger = _build_logger()

_NOISY_LOGGERS = ["datasets", "urllib3", "filelock", "fsspec", "matplotlib"]


@contextmanager
def unified_logging(level: int = logging.INFO) -> Iterator[None]:
    """Set our level and quiet known-noisy third-party loggers for the scope."""
    previous = logger.level
    noisy_previous = {}
    logger.setLevel(level)
    for name in _NOISY_LOGGERS:
        other = logging.getLogger(name)
        noisy_previous[name] = other.level
        other.setLevel(max(level, logging.WARNING))
    try:
        yield
    finally:
        logger.setLevel(previous)
        for name, lvl in noisy_previous.items():
            logging.getLogger(name).setLevel(lvl)


@contextmanager
def debug_logger() -> Iterator[None]:
    """DEBUG-level logging for the scope."""
    with unified_logging(logging.DEBUG):
        yield
