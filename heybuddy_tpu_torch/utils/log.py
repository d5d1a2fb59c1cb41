"""
Logging for heybuddy_tpu_torch: one package logger on stderr, level from
``HEYBUDDY_LOG_LEVEL`` (default INFO), colored on a tty.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

__all__ = ["logger"]

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
