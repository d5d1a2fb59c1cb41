"""
String helpers: the filesystem slug that feature caches are keyed by, and a
human-readable duration for log lines. Equal to the JAX package's for every
input (held by the tests).
"""

from __future__ import annotations

import re

__all__ = ["safe_name", "human_duration", "human_size"]

_SLUG_STRIP = re.compile(r"[^a-z0-9]+")


def safe_name(text: str) -> str:
    """
    Lower-case ``text`` and join its alphanumeric runs with ``-``.

    >>> safe_name("Hello, World!")
    'hello-world'
    >>> safe_name("  hey   buddy  ")
    'hey-buddy'
    """
    return _SLUG_STRIP.sub("-", text.strip().lower()).strip("-")


def human_duration(seconds: float) -> str:
    """
    ``seconds`` as ``500ms``, ``1m 30s`` or ``1h 2m 5s``.

    >>> human_duration(0.5)
    '500ms'
    >>> human_duration(3725)
    '1h 2m 5s'
    """
    if seconds < 1:
        return f"{seconds * 1000:.0f}ms"
    seconds = int(round(seconds))
    hours, rem = divmod(seconds, 3600)
    minutes, secs = divmod(rem, 60)
    parts = []
    if hours:
        parts.append(f"{hours}h")
    if minutes:
        parts.append(f"{minutes}m")
    if secs or not parts:
        parts.append(f"{secs}s")
    return " ".join(parts)


def human_size(num_bytes: float) -> str:
    """A byte count as "512B", "2.0KB", "5.0GB" (powers of 1024, up to PB)."""
    size = float(num_bytes)
    for unit in ["B", "KB", "MB", "GB", "TB", "PB"]:
        if abs(size) < 1024.0 or unit == "PB":
            return f"{int(size)}{unit}" if unit == "B" else f"{size:.1f}{unit}"
        size /= 1024.0
    return f"{size:.1f}PB"
