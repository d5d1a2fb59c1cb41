"""
Piper interop data: the default phoneme-id and speaker-id maps.

The port's copy of the JAX package's readers. The tables are data files of
the JAX package (``heybuddy_tpu/assets/piper_*.json``), read by path:

* ``piper_phoneme_id_map``: piper-phonemize's default IPA -> id map
  (pad 0, bos 1, eos 2, then IPA letters and diacritics), the ids every
  Piper voice trained with piper-phonemize expects;
* ``piper_speaker_id_map``: the 904-speaker LibriTTS voice's speaker name ->
  id table.

A voice's own ``config.json`` takes precedence (``models/tts.py``).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List

__all__ = ["piper_phoneme_id_map", "piper_speaker_id_map"]

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "heybuddy_tpu", "assets"
)


@functools.lru_cache(maxsize=None)
def piper_phoneme_id_map() -> Dict[str, List[int]]:
    """IPA character -> [id] (piper-phonemize's default table)."""
    with open(os.path.join(_ASSET_DIR, "piper_phoneme_id_map.json"), encoding="utf-8") as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def piper_speaker_id_map() -> Dict[str, int]:
    """LibriTTS speaker name -> speaker id (904 speakers)."""
    with open(os.path.join(_ASSET_DIR, "piper_speaker_id_map.json"), encoding="utf-8") as f:
        return json.load(f)
