"""
espeak-ng binding (ctypes, no wheel dependency).

A copy of the JAX package's ``text/espeak.py``, so that both packages pick
the same phonemizer on the same machine and phonemize alike.

The reference gets espeak-grade G2P through the ``phonemizer`` package and
piper's ``piper_phonemize`` C++ wheel (reference phonemizer.py:52-160,
piper/pretrained.py:117-159). Neither ships here, so this binds
``libespeak-ng`` directly with ctypes when the shared library is present.
Produces IPA (for piper phoneme-id maps) and ARPAbet (for the adversarial
text engine) behind the same interface as the rule-based
``SimplePhonemizer``; ``get_phonemizer`` upgrades automatically.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import re
from typing import List, Optional

__all__ = ["EspeakPhonemizer", "espeak_library_path"]

# IPA -> ARPAbet, longest-match-first (reference phonemizer.py:52-160 table).
_IPA_TO_ARPABET = [
    ("aʊ", "AW"), ("aɪ", "AY"), ("eɪ", "EY"), ("oʊ", "OW"), ("əʊ", "OW"),
    ("ɔɪ", "OY"), ("tʃ", "CH"), ("dʒ", "JH"), ("ɪə", "IH R"), ("eə", "EH R"),
    ("ʊə", "UH R"), ("ɜː", "ER"), ("ɑː", "AA"), ("ɔː", "AO"), ("uː", "UW"),
    ("iː", "IY"), ("ɑ", "AA"), ("æ", "AE"), ("ʌ", "AH"), ("ɐ", "AH"),
    ("ɔ", "AO"), ("ɒ", "AA"), ("ɛ", "EH"), ("ɜ", "ER"), ("ɝ", "ER"),
    ("ɚ", "ER"), ("ɪ", "IH"), ("i", "IY"), ("ʊ", "UH"), ("u", "UW"),
    ("ə", "AH"), ("e", "EH"), ("a", "AE"), ("o", "OW"),
    ("b", "B"), ("d", "D"), ("ð", "DH"), ("f", "F"), ("ɡ", "G"), ("g", "G"),
    ("h", "HH"), ("k", "K"), ("l", "L"), ("ɫ", "L"), ("m", "M"), ("n", "N"),
    ("ŋ", "NG"), ("p", "P"), ("ɹ", "R"), ("r", "R"), ("ɾ", "T"), ("s", "S"),
    ("ʃ", "SH"), ("t", "T"), ("ʔ", "T"), ("θ", "TH"), ("v", "V"), ("w", "W"),
    ("j", "Y"), ("z", "Z"), ("ʒ", "ZH"),
]
_IPA_IGNORE = "ˈˌːˑ̩̯̃͡ʲ '̯̩͡"


def espeak_library_path() -> Optional[str]:
    """Locate libespeak-ng (env override HEYBUDDY_ESPEAK_LIB > ldconfig)."""
    env = os.environ.get("HEYBUDDY_ESPEAK_LIB")
    if env and os.path.exists(env):
        return env
    for name in ("espeak-ng", "espeak"):
        path = ctypes.util.find_library(name)
        if path:
            return path
    return None


class EspeakPhonemizer:
    """
    Text -> IPA / bracketed ARPAbet through libespeak-ng.

    Same output contract as ``SimplePhonemizer.__call__`` so the two swap
    freely: ``"hello world" -> "[HH][AH][L][OW] [W][ER][L][D]"``.
    """

    name = "espeak"

    # espeak-ng AUDIO_OUTPUT enum value 2 = AUDIO_OUTPUT_SYNCHRONOUS: no
    # audio device is opened — required for a phonemize-only binding in
    # headless environments (value 3 would be SYNCH_PLAYBACK and try to
    # open an audio output).
    _AUDIO_OUTPUT_SYNCHRONOUS = 0x02
    _CHARS_UTF8 = 1
    _PHONEMES_IPA = 0x02

    def __init__(self, voice: str = "en-us", library: Optional[str] = None) -> None:
        path = library or espeak_library_path()
        if path is None:
            raise RuntimeError(
                "libespeak-ng not found; install espeak-ng or set HEYBUDDY_ESPEAK_LIB"
            )
        self.lib = ctypes.CDLL(path)
        self.lib.espeak_Initialize.restype = ctypes.c_int
        self.lib.espeak_SetVoiceByName.restype = ctypes.c_int
        self.lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        self.lib.espeak_TextToPhonemes.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int,
            ctypes.c_int,
        ]
        rate = self.lib.espeak_Initialize(self._AUDIO_OUTPUT_SYNCHRONOUS, 0, None, 0)
        if rate <= 0:
            raise RuntimeError("espeak_Initialize failed")
        if self.lib.espeak_SetVoiceByName(voice.encode()) != 0:
            raise RuntimeError(f"espeak voice {voice!r} unavailable")

    @staticmethod
    def available() -> bool:
        return espeak_library_path() is not None

    def ipa(self, text: str) -> str:
        """Raw IPA phoneme string (words space-separated, clauses joined)."""
        buf = ctypes.create_string_buffer(text.encode("utf-8"))
        ptr = ctypes.c_void_p(ctypes.addressof(buf))
        clauses: List[str] = []
        while ptr.value:
            out = self.lib.espeak_TextToPhonemes(
                ctypes.byref(ptr), self._CHARS_UTF8, self._PHONEMES_IPA
            )
            if out:
                clauses.append(out.decode("utf-8"))
        return " ".join(c.strip() for c in clauses if c.strip())

    @classmethod
    def ipa_word_to_arpabet(cls, ipa_word: str) -> List[str]:
        phones: List[str] = []
        i = 0
        while i < len(ipa_word):
            ch = ipa_word[i]
            if ch in _IPA_IGNORE:
                i += 1
                continue
            for seq, arp in _IPA_TO_ARPABET:
                if ipa_word.startswith(seq, i):
                    phones.extend(arp.split())
                    i += len(seq)
                    break
            else:
                i += 1  # unknown symbol: drop
        return phones

    def word_phones(self, word: str) -> List[str]:
        return self.ipa_word_to_arpabet(self.ipa(word))

    def __call__(self, text: str) -> str:
        out_words = []
        for ipa_word in re.split(r"[\s_]+", self.ipa(text)):
            phones = self.ipa_word_to_arpabet(ipa_word)
            if phones:
                out_words.append("".join(f"[{p}]" for p in phones))
        return " ".join(out_words)
