"""
Tokenizer for labeled feature shards.

Counterpart of the JAX package's ``text/tokens.py``: transcript -> a fixed
length of int64 token ids (special tokens stripped, truncated or zero
padded), stored as row 17 of an extracted shard so that training can exclude
rows containing the wake phrase. What matters is a consistent text -> ids
mapping between extract time and train time, so the ids equal the JAX
package's for the same text and settings.

Resolution order, as in the JAX package:
1. ``HEYBUDDY_TOKENIZER`` naming a ``tokenizer.json`` or ``vocab.txt``: a
   WordPiece tokenizer from the ``tokenizers`` package, imported only then.
2. Otherwise, or if that fails to load: a deterministic hash tokenizer
   (md5 of each lowercase word).
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np

from heybuddy_tpu_torch.utils.log import logger

__all__ = ["PretrainedTokenizer", "BERTTokenizer", "HashWordTokenizer"]

DEFAULT_TOKEN_LENGTH = 96


def _normalize(text: str) -> str:
    return re.sub(r"\s+", " ", re.sub(r"[^a-z0-9']", " ", text.lower())).strip()


class HashWordTokenizer:
    """
    Deterministic offline tokenizer: lowercase word -> stable id in
    [1000, 29000). Keeps a reverse map, so ``decode`` works for the words
    this instance has encoded.
    """

    vocab_size = 30522  # BERT-base size, for range compatibility
    pad_token_id = 0

    def __init__(self) -> None:
        self._reverse: Dict[int, str] = {}

    def _word_id(self, word: str) -> int:
        digest = hashlib.md5(word.encode("utf-8")).digest()
        token = 1000 + int.from_bytes(digest[:4], "little") % 28000
        self._reverse[token] = word
        return token

    def encode(self, text: str) -> List[int]:
        return [self._word_id(w) for w in _normalize(text).split() if w]

    def decode(self, ids: List[int]) -> str:
        return " ".join(self._reverse.get(int(i), "[UNK]") for i in ids if int(i) != 0)


def _load_wordpiece(path: str) -> Any:
    """A ``tokenizers`` tokenizer from a tokenizer.json or a BERT vocab.txt."""
    from tokenizers import Tokenizer, normalizers, pre_tokenizers
    from tokenizers.models import WordPiece

    if path.endswith(".json"):
        return Tokenizer.from_file(path)
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    tok = Tokenizer(WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer()
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    return tok


class PretrainedTokenizer:
    """
    Fixed-length tokenizer: strips special tokens, truncates or pads to
    ``length``, returns int64 numpy arrays.
    """

    def __init__(self, length: int = DEFAULT_TOKEN_LENGTH) -> None:
        self.length = length
        self._backend = self._resolve_backend()

    @staticmethod
    def _resolve_backend() -> Any:
        path = os.environ.get("HEYBUDDY_TOKENIZER")
        if path and os.path.exists(path):
            try:
                return _load_wordpiece(path)
            # the tokenizers package raises a bare Exception for a malformed file;
            # like the JAX package, fall back to the hash tokenizer with a warning
            except Exception as ex:  # noqa: BLE001
                logger.warning(f"Failed to load tokenizer from {path}: {ex}")
        return HashWordTokenizer()

    @property
    def is_wordpiece(self) -> bool:
        return not isinstance(self._backend, HashWordTokenizer)

    def __call__(self, text: str, length: Optional[int] = None) -> np.ndarray:
        length = length if length is not None else self.length
        if isinstance(self._backend, HashWordTokenizer):
            ids = self._backend.encode(text)
        else:
            encoding = self._backend.encode(text)
            special = {"[CLS]", "[SEP]", "[PAD]"}
            ids = [i for i, tok in zip(encoding.ids, encoding.tokens) if tok not in special]
        ids = ids[:length]
        out = np.zeros(length, dtype=np.int64)
        out[: len(ids)] = ids
        return out

    def decode(self, ids: np.ndarray) -> str:
        return self._backend.decode([int(i) for i in np.asarray(ids).flatten() if int(i) != 0])


class BERTTokenizer(PretrainedTokenizer):
    """The tokenizer of labeled feature shards."""
