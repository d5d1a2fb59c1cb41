"""
Adversarial phrase generation via phoneme-overlap search.

A copy of the JAX package's ``text/adversarial.py`` (numpy only): for the
same phrase and seed the adversarial, prefix-negative and swap-collision
texts are equal to the JAX package's.

Capability parity with reference ``util/lang_util.py``: for each word of the
wake phrase, find dictionary words whose pronunciations match the word's phone
sequence with up to ``len-2`` phonemes wildcarded and all vowel stresses freed,
then sample adversarial phrases (optionally keeping some input words, and
occasionally sampling partial phrases). These become the hard-negative TTS
prompts.

The search corpus is the CMU dictionary when available (``HEYBUDDY_CMUDICT``),
otherwise a bundled common-word list phonemized by the rule G2P — smaller, but
fully offline and deterministic.
"""

from __future__ import annotations

import itertools
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from heybuddy_tpu_torch.text.phonemizer import SimplePhonemizer, get_phonemizer, load_cmudict, VOWEL_PHONEMES
from heybuddy_tpu_torch.text.wordlist import WORDS
from heybuddy_tpu_torch.utils.log import logger

__all__ = [
    "AdversarialTextGenerator",
    "get_adversarial_text_generator",
    "prefix_negative_texts",
    "replace_phonemes",
]


def replace_phonemes(
    input_chars: List[str],
    max_replace: int,
    replace_char: str = "(.){1,3}",
) -> List[str]:
    """
    All phone sequences with 1..max_replace positions wildcarded
    (reference lang_util.py:18-38).
    """
    results = []
    num_chars = len(input_chars)
    for r in range(1, max_replace + 1):
        for combination in itertools.combinations(range(num_chars), r):
            chars = input_chars.copy()
            for index in combination:
                chars[index] = replace_char
            results.append(" ".join(chars))
    return results


def _stress_phones(phones: List[str]) -> str:
    """Attach stress digits (primary on first vowel, 0 on the rest)."""
    out = []
    seen_vowel = False
    for p in phones:
        if p in VOWEL_PHONEMES:
            out.append(p + ("1" if not seen_vowel else "0"))
            seen_vowel = True
        else:
            out.append(p)
    return " ".join(out)


class Lexicon:
    """word -> stressed phone string, with regex search over pronunciations."""

    def __init__(self) -> None:
        self.entries: Dict[str, str] = {}
        cmu = load_cmudict()
        if cmu is not None:
            for word, phones in cmu.items():
                if word.isalpha():
                    self.entries[word] = " ".join(phones)
            logger.info(f"Adversarial lexicon: CMU dictionary with {len(self.entries)} words")
        else:
            g2p = SimplePhonemizer(use_cmudict=False)
            # sorted: set iteration order depends on PYTHONHASHSEED, which
            # would make candidate order — and therefore seeded pools —
            # differ across processes.
            for word in sorted(set(WORDS)):
                phones = g2p.word_phones(word)
                if phones:
                    self.entries[word] = _stress_phones(phones)
        self._items: List[Tuple[str, str]] = sorted(self.entries.items())

    def phones_for_word(self, word: str) -> Optional[str]:
        return self.entries.get(word.lower())

    def search(self, pattern: str) -> List[str]:
        """Words whose phone string contains the pattern (pronouncing semantics).

        The pattern is anchored with word boundaries like pronouncing.search
        (reference lang_util via pronouncing): without them a literal phone
        matches prefixes of longer phones (T inside TH, S inside SH), letting
        words 2+ phoneme edits away pose as near-collisions.
        """
        regex = re.compile(r"\b" + pattern + r"\b")
        return [word for word, phones in self._items if regex.search(phones)]


_GLOBAL_LEXICON: Optional[Lexicon] = None


def get_lexicon() -> Lexicon:
    global _GLOBAL_LEXICON
    if _GLOBAL_LEXICON is None:
        _GLOBAL_LEXICON = Lexicon()
    return _GLOBAL_LEXICON


class AdversarialTextGenerator:
    """
    Generate phonetically-adversarial words and phrases
    (reference util/lang_util.py:40-167).
    """

    def __init__(
        self,
        partial_phrase_ratio: float = 0.10,
        input_words_ratio: float = 0.33,
        lexicon: Optional[Lexicon] = None,
        **_compat_kwargs,
    ) -> None:
        self.partial_phrase_ratio = partial_phrase_ratio
        self.input_words_ratio = input_words_ratio
        self.lexicon = lexicon or get_lexicon()
        self._phonemizer = get_phonemizer()

    def _word_queries(self, phones: List[str]) -> List[str]:
        """Wildcarded queries with freed vowel stress (lang_util.py:123-137)."""
        freed = [
            p + "[012]" if p in VOWEL_PHONEMES else p
            for p in (re.sub(r"\d+", "", x) for x in phones)
        ]
        if len(freed) <= 2:
            return [" ".join(freed)]
        return replace_phonemes(freed, max_replace=max(0, len(freed) - 2))

    def adversarial_words(self, word: str) -> List[str]:
        """All lexicon words phonetically near ``word`` but not identical."""
        word = word.lower()
        phone_str = self.lexicon.phones_for_word(word)
        if phone_str is None:
            phones = self._phonemizer.word_phones(word)
            phone_str = _stress_phones(phones)
        phones = phone_str.split()
        if not phones:
            # Digits/punctuation-only "words" phonemize to nothing; an empty
            # query would regex-match EVERY lexicon entry.
            return []
        exact = " ".join(re.sub(r"\d+", "", p) for p in phones)

        candidates: List[str] = []
        for query in self._word_queries(phones):
            for match in self.lexicon.search(query):
                match_phones = self.lexicon.phones_for_word(match) or ""
                match_exact = " ".join(re.sub(r"\d+", "", p) for p in match_phones.split())
                if match_exact != exact and match != word:
                    candidates.append(match)
        return candidates

    def __call__(
        self,
        input_text: str,
        num_samples: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> Iterator[str]:
        rng = np.random.default_rng(seed)
        words = input_text.split()
        adversarial_per_word: List[List[str]] = []
        for word in words:
            found = self.adversarial_words(word)
            if found:
                adversarial_per_word.append(found)
            else:
                logger.warning(f"No adversarial candidates for '{word}'; keeping the word itself")
                adversarial_per_word.append([word])

        # Degenerate case: a single word with no phonetic neighbors can only
        # ever reproduce the input — the rejection loop below would never
        # terminate (measured: 'wednesday' has no neighbors in the bundled
        # lexicon and hung a 512-cluster pretraining text build).
        if len(words) == 1 and adversarial_per_word[0] == [words[0]]:
            logger.warning(
                f"No distinct adversarial texts possible for '{input_text}'"
            )
            return

        yielded = 0
        failures = 0
        seen: set = set()
        while num_samples is None or yielded < num_samples:
            parts: List[str] = []
            for candidates, original in zip(adversarial_per_word, words):
                if rng.random() > (1.0 - self.input_words_ratio):
                    parts.append(original)
                else:
                    parts.append(str(candidates[rng.integers(0, len(candidates))]))

            if len(words) > 1 and rng.random() <= self.partial_phrase_ratio:
                n_words = int(rng.integers(1, len(words) + 1))
                chosen = rng.choice(parts, size=n_words, replace=False)
                adversarial_text = " ".join(str(c) for c in chosen)
            else:
                adversarial_text = " ".join(parts)

            if adversarial_text != input_text and adversarial_text not in seen:
                seen.add(adversarial_text)
                yield adversarial_text
                yielded += 1
                failures = 0
            else:
                # Bounded rejection: duplicates (candidate multiplicity made a
                # 60-draw pool carry the same phrase 10+ times, collapsing
                # training adversarial diversity) or the input itself. With few
                # candidates distinct texts may be rare or impossible.
                failures += 1
                # Rejection draws are near-free (no TTS); a tight bound made
                # large pools exhaust early because the word distribution is
                # multiplicity-weighted and late draws are mostly duplicates
                # (measured: 150 requested -> 134 yielded at bound 100).
                if failures >= 2000:
                    logger.warning(
                        f"Exhausted adversarial sampling for '{input_text}' "
                        f"after {yielded} distinct text(s)"
                    )
                    return


# Neutral sentence continuations appended after the divergence point so a
# prefix negative sounds like ongoing speech (the stream distribution the
# deployed sliding window scores), not an isolated word.
_PREFIX_CONTINUATIONS: List[str] = [
    "can you come here",
    "did you see that",
    "what is the time",
    "the meeting starts soon",
    "we should go now",
    "turn it down a bit",
    "i was thinking about it",
    "over there by the door",
    "later this afternoon",
    "that was really loud",
    "where did it go",
    "it works now",
]


def prefix_negative_texts(
    phrase: str,
    num_samples: int = 64,
    seed: int = 0,
    min_prefix_phones: int = 2,
    lexicon: Optional[Lexicon] = None,
) -> List[str]:
    """Texts that BEGIN exactly like ``phrase`` and then diverge mid-word.

    A causal sliding-window classifier hears the wake phrase's onset before
    its completion, so a model trained only on full-phrase positives and
    whole-word adversaries can fire on the shared prefix alone (measured:
    "hey but" — a strict prefix of "hey buddy" — fired the deployed gate on
    50% of renderings while every whole-word near-collision sat at 0.0).

    For each word position ``i`` and lexicon word sharing that word's first
    ``>= min_prefix_phones`` phones before continuing differently (or ending,
    like "bud" inside "buddy"), emit ``words[:i] + divergent_word +
    continuation`` — the exact phrase onset followed by non-target speech.
    Candidates are ranked by total matched onset phones, so the deepest
    prefixes ("hey bud-" + budget/button/buzzer) dominate the pool. Words
    that EXTEND the full target word ("buddies") are excluded: rejecting
    them would teach rejection of the phrase itself.

    No reference equivalent — its adversarial generator substitutes whole
    words only (reference util/lang_util.py:40-167).
    """
    lexicon = lexicon or get_lexicon()
    phonemizer = get_phonemizer()
    rng = np.random.default_rng(seed)
    words = phrase.lower().split()

    def stripped(phones_str: str) -> Tuple[str, ...]:
        return tuple(re.sub(r"\d+", "", p) for p in phones_str.split())

    word_phone_counts: List[int] = []
    scored: List[Tuple[int, int, str]] = []  # (onset_phones, word_index, candidate)
    for i, word in enumerate(words):
        phones_str = lexicon.phones_for_word(word)
        if phones_str is None:
            phones = phonemizer.word_phones(word)
            phones_str = _stress_phones(phones) if phones else ""
        target = stripped(phones_str)
        word_phone_counts.append(len(target))
        if len(target) < min_prefix_phones:
            continue
        onset_before = sum(word_phone_counts[:i])
        seen_pron: set = set()
        for cand, cand_phones in lexicon._items:
            cp = stripped(cand_phones)
            if cand == word or cp == target or cp in seen_pron:
                continue
            match = 0
            for a, b in zip(cp, target):
                if a != b:
                    break
                match += 1
            if match < min_prefix_phones or match == len(target):
                continue
            seen_pron.add(cp)
            scored.append((onset_before + match, i, cand))

    if not scored:
        return []
    # Deepest onsets first; rng only breaks ties so seeded pools vary without
    # ever preferring a shallow prefix over a deep one.
    order = rng.permutation(len(scored))
    ranked = sorted(
        (scored[j] for j in order), key=lambda t: (-t[0], -t[1])
    )
    keep = ranked[: max(num_samples, 32)]

    texts: List[str] = []
    seen_text: set = set()
    k = 0
    while len(texts) < num_samples and k < 8 * num_samples:
        onset, i, cand = keep[k % len(keep)]
        k += 1
        cont = _PREFIX_CONTINUATIONS[int(rng.integers(0, len(_PREFIX_CONTINUATIONS)))]
        parts = words[:i] + [cand]
        # Vary the continuation presence: bare divergences ("hey bud") teach
        # the clip boundary, continued ones teach the stream case.
        if rng.random() < 0.85:
            parts.append(cont)
        text = " ".join(parts)
        if text != phrase and text not in seen_text:
            seen_text.add(text)
            texts.append(text)
    return texts


def single_swap_collision_texts(
    phrase: str,
    num_samples: int = 48,
    seed: int = 0,
    exclude: Optional[List[str]] = None,
    max_swaps: int = 1,
) -> List[str]:
    """Texts differing from ``phrase`` in a small number of words, each
    swapped with a phonetic neighbor — the maximal-overlap collision class.

    Motivation (QUALITY.md round-4 tail): the v23 per-text FAR attribution
    put the held-out FAR_adv mass on texts keeping all-but-one word of the
    wake phrase verbatim ("hate buddy" 0.625, "hey buddies" 0.625, "hey
    duty" 0.5, "hey body" 0.417). The generic adversarial generator swaps
    each word INDEPENDENTLY (keep probability ``input_words_ratio`` = 0.33
    per word), so for a 2-word phrase only ~44% of its pool is single-swap
    and the hardest texts are systematically under-represented in training
    relative to their share of the measured failure mass.

    ``max_swaps=1`` (default) emits one text per (position, neighbor) pair,
    round-robin across positions (so a phrase with one neighbor-rich word
    still covers every position), neighbor order seeded — byte-identical to
    the round-5 v25 channel. ``max_swaps>=2`` interleaves deeper depths
    round-robin (depth 1, depth 2, depth 1, ...), where a depth-d text swaps
    exactly d positions with seeded neighbor draws: the v25 attribution
    showed the residual FAR mass moving to DOUBLE swaps once single swaps
    were trained ("hate buddies" 0.583, "hate bully" 0.542 — QUALITY.md
    round 5). ``exclude`` removes exact strings — callers pass the held-out
    pool so the emphasis class can never train on the literally-measured
    texts.

    No reference equivalent (its generator has no swap-depth mode,
    reference util/lang_util.py:40-167).
    """
    from itertools import combinations

    g = get_adversarial_text_generator()
    rng = np.random.default_rng(seed)
    words = phrase.lower().split()
    excluded = {t.lower() for t in (exclude or [])} | {phrase.lower()}

    per_pos: List[List[str]] = []
    for w in words:
        # adversarial_words is multiplicity-weighted (one entry per matching
        # wildcard query); dedupe preserving rank, then shuffle seeded.
        neigh = [n for n in dict.fromkeys(g.adversarial_words(w)) if n != w]
        per_pos.append([neigh[j] for j in rng.permutation(len(neigh))])

    def depth1_iter():
        """Original round-robin-across-positions order (kept byte-stable)."""
        idx = [0] * len(words)
        while True:
            progress = False
            for i in range(len(words)):
                while idx[i] < len(per_pos[i]):
                    cand = list(words)
                    cand[i] = per_pos[i][idx[i]]
                    idx[i] += 1
                    text = " ".join(cand)
                    if text not in excluded:
                        progress = True
                        yield text
                        break
            if not progress:
                return

    def depth_iter(d: int):
        """Depth-d texts: every d-position combo, seeded neighbor draws."""
        combos = [c for c in combinations(range(len(words)), d)
                  if all(per_pos[i] for i in c)]
        if not combos:
            return
        drng = np.random.default_rng(seed + 104729 * d)
        attempts = 0
        max_attempts = 40 * max(num_samples, 1)
        while attempts < max_attempts:
            for combo in combos:
                attempts += 1
                cand = list(words)
                for i in combo:
                    cand[i] = per_pos[i][int(drng.integers(0, len(per_pos[i])))]
                text = " ".join(cand)
                if text not in excluded:
                    yield text

    depths = [depth1_iter()] + [
        depth_iter(d) for d in range(2, min(max_swaps, len(words)) + 1)
    ]
    texts: List[str] = []
    while len(texts) < num_samples and depths:
        alive = []
        for it in depths:
            if len(texts) >= num_samples:
                break
            text = next(it, None)
            if text is None:
                continue
            excluded.add(text)
            texts.append(text)
            alive.append(it)
        depths = alive
    return texts


_GLOBAL_GENERATOR: Optional[AdversarialTextGenerator] = None
_GLOBAL_GENERATOR_KWARGS: dict = {}


def get_adversarial_text_generator(**kwargs) -> AdversarialTextGenerator:
    """Shared generator instance (reference lang_util.py:169-178).

    Rebuilds when called with different kwargs than the cached instance —
    silently returning a differently-configured singleton would drop the
    caller's parameters."""
    global _GLOBAL_GENERATOR, _GLOBAL_GENERATOR_KWARGS
    if _GLOBAL_GENERATOR is None or kwargs != _GLOBAL_GENERATOR_KWARGS:
        _GLOBAL_GENERATOR = AdversarialTextGenerator(**kwargs)
        _GLOBAL_GENERATOR_KWARGS = dict(kwargs)
    return _GLOBAL_GENERATOR
