"""
Rule-G2P accuracy: the port's rule engine against dictionary truth.

    python -m heybuddy_tpu_torch.tools.g2p_accuracy [--sample 2000] [--json out.json] [--seed 0]

The counterpart of the JAX package's ``scripts/g2p_accuracy.py``, with its
arguments and its JSON. It scores ``text/phonemizer.py``'s RULE engine
(exception lexicon + letter-context rules, CMUdict disabled) against:

* the full CMU pronouncing dictionary when ``HEYBUDDY_CMUDICT`` points at one
  (a seeded sample of its alphabetic words), and
* the embedded golden lexicon ``GOLDEN`` (stress-stripped CMUdict
  pronunciations of common and wake-word-relevant words) always.

It reports word accuracy (exact phone-sequence match), phone error rate
(Levenshtein distance over ARPAbet symbols / reference length) and the 15
worst words. Python only, so it runs anywhere and takes no ``--device``,
like the script.
"""

from __future__ import annotations

import argparse
import json
import random
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["GOLDEN", "edit_distance", "score", "cmudict_pairs", "accuracy", "main"]

# Stress-stripped CMUdict pronunciations. Deliberately NOT drawn from the
# phonemizer's exception table alone: includes rule-path words.
GOLDEN = {
    "about": "AH B AW T", "after": "AE F T ER", "almost": "AO L M OW S T",
    "baby": "B EY B IY", "back": "B AE K", "banana": "B AH N AE N AH",
    "basket": "B AE S K AH T", "bed": "B EH D", "big": "B IH G",
    "black": "B L AE K", "blue": "B L UW", "book": "B UH K",
    "bottle": "B AA T AH L", "box": "B AA K S", "bring": "B R IH NG",
    "brother": "B R AH DH ER", "brown": "B R AW N", "bunny": "B AH N IY",
    "butter": "B AH T ER", "cake": "K EY K", "car": "K AA R",
    "cat": "K AE T", "chair": "CH EH R", "cheese": "CH IY Z",
    "chicken": "CH IH K AH N", "child": "CH AY L D", "clean": "K L IY N",
    "clock": "K L AA K", "cold": "K OW L D", "cookie": "K UH K IY",
    "corn": "K AO R N", "cup": "K AH P", "dance": "D AE N S",
    "dark": "D AA R K", "day": "D EY", "deep": "D IY P",
    "dinner": "D IH N ER", "doctor": "D AA K T ER", "dog": "D AO G",
    "door": "D AO R", "dream": "D R IY M", "dress": "D R EH S",
    "drink": "D R IH NG K", "drive": "D R AY V", "duck": "D AH K",
    "east": "IY S T", "eat": "IY T", "egg": "EH G",
    "face": "F EY S", "fall": "F AO L", "farm": "F AA R M",
    "fast": "F AE S T", "feet": "F IY T", "find": "F AY N D",
    "fine": "F AY N", "fish": "F IH SH", "five": "F AY V",
    "flower": "F L AW ER", "food": "F UW D", "four": "F AO R",
    "fox": "F AA K S", "frog": "F R AO G", "fun": "F AH N",
    "game": "G EY M", "garden": "G AA R D AH N", "girl": "G ER L",
    "glass": "G L AE S", "green": "G R IY N", "hand": "HH AE N D",
    "happy": "HH AE P IY", "hat": "HH AE T", "help": "HH EH L P",
    "home": "HH OW M", "horse": "HH AO R S", "hot": "HH AA T",
    "jump": "JH AH M P", "keep": "K IY P", "king": "K IH NG",
    "kitchen": "K IH CH AH N", "lake": "L EY K", "land": "L AE N D",
    "last": "L AE S T", "late": "L EY T", "leg": "L EH G",
    "letter": "L EH T ER", "like": "L AY K", "long": "L AO NG",
    "look": "L UH K", "make": "M EY K", "man": "M AE N",
    "milk": "M IH L K", "moon": "M UW N", "morning": "M AO R N IH NG",
    "mother": "M AH DH ER", "mountain": "M AW N T AH N", "name": "N EY M",
    "nest": "N EH S T", "nice": "N AY S", "north": "N AO R TH",
    "old": "OW L D", "orange": "AO R AH N JH", "park": "P AA R K",
    "pen": "P EH N", "pig": "P IH G", "pink": "P IH NG K",
    "plant": "P L AE N T", "print": "P R IH N T", "rabbit": "R AE B AH T",
    "rain": "R EY N", "read": "R IY D", "red": "R EH D",
    "ring": "R IH NG", "river": "R IH V ER", "room": "R UW M",
    "run": "R AH N", "sand": "S AE N D", "school": "S K UW L",
    "sea": "S IY", "seat": "S IY T", "send": "S EH N D",
    "seven": "S EH V AH N", "sheep": "SH IY P", "ship": "SH IH P",
    "shoe": "SH UW", "sing": "S IH NG", "sister": "S IH S T ER",
    "sit": "S IH T", "six": "S IH K S", "sky": "S K AY",
    "sleep": "S L IY P", "small": "S M AO L", "smile": "S M AY L",
    "snake": "S N EY K", "snow": "S N OW", "song": "S AO NG",
    "soon": "S UW N", "spring": "S P R IH NG", "star": "S T AA R",
    "stand": "S T AE N D", "stone": "S T OW N", "street": "S T R IY T",
    "strong": "S T R AO NG", "summer": "S AH M ER", "sun": "S AH N",
    "sweet": "S W IY T", "swim": "S W IH M", "table": "T EY B AH L",
    "take": "T EY K", "tall": "T AO L", "ten": "T EH N",
    "test": "T EH S T", "three": "TH R IY", "train": "T R EY N",
    "tree": "T R IY", "truck": "T R AH K", "under": "AH N D ER",
    "warm": "W AO R M", "west": "W EH S T", "wind": "W IH N D",
    "window": "W IH N D OW", "winter": "W IH N T ER", "yellow": "Y EH L OW",
    # words added after the rule engine reached 1.00 on the 162 above, so
    # that the metric keeps measuring generalization (several are expected
    # failures of known rule gaps)
    "paper": "P EY P ER", "spider": "S P AY D ER", "never": "N EH V ER",
    "candy": "K AE N D IY", "simple": "S IH M P AH L", "purple": "P ER P AH L",
    "middle": "M IH D AH L", "funny": "F AH N IY", "puppy": "P AH P IY",
    "kitten": "K IH T AH N", "button": "B AH T AH N", "lesson": "L EH S AH N",
    "ribbon": "R IH B AH N", "dragon": "D R AE G AH N", "wagon": "W AE G AH N",
    "lemon": "L EH M AH N", "melon": "M EH L AH N", "second": "S EH K AH N D",
    "moment": "M OW M AH N T", "follow": "F AA L OW", "pillow": "P IH L OW",
    "shadow": "SH AE D OW", "silver": "S IH L V ER", "finger": "F IH NG G ER",
    "better": "B EH T ER", "rubber": "R AH B ER", "string": "S T R IH NG",
    "queen": "K W IY N", "screen": "S K R IY N", "plate": "P L EY T",
    "grape": "G R EY P", "plane": "P L EY N", "white": "W AY T",
    "write": "R AY T", "wrong": "R AO NG", "young": "Y AH NG",
    "story": "S T AO R IY", "party": "P AA R T IY", "forty": "F AO R T IY",
    "dirty": "D ER T IY", "thirty": "TH ER T IY", "city": "S IH T IY",
    "candle": "K AE N D AH L", "jungle": "JH AH NG G AH L",
    "turtle": "T ER T AH L", "gentle": "JH EH N T AH L",
    "teacher": "T IY CH ER", "farmer": "F AA R M ER", "number": "N AH M B ER",
    "hundred": "HH AH N D R AH D", "thousand": "TH AW Z AH N D",
    "center": "S EH N T ER", "carrot": "K AE R AH T", "minute": "M IH N AH T",
    "pretty": "P R IH T IY", "upon": "AH P AA N",
}


def edit_distance(a: Sequence[str], b: Sequence[str]) -> int:
    """Levenshtein distance between two symbol sequences."""
    m, n = len(a), len(b)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[n]


def score(pairs: Sequence[Tuple[str, str]], g2p: Callable[[str], List[str]]) -> Dict:
    """``(word, "REF PHONES")`` pairs through ``g2p``: word accuracy, phone
    error rate and the 15 worst words (by distance over reference length)."""
    exact = 0
    dist = 0
    ref_len = 0
    worst = []
    for word, ref in pairs:
        hyp = g2p(word)
        ref_phones = ref.split()
        d = edit_distance(hyp, ref_phones)
        exact += int(hyp == ref_phones)
        dist += d
        ref_len += len(ref_phones)
        if d > 0:
            worst.append((d / max(len(ref_phones), 1), word, " ".join(hyp), ref))
    worst.sort(reverse=True)
    return {
        "words": len(pairs),
        "word_accuracy": round(exact / max(len(pairs), 1), 4),
        "phone_error_rate": round(dist / max(ref_len, 1), 4),
        "worst": [{"word": w, "hyp": h, "ref": r} for _, w, h, r in worst[:15]],
    }


def cmudict_pairs(cmu: Dict[str, List[str]], sample: int, seed: int) -> List[Tuple[str, str]]:
    """A seeded sample of the dictionary's alphabetic words with their stress-stripped phones."""
    rng = random.Random(seed)
    words = [w for w in cmu if w.isalpha()]
    chosen = rng.sample(words, min(sample, len(words)))
    return [(w, " ".join(re.sub(r"\d", "", p) for p in cmu[w])) for w in chosen]


def accuracy(sample: int = 2000, seed: int = 0, cmu: Optional[Dict[str, List[str]]] = None) -> Dict:
    """The report: ``"cmudict"`` when a dictionary is given (or
    ``HEYBUDDY_CMUDICT`` names one), and ``"golden"``."""
    from heybuddy_tpu_torch.text.phonemizer import _g2p_word, load_cmudict

    results = {}
    cmu = cmu if cmu is not None else load_cmudict()
    if cmu:
        results["cmudict"] = score(cmudict_pairs(cmu, sample, seed), _g2p_word)
    results["golden"] = score(sorted(GOLDEN.items()), _g2p_word)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sample", type=int, default=2000, help="CMUdict sample size (when HEYBUDDY_CMUDICT is set)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    results = accuracy(args.sample, args.seed)
    print(json.dumps(results, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
