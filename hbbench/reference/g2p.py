"""Grapheme-to-phoneme for the reference planner, written out again: the
rule engine (an exception lexicon, then letter-context rules) that gives
each word its ARPAbet phones without stress marks, e.g. "buddy" ->
B AH D IY. The benchmark runs the program on this engine too (no espeak, no
pronouncing dictionary)."""

from __future__ import annotations

import re
from typing import Dict, List

_EXCEPTIONS: Dict[str, str] = {
    "a": "AH", "an": "AE N", "the": "DH AH", "of": "AH V", "to": "T UW",
    "and": "AE N D", "is": "IH Z", "are": "AA R", "was": "W AA Z",
    "were": "W ER", "be": "B IY", "been": "B IH N", "have": "HH AE V",
    "has": "HH AE Z", "had": "HH AE D", "do": "D UW", "does": "D AH Z",
    "did": "D IH D", "will": "W IH L", "would": "W UH D", "should": "SH UH D",
    "could": "K UH D", "can": "K AE N", "may": "M EY", "might": "M AY T",
    "one": "W AH N", "two": "T UW", "once": "W AH N S", "who": "HH UW",
    "what": "W AH T", "where": "W EH R", "when": "W EH N", "why": "W AY",
    "how": "HH AW", "there": "DH EH R", "their": "DH EH R", "they": "DH EY",
    "them": "DH EH M", "these": "DH IY Z", "those": "DH OW Z",
    "this": "DH IH S", "that": "DH AE T", "then": "DH EH N", "than": "DH AE N",
    "with": "W IH DH", "from": "F R AH M", "come": "K AH M", "some": "S AH M",
    "done": "D AH N", "gone": "G AO N", "none": "N AH N", "love": "L AH V",
    "move": "M UW V", "give": "G IH V", "live": "L IH V", "said": "S EH D",
    "says": "S EH Z", "again": "AH G EH N", "against": "AH G EH N S T",
    "any": "EH N IY", "many": "M EH N IY", "very": "V EH R IY",
    "every": "EH V R IY", "people": "P IY P AH L", "water": "W AO T ER",
    "woman": "W UH M AH N", "women": "W IH M AH N", "world": "W ER L D",
    "word": "W ER D", "work": "W ER K", "weren't": "W ER N T",
    "hello": "HH AH L OW", "hey": "HH EY", "hi": "HH AY",
    "buddy": "B AH D IY", "computer": "K AH M P Y UW T ER",
    "google": "G UW G AH L", "alexa": "AH L EH K S AH", "siri": "S IH R IY",
    "okay": "OW K EY", "ok": "OW K EY", "please": "P L IY Z",
    "assistant": "AH S IH S T AH N T", "jarvis": "JH AA R V IH S",
    "friend": "F R EH N D", "listen": "L IH S AH N", "answer": "AE N S ER",
    "laugh": "L AE F", "enough": "IH N AH F", "through": "TH R UW",
    "though": "DH OW", "thought": "TH AO T", "tough": "T AH F",
    "eight": "EY T", "height": "HH AY T", "weight": "W EY T",
    "light": "L AY T", "night": "N AY T", "right": "R AY T",
    "you": "Y UW", "your": "Y AO R", "our": "AW ER", "out": "AW T",
    "about": "AH B AW T", "house": "HH AW S", "mouse": "M AW S",
    "sound": "S AW N D", "down": "D AW N", "now": "N AW", "new": "N UW",
    "know": "N OW", "no": "N OW", "go": "G OW", "so": "S OW",
    "show": "SH OW", "slow": "S L OW", "grow": "G R OW", "low": "L OW",
    "own": "OW N", "only": "OW N L IY", "open": "OW P AH N",
    "over": "OW V ER", "also": "AO L S OW", "always": "AO L W EY Z",
    "because": "B IH K AO Z", "before": "B IH F AO R", "being": "B IY IH NG",
    "between": "B IH T W IY N", "both": "B OW TH", "busy": "B IH Z IY",
    "buy": "B AY", "by": "B AY", "bye": "B AY", "eye": "AY", "i": "AY",
    "my": "M AY", "me": "M IY", "we": "W IY", "he": "HH IY", "she": "SH IY",
    "here": "HH IY R", "hear": "HH IY R", "year": "Y IH R",
    "friendly": "F R EH N D L IY", "little": "L IH T AH L",
    "music": "M Y UW Z IH K", "turn": "T ER N", "start": "S T AA R T",
    "stop": "S T AA P", "play": "P L EY", "call": "K AO L",
    "wake": "W EY K", "up": "AH P", "off": "AO F", "on": "AA N",
    "time": "T AY M", "timer": "T AY M ER", "today": "T AH D EY",
    "tomorrow": "T AH M AA R OW", "weather": "W EH DH ER",
    "question": "K W EH S CH AH N", "machine": "M AH SH IY N",
    "special": "S P EH SH AH L", "social": "S OW SH AH L",
    "station": "S T EY SH AH N", "nation": "N EY SH AH N",
    "action": "AE K SH AH N", "nature": "N EY CH ER",
    "picture": "P IH K CH ER", "future": "F Y UW CH ER",
    "sure": "SH UH R", "sugar": "SH UH G ER", "usual": "Y UW ZH AH W AH L",
    "measure": "M EH ZH ER", "pleasure": "P L EH ZH ER",
    "television": "T EH L AH V IH ZH AH N", "vision": "V IH ZH AH N",
    "version": "V ER ZH AH N", "decision": "D IH S IH ZH AH N",
    "shoe": "SH UW", "shoes": "SH UW Z", "orange": "AO R AH N JH",
    "iron": "AY ER N", "island": "AY L AH N D", "hour": "AW ER",
    "honest": "AA N AH S T", "heart": "HH AA R T", "early": "ER L IY",
    "earth": "ER TH", "learn": "L ER N", "head": "HH EH D",
    "bread": "B R EH D", "dead": "D EH D", "ready": "R EH D IY",
    "heavy": "HH EH V IY", "great": "G R EY T", "break": "B R EY K",
    "steak": "S T EY K", "friend": "F R EH N D", "blood": "B L AH D",
    "flood": "F L AH D", "among": "AH M AH NG", "money": "M AH N IY",
    "monkey": "M AH NG K IY", "month": "M AH N TH", "front": "F R AH N T",
    "son": "S AH N", "ton": "T AH N", "won": "W AH N", "warm": "W AO R M",
    "war": "W AO R", "want": "W AA N T", "watch": "W AA CH",
    "wash": "W AA SH", "father": "F AA DH ER", "other": "AH DH ER",
    "another": "AH N AH DH ER", "nothing": "N AH TH IH NG",
    "something": "S AH M TH IH NG", "doctor": "D AA K T ER",
    # irregular vowels the rules cannot predict
    "most": "M OW S T", "almost": "AO L M OW S T",
    "already": "AO L R EH D IY", "although": "AO L DH OW",
    "wind": "W IH N D",  # the noun; the ind$ rule owns find/kind/mind
    "banana": "B AH N AE N AH", "bother": "B AA DH ER",
    "build": "B IH L D", "built": "B IH L T",
    "triple": "T R IH P AH L",
    # lexically reduced -ain (vs stressed contain/remain/maintain)
    "mountain": "M AW N T AH N", "fountain": "F AW N T AH N",
    "captain": "K AE P T AH N", "certain": "S ER T AH N",
    "curtain": "K ER T AH N", "bargain": "B AA R G AH N",
    # ow-verb participles keep OW against the own$ -> AW N rule
    "known": "N OW N", "grown": "G R OW N", "thrown": "TH R OW N",
    "shown": "SH OW N", "blown": "B L OW N", "flown": "F L OW N",
    # final-syllable-stressed verbs exempt from the -et/-it reduction
    "forget": "F ER G EH T", "upset": "AH P S EH T",
    "admit": "AH D M IH T", "commit": "K AH M IH T",
    "permit": "P ER M IH T",
    # stressed final -on, exempt from the -on reduction
    "upon": "AH P AA N",
    # irregulars surfaced by the expanded golden set
    "spider": "S P AY D ER", "young": "Y AH NG",
    "thousand": "TH AW Z AH N D", "second": "S EH K AH N D",
    "minute": "M IH N AH T", "pretty": "P R IH T IY",
    "moment": "M OW M AH N T",
}

# Ordered rewrite rules: (pattern, phones). Longest patterns first. ``|`` marks
# positions: ^ start-anchored, $ end-anchored handled separately below.
_DIGRAPH_RULES: List = [
    ("tion", "SH AH N"), ("sion", "ZH AH N"), ("ture", "CH ER"),
    ("ought", "AO T"), ("aught", "AO T"), ("eigh", "EY"), ("igh", "AY"),
    ("other$", "AH DH ER"),  # mother, brother, other: reduced o + voiced th
    ("ther$", "DH ER"),  # father: intervocalic th voices
    ("tch", "CH"), ("dge", "JH"), ("sch", "S K"), ("ck", "K"),
    ("ook", "UH K"),     # look, book, cook: oo shortens before k
    ("all$", "AO L"), ("ong$", "AO NG"), ("old", "OW L D"),
    ("air", "EH R"), ("oor", "AO R"), ("our$", "AO R"), ("eese", "IY Z"),
    ("ees$", "IY Z"),    # cheese after magic-e drop
    ("og$", "AO G"), ("ind$", "AY N D"), ("ild$", "AY L D"),
    ("own$", "AW N"),    # brown, crown, town; ow-verb participles are exceptions
    ("ower$", "AW ER"),
    ("ch", "CH"), ("sh", "SH"), ("th", "TH"), ("ph", "F"), ("wh", "W"),
    ("gh", "G"),
    # medial ng before a sounded vowel/l keeps the hard g (finger, jungle);
    # word-final or pre-consonant ng does not (sing, length)
    ("ngle$", "NG G AH L"), ("nger$", "NG G ER"),
    ("nk", "NG K"), ("ng", "NG"), ("qu", "K W"),
    ("ment$", "M AH N T"), ("dred$", "D R AH D"),
    ("cen", "S EH N"), ("gen", "JH EH N"),
    ("arr", "AE R"),
    ("wr", "R"), ("kn", "N"),
    ("gn", "N"), ("mb$", "M"), ("oo", "UW"), ("ee", "IY"), ("ea", "IY"),
    ("ai", "EY"), ("ay", "EY"), ("ey", "EY"), ("oa", "OW"), ("ow", "OW"),
    ("ou", "AW"), ("oy", "OY"), ("oi", "OY"), ("au", "AO"), ("aw", "AO"),
    ("ew", "UW"), ("ue", "UW"), ("ui", "UW"), ("ie", "IY"),
    ("ar", "AA R"), ("er", "ER"), ("ir", "ER"), ("ur", "ER"), ("or", "AO R"),
    # consonant + final le: syllabic l (bottle, little, table — NOT smile)
    ("ble$", "B AH L"), ("cle$", "K AH L"), ("dle$", "D AH L"),
    ("fle$", "F AH L"), ("gle$", "G AH L"), ("kle$", "K AH L"),
    ("ple$", "P AH L"), ("sle$", "S AH L"), ("tle$", "T AH L"),
    ("zle$", "Z AH L"),
    ("ce", "S"), ("ci", "S IH"), ("cy", "S IY"),
    ("ge$", "JH"), ("gy", "JH IY"),
]

_SINGLE_RULES: Dict[str, str] = {
    "a": "AE", "b": "B", "c": "K", "d": "D", "e": "EH", "f": "F",
    "g": "G", "h": "HH", "i": "IH", "j": "JH", "k": "K", "l": "L",
    "m": "M", "n": "N", "o": "AA", "p": "P", "r": "R", "s": "S",
    "t": "T", "u": "AH", "v": "V", "w": "W", "x": "K S", "y": "Y",
    "z": "Z", "'": "",
}

VOWEL_PHONEMES = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}


def _g2p_word(word: str) -> List[str]:
    """Rule-based grapheme-to-phoneme for one lowercase word."""
    word = re.sub(r"[^a-z']", "", word.lower())
    if not word:
        return []
    if word in _EXCEPTIONS:
        return _EXCEPTIONS[word].split()

    # silent final e: "make" -> long vowel handled crudely by the vowel rules;
    # drop the e itself when the word is long enough. Keep it in
    # consonant+le words ("bottle": the Cle$ rules own the syllabic l, while
    # "smile" still takes the magic e) and remember soft c/g ("dance",
    # "large": the dropped e softened the consonant).
    working = word
    magic_e = False
    soft_final = ""
    if (
        len(working) > 3
        and working.endswith("e")
        and working[-2] not in "aeiou"
        and not re.search(r"[^aeiou]le$", working)
    ):
        working = working[:-1]
        magic_e = True
        if working.endswith("c"):
            working, soft_final = working[:-1], "S"
        elif working.endswith("g"):
            working, soft_final = working[:-1], "JH"

    # Unstressed final closed syllables reduce to schwa: "-Cen" -> AH N
    # (seven, kitchen, garden), "-Cet"/"-Cit" -> AH T (basket, rabbit, visit).
    # Requires a consonant before the suffix (so sweet/queen/quiet keep their
    # vowel digraphs) and an earlier vowel (so ten/pen/get stay stressed);
    # final-syllable-stressed verbs (forget, admit) are lexicon exceptions.
    suffix_phones: List[str] = []
    if not magic_e and len(working) > 3 and working[-3] not in "aeiou":
        if working.endswith("en") and any(c in "aeiouy" for c in working[:-2]):
            working, suffix_phones = working[:-2], ["AH", "N"]
        elif working.endswith(("et", "it")) and any(c in "aeiou" for c in working[:-2]):
            working, suffix_phones = working[:-2], ["AH", "T"]
        elif working.endswith("on") and any(c in "aeiouy" for c in working[:-2]):
            # lesson, ribbon, dragon, wagon; "upon" is a lexicon exception
            working, suffix_phones = working[:-2], ["AH", "N"]
        if suffix_phones and working.endswith("dg"):
            # the trimmed e was softening a dge cluster (budget, gadget)
            working, suffix_phones = working[:-2], ["JH"] + suffix_phones

    phones: List[str] = []
    i = 0
    while i < len(working):
        matched = False
        for pattern, replacement in _DIGRAPH_RULES:
            anchored_end = pattern.endswith("$")
            pat = pattern[:-1] if anchored_end else pattern
            if working.startswith(pat, i):
                if anchored_end and i + len(pat) != len(working):
                    continue
                phones.extend(replacement.split())
                i += len(pat)
                matched = True
                break
        if matched:
            continue
        ch = working[i]
        # skip doubled consonants
        if i + 1 < len(working) and working[i + 1] == ch and ch not in "aeiou":
            i += 1
            continue
        # final y acts as a vowel: AY in monosyllables with no other vowel
        # letter ("sky", "try", "my"); IY otherwise ("buddy", "happy")
        if ch == "y" and i == len(working) - 1:
            has_other_vowel = any(c in "aeiou" for c in working[:-1])
            phones.append("IY" if has_other_vowel and len(working) > 2 else "AY")
            i += 1
            continue
        # open-syllable lengthening: the word's FIRST (stressed) vowel before a
        # SINGLE consonant reads long in "-Cle" words (table, title, noble,
        # bugle) and "aCy" words (baby, lady, lazy). Later, unstressed
        # syllables reduce instead (article, possible, company), and r colors
        # rather than opens ("-ary": salary).
        if (
            ch in "aiou"
            and i + 1 < len(working)
            and working[i + 1] not in "aeiouy"
            and not any(c in "aeiou" for c in working[:i])
        ):
            rest = working[i + 2:]
            if (rest == "le" and not magic_e) or (
                ch == "a" and rest in ("y", "er") and working[i + 1] != "r"
            ):
                phones.append({"a": "EY", "i": "AY", "o": "OW", "u": "UW"}[ch])
                i += 1
                continue
        phones.extend(_SINGLE_RULES.get(ch, "").split())
        i += 1

    phones.extend(suffix_phones)

    if soft_final:
        phones.append(soft_final)

    # magic e lengthens the last short vowel (AE->EY, IH->AY, AA->OW,
    # EH->IY, AH->UW) — but only across a SINGLE consonant ("make", "nice");
    # with a cluster before the e ("dance", "prince") the e only marks the
    # soft consonant and the vowel stays short.
    if magic_e and re.search(r"[aeiouy][^aeiouy]e$", word):
        lengthen = {"AE": "EY", "IH": "AY", "AA": "OW", "EH": "IY", "AH": "UW"}
        for j in range(len(phones) - 1, -1, -1):
            if phones[j] in lengthen:
                phones[j] = lengthen[phones[j]]
                break
    return [p for p in phones if p]


def word_phones(word: str) -> List[str]:
    return _g2p_word(word.lower().strip())
