"""The port's text front end against the JAX package's: phonemes, adversarial,
prefix-negative and swap-collision texts (pure Python / numpy on both sides,
so every comparison is exact)."""

import importlib.util
import os

import pytest

from heybuddy_tpu.text import adversarial as jax_adversarial
from heybuddy_tpu.text import espeak as jax_espeak
from heybuddy_tpu.text import phonemizer as jax_phonemizer
from heybuddy_tpu.text.wordlist import WORDS as JAX_WORDS
from heybuddy_tpu_torch.text import adversarial, espeak, phonemizer
from heybuddy_tpu_torch.text.wordlist import WORDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def simple_phonemizer(monkeypatch):
    """Both packages on the rule engine, their shared instances rebuilt."""
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.delenv("HEYBUDDY_CMUDICT", raising=False)
    for mod in (phonemizer, jax_phonemizer):
        monkeypatch.setattr(mod, "_GLOBAL_PHONEMIZER", None)
        monkeypatch.setattr(mod, "_CMUDICT_CACHE", None)
    for mod in (adversarial, jax_adversarial):
        monkeypatch.setattr(mod, "_GLOBAL_LEXICON", None)
        monkeypatch.setattr(mod, "_GLOBAL_GENERATOR", None)


def _golden_words():
    spec = importlib.util.spec_from_file_location("g2p_accuracy", os.path.join(ROOT, "scripts", "g2p_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return sorted(mod.GOLDEN)


def test_phonemes_equal_jax_over_the_word_list_and_goldens():
    port, ref = phonemizer.get_phonemizer(), jax_phonemizer.get_phonemizer()
    assert port.name == ref.name == "simple"
    assert WORDS == JAX_WORDS
    words = sorted(set(WORDS)) + _golden_words() + ["Hey,", "buddy's", "x-ray", "", "ok123"]
    assert len(words) > 1000
    for word in words:
        assert port.word_phones(word) == ref.word_phones(word), word
    for text in ("hello world", "hey buddy", "please turn on the lights", "she sells sea shells"):
        assert port(text) == ref(text)
    assert port("hello world") == "[HH][AH][L][OW] [W][ER][L][D]"


def test_phonemizer_choice_follows_jax(monkeypatch):
    """No libespeak-ng here: both choose the rule engine; with neural both build
    a NeuralPhonemizer on the bundled checkpoint that phonemizes alike."""
    monkeypatch.delenv("HEYBUDDY_PHONEMIZER")
    assert espeak.espeak_library_path() == jax_espeak.espeak_library_path()
    assert type(phonemizer.get_phonemizer()).__name__ == type(jax_phonemizer.get_phonemizer()).__name__
    for mod in (phonemizer, jax_phonemizer):
        monkeypatch.setattr(mod, "_GLOBAL_PHONEMIZER", None)
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "neural")
    monkeypatch.delenv("HEYBUDDY_G2P_WEIGHTS", raising=False)
    port, ref = phonemizer.get_phonemizer(), jax_phonemizer.get_phonemizer()
    assert type(port).__name__ == type(ref).__name__ == "NeuralPhonemizer"
    assert port.name == ref.name == "neural"
    for text in ("hello world", "hey buddy", "please turn on the lights", "zephyr quokka"):
        assert port(text) == ref(text), text
    for ipa in ("həlˈoʊ", "wˈɜːld", "bˈʌdi", "tʃˈɪps"):
        assert espeak.EspeakPhonemizer.ipa_word_to_arpabet(ipa) == jax_espeak.EspeakPhonemizer.ipa_word_to_arpabet(ipa)


def test_cmudict_loads_as_jax(tmp_path, monkeypatch):
    path = tmp_path / "cmudict.txt"
    path.write_text(";;; comment\nHEY  HH EY1\nBUDDY  B AH1 D IY0\nBUDDY(1)  B UH1 D IY0\n", encoding="latin1")
    monkeypatch.setenv("HEYBUDDY_CMUDICT", str(path))
    assert phonemizer.load_cmudict() == jax_phonemizer.load_cmudict() == {
        "hey": ["HH", "EY1"], "buddy": ["B", "AH1", "D", "IY0"]}
    assert phonemizer.SimplePhonemizer()("hey buddy") == jax_phonemizer.SimplePhonemizer()("hey buddy")


@pytest.mark.parametrize("phrase", ["hey buddy", "hello world", "okay computer", "wednesday"])
def test_adversarial_texts_equal_jax(phrase):
    port = adversarial.AdversarialTextGenerator()
    ref = jax_adversarial.AdversarialTextGenerator()
    for word in phrase.split():
        assert port.adversarial_words(word) == ref.adversarial_words(word)
    for seed in (0, 7):
        got = list(port(phrase, num_samples=60, seed=seed))
        assert got == list(ref(phrase, num_samples=60, seed=seed))
    assert len(got) == {"hey buddy": 60, "hello world": 60, "okay computer": 15, "wednesday": 0}[phrase]


@pytest.mark.parametrize("phrase", ["hey buddy", "okay computer"])
def test_prefix_and_collision_texts_equal_jax(phrase):
    for seed in (0, 3):
        got = adversarial.prefix_negative_texts(phrase, num_samples=40, seed=seed)
        assert got == jax_adversarial.prefix_negative_texts(phrase, num_samples=40, seed=seed)
        assert got
        for depth in (1, 2):
            kwargs = dict(num_samples=30, seed=seed, max_swaps=depth, exclude=["hey body"])
            got = adversarial.single_swap_collision_texts(phrase, **kwargs)
            assert got == jax_adversarial.single_swap_collision_texts(phrase, **kwargs)
            assert got and "hey body" not in got
