"""
Continuous-speech streams and their sliding runtime windows.

Counterpart of the JAX package's ``data/streams.py`` (numpy and the host
TTS): the deployed runtime scores a 1.44 s window every 0.12 s of continuous
audio (the browser batcher; ``listen``), and windows of a stream straddle
phrase boundaries at every offset, which isolated clips never show.

* ``synth_speech_stream``: ordinary speech (random phrases of the word list,
  the wake phrase's words left out) with gaps and light background noise,
  rendered through the training TTS pipeline;
* ``synth_adversarial_stream``: phonetic near-collisions of the wake phrase;
* ``synth_collision_salad_stream``: word salads with one or two of the
  phrase's phonetic neighbours in each;
* ``stream_window_clips`` / ``stream_window_count``: every runtime window
  position of a stream.

For the same arguments each stream equals the JAX package's bit for bit:
the texts, the generator's batch size and seeds, the gain and gap draws and
the noise. ``device`` is where the "formant-device" backend renders.
``TrainingFeaturesGenerator.get_stream_window_features`` featurizes the
windows on the card without materialising them
(``SpeechEmbeddings.featurize_stream_device``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from heybuddy_tpu_torch.constants import CLIP_SAMPLES, RUNTIME_WINDOW_STRIDE, SAMPLE_RATE
from heybuddy_tpu_torch.device import DeviceLike

__all__ = [
    "texts_to_stream",
    "synth_speech_stream",
    "synth_adversarial_stream",
    "synth_collision_salad_stream",
    "stream_window_clips",
    "stream_window_count",
    "RUNTIME_WINDOW_STRIDE",
]

StreamResult = Union[np.ndarray, Tuple[np.ndarray, List[tuple]]]


def texts_to_stream(
    texts: Sequence[str],
    minutes: float,
    seed: int,
    sample_rate: int = SAMPLE_RATE,
    tts_backend: Optional[str] = None,
    snr_db_range: tuple = (20.0, 30.0),
    return_schedule: bool = False,
    device: DeviceLike = "cuda",
) -> StreamResult:
    """
    Render a text list as one continuous float32 stream in [-1, 1]: phrases
    with a random gain in [0.3, 1), gaps of 0.15-1.2 s, and white background
    noise at a random SNR. ``return_schedule=True`` also returns the
    ``(start, end, text)`` sample span of each phrase.
    """
    from heybuddy_tpu_torch.data.tts_generator import SpeechSampleGenerator
    from heybuddy_tpu_torch.models.tts import DEVICE_TTS_BATCH, resolve_tts_backend

    rng = np.random.default_rng(seed)
    # the batch size sets the speaker offsets, so it is part of the stream
    batch_size = DEVICE_TTS_BATCH if resolve_tts_backend(tts_backend) == "formant-device" else 8
    gen = SpeechSampleGenerator(
        texts[0], additional_phrases=list(texts[1:]), batch_size=batch_size,
        seed=seed, tts_backend=tts_backend, phrase_augment_prob=0.0, device=device,
    )
    total = int(minutes * 60 * sample_rate)
    out = np.zeros(total, dtype=np.float32)
    schedule: List[tuple] = []
    pos = 0
    # about 1.6 s a phrase with its gap: a generous sample budget
    for sample in gen(int(minutes * 60 / 1.2) + 16):
        clip = np.asarray(sample["audio"]["array"], dtype=np.float32)
        if np.abs(clip).max() > 4.0:  # int16-range PCM
            clip = clip / 32768.0
        clip = clip * float(rng.uniform(0.3, 1.0))
        end = min(pos + len(clip), total)
        out[pos:end] = clip[: end - pos]
        schedule.append((pos, end, sample.get("phrase", "")))
        pos = end + int(rng.uniform(0.15, 1.2) * sample_rate)
        if pos >= total:
            break
    noise = rng.normal(0.0, 1.0, total).astype(np.float32)
    speech_rms = float(np.sqrt(np.mean(out**2)) + 1e-9)
    snr_db = float(rng.uniform(*snr_db_range))
    noise *= speech_rms / (10 ** (snr_db / 20.0)) / (np.sqrt(np.mean(noise**2)) + 1e-9)
    stream = np.clip(out + noise, -1.0, 1.0)
    if return_schedule:
        return stream, schedule
    return stream


def synth_speech_stream(
    minutes: float,
    seed: int,
    exclude_phrase: str = "",
    num_texts: int = 256,
    tts_backend: Optional[str] = None,
    return_schedule: bool = False,
    device: DeviceLike = "cuda",
) -> StreamResult:
    """Ordinary speech: ``num_texts`` random phrases of 1-6 words of the word
    list, the words of ``exclude_phrase`` removed, with gaps and noise."""
    from heybuddy_tpu_torch.text.wordlist import WORDS

    rng = np.random.default_rng(seed)
    vocabulary = sorted(set(WORDS) - set(exclude_phrase.lower().split()))
    texts: List[str] = []
    for _ in range(num_texts):
        n_words = int(rng.integers(1, 7))
        texts.append(" ".join(rng.choice(vocabulary, size=n_words, replace=False)))
    return texts_to_stream(
        texts, minutes, seed, tts_backend=tts_backend, return_schedule=return_schedule, device=device
    )


def synth_adversarial_stream(
    phrase: str,
    minutes: float,
    seed: int,
    num_texts: int = 120,
    tts_backend: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Phonetic near-collisions of ``phrase``, rendered at ``seed + 1``."""
    from heybuddy_tpu_torch.text.adversarial import get_adversarial_text_generator

    texts = list(get_adversarial_text_generator()(phrase, num_samples=num_texts, seed=seed))
    if not texts:
        # a phrase without neighbours has no adversarial texts: ordinary
        # speech without its words, never the phrase itself in a negative stream
        return synth_speech_stream(minutes, seed + 1, exclude_phrase=phrase, tts_backend=tts_backend, device=device)
    return texts_to_stream(texts, minutes, seed + 1, tts_backend=tts_backend, device=device)


def synth_collision_salad_stream(
    phrase: str,
    minutes: float,
    seed: int,
    num_texts: int = 160,
    tts_backend: Optional[str] = None,
    return_schedule: bool = False,
    device: DeviceLike = "cuda",
) -> StreamResult:
    """
    Word salads of 2-6 words of the word list in which one or two words are
    replaced by phonetic neighbours of the phrase's words; the phrase's own
    words never appear. Rendered at ``seed + 2``, apart from the speech
    (``seed``) and adversarial (``seed + 1``) streams, whose segments are
    seeded by the same row offsets.
    """
    from heybuddy_tpu_torch.text.adversarial import get_adversarial_text_generator
    from heybuddy_tpu_torch.text.wordlist import WORDS

    words = phrase.lower().split()
    g = get_adversarial_text_generator()
    neighbors = sorted({w for pw in words for w in g.adversarial_words(pw)} - set(words))
    rng = np.random.default_rng(seed)
    vocabulary = sorted(set(WORDS) - set(words))
    if not neighbors:
        neighbors = vocabulary  # a phrase without neighbours: plain salads
    texts: List[str] = []
    for _ in range(num_texts):
        n_words = int(rng.integers(2, 7))
        salad = list(rng.choice(vocabulary, size=n_words, replace=False))
        n_coll = int(rng.integers(1, 3))
        for p in rng.choice(n_words, size=min(n_coll, n_words), replace=False):
            salad[int(p)] = str(rng.choice(neighbors))
        texts.append(" ".join(salad))
    return texts_to_stream(
        texts, minutes, seed + 2, tts_backend=tts_backend, return_schedule=return_schedule, device=device
    )


def stream_window_count(
    stream: np.ndarray, window: int = CLIP_SAMPLES, stride: int = RUNTIME_WINDOW_STRIDE
) -> int:
    """Number of runtime window positions in a stream."""
    return max((len(stream) - window) // stride + 1, 0)


def stream_window_clips(
    stream: np.ndarray,
    window: int = CLIP_SAMPLES,
    stride: int = RUNTIME_WINDOW_STRIDE,
    start: int = 0,
    count: Optional[int] = None,
) -> np.ndarray:
    """
    (t,) stream -> (n, window) float32 batch of the runtime window positions
    ``start`` .. ``start + count`` (all from ``start`` without ``count``),
    exactly what the sliding runtime scores.
    """
    n = stream_window_count(stream, window=window, stride=stride)
    if count is not None:
        n = min(n, start + count)
    if start >= n:
        return np.zeros((0, window), dtype=np.float32)
    starts = np.arange(start, n) * stride
    return np.stack([stream[s : s + window] for s in starts]).astype(np.float32)
