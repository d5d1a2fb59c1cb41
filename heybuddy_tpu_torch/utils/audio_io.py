"""
Audio input for the serving path (numpy).

WAV files through the stdlib ``wave`` module (integer PCM; ``codecs.
read_wav_any`` adds IEEE-float WAV), resampling by polyphase filtering
(``scipy.signal.resample_poly``), and the universal ``audio_to_bct_array``
loader that turns paths, WAV bytes, arrays or lists into float32
``(batch, channels, time)`` in [-1, 1]. Other containers (mp3, flac, ogg)
decode through ``codecs.decode_audio``, which needs ffmpeg.
"""

from __future__ import annotations

import io
import os
import wave
from math import gcd
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "audio_to_bct_array", "read_wav", "write_wav", "resample_audio", "normalize_peak", "normalize_rms",
]

AudioLike = Union[str, bytes, np.ndarray, Sequence[Any]]

_WAV_EXTENSIONS = (".wav", ".wave", "")


def read_wav(path_or_bytes: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """
    Read an integer-PCM WAV file (path or raw bytes) into float32
    ``(channels, time)`` in [-1, 1], with its sample rate.
    """
    fileobj: Any = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    try:
        with wave.open(fileobj, "rb") as wav:
            n_channels = wav.getnchannels()
            sample_width = wav.getsampwidth()
            sample_rate = wav.getframerate()
            raw = wav.readframes(wav.getnframes())
    except wave.Error as exc:
        raise NotImplementedError(
            f"the wave module reads integer-PCM WAV only ({exc}); codecs.read_wav_any "
            "reads IEEE-float WAV"
        ) from exc

    if sample_width == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sample_width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sample_width == 3:  # packed 24-bit
        as_bytes = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            as_bytes[:, 0].astype(np.int32)
            | (as_bytes[:, 1].astype(np.int32) << 8)
            | (as_bytes[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    elif sample_width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sample_width}")
    return np.ascontiguousarray(data.reshape(-1, n_channels).T), sample_rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000) -> None:
    """Write float32 audio in [-1, 1] (``(time,)`` or ``(channels, time)``) as 16-bit PCM."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[np.newaxis, :]
    if audio.ndim != 2:
        raise ValueError(f"Audio must be 1D or 2D, got {audio.ndim}D")
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as wav:
        wav.setnchannels(audio.shape[0])
        wav.setsampwidth(2)
        wav.setframerate(sample_rate)
        wav.writeframes(pcm.T.reshape(-1).tobytes())


def resample_audio(audio: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if orig_rate == target_rate:
        return audio
    from scipy.signal import resample_poly

    g = gcd(int(orig_rate), int(target_rate))
    return resample_poly(audio, target_rate // g, orig_rate // g, axis=-1).astype(np.float32)


def _coerce_single(item: AudioLike, sample_rate: Optional[int]) -> Tuple[np.ndarray, Optional[int]]:
    """One item as (channels, time) float32 plus its native sample rate."""
    if isinstance(item, (str, bytes)):
        if isinstance(item, str) and os.path.splitext(item)[1].lower() not in _WAV_EXTENSIONS:
            # non-WAV containers go through the codec layer (ffmpeg)
            from heybuddy_tpu_torch.utils.codecs import decode_audio

            return decode_audio(item, sample_rate=sample_rate)
        from heybuddy_tpu_torch.utils.codecs import read_wav_any

        return read_wav_any(item)
    raw = np.asarray(item)
    arr = raw.astype(np.float32)
    if raw.dtype.kind == "i":
        # integer PCM normalizes to [-1, 1] (int16 / 32768)
        arr /= float(np.iinfo(raw.dtype).max) + 1.0
    elif raw.dtype.kind == "u":
        half = (float(np.iinfo(raw.dtype).max) + 1.0) / 2.0
        arr = (arr - half) / half
    if arr.ndim == 1:
        arr = arr[np.newaxis, :]
    elif arr.ndim != 2:
        raise ValueError(f"Array audio must be 1D or 2D per item, got {arr.ndim}D")
    return arr, sample_rate


def audio_to_bct_array(
    audio: AudioLike,
    sample_rate: Optional[int] = None,
    source_sample_rate: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """
    File path(s), WAV bytes, numpy array(s) or nested lists -> float32
    ``(batch, channels, time)`` in [-1, 1], resampled to ``sample_rate`` when
    it is given; returns the final sample rate too. ``source_sample_rate``
    declares the native rate of raw-array inputs (defaults to ``sample_rate``).
    Shorter items are zero-padded at the end; mono items are repeated across
    channels when others have more.
    """
    items: List[AudioLike]
    if isinstance(audio, (str, bytes)):
        items = [audio]
    elif isinstance(audio, np.ndarray):
        items = list(audio) if audio.ndim in (2, 3) else [audio]
    elif isinstance(audio, Sequence):
        if len(audio) > 0 and isinstance(audio[0], (int, float, np.floating, np.integer)):
            items = [np.asarray(audio, dtype=np.float32)]
        else:
            items = list(audio)
    else:
        raise TypeError(f"Unsupported audio input type: {type(audio)}")

    coerced: List[np.ndarray] = []
    final_rate = sample_rate
    for item in items:
        arr, native_rate = _coerce_single(item, source_sample_rate or sample_rate)
        if sample_rate is not None and native_rate is not None and native_rate != sample_rate:
            arr = resample_audio(arr, native_rate, sample_rate)
        elif final_rate is None:
            final_rate = native_rate
        elif native_rate is not None and native_rate != final_rate:
            # no target rate and mixed native rates: conform to the first item's
            arr = resample_audio(arr, native_rate, final_rate)
        coerced.append(arr.astype(np.float32))

    max_channels = max(a.shape[0] for a in coerced)
    max_time = max(a.shape[1] for a in coerced)
    batch = np.zeros((len(coerced), max_channels, max_time), dtype=np.float32)
    for i, arr in enumerate(coerced):
        c, t = arr.shape
        if c < max_channels:
            arr = np.broadcast_to(arr.mean(axis=0, keepdims=True), (max_channels, t))
        batch[i, :, :t] = arr
    return batch, int(final_rate or 16000)


def normalize_peak(audio: np.ndarray, peak: float = 0.95) -> np.ndarray:
    """Scale so the maximum absolute sample equals ``peak`` (no-op on silence)."""
    current = np.max(np.abs(audio))
    if current < 1e-9:
        return audio
    return (audio * (peak / current)).astype(np.float32)


def normalize_rms(audio: np.ndarray, rms_db: float = -20.0) -> np.ndarray:
    """Scale to a target RMS level in dBFS (no-op on silence)."""
    current = np.sqrt(np.mean(np.square(audio)))
    if current < 1e-9:
        return audio
    target = 10.0 ** (rms_db / 20.0)
    return (audio * (target / current)).astype(np.float32)
