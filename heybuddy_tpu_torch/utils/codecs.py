"""
Audio codec and loudness layer (numpy), the JAX package's ``utils/codecs.py``.

* ``read_wav_any``: integer-PCM WAV through the stdlib ``wave`` module
  (``audio_io.read_wav``); what it rejects (IEEE-float WAV,
  WAVE_FORMAT_EXTENSIBLE with a float sub-format) is parsed from the RIFF
  chunks here.
* ``decode_audio`` / ``encode_audio`` / ``compress_roundtrip``: other
  containers (mp3, aac, ogg, flac, ...) through an ``ffmpeg`` on PATH, WAV
  natively; without ffmpeg they raise the JAX package's ``RuntimeError``.
* ``measure_loudness`` / ``normalize_loudness``: ITU-R BS.1770-4 integrated
  loudness (K-weighting, gated 400 ms blocks), equal to the JAX functions.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile
from typing import Optional, Tuple, Union

import numpy as np

from heybuddy_tpu_torch.utils.audio_io import read_wav, resample_audio, write_wav

__all__ = [
    "ffmpeg_available",
    "decode_audio",
    "encode_audio",
    "compress_roundtrip",
    "read_wav_any",
    "measure_loudness",
    "normalize_loudness",
]

_WAV_EXTENSIONS = {".wav", ".wave"}

_FORMAT_PCM = 1
_FORMAT_IEEE_FLOAT = 3
_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav_any(path_or_bytes: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """
    Read a PCM *or* IEEE-float WAV (path or raw bytes) into float32
    ``(channels, time)`` in [-1, 1], with its sample rate.
    """
    try:
        return read_wav(path_or_bytes)
    except NotImplementedError:
        pass  # a format the wave module rejects: parse the RIFF chunks

    if isinstance(path_or_bytes, bytes):
        raw = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("WAV missing fmt or data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == _FORMAT_EXTENSIBLE:
        audio_format = _FORMAT_IEEE_FLOAT if bits in (32, 64) else _FORMAT_PCM
    if audio_format == _FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        arr = np.frombuffer(data, dtype=dtype).astype(np.float32)
    elif audio_format == _FORMAT_PCM:
        if bits == 16:
            arr = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
        elif bits == 32:
            arr = np.frombuffer(data, dtype=np.int32).astype(np.float32) / 2147483648.0
        elif bits == 8:
            arr = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"Unsupported WAV format tag {audio_format}")
    arr = arr.reshape(-1, n_channels).T
    return np.ascontiguousarray(arr), sample_rate


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


# ------------------------------------------------------------------ codecs --


def decode_audio(
    path_or_bytes: Union[str, bytes],
    sample_rate: Optional[int] = None,
    extension: Optional[str] = None,
) -> Tuple[np.ndarray, int]:
    """
    Decode any audio container to float32 ``(channels, time)`` in [-1, 1].
    WAV decodes natively; other formats need ffmpeg on PATH (decoded to mono
    at ``sample_rate``, default 16 kHz). ``sample_rate`` resamples a WAV.
    """
    is_path = isinstance(path_or_bytes, str)
    ext = (extension or (os.path.splitext(path_or_bytes)[1] if is_path else "")).lower()
    looks_wav = ext in _WAV_EXTENSIONS or (
        not is_path and isinstance(path_or_bytes, bytes) and path_or_bytes[:4] == b"RIFF"
    )
    if looks_wav or (is_path and not ext):
        audio, rate = read_wav_any(path_or_bytes)
        if sample_rate is not None and rate != sample_rate:
            audio, rate = resample_audio(audio, rate, sample_rate), sample_rate
        return audio, rate

    if not ffmpeg_available():
        raise RuntimeError(
            f"Decoding {ext or 'non-WAV audio'} requires ffmpeg on PATH "
            "(not present in this environment). Convert to WAV first."
        )
    target_rate = sample_rate or 16000
    cmd = ["ffmpeg", "-v", "error", "-i", path_or_bytes if is_path else "pipe:0"]
    cmd += ["-f", "f32le", "-acodec", "pcm_f32le", "-ar", str(target_rate), "pipe:1"]
    proc = subprocess.run(cmd, input=None if is_path else path_or_bytes, capture_output=True, check=True)
    return np.frombuffer(proc.stdout, dtype=np.float32)[np.newaxis, :], target_rate


def encode_audio(path: str, audio: np.ndarray, sample_rate: int = 16000, **ffmpeg_args: object) -> str:
    """Write audio to ``path``: WAV natively, any other container through ffmpeg."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _WAV_EXTENSIONS:
        write_wav(path, audio, sample_rate)
        return path
    if not ffmpeg_available():
        raise RuntimeError(f"Encoding {ext} requires ffmpeg on PATH. Use .wav instead.")
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[np.newaxis, :]
    cmd = ["ffmpeg", "-v", "error", "-y", "-f", "f32le", "-ar", str(sample_rate), "-ac", str(audio.shape[0]),
           "-i", "pipe:0"]
    for key, value in ffmpeg_args.items():
        cmd += [f"-{key}", str(value)]
    cmd.append(path)
    subprocess.run(cmd, input=audio.T.reshape(-1).tobytes(), capture_output=True, check=True)
    return path


def compress_roundtrip(
    audio: np.ndarray,
    sample_rate: int = 16000,
    codec: str = "mp3",
    bitrate: str = "64k",
) -> np.ndarray:
    """
    Lossy compress and decode back (an augmentation), trimmed or padded to
    the input's length. Needs ffmpeg; raises a RuntimeError without it.
    """
    if not ffmpeg_available():
        raise RuntimeError("compress_roundtrip requires ffmpeg on PATH")
    suffix = {"mp3": ".mp3", "aac": ".m4a", "ogg": ".ogg", "opus": ".opus"}[codec]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"clip{suffix}")
        encode_audio(path, audio, sample_rate, **{"b:a": bitrate})
        decoded, _ = decode_audio(path, sample_rate=sample_rate)
    out = decoded.mean(axis=0) if np.asarray(audio).ndim == 1 else decoded
    length = np.asarray(audio).shape[-1]
    if out.shape[-1] >= length:
        return out[..., :length].astype(np.float32)
    pad = [(0, 0)] * (out.ndim - 1) + [(0, length - out.shape[-1])]
    return np.pad(out, pad).astype(np.float32)


# ---------------------------------------------------- BS.1770 loudness ------


def _k_weighting_coefficients(rate: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """
    ITU-R BS.1770-4 K-weighting as two biquads designed for ``rate``: the
    high shelf (f0 1681.97 Hz, +3.99984 dB, Q 0.7072), then the RLB
    high-pass (f0 38.135 Hz, Q 0.5003).
    """
    db, f0, q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    k = np.tan(np.pi * f0 / rate)
    vh = 10.0 ** (db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b1 = np.array([
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
    ])
    a1 = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])

    f0, q = 38.13547087602444, 0.5003270373238773
    k = np.tan(np.pi * f0 / rate)
    a0 = 1.0 + k / q + k * k
    b2 = np.array([1.0, -2.0, 1.0]) / a0
    a2 = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    return b1, a1, b2, a2


def measure_loudness(audio: np.ndarray, sample_rate: int = 16000) -> float:
    """
    Integrated loudness in LUFS (ITU-R BS.1770-4): K-weighting, 400 ms blocks
    at 75% overlap, a -70 LUFS absolute gate, then a -10 LU relative gate.
    Mono or ``(channels, time)``, every channel weighted 1.0.
    """
    from scipy.signal import lfilter

    audio = np.asarray(audio, dtype=np.float64)
    if audio.ndim == 1:
        audio = audio[np.newaxis, :]
    b1, a1, b2, a2 = _k_weighting_coefficients(sample_rate)
    weighted = lfilter(b2, a2, lfilter(b1, a1, audio, axis=-1), axis=-1)

    block = int(0.4 * sample_rate)
    hop = block // 4
    if weighted.shape[-1] < block:
        power = np.mean(np.sum(weighted**2, axis=0))
        return float(-0.691 + 10.0 * np.log10(power + 1e-12))
    n_blocks = (weighted.shape[-1] - block) // hop + 1
    sq = np.sum(weighted**2, axis=0)  # channel-summed squared signal
    csum = np.concatenate([[0.0], np.cumsum(sq)])
    starts = np.arange(n_blocks) * hop
    powers = (csum[starts + block] - csum[starts]) / block
    loudness = -0.691 + 10.0 * np.log10(powers + 1e-12)

    abs_gated = powers[loudness > -70.0]
    if abs_gated.size == 0:
        return -70.0
    relative_threshold = -0.691 + 10.0 * np.log10(abs_gated.mean() + 1e-12) - 10.0
    gated = powers[(loudness > -70.0) & (loudness > relative_threshold)]
    if gated.size == 0:
        return -70.0
    return float(-0.691 + 10.0 * np.log10(gated.mean() + 1e-12))


def normalize_loudness(
    audio: np.ndarray,
    sample_rate: int = 16000,
    target_lufs: float = -23.0,
    max_peak: float = 0.99,
) -> np.ndarray:
    """Scale to a target integrated loudness, then down to ``max_peak`` if it would clip."""
    current = measure_loudness(audio, sample_rate)
    gain = 10.0 ** ((target_lufs - current) / 20.0)
    out = np.asarray(audio, dtype=np.float32) * gain
    peak = np.max(np.abs(out)) if out.size else 0.0
    if peak > max_peak:
        out = out * (max_peak / peak)
    return out.astype(np.float32)
