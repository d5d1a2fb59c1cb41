"""
WAV decoding beyond integer PCM.

Counterpart of ``read_wav_any`` in the JAX package's ``utils/codecs.py``:
integer-PCM WAV goes through the stdlib ``wave`` module (``audio_io.read_wav``);
what it rejects (IEEE-float WAV, WAVE_FORMAT_EXTENSIBLE with a float
sub-format) is parsed from the RIFF chunks here. The ffmpeg-backed decoders
for other containers are not ported yet.
"""

from __future__ import annotations

import struct
from typing import Tuple, Union

import numpy as np

from heybuddy_tpu_torch.utils.audio_io import read_wav

__all__ = ["read_wav_any"]

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
