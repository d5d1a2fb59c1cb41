"""
The real-time listening loop (``listen``).

Counterpart of the JAX package's ``runtime/listen.py``: a rolling 2 s buffer
fed by the microphone (pyaudio, when installed) or a wav file
(``--input-wav``) is scored after every chunk by each checkpoint's model
(npz, ``.pt`` or ``.onnx``), and a detection is recorded when a model's
``ConsecutiveGate`` fires. Each scored chunk runs K1 and K2 once per model on
``device`` (b = 1, t = 32000). With ``use_vad`` a ``VADGate`` over 20 ms
frames skips the models while no speech is active (nor was within the rolling
buffer). Inference is serial on the calling thread unless
``HEYBUDDY_LISTEN_THREADS=1`` (one ``WakeWordModelThread`` per model).
Each chunk logs, at debug level, its scores and wall time or that it was
skipped.
"""

from __future__ import annotations

import os
import queue
import sys
import time
from typing import Iterator, List, Optional

import numpy as np

from heybuddy_tpu_torch.constants import DEFAULT_LISTEN_BUFFER_SIZE, SAMPLE_RATE
from heybuddy_tpu_torch.device import DeviceLike
from heybuddy_tpu_torch.runtime.model_thread import WakeWordModelThread
from heybuddy_tpu_torch.utils.audio_io import resample_audio
from heybuddy_tpu_torch.utils.codecs import read_wav_any
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.profiling import span

__all__ = ["run_listen", "ROLLING_SAMPLES"]

ROLLING_SAMPLES = 32000  # 2 s at 16 kHz
VAD_FRAME = 320  # 20 ms


def _mic_chunks(buffer_size: int) -> Iterator[np.ndarray]:
    try:
        import pyaudio  # type: ignore[import-not-found]
    except ImportError as ex:
        raise RuntimeError(
            "pyaudio is required for microphone listening; use --input-wav to stream a file instead"
        ) from ex
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=SAMPLE_RATE, input=True,
                     frames_per_buffer=buffer_size)
    try:
        while True:
            data = stream.read(buffer_size, exception_on_overflow=False)
            yield np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()


def _wav_chunks(path: str, buffer_size: int, realtime: bool = False) -> Iterator[np.ndarray]:
    audio, rate = read_wav_any(path)
    mono = audio.mean(axis=0)
    if rate != SAMPLE_RATE:
        mono = resample_audio(mono, rate, SAMPLE_RATE)
    for start in range(0, len(mono), buffer_size):
        chunk = mono[start : start + buffer_size]
        if realtime:
            time.sleep(len(chunk) / SAMPLE_RATE)
        yield chunk


def _use_serial_inference() -> bool:
    """Serial unless ``HEYBUDDY_LISTEN_THREADS=1`` (``HEYBUDDY_LISTEN_SERIAL=1`` forces it)."""
    if os.environ.get("HEYBUDDY_LISTEN_SERIAL") == "1":
        return True
    return os.environ.get("HEYBUDDY_LISTEN_THREADS") != "1"


class _SerialModel:
    """Calling-thread drop-in for ``WakeWordModelThread``."""

    def __init__(self, checkpoint_path: str, threshold: float = 0.5, device: DeviceLike = "cuda") -> None:
        from heybuddy_tpu_torch.cli import _load_any_model

        self._model = _load_any_model(checkpoint_path, device=device)
        self._pending: Optional[np.ndarray] = None
        self.threshold = threshold

    def put(self, audio: np.ndarray) -> None:
        self._pending = audio

    def get(self, timeout: Optional[float] = None) -> tuple:
        start = time.perf_counter()
        with span("listen/score"):
            scores = self._model.predict(self._pending, return_scores=True)
        return (float(scores[0]) if scores else 0.0, time.perf_counter() - start)

    def stop(self) -> None:
        pass


def run_listen(
    checkpoints: List[str],
    threshold: float = 0.5,
    buffer_size: int = DEFAULT_LISTEN_BUFFER_SIZE,
    input_wav: Optional[str] = None,
    max_chunks: Optional[int] = None,
    use_vad: bool = False,
    consecutive: int = 1,
    device: DeviceLike = "cuda",
) -> List[str]:
    """
    Run the listen loop; prints and returns the detection lines
    ("NAME @ T.TTs score=S", T the chunk's start in the input).

    ``use_vad`` skips the models on chunks while the VAD gate is shut and no
    speech was active within the rolling buffer (``speech_cooldown``); the
    score gates are fed 0.0 for each skipped chunk, so a spike before the
    silence cannot pair with one after it. ``consecutive`` chunks at or
    above the threshold make a detection (1: fire on any chunk).
    """
    from heybuddy_tpu_torch.runtime.detection import ConsecutiveGate

    if _use_serial_inference():
        models: List = [_SerialModel(path, threshold=threshold, device=device) for path in checkpoints]
    else:
        models = [WakeWordModelThread(path, threshold=threshold, device=device) for path in checkpoints]
    names = [os.path.splitext(os.path.basename(p))[0] for p in checkpoints]
    rolling = np.zeros(ROLLING_SAMPLES, dtype=np.float32)
    detections: List[str] = []
    # debounce_windows=0: the gate adds only the consecutive-chunk rule
    score_gates = [ConsecutiveGate(threshold=threshold, consecutive=consecutive, debounce_windows=0) for _ in names]
    is_tty = sys.stdout.isatty()

    gate = None
    speech_cooldown = 0
    if use_vad:
        from heybuddy_tpu_torch.models.vad import EnergyVAD, VADGate, get_vad_model

        vad = get_vad_model(device=device)
        if isinstance(vad, EnergyVAD):
            gate = VADGate(vad, positive_threshold=0.5, negative_threshold=0.25)
        else:
            gate = VADGate(vad)

    chunks = _wav_chunks(input_wav, buffer_size) if input_wav else _mic_chunks(buffer_size)
    try:
        for i, chunk in enumerate(chunks):
            if max_chunks is not None and i >= max_chunks:
                break
            start = time.perf_counter()
            if len(chunk) >= ROLLING_SAMPLES:
                rolling = chunk[-ROLLING_SAMPLES:].astype(np.float32).copy()
            else:
                rolling = np.roll(rolling, -len(chunk))
                rolling[-len(chunk) :] = chunk
            if gate is not None:
                # OR over the chunk's frames: speech that starts and ends
                # inside one chunk still opens it
                speaking = False
                for f in range(0, len(chunk) - VAD_FRAME + 1, VAD_FRAME):
                    speaking = gate.update(chunk[f : f + VAD_FRAME]) or speaking
                if speaking:
                    # keep scoring until the speech has rolled out of the buffer
                    speech_cooldown = ROLLING_SAMPLES // max(len(chunk), 1) + 1
                elif speech_cooldown > 0:
                    speech_cooldown -= 1
                else:
                    for score_gate in score_gates:
                        score_gate.update(0.0)
                    logger.debug(f"listen chunk {i}: skipped in {(time.perf_counter() - start) * 1e3:.3f} ms")
                    if is_tty:
                        sys.stdout.write("\x1b[2J\x1b[H(listening — no speech)\n")
                        sys.stdout.flush()
                    continue
            for model in models:
                model.put(rolling.copy())
            rows = []
            scores = []
            for name, model, score_gate in zip(names, models, score_gates):
                try:
                    score, duration = model.get(timeout=10.0)
                except queue.Empty:
                    # a late result: the model thread drops it by its sequence tag
                    score, duration = 0.0, 0.0
                scores.append(score)
                flag = "*" if score >= threshold else " "
                rows.append(f"{flag} {name:<30} {score:6.3f}  {duration * 1000:7.1f}ms")
                if score_gate.update(score):
                    stamp = i * buffer_size / SAMPLE_RATE
                    detections.append(f"{name} @ {stamp:.2f}s score={score:.3f}")
            logger.debug(f"listen chunk {i}: scores {scores} in {(time.perf_counter() - start) * 1e3:.3f} ms")
            if is_tty:
                sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(rows) + "\n")
                sys.stdout.flush()
    except KeyboardInterrupt:
        logger.info("Interrupted")
    finally:
        for model in models:
            model.stop()
    for line in detections:
        print(line)
    return detections
