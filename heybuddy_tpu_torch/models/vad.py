"""
Voice activity detection.

Counterpart of the JAX package's ``models/vad.py``. Three detectors share one
call (``vad(frame) -> speech probability``) and one ``trim``:

* ``EnergyVAD``: frame RMS against a running noise floor mapped to [0, 1];
  numpy, the default, equal to the JAX package's bit for bit;
* ``SileroStyleVAD``: the Silero layout (the 256-point STFT magnitude of the
  chunk averaged over its frames -> log1p -> a dense ReLU encoder -> two LSTM
  cells with ``[2, 1, 64]`` h / c state kept across calls -> a sigmoid) as an
  ``nn.Module`` on an explicit ``device``. Its weights come from an npz of
  the JAX package's keys or from numpy ``default_rng(seed)`` draws as JAX's
  (random weights detect nothing; they make the arithmetic checkable);
* ``SileroOnnxVAD``: a Silero VAD ``.onnx`` file (the v3/v4 layout with
  ``h`` / ``c`` state or the v5 layout with one ``state``) imported by
  ``export/onnx_to_torch.py`` and run on ``device``, its state kept there
  across calls;
* ``VADGate``: the runtime's speaking-state hysteresis over any of them.

``get_vad_model`` resolves as JAX's does: ``HEYBUDDY_VAD_ONNX``
(``SileroOnnxVAD``), then ``HEYBUDDY_VAD_WEIGHTS`` (``SileroStyleVAD``), then
``EnergyVAD``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from heybuddy_tpu_torch.constants import SAMPLE_RATE
from heybuddy_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["EnergyVAD", "SileroStyleVAD", "SileroOnnxVAD", "VADGate", "get_vad_model"]


class _TrimMixin:
    """Silence trimming with any frame VAD."""

    def trim(
        self,
        audio: np.ndarray,
        sample_rate: int = SAMPLE_RATE,
        frame_duration: float = 0.03,
        min_start: int = 2000,
        threshold: float = 0.15,
        pad_s: Optional[Union[float, Tuple[float, float]]] = None,
    ) -> np.ndarray:
        """
        Keep the first ``min_start`` samples, then from the first frame whose
        probability exceeds ``threshold`` to the end of the last such frame;
        ``pad_s`` seconds of zeros (one value, or (start, end)) go around it.
        """
        return_first = False
        if audio.ndim == 1:
            return_first = True
            audio = audio[np.newaxis, :]

        audio_len = audio.shape[1]
        frame_size = int(sample_rate * frame_duration)

        start = min_start
        for i in range(min_start, audio_len, frame_size):
            if self(audio[:, i : i + frame_size], sample_rate) > threshold:
                start = i
                break

        end = audio_len
        for i in range(audio_len - frame_size, min_start, -frame_size):
            if self(audio[:, i : i + frame_size], sample_rate) > threshold:
                end = min(i + frame_size, audio_len)
                break

        audio = np.hstack([audio[:, :min_start], audio[:, start:end]])

        if isinstance(pad_s, tuple):
            pad_start, pad_end = pad_s
        elif isinstance(pad_s, float):
            pad_start = pad_end = pad_s
        else:
            pad_start = pad_end = 0.0
        if pad_start > 0 or pad_end > 0:
            audio = np.pad(audio, ((0, 0), (int(pad_start * sample_rate), int(pad_end * sample_rate))))

        if return_first:
            return audio[0]
        return audio


class EnergyVAD(_TrimMixin):
    """
    Adaptive-energy speech detector: a frame's RMS over a running noise floor
    (``floor_decay`` per frame, never above the frame's RMS), ratio 1.5 -> 0
    and ratio 8 -> 1.
    """

    def __init__(self, floor_decay: float = 0.98) -> None:
        self.floor_decay = floor_decay
        self._noise_floor = 1e-4

    def reset(self) -> None:
        self._noise_floor = 1e-4

    def __call__(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE, **_: Any) -> float:
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        if audio.size == 0:
            return 0.0
        rms = float(np.sqrt(np.mean(audio**2)))
        self._noise_floor = min(
            self.floor_decay * self._noise_floor + (1 - self.floor_decay) * rms,
            max(rms, 1e-5),
        )
        ratio = rms / (self._noise_floor + 1e-6)
        return float(np.clip((ratio - 1.5) / 6.5, 0.0, 1.0))


class VADGate:
    """
    Speaking-state hysteresis over a frame-probability VAD: speech starts
    when a frame reaches ``positive_threshold`` and ends only after
    ``silent_frames_to_stop`` consecutive frames below ``negative_threshold``.
    The defaults are the Silero operating point of the browser runtime
    (0.65 / 0.4 / 8 frames of 20 ms); the energy VAD is calibrated at 0.5 / 0.25.
    """

    def __init__(
        self,
        vad: Any = None,
        positive_threshold: float = 0.65,
        negative_threshold: float = 0.4,
        silent_frames_to_stop: int = 8,
    ) -> None:
        self.vad = vad
        self.positive_threshold = positive_threshold
        self.negative_threshold = negative_threshold
        self.silent_frames_to_stop = silent_frames_to_stop
        self.speaking = False
        self.silent_frames = 0

    def reset(self) -> None:
        self.speaking = False
        self.silent_frames = 0
        if self.vad is not None and hasattr(self.vad, "reset"):
            self.vad.reset()

    def update(self, frame_or_probability: Any) -> bool:
        """Advance one frame (raw audio if a VAD is attached, else a probability)."""
        if self.vad is not None and not np.isscalar(frame_or_probability):
            p = float(self.vad(np.asarray(frame_or_probability)))
        else:
            p = float(frame_or_probability)
        if not self.speaking:
            if p >= self.positive_threshold:
                self.speaking = True
                self.silent_frames = 0
        elif p < self.negative_threshold:
            self.silent_frames += 1
            if self.silent_frames >= self.silent_frames_to_stop:
                self.speaking = False
                self.silent_frames = 0
        else:
            self.silent_frames = 0
        return self.speaking


class SileroStyleVAD(_TrimMixin, nn.Module):
    """
    The Silero layout on ``device``. A call pads the chunk with zeros to a
    multiple of 256 samples (at least 256), frames it by 256 under the
    symmetric Hann window, and advances the LSTM state, which persists
    across calls until ``reset``. The LSTM gates split as i, f, g, o over one
    bias, as in the JAX package.
    """

    HIDDEN = 64
    FEATURES = 64
    FRAME = 256

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0, device: DeviceLike = "cuda") -> None:
        nn.Module.__init__(self)
        self.device = resolve_device(device)
        if weights_path and os.path.exists(weights_path):
            with np.load(weights_path) as loaded:
                params = {k: np.asarray(loaded[k], dtype=np.float32) for k in loaded.files}
        else:
            params = self._init_params(seed)
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(torch.from_numpy(value), requires_grad=False))
        self.register_buffer("window", torch.hann_window(self.FRAME, periodic=False, dtype=torch.float32))
        self.to(self.device).eval()
        self.reset()

    def _init_params(self, seed: int) -> Dict[str, np.ndarray]:
        """The JAX package's initial parameters: scaled normal draws of ``default_rng(seed)`` in its order."""
        rng = np.random.default_rng(seed)

        def dense(i: int, o: int) -> np.ndarray:
            return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

        h, f = self.HIDDEN, self.FEATURES
        return {
            "enc_w": dense(self.FRAME // 2 + 1, f),
            "enc_b": np.zeros(f, np.float32),
            "lstm0_wi": dense(f, 4 * h),
            "lstm0_wh": dense(h, 4 * h),
            "lstm0_b": np.zeros(4 * h, np.float32),
            "lstm1_wi": dense(h, 4 * h),
            "lstm1_wh": dense(h, 4 * h),
            "lstm1_b": np.zeros(4 * h, np.float32),
            "out_w": dense(h, 1),
            "out_b": np.zeros(1, np.float32),
        }

    def params_numpy(self) -> Dict[str, np.ndarray]:
        """The parameters under the npz keys, as float32 numpy arrays."""
        return {name: p.detach().cpu().numpy() for name, p in self.named_parameters()}

    def reset(self) -> None:
        self.h = torch.zeros((2, 1, self.HIDDEN), device=self.device)
        self.c = torch.zeros((2, 1, self.HIDDEN), device=self.device)

    @staticmethod
    def _cell(wi: torch.Tensor, wh: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        i, f, g, o = torch.split(x @ wi + h @ wh + b, wi.shape[1] // 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new

    @torch.no_grad()
    def forward(self, audio: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """(b, n) chunk, n a multiple of 256 -> (probability (b, 1), new h, new c)."""
        b, n = audio.shape
        frames = audio.reshape(b, n // self.FRAME, self.FRAME) * self.window
        spec = torch.fft.rfft(frames, dim=-1).abs().mean(dim=1)  # (b, 129)
        feats = torch.relu(torch.log1p(spec) @ self.enc_w + self.enc_b)
        h0, c0 = self._cell(self.lstm0_wi, self.lstm0_wh, self.lstm0_b, feats, h[0], c[0])
        h1, c1 = self._cell(self.lstm1_wi, self.lstm1_wh, self.lstm1_b, h0, h[1], c[1])
        prob = torch.sigmoid(h1 @ self.out_w + self.out_b)
        return prob, torch.stack([h0, h1]), torch.stack([c0, c1])

    def __call__(self, audio: Any, sample_rate: int = SAMPLE_RATE, **_: Any) -> float:
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[np.newaxis, :]
        mono = audio.mean(axis=0)
        target = max(self.FRAME, -(-mono.shape[-1] // self.FRAME) * self.FRAME)
        if mono.shape[-1] < target:
            mono = np.pad(mono, (0, target - mono.shape[-1]))
        x = torch.from_numpy(np.ascontiguousarray(mono[None])).to(self.device)
        prob, self.h, self.c = self.forward(x, self.h, self.c)
        return float(prob[0, 0])


class SileroOnnxVAD(_TrimMixin):
    """
    The Silero VAD imported from its ``.onnx`` file, on ``device``.

    Both published layouts: v3/v4 (inputs ``input, sr, h, c``; outputs
    ``output, hn, cn``) and v5 (inputs ``input, state, sr``; outputs
    ``output, stateN``). The sample rate is passed as a numpy integer, so the
    graph's sample-rate ``If`` folds on the host; audio at another rate
    raises. The recurrent state stays on the device across calls until
    ``reset``. A call zero-pads the audio to whole chunks (512 samples at
    16 kHz, else 256), runs them in order and returns the largest probability.
    """

    def __init__(self, onnx_path: str, sample_rate: int = SAMPLE_RATE, device: DeviceLike = "cuda") -> None:
        from heybuddy_tpu_torch.export.onnx_to_torch import OnnxTorchFunction

        self.device = resolve_device(device)
        self._fn = OnnxTorchFunction.from_file(onnx_path, self.device)
        self.params = self._fn.params
        self.sample_rate = sample_rate
        self._names = self._fn.input_names
        self._v5 = "state" in self._names
        self._state_shape = (2, 1, 128) if self._v5 else (2, 1, 64)
        expected = {"input", "sr", "state"} if self._v5 else {"input", "sr", "h", "c"}
        unknown = set(self._names) - expected
        if unknown:
            raise ValueError(f"Unrecognized Silero VAD graph inputs: {sorted(unknown)}")
        self.reset()

    def reset(self) -> None:
        n_state = 1 if self._v5 else 2
        self._state: Tuple[torch.Tensor, ...] = tuple(
            torch.zeros(self._state_shape, dtype=torch.float32, device=self.device) for _ in range(n_state)
        )

    @torch.no_grad()
    def step(self, chunk: torch.Tensor) -> torch.Tensor:
        """One (1, n) chunk on the device -> its probability tensor; advances the state."""
        state = iter(self._state)
        ordered = []
        for name in self._names:
            if name == "input":
                ordered.append(chunk)
            elif name == "sr":
                ordered.append(np.int64(self.sample_rate))
            else:
                ordered.append(next(state))
        out = self._fn(self.params, *ordered)
        if not isinstance(out, (list, tuple)):
            out = [out]
        self._state = tuple(out[1:])
        return out[0]

    def __call__(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE, **_: Any) -> float:
        if sample_rate != self.sample_rate:
            raise ValueError(
                f"SileroOnnxVAD was built for {self.sample_rate} Hz; got {sample_rate} Hz (construct a "
                "new instance for that rate)"
            )
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        chunk = 512 if self.sample_rate == 16000 else 256
        pad = (-audio.shape[-1]) % chunk
        if pad or audio.shape[-1] == 0:
            audio = np.pad(audio, (0, pad if audio.shape[-1] else chunk))
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
        probs = [self.step(x[None, i: i + chunk]).reshape(-1)[0] for i in range(0, x.shape[0], chunk)]
        return float(torch.stack(probs).max())


# the shared VAD of each device
_GLOBAL_VAD: Dict[str, _TrimMixin] = {}


def get_vad_model(device: DeviceLike = "cuda", **_compat: Any) -> _TrimMixin:
    """
    The shared VAD, resolved as the JAX package resolves it:
    ``HEYBUDDY_VAD_ONNX`` naming a file gives ``SileroOnnxVAD`` on ``device``,
    then ``HEYBUDDY_VAD_WEIGHTS`` gives ``SileroStyleVAD`` on ``device``, else
    ``EnergyVAD`` (host numpy: ``device`` is not used).
    """
    key = str(device)
    if key not in _GLOBAL_VAD:
        onnx_path = os.environ.get("HEYBUDDY_VAD_ONNX")
        weights = os.environ.get("HEYBUDDY_VAD_WEIGHTS")
        if onnx_path and os.path.exists(onnx_path):
            _GLOBAL_VAD[key] = SileroOnnxVAD(onnx_path, device=device)
        elif weights and os.path.exists(weights):
            _GLOBAL_VAD[key] = SileroStyleVAD(weights, device=device)
        else:
            _GLOBAL_VAD[key] = EnergyVAD()
    return _GLOBAL_VAD[key]
