"""
A wake-word head loaded from its exported ``.onnx`` file.

Counterpart of the JAX package's ``runtime/onnx_model.py``: the same
inference API as the native heads (``__call__`` over (b, 16, 96) features,
``scores``, ``predict``, ``predict_timecodes``). The graph runs on
onnxruntime when it is installed, else on the port's numpy ``OnnxRunner``;
the features come from the shared featurizer of ``device`` (K1 -> K2 on the
card). ``device_scores`` scores features that are already on ``device``
there, through the ONNX importer's tensor ops (``export/onnx_to_torch.py``),
so that they need no copy to the host.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.wakeword import WakeWordInferenceMixin

__all__ = ["WakeWordONNXModel"]


class WakeWordONNXModel(WakeWordInferenceMixin):
    def __init__(self, path: str, device: DeviceLike = "cuda") -> None:
        self.path = path
        self.device = resolve_device(device)
        self._session = None
        self._runner = None
        self._batch_ok: Optional[bool] = None  # None: not yet checked on a batched call
        self._device_fn: Any = None  # the graph on self.device, built by the first device_scores
        try:
            import onnxruntime  # type: ignore[import-not-found]

            self._session = onnxruntime.InferenceSession(path, providers=["CPUExecutionProvider"])
        except ImportError:
            from heybuddy_tpu_torch.export.onnx_numpy import OnnxRunner

            self._runner = OnnxRunner.from_file(path)

    def __call__(self, features: Any) -> np.ndarray:
        features = np.asarray(features, dtype=np.float32)
        if features.ndim == 2:
            features = features[None]
        # The exported graph declares a batch-1 input, but its ops are
        # batch-agnostic, so the numpy runner walks a whole batch at once. The
        # first batched call checks one row against the single-row walk (an op
        # that mixed rows would keep the shape and corrupt every row) and the
        # verdict is kept; the row loop is the fallback.
        if self._runner is not None and len(features) > 1 and self._batch_ok is not False:
            try:
                out = np.asarray(self._runner(input=features)["output"])
                if out.shape[:1] == features.shape[:1]:
                    if self._batch_ok is None:
                        single = np.asarray(self._runner(input=features[:1])["output"])
                        self._batch_ok = bool(np.allclose(out[0], single[0], rtol=1e-4, atol=1e-5))
                    if self._batch_ok:
                        return out
            except Exception:
                pass
        outputs = []
        for row in features:
            if self._session is not None:
                out = self._session.run(None, {"input": row[None]})[0]
            else:
                out = self._runner(input=row[None])["output"]
            outputs.append(out[0])
        return np.stack(outputs)

    def scores(self, features: np.ndarray) -> np.ndarray:
        """(n, 16, 96) features -> (n,) probabilities (the graph is numpy in, numpy out)."""
        return np.asarray(self(features), dtype=np.float32).reshape(-1)

    @torch.no_grad()
    def device_scores(self, features: torch.Tensor) -> torch.Tensor:
        """(n, 16, 96) features on ``self.device`` -> (n,) probabilities there."""
        if self._device_fn is None:
            from heybuddy_tpu_torch.export.onnx_to_torch import OnnxTorchFunction

            self._device_fn = OnnxTorchFunction.from_file(self.path, self.device)
        return self._device_fn(self._device_fn.params, features.float()).reshape(-1)
