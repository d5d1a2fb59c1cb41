"""
The featurization pipeline: raw audio clips -> (n, windows, 96) features.

Counterpart of the JAX package's ``models/featurizer.py``. ``featurize_batch``
takes the JAX function's ``pooling`` values:

* ``"fused"`` (and ``"auto"``): the mel-patch kernel (K1) and the fused
  embedding kernel (K2) back to back, the patch layout handed from one to
  the other;
* ``"mega"``: the one-kernel featurizer (K4), audio to embeddings;
* ``"banded"`` / ``"gather"``: the mel-spectrogram kernel (K3), then
  ``EmbeddingNet.apply_spectrogram_banded`` / ``apply_spectrogram`` in plain
  PyTorch, as the JAX package leaves those formulations to XLA.

``featurize_batch_per_window`` serves an imported ONNX embedding
(``SpeechEmbeddings(onnx_path=...)``): K3, then the graph on every window.

On a CUDA device the kernels are the hand-written ones; on the CPU the
wrappers run their plain versions. The batch is not padded: padding existed
only to bound XLA compiles. A (b, 23040) clip batch in int16 range gives
(b, 16, 96).

``SpeechEmbeddings(mesh=...)`` shards bulk featurization over the mesh's data
axis (``extract --mesh``): each rank featurizes its rows of the batch,
padded with zero clips to a multiple of the data axis, through the active
backend, the rows are gathered in rank order and the padding dropped, and
every rank returns the whole result. Each clip is featurized on its own, so
the result equals the one-rank run's.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    AUDIO_WINDOW_SIZE,
    AUDIO_WINDOW_STRIDE,
    CLIP_SAMPLES,
    EMBEDDING_WINDOW_SIZE,
    EMBEDDING_WINDOW_STRIDE,
    MEL_HOP_LENGTH,
    SAMPLE_RATE,
)
from heybuddy_tpu_torch.convert import embedding_params_from_numpy
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models import embedding_net
from heybuddy_tpu_torch.models.embedding_net import EmbeddingNet
from heybuddy_tpu_torch.ops.kernels.embedding_kernel import fused_embedding_from_patches
from heybuddy_tpu_torch.ops.kernels.featurize_kernel import fused_featurize
from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_patches, mel_spectrogram
from heybuddy_tpu_torch.ops.melspec import num_frames
from heybuddy_tpu_torch.ops.windows import embedding_window_starts
from heybuddy_tpu_torch.parallel.mesh import Mesh, gather_rows, row_range
from heybuddy_tpu_torch.utils.audio_io import audio_to_bct_array
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.profiling import span

__all__ = [
    "featurize_batch", "featurize_batch_per_window", "SpeechEmbeddings", "get_speech_embeddings", "POOLINGS",
    "STREAM_SEGMENT_WINDOWS",
]

POOLINGS = ("fused", "mega", "banded", "gather")
# sliding windows featurized from one uploaded stream segment at most
STREAM_SEGMENT_WINDOWS = 1024


def featurize_batch(
    net: EmbeddingNet,
    audio: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    pooling: str = "fused",
) -> torch.Tensor:
    """
    (batch, t) float32 int16-range audio on the net's device ->
    (batch, n_windows, 96) embeddings, by the formulation ``pooling`` names
    (module docstring; ``"auto"`` is ``"fused"``). The kernels of ``"fused"``
    and ``"mega"`` compute in bf16, so another ``compute_dtype`` runs
    ``"banded"`` instead, as in the JAX function. ``"fused"`` takes a
    row-strided view of overlapping windows as it is (``mel_patches``); the
    other formulations take a contiguous copy.
    """
    if audio.ndim == 1:
        audio = audio[None, :]
    if pooling == "auto":
        pooling = "fused"
    if pooling in ("mega", "fused") and compute_dtype != torch.bfloat16:
        pooling = "banded"
    if pooling not in POOLINGS:
        raise ValueError(f"unknown pooling {pooling!r}; expected auto or one of {POOLINGS}")
    if pooling != "fused":  # K1 alone reads a row-strided view in place
        audio = audio.contiguous()
    starts = embedding_window_starts(audio.shape[1])
    if pooling == "mega":
        return fused_featurize(net, audio, starts)
    if pooling == "fused":
        patches, num_patches = mel_patches(audio)
        return fused_embedding_from_patches(net, patches, starts, num_patches)
    spec = mel_spectrogram(audio)
    apply_fn = net.apply_spectrogram_banded if pooling == "banded" else net.apply_spectrogram
    return apply_fn(spec, starts, compute_dtype=compute_dtype)


def featurize_batch_per_window(apply_fn: Any, audio: torch.Tensor) -> torch.Tensor:
    """
    For imported frozen models whose graph runs one 76 x 32 window at a time
    (the ONNX embedding): K3's mel spectrogram once for the batch, every
    window gathered by the static plan, then one batched forward over
    (b * windows, 76, 32). (b, t) int16-range audio -> (b, windows, 96).
    """
    if audio.ndim == 1:
        audio = audio[None, :]
    b, t = audio.shape
    spec = mel_spectrogram(audio.contiguous())  # (b, frames, 32)
    starts = np.asarray(embedding_window_starts(t))
    idx = torch.as_tensor(starts[:, None] + np.arange(EMBEDDING_WINDOW_SIZE)[None, :], device=spec.device)
    windows = spec[:, idx]  # (b, W, 76, 32)
    w = windows.shape[1]
    emb = apply_fn(windows.reshape(b * w, EMBEDDING_WINDOW_SIZE, -1))
    return emb.reshape(b, w, -1)


class SpeechEmbeddings:
    """
    User-facing featurizer: accepts paths / arrays / lists, resamples to
    16 kHz, downmixes to mono, scales to int16-range values and returns
    float32 numpy embeddings (batch, n, 96); optionally also the scaled
    log-mel spectrograms truncated to whole embedding windows.

    ``params`` is the JAX-layout numpy tree (default: ``default_params()``)
    or an ``EmbeddingNet``. ``onnx_path`` (or, without ``params``,
    ``HEYBUDDY_EMBEDDING_ONNX``) selects the "onnx" backend instead: the
    imported frozen graph per window after K3 (``featurize_batch_per_window``),
    a space id of its own; a path that does not exist raises. ``device``
    defaults to ``"cuda"`` and raises without it; with ``mesh`` the device is
    the rank's and batches are sharded over the data axis (module docstring).
    ``compute_dtype`` is ``featurize_batch``'s (bf16 runs the fused kernels).
    ``seed`` seeds the generator of ``_repair_nan``'s row choice.
    """

    def __init__(
        self,
        params: Optional[Any] = None,
        device: DeviceLike = "cuda",
        compute_dtype: torch.dtype = torch.bfloat16,
        onnx_path: Optional[str] = None,
        seed: int = 0,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.compute_dtype = compute_dtype
        self.generator = torch.Generator().manual_seed(seed)
        self._space_id: Optional[str] = None
        if onnx_path is None and params is None:
            onnx_path = os.environ.get("HEYBUDDY_EMBEDDING_ONNX") or None
        self.onnx_net: Optional[embedding_net.OnnxEmbeddingNet] = None
        self.net: Optional[EmbeddingNet] = None
        if onnx_path:
            if not os.path.exists(onnx_path):
                raise FileNotFoundError(
                    f"HEYBUDDY_EMBEDDING_ONNX / onnx_path {onnx_path!r} does not exist; the trunkpool "
                    "embedding would be a different feature space"
                )
            self.onnx_net = embedding_net.load_from_onnx(onnx_path, self.device)
            self.backend = "onnx"
            return
        if params is None:
            params = embedding_net.default_params()
        net = params if isinstance(params, EmbeddingNet) else embedding_params_from_numpy(params)
        self.net = net.to(self.device).eval()
        self.backend = "trunkpool"

    @property
    def space_id(self) -> str:
        """Stable identifier of the feature space (backend + weights hash)."""
        if self._space_id is None:
            weights = self.net if self.onnx_net is None else self.onnx_net.params_numpy()
            self._space_id = embedding_net.embedding_space_id(weights, self.backend)
        return self._space_id

    def _featurize(self, audio: torch.Tensor) -> torch.Tensor:
        """(b, t) int16-range audio on the device -> (b, windows, 96) by the active backend."""
        if self.onnx_net is not None:
            return featurize_batch_per_window(self.onnx_net.apply, audio)
        return featurize_batch(self.net, audio, self.compute_dtype)

    def _featurize_sharded(self, mono: np.ndarray) -> torch.Tensor:
        """(b, t) int16-range host audio -> (b, windows, 96) on every rank of
        the mesh: this rank's rows (zero clips past ``b``), then the rows of
        every rank in order."""
        b = mono.shape[0]
        lo, hi, per = row_range(b, self.mesh)
        local = np.zeros((per,) + mono.shape[1:], dtype=np.float32)
        local[: hi - lo] = mono[lo:hi]
        return gather_rows(self._featurize(torch.from_numpy(local).to(self.device)), b, self.mesh)

    @torch.no_grad()
    def featurize_device(self, audio_batch: np.ndarray) -> Tuple[torch.Tensor, int]:
        """
        Featurize a prepared (b, t) float32 batch in [-1, 1] on the device;
        returns the device tensor (not synchronised) and the row count.
        """
        mono = np.ascontiguousarray(audio_batch, dtype=np.float32) * 32767.0
        if self.mesh is not None:
            return self._featurize_sharded(mono), audio_batch.shape[0]
        return self._featurize(torch.from_numpy(mono).to(self.device)), audio_batch.shape[0]

    @torch.no_grad()
    def featurize_stream_device(self, stream: np.ndarray, count: int, stride: int) -> Tuple[torch.Tensor, int]:
        """
        Featurize the first ``count`` (at most ``STREAM_SEGMENT_WINDOWS``)
        sliding windows, ``CLIP_SAMPLES`` wide and ``stride`` apart, of a
        float32 stream in [-1, 1]. The segment they span is uploaded once,
        zero-filled past the stream's end, and scaled on the device; the
        windows are a row-strided view of it that K1 reads in place, so no
        window is copied. Returns the device tensor (not synchronised) and
        ``count``. Unlike the JAX function nothing pads to a fixed window count.
        """
        count = min(count, STREAM_SEGMENT_WINDOWS)
        if count < 1:
            raise ValueError(f"a stream of {len(stream)} samples holds no window of {CLIP_SAMPLES}")
        seg = np.zeros((count - 1) * stride + CLIP_SAMPLES, dtype=np.float32)
        take = min(len(stream), seg.shape[0])
        seg[:take] = stream[:take]
        segment = torch.from_numpy(seg).to(self.device).mul_(32767.0)
        windows = segment.as_strided((count, CLIP_SAMPLES), (stride, 1))
        return self._featurize(windows), count

    @torch.no_grad()
    def __call__(
        self,
        audio: Any,
        remove_nan: bool = True,
        return_spectrograms: bool = False,
        **_compat_kwargs: Any,
    ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        with span("featurizer/embed"):
            with span("featurizer/upload"):
                batch, _sr = audio_to_bct_array(audio, sample_rate=SAMPLE_RATE)
                mono = np.ascontiguousarray(batch.mean(axis=1) * 32767.0, dtype=np.float32)
                b, t = mono.shape
                mono_dev = torch.from_numpy(mono).to(self.device) if self.mesh is None else None
            with span("featurizer/featurize"):
                features = self._featurize(mono_dev) if self.mesh is None else self._featurize_sharded(mono)
            with span("featurizer/download"):  # waits for the featurize kernels, then copies
                embeddings = features.cpu().numpy()
                if remove_nan:
                    embeddings = self._repair_nan(embeddings, self.generator)

        if return_spectrograms:
            # per-audio-window spectrograms concatenated along the frame axis,
            # truncated to whole embedding windows (17280 -> 105 frames -> 100;
            # 23040 -> 4 x 105 = 420); K3 on the card
            if mono_dev is None:
                mono_dev = torch.from_numpy(mono).to(self.device)
            spec = mel_spectrogram(mono_dev).cpu().numpy()
            frames_per = num_frames(AUDIO_WINDOW_SIZE)
            hops = AUDIO_WINDOW_STRIDE // MEL_HOP_LENGTH
            per_window = [
                spec[:, k * hops : k * hops + frames_per]
                for k, _ in enumerate(range(0, t - AUDIO_WINDOW_SIZE + 1, AUDIO_WINDOW_STRIDE))
            ]
            concat = np.concatenate(per_window, axis=1)
            total = concat.shape[1]
            truncated = total - ((total - EMBEDDING_WINDOW_SIZE) % EMBEDDING_WINDOW_STRIDE)
            return embeddings, concat[:, :truncated]
        return embeddings

    @staticmethod
    def _repair_nan(embeddings: np.ndarray, generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Replace NaN rows with randomly chosen good rows (zeros if none is good)."""
        nan_rows = np.isnan(embeddings).any(axis=(1, 2))
        if not nan_rows.any():
            return embeddings
        keep = np.where(~nan_rows)[0]
        bad = np.where(nan_rows)[0]
        logger.warning(f"Replacing {len(bad)} NaN embeddings with random embeddings.")
        if keep.size == 0:
            logger.warning("All embeddings are NaN, returning zero embeddings.")
            return np.zeros_like(embeddings)
        pick = torch.randint(0, keep.size, (len(bad),), generator=generator).numpy()
        embeddings = embeddings.copy()
        embeddings[bad] = embeddings[keep[pick]]
        return embeddings


# one shared featurizer per device; the lock keeps two model threads of
# ``listen`` from building two
_GLOBAL_EMBEDDINGS: Dict[str, SpeechEmbeddings] = {}
_GLOBAL_LOCK = threading.Lock()


def get_speech_embeddings(device: DeviceLike = "cuda", **kwargs: Any) -> SpeechEmbeddings:
    """The shared featurizer of ``device``, built on first use."""
    key = str(resolve_device(device))
    with _GLOBAL_LOCK:
        if key not in _GLOBAL_EMBEDDINGS:
            _GLOBAL_EMBEDDINGS[key] = SpeechEmbeddings(device=device, **kwargs)
        elif kwargs:
            logger.warning(
                f"get_speech_embeddings ignoring {sorted(kwargs)}: the shared featurizer "
                "was already constructed with different settings."
            )
        return _GLOBAL_EMBEDDINGS[key]
