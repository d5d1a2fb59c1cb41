"""
Frozen speech-embedding network: log-mel spectrogram -> (windows, 96).

Counterpart of the JAX package's ``models/embedding_net.py``. The spectrogram
is cut into non-overlapping 4-frame patches (4 x 32 = 128 values); a shared
trunk runs once per patch (centred RMS -> ``patch_proj`` 128->192 -> blocks of
[RMS, up 192->384, exact-erf GELU, down 384->192, residual]); each 76-frame
window gathers its 19 patch features and pools them with 4-head attention
(learned positional code, softmax over the window), then a grouped RMS and
the head 768->96.

``EmbeddingNet.forward`` is the banded formulation (``apply_spectrogram_banded``),
``apply_spectrogram`` the gather formulation kept as the float32 reference.
Both emulate a bf16 compute dtype the way the JAX functions round: operands
are rounded to bf16 and multiplied in float32 (``a.bfloat16().float() @
w.bfloat16().float()``), because a bare bf16 CPU matmul rounds its output.

Weights come from an npz in the flat ``patch_proj/w``, ``trunk/0/up/w``, ...
layout (``load_params``, written by ``save_params``, the JAX package's
format both ways): ``HEYBUDDY_EMBEDDING_WEIGHTS`` or the bundled
``heybuddy_tpu/assets/embedding-pretrained.npz``, read by path. With neither
there is no fallback: the JAX package's seeded initialisation uses
``jax.random``, which torch cannot reproduce, so ``default_params`` raises.
``init_params`` draws a fresh parameter tree from a ``torch.Generator`` with
the JAX function's distributions, for pretraining from scratch.

``EmbeddingNet.apply`` is the per-window forward ((n, 76, 32) windows ->
(n, 96)). ``OnnxEmbeddingNet`` (``load_from_onnx``) is a frozen embedding
imported from an ``.onnx`` file instead, run by the ONNX importer; the
featurizer's "onnx" backend.

An ``EmbeddingNet``'s parameters are created frozen (``requires_grad=False``):
the featurizer never trains them. Pretraining builds its own copy and calls
``requires_grad_(True)`` on it. The bf16 rounding points (``_q``,
``x.to(bf16).float()``) carry gradients, rounding the cotangent to bf16 where
JAX's ``astype`` does.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from heybuddy_tpu_torch.constants import EMBEDDING_DIM, EMBEDDING_WINDOW_SIZE, MEL_BINS
from heybuddy_tpu_torch.utils.log import logger

__all__ = [
    "EmbeddingNetConfig",
    "EmbeddingNet",
    "OnnxEmbeddingNet",
    "load_from_onnx",
    "init_params",
    "save_params",
    "load_params",
    "default_params",
    "bundled_weights_path",
    "embedding_space_id",
    "flatten_params",
]

Params = Dict[str, Any]


class EmbeddingNetConfig:
    """Static architecture hyperparameters of the frozen embedding network."""

    def __init__(
        self,
        window_size: int = EMBEDDING_WINDOW_SIZE,
        mel_bins: int = MEL_BINS,
        patch_frames: int = 4,
        hidden_dim: int = 192,
        trunk_hidden_dim: int = 384,
        trunk_blocks: int = 2,
        pool_heads: int = 4,
        embedding_dim: int = EMBEDDING_DIM,
    ) -> None:
        assert window_size % patch_frames == 0
        self.window_size = window_size
        self.mel_bins = mel_bins
        self.patch_frames = patch_frames
        self.window_patches = window_size // patch_frames  # 19
        self.patch_dim = patch_frames * mel_bins  # 128
        self.hidden_dim = hidden_dim
        self.trunk_hidden_dim = trunk_hidden_dim
        self.trunk_blocks = trunk_blocks
        self.pool_heads = pool_heads
        self.embedding_dim = embedding_dim

    def as_dict(self) -> Dict[str, int]:
        return {
            "window_size": self.window_size,
            "mel_bins": self.mel_bins,
            "patch_frames": self.patch_frames,
            "hidden_dim": self.hidden_dim,
            "trunk_hidden_dim": self.trunk_hidden_dim,
            "trunk_blocks": self.trunk_blocks,
            "pool_heads": self.pool_heads,
            "embedding_dim": self.embedding_dim,
        }

    def __eq__(self, other: object) -> bool:
        return isinstance(other, EmbeddingNetConfig) and self.as_dict() == other.as_dict()

    def __hash__(self) -> int:
        return hash(tuple(sorted(self.as_dict().items())))


def _q(x: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
    """Round float32 values to the compute dtype, kept in float32."""
    return x if compute == torch.float32 else x.to(compute).float()


def _rms_scale(x: torch.Tensor, compute: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """Centred RMS normalisation (LayerNorm without affine) in float32."""
    centered = x - x.mean(dim=-1, keepdim=True)
    ms = (centered * centered).mean(dim=-1, keepdim=True)
    return _q(centered * torch.rsqrt(ms + eps), compute)


class _Dense(nn.Module):
    """x @ w + b with w stored (in, out), as in the JAX parameter tree."""

    def __init__(self, fan_in: int, fan_out: int) -> None:
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(fan_out), requires_grad=False)

    def forward(self, x: torch.Tensor, compute: torch.dtype = torch.float32) -> torch.Tensor:
        """Operands rounded to ``compute``, float32 accumulation, output rounded."""
        return _q(torch.matmul(x, _q(self.w, compute)) + self.b, compute)


class _TrunkBlock(nn.Module):
    def __init__(self, hidden: int, trunk_hidden: int) -> None:
        super().__init__()
        self.up = _Dense(hidden, trunk_hidden)
        self.down = _Dense(trunk_hidden, hidden)


@functools.lru_cache(maxsize=None)
def _band_constants(
    starts: Tuple[int, ...], patch_frames: int, window_patches: int, num_patches: int
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Banded-pooling structure:
      selector: (W, P) 0/1 — patch p lies in window w
      k_index:  (W, P) int — p's position within w (0 where unused)
    """
    selector = np.zeros((len(starts), num_patches), dtype=np.float32)
    k_index = np.zeros((len(starts), num_patches), dtype=np.int64)
    for w, start in enumerate(starts):
        p0 = start // patch_frames
        for k in range(window_patches):
            selector[w, p0 + k] = 1.0
            k_index[w, p0 + k] = k
    return selector, k_index


class EmbeddingNet(nn.Module):
    """The frozen embedding network; parameter names follow the JAX tree."""

    def __init__(self, config: Optional[EmbeddingNetConfig] = None) -> None:
        super().__init__()
        cfg = config or EmbeddingNetConfig()
        self.config = cfg
        self.patch_proj = _Dense(cfg.patch_dim, cfg.hidden_dim)
        self.trunk = nn.ModuleList(
            _TrunkBlock(cfg.hidden_dim, cfg.trunk_hidden_dim) for _ in range(cfg.trunk_blocks)
        )
        self.pos = nn.Parameter(torch.zeros(cfg.window_patches, cfg.hidden_dim), requires_grad=False)
        self.pool_query = nn.Parameter(torch.zeros(cfg.hidden_dim, cfg.pool_heads), requires_grad=False)
        self.head = _Dense(cfg.hidden_dim * cfg.pool_heads, cfg.embedding_dim)

    # --- shared pieces ---------------------------------------------------------

    def _patches(self, spectrogram: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, frames, _ = spectrogram.shape
        usable = (frames // cfg.patch_frames) * cfg.patch_frames
        return spectrogram[:, :usable].reshape(b, usable // cfg.patch_frames, cfg.patch_dim)

    def trunk_features(self, patches: torch.Tensor, compute: torch.dtype) -> torch.Tensor:
        """(..., patch_dim) -> (..., hidden) shared patch features."""
        x = self.patch_proj(_rms_scale(_q(patches.float(), compute), compute), compute)
        for block in self.trunk:
            h = block.up(_rms_scale(x, compute), compute)
            h = _q(torch.nn.functional.gelu(h), compute)  # exact erf GELU
            x = _q(x + block.down(h, compute), compute)
        return x

    def _check_starts(self, window_starts: Sequence[int]) -> Tuple[int, ...]:
        starts = tuple(int(s) for s in window_starts)
        if any(s % self.config.patch_frames for s in starts):
            raise ValueError("window starts must align to the patch grid")
        return starts

    # --- forward formulations --------------------------------------------------

    def apply_spectrogram(
        self,
        spectrogram: torch.Tensor,
        window_starts: Sequence[int],
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """
        Gather formulation, the float32 reference: (b, frames, mel) + window
        starts -> (b, W, 96). Each window gathers its 19 trunk features, adds
        the positional code and pools with a per-head softmax.
        """
        cfg = self.config
        compute = compute_dtype
        feats = self.trunk_features(self._patches(spectrogram), compute)  # (b, P, D)
        starts = self._check_starts(window_starts)
        b = feats.shape[0]
        idx = torch.as_tensor(
            np.asarray(starts)[:, None] // cfg.patch_frames + np.arange(cfg.window_patches)[None, :],
            device=feats.device,
        )
        x = _q(feats[:, idx] + _q(self.pos, compute), compute)  # (b, W, 19, D)
        scores = torch.matmul(x, _q(self.pool_query, compute))  # (b, W, 19, H)
        weights = _q(torch.softmax(scores, dim=2), compute)
        pooled = _q(torch.einsum("bwph,bwpd->bwhd", weights, x), compute)
        pooled = pooled.reshape(b * len(starts), cfg.pool_heads * cfg.hidden_dim)
        out = self.head(_rms_scale(pooled, compute), compute)
        return out.reshape(b, len(starts), cfg.embedding_dim)

    def apply_spectrogram_banded(
        self,
        spectrogram: torch.Tensor,
        window_starts: Sequence[int],
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """
        Banded formulation: the pooling as two products over the whole clip.
        ``softmax((f + pos) @ Q)`` separates as ``e_a(p) * e_c(k) / denom``, so
        ``pooled = W @ feats + W @ POSP`` with the band weights
        ``W = band * e_a / denom`` cast to the compute dtype after
        normalisation, as in the JAX function.
        """
        cfg = self.config
        compute = compute_dtype
        feats = self.trunk_features(self._patches(spectrogram), compute)  # (b, P, D)
        b, num_patches, hidden = feats.shape
        starts = self._check_starts(window_starts)
        n_windows, heads = len(starts), cfg.pool_heads
        selector_np, k_index_np = _band_constants(
            starts, cfg.patch_frames, cfg.window_patches, num_patches
        )
        dev = feats.device
        selector = torch.from_numpy(selector_np).to(dev)
        k_index = torch.from_numpy(k_index_np).to(dev)

        q = self.pool_query.float()
        c = torch.matmul(self.pos.float(), q)  # (19, H)
        exp_c = torch.exp(c - c.max())
        band = exp_c[k_index].permute(0, 2, 1) * selector[:, None, :]  # (W, H, P)

        a = torch.matmul(feats, _q(q, compute))  # (b, P, H)
        a = a - a.max(dim=1, keepdim=True).values
        e_a = torch.exp(a)
        bw = band[None] * e_a.permute(0, 2, 1)[:, None]  # (b, W, H, P)
        denom = bw.sum(dim=3, keepdim=True)
        weights = _q(bw / (denom + 1e-30), compute)
        numer1 = torch.matmul(weights.reshape(b, n_windows * heads, num_patches), feats)
        numer1 = numer1.reshape(b, n_windows, heads, hidden)

        idx = torch.as_tensor(
            np.asarray(starts)[:, None] // cfg.patch_frames + np.arange(cfg.window_patches)[None, :],
            device=dev,
        )
        ea_w = e_a[:, idx]  # (b, W, 19, H)
        wk = ea_w * exp_c[None, None] / (denom.permute(0, 1, 3, 2) + 1e-30)
        wk = _q(wk.permute(0, 1, 3, 2), compute)  # (b, W, H, 19)
        numer2 = torch.matmul(wk, _q(self.pos.float(), compute))  # (b, W, H, D)

        pooled = _q(numer1 + numer2, compute).reshape(b * n_windows, heads * hidden)
        out = self.head(_rms_scale(pooled, compute), compute)
        return out.reshape(b, n_windows, cfg.embedding_dim)

    def forward(
        self,
        spectrogram: torch.Tensor,
        window_starts: Sequence[int],
        compute_dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        return self.apply_spectrogram_banded(spectrogram, window_starts, compute_dtype)

    def apply(self, windows: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """
        Per-window forward: (n, 76, 32) or (n, 76, 32, 1) log-mel windows ->
        (n, 96), the gather formulation with each row one window at frame 0.
        """
        if windows.ndim == 4:
            windows = windows[..., 0]
        return self.apply_spectrogram(windows, [0], compute_dtype)[:, 0]


class OnnxEmbeddingNet:
    """
    A frozen speech-embedding model imported from an ``.onnx`` file (the
    bundled ``browser/models/speech-embedding.onnx``, or the reference's
    Google model) and run on ``device`` by ``OnnxTorchFunction``.

    ``apply(windows)`` takes (n, 76, 32) or (n, 76, 32, 1) log-mel windows
    and returns (n, 96) float32. The output is ``conv2d_19`` when the graph
    has it (the name the browser runtime reads), else the sole output.
    """

    def __init__(self, fn: Any, input_name: str, output_name: str, input_rank: int) -> None:
        self._fn = fn
        self.input_name = input_name
        self.output_name = output_name
        self.input_rank = input_rank
        self.params: Dict[str, torch.Tensor] = fn.params

    @classmethod
    def from_file(cls, path: str, device: Any = "cuda") -> "OnnxEmbeddingNet":
        from heybuddy_tpu_torch.export.onnx_to_torch import OnnxTorchFunction

        fn = OnnxTorchFunction.from_file(path, device)
        if len(fn.input_names) != 1:
            raise ValueError(f"Expected a single graph input, got {fn.input_names}: not a frozen embedding model")
        output = "conv2d_19" if "conv2d_19" in fn.output_names else fn.output_names[0]
        declared = {i.name: i.shape for i in fn.graph.inputs}
        rank = len(declared.get(fn.input_names[0], (0, 0, 0, 0)))
        return cls(fn, fn.input_names[0], output, rank)

    def params_numpy(self) -> Dict[str, np.ndarray]:
        """The float initializers as numpy arrays (what the space id hashes)."""
        return {k: v.detach().cpu().numpy() for k, v in self.params.items()}

    def apply(self, windows: torch.Tensor) -> torch.Tensor:
        if windows.ndim == 3 and self.input_rank == 4:
            windows = windows[..., None]  # NHWC channel dim
        elif windows.ndim == 4 and self.input_rank == 3:
            windows = windows[..., 0]
        out = self._fn(self.params, windows)
        if isinstance(out, (list, tuple)):
            out = out[self._fn.output_names.index(self.output_name)]
        return out.reshape(out.shape[0], -1).float()  # (n, 1, 1, 96) -> (n, 96)


def load_from_onnx(path: str, device: Any = "cuda") -> OnnxEmbeddingNet:
    """Import a frozen embedding model from an ``.onnx`` file onto ``device``."""
    return OnnxEmbeddingNet.from_file(path, device)


# --- weights -------------------------------------------------------------------


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree (or an ``nn.Module``) -> flat {"a/0/b": array}."""
    if isinstance(params, nn.Module):
        return {
            k.replace(".", "/"): v.detach().cpu().numpy() for k, v in params.state_dict().items()
        }
    flat: Dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Params:
    """Flat {"trunk/0/up/w": array} -> nested dicts, with lists for digit keys."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        items = {k: listify(v) for k, v in node.items()}
        if items and all(k.isdigit() for k in items):
            return [items[str(i)] for i in range(len(items))]
        return items

    return listify(root)


def init_params(generator: torch.Generator, config: Optional[EmbeddingNetConfig] = None) -> Params:
    """
    A fresh parameter tree (float32 numpy, the JAX layout) drawn from
    ``generator`` on its device with the JAX function's distributions and in
    its order of draws: dense weights uniform in +-1/sqrt(fan_in) (patch_proj,
    then each block's up and down, pool_query, head), biases zero, ``pos``
    0.02 N(0, 1) (drawn after the blocks). ``jax.random`` streams cannot be
    reproduced, so the values differ from the JAX function's for any seed.
    """
    cfg = config or EmbeddingNetConfig()
    dev = generator.device

    def dense(fan_in: int, fan_out: int) -> np.ndarray:
        scale = 1.0 / np.sqrt(fan_in)
        u = torch.rand((fan_in, fan_out), generator=generator, device=dev)
        return (u * (2.0 * scale) - scale).cpu().numpy()

    def zeros(n: int) -> np.ndarray:
        return np.zeros((n,), dtype=np.float32)

    patch_w = dense(cfg.patch_dim, cfg.hidden_dim)
    blocks = []
    for _ in range(cfg.trunk_blocks):
        up_w = dense(cfg.hidden_dim, cfg.trunk_hidden_dim)
        down_w = dense(cfg.trunk_hidden_dim, cfg.hidden_dim)
        blocks.append({"up": {"w": up_w, "b": zeros(cfg.trunk_hidden_dim)},
                       "down": {"w": down_w, "b": zeros(cfg.hidden_dim)}})
    pos = (0.02 * torch.randn((cfg.window_patches, cfg.hidden_dim), generator=generator, device=dev)).cpu().numpy()
    pool_query = dense(cfg.hidden_dim, cfg.pool_heads)
    head_w = dense(cfg.hidden_dim * cfg.pool_heads, cfg.embedding_dim)
    return {
        "patch_proj": {"w": patch_w, "b": zeros(cfg.hidden_dim)},
        "trunk": blocks,
        "pos": pos,
        "pool_query": pool_query,
        "head": {"w": head_w, "b": zeros(cfg.embedding_dim)},
    }


def save_params(params: Any, path: str) -> None:
    """Write a parameter tree (or an ``EmbeddingNet``) as the flat npz both packages' ``load_params`` read."""
    np.savez(path, **{k: np.asarray(v, dtype=np.float32) for k, v in flatten_params(params).items()})


def load_params(path: str) -> Params:
    """Read an embedding npz (flat ``patch_proj/w`` keys) as a nested numpy tree."""
    with np.load(path) as loaded:
        return unflatten_params({k: np.asarray(loaded[k]) for k in loaded.files})


def bundled_weights_path() -> Optional[str]:
    """Path of the bundled pretrained embedding (a data file of the JAX package)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(root, "heybuddy_tpu", "assets", "embedding-pretrained.npz")
    return path if os.path.exists(path) else None


@functools.lru_cache(maxsize=None)
def _load_cached(path: str) -> Params:
    return load_params(path)


def default_params() -> Params:
    """
    The frozen default weights: ``HEYBUDDY_EMBEDDING_WEIGHTS`` if it names an
    existing file, else the bundled pretrained npz. Raises if neither exists.
    """
    env_path = os.environ.get("HEYBUDDY_EMBEDDING_WEIGHTS")
    if env_path:
        if os.path.exists(env_path):
            return _load_cached(os.path.abspath(env_path))
        logger.warning(
            f"HEYBUDDY_EMBEDDING_WEIGHTS={env_path!r} does not exist; falling back to "
            "the bundled weights — a DIFFERENT feature space."
        )
    bundled = bundled_weights_path()
    if bundled is None:
        raise FileNotFoundError(
            "no embedding weights: set HEYBUDDY_EMBEDDING_WEIGHTS or keep "
            "heybuddy_tpu/assets/embedding-pretrained.npz (the port cannot "
            "reproduce the seeded initialisation)"
        )
    return _load_cached(bundled)


def embedding_space_id(params: Any, backend: str = "trunkpool") -> str:
    """
    Short stable id of the feature space a parameter set produces: sha256 of
    the backend name and every weight buffer (float32) in sorted key order.
    Equal to the JAX function's id for the same weights.
    """
    h = hashlib.sha256(backend.encode())
    for key, value in sorted(flatten_params(params).items()):
        h.update(key.encode())
        h.update(np.ascontiguousarray(np.asarray(value, dtype=np.float32)).tobytes())
    return h.hexdigest()[:16]
