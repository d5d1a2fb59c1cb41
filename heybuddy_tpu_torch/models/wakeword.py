"""
The wake-word heads, their checkpoints and audio-level prediction.

Counterpart of the JAX package's ``models/wakeword.py``:

* ``WakeWordMLPModel`` (``perceptron``) flattens (batch, 16, 96) features ->
  LayerNorm -> gated MLP -> optional 16 half-layer branches on striped frame
  subsets -> N x [LayerNorm + gated MLP] -> LayerNorm -> gated MLP -> sigmoid.
* ``WakeWordTransformerModel`` (``transformer``): linear-in -> LayerNorm ->
  activation -> N pre-norm blocks (attention with LayerNorm on the queries
  and keys and softmax scale 1.0, gated FFN with hidden width a multiple of
  18) -> an affine-free norm over the 16 frames (eps 1e-6) -> one
  zero-initialised linear per channel -> sigmoid -> max over the channels.

LayerNorm is float32 (eps 1e-5 unless stated); the small products stay
``torch.matmul`` in float32 (TF32 off), as the JAX heads leave them to XLA.
``forward(x, train=True, generator=g)`` applies the input dropout of
training with draws from ``g``, an explicit ``torch.Generator`` on the
model's device (``jax.random``'s draws cannot be reproduced).

Checkpoints are the JAX package's flat npz: ``a/0/b`` keys in the JAX
parameter tree's layout (dense weights (in, out)) plus ``__config__``, so a
checkpoint written by either package loads in the other.
``WakeWordMLPModel.from_torch_file`` imports a reference ``.pt`` state dict.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from heybuddy_tpu_torch.constants import (
    CLIP_SAMPLES,
    DEFAULT_ACTIVATION_THRESHOLD,
    DEFAULT_HEADS,
    DEFAULT_LAYER_DIM,
    DEFAULT_LAYERS,
    DEFAULT_USE_GATING,
    DEFAULT_USE_HALF_LAYERS,
    EMBEDDING_DIM,
    FEATURE_FRAMES,
    SAMPLE_RATE,
)
from heybuddy_tpu_torch.convert import restore_empty_lists, wakeword_params_from_numpy, wakeword_params_to_numpy
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.embedding_net import flatten_params, unflatten_params
from heybuddy_tpu_torch.utils.profiling import span

__all__ = [
    "WakeWordMLPModel",
    "WakeWordTransformerModel",
    "load_model",
    "save_model",
    "read_checkpoint",
    "HALF_LAYER_INDICES",
    "get_normalized_dim",
    "find_nearest_multiple",
]

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": torch.nn.functional.silu,
    "swish": torch.nn.functional.silu,
    "mish": torch.nn.functional.mish,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}

# Striped index masks of the optional half-connected layers
HALF_LAYER_INDICES: List[List[int]] = [
    [0, 1, 2, 3, 4, 5, 6, 7],
    [8, 9, 10, 11, 12, 13, 14, 15],
    [0, 1, 2, 3, 8, 9, 10, 11],
    [4, 5, 6, 7, 12, 13, 14, 15],
    [4, 5, 6, 7, 8, 9, 10, 11],
    [0, 1, 2, 3, 12, 13, 14, 15],
    [0, 1, 4, 5, 8, 9, 12, 13],
    [2, 3, 6, 7, 10, 11, 14, 15],
    [0, 1, 6, 7, 8, 9, 14, 15],
    [2, 3, 4, 5, 10, 11, 12, 13],
    [0, 2, 4, 6, 8, 10, 12, 14],
    [1, 3, 5, 7, 9, 11, 13, 15],
    [0, 3, 4, 7, 8, 11, 12, 15],
    [1, 2, 5, 6, 9, 10, 13, 14],
    [0, 5, 2, 7, 8, 13, 10, 15],
    [1, 4, 3, 6, 9, 12, 11, 14],
]


def find_nearest_multiple(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple``."""
    if n % multiple == 0:
        return n
    return n + multiple - (n % multiple)


def get_normalized_dim(dim: int, multiple_of: int = 8, down_ratio: float = 2 / 3) -> int:
    """Hidden width: ``dim * 2/3`` rounded up to a multiple of ``multiple_of``."""
    return find_nearest_multiple(int(dim * down_ratio), multiple_of)


class _Linear(nn.Module):
    """x @ w (+ b), w stored (in, out) as in the JAX tree; torch default init."""

    def __init__(self, fan_in: int, fan_out: int, generator: torch.Generator, bias: bool = True) -> None:
        super().__init__()
        bound = 1.0 / np.sqrt(fan_in)
        self.w = nn.Parameter(torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator))
        self.b = (
            nn.Parameter(torch.empty(fan_out).uniform_(-bound, bound, generator=generator)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.w)
        return out if self.b is None else out + self.b


class _LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _normalize(x, self.eps) * self.g + self.b


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over the last axis, in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return (xf - mean) * torch.rsqrt(var + eps)


class _GatedMLP(nn.Module):
    def __init__(
        self, input_dim: int, hidden_dim: int, output_dim: int, gated: bool,
        activation: str, generator: torch.Generator, multiple_of: int = 8,
    ) -> None:
        super().__init__()
        hidden_dim = get_normalized_dim(hidden_dim, multiple_of)
        self.hidden = _Linear(input_dim, hidden_dim, generator)
        self.output = _Linear(hidden_dim, output_dim, generator)
        self.gate = _Linear(input_dim, hidden_dim, generator) if gated else None
        self.act = ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.hidden(x))
        if self.gate is not None:
            h = h * self.gate(x)
        return self.output(h)


class _NormMLP(nn.Module):
    def __init__(self, norm: _LayerNorm, mlp: _GatedMLP) -> None:
        super().__init__()
        self.norm = norm
        self.mlp = mlp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.norm(x))


def _dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
    batch_rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Inverted dropout with draws from ``generator``; identity without one.
    ``batch_rows`` = (first, total) marks ``x`` as rows ``first..`` of a
    ``total``-row batch: the draws are the whole batch's, sliced, so ranks of
    a mesh drop what one device would drop on the whole batch."""
    if generator is None or rate <= 0.0:
        return x
    if batch_rows is None:
        draws = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        first, total = batch_rows
        draws = torch.rand((total,) + tuple(x.shape[1:]), generator=generator, device=x.device)
        draws = draws[first : first + x.shape[0]]
    keep = draws < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class WakeWordInferenceMixin:
    """Audio-level prediction on top of the shared featurizer of ``self.device``."""

    device: torch.device

    @torch.no_grad()
    def scores(self, features: np.ndarray) -> np.ndarray:
        """(n, 16, 96) features -> (n,) probabilities, as numpy."""
        with span("wakeword/head"):
            x = torch.from_numpy(np.ascontiguousarray(features, dtype=np.float32)).to(self.device)
            return self(x).reshape(-1).cpu().numpy()

    def _predict_scores(self, audio: Any, min_frames: int = CLIP_SAMPLES) -> np.ndarray:
        from heybuddy_tpu_torch.models.featurizer import get_speech_embeddings
        from heybuddy_tpu_torch.utils.audio_io import audio_to_bct_array

        with span("wakeword/prepare"):
            audio_arr, _ = audio_to_bct_array(audio, sample_rate=SAMPLE_RATE)
            n, _c, t = audio_arr.shape
            if t < min_frames:
                pad = min_frames - t
                left = pad // 2
                audio_arr = np.pad(audio_arr, ((0, 0), (0, 0), (left, pad - left)))
        embeddings = get_speech_embeddings(device=self.device)(audio_arr)  # (n, frames, 96)

        frames = embeddings.shape[1]
        if frames > FEATURE_FRAMES:
            # every 4 consecutive embeddings come from one audio window, so a
            # 16-embedding context slides in steps of 4; the max is the score
            step = 4
            k = (frames - FEATURE_FRAMES) // step + 1
            with span("wakeword/contexts"):
                windows = np.stack(
                    [embeddings[:, i * step : i * step + FEATURE_FRAMES] for i in range(k)], axis=1
                )  # (n, k, 16, 96)
                flat = windows.reshape(n * k, FEATURE_FRAMES, -1)
            return self.scores(flat).reshape(n, k).max(axis=1)
        return self.scores(embeddings)

    def predict(
        self,
        audio: Any,
        threshold: float = DEFAULT_ACTIVATION_THRESHOLD,
        return_scores: bool = False,
        min_frames: int = CLIP_SAMPLES,
        **_compat: Any,
    ) -> Tuple[Any, ...]:
        scores = self._predict_scores(audio, min_frames=min_frames)
        if return_scores:
            return tuple(float(s) for s in scores)
        return tuple(bool(s > threshold) for s in scores)

    @staticmethod
    def timecode_windows(audio: Any) -> np.ndarray:
        """The 2 s windows, 1 s apart, that ``predict_timecodes`` scores."""
        from heybuddy_tpu_torch.utils.audio_io import audio_to_bct_array

        audio_arr, _ = audio_to_bct_array(audio, sample_rate=SAMPLE_RATE)
        mono = audio_arr[0].mean(axis=0)
        remainder = mono.shape[0] % SAMPLE_RATE
        if remainder > 0:
            mono = np.concatenate([mono, np.zeros(SAMPLE_RATE - remainder, dtype=np.float32)])
        silence = np.zeros(SAMPLE_RATE, dtype=np.float32)
        mono = np.concatenate([silence, mono, silence])
        return np.stack(
            [mono[i : i + 2 * SAMPLE_RATE] for i in range(0, mono.shape[0] - SAMPLE_RATE, SAMPLE_RATE)]
        )

    def predict_timecodes(
        self, audio: Any, threshold: float = DEFAULT_ACTIVATION_THRESHOLD, **_compat: Any
    ) -> List[float]:
        """2 s windows, 1 s stride; adjacent hits are merged at the half second."""
        predictions = [bool(p) for p in self.predict(self.timecode_windows(audio), threshold=threshold)]
        times: List[float] = []
        for i, hit in enumerate(predictions):
            if not hit:
                continue
            if i < len(predictions) - 1 and predictions[i + 1]:
                times.append(i + 0.5)
            elif i == len(predictions) - 1 and i > 0 and predictions[i - 1]:
                continue
            else:
                times.append(float(i))
        return times


class _WakeWordHead(WakeWordInferenceMixin, nn.Module):
    """What both heads share beyond inference: ``save`` / ``from_file`` through
    one checkpoint npz (the JAX package's layout)."""

    def save(self, path: str) -> None:
        save_model(self, path)

    @classmethod
    def from_file(cls, path: str, device: DeviceLike = "cuda", **kwargs: Any) -> Any:
        """The head in the checkpoint at ``path``, on ``device``; raises
        ``TypeError`` when the file holds the other architecture."""
        model = load_model(path, device)
        if not isinstance(model, cls):
            raise TypeError(f"{path} holds a {type(model).__name__}, not a {cls.__name__}")
        return model


class WakeWordMLPModel(_WakeWordHead):
    """Gated-MLP wake-word classifier: (batch, 16, 96) -> (batch, 1) probability."""

    architecture = "perceptron"

    def __init__(
        self,
        input_shape: Tuple[int, int] = (FEATURE_FRAMES, EMBEDDING_DIM),
        layer_dim: int = DEFAULT_LAYER_DIM,
        num_layers: int = DEFAULT_LAYERS,
        use_gating: bool = DEFAULT_USE_GATING,
        use_half_layers: bool = DEFAULT_USE_HALF_LAYERS,
        dropout: float = 0.1,
        activation: str = "silu",
        params: Optional[Any] = None,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> None:
        nn.Module.__init__(self)
        self.input_shape = tuple(input_shape)
        features = input_shape[0] * input_shape[1]
        self.layer_dim = layer_dim
        self.num_layers = num_layers
        self.use_gating = use_gating
        self.use_half_layers = use_half_layers
        self.dropout = dropout
        self.activation = activation
        gen = torch.Generator().manual_seed(seed)

        def mlp(fan_in: int, fan_out: int) -> _GatedMLP:
            return _GatedMLP(fan_in, layer_dim, fan_out, use_gating, activation, gen)

        self.norm_in = _LayerNorm(features)
        self.mlp_in = mlp(features, layer_dim)
        self.half_layers = nn.ModuleList(
            _NormMLP(_LayerNorm(features // 2), mlp(features // 2, layer_dim)) for _ in self.half_indices
        )
        self.layers = nn.ModuleList(
            _NormMLP(_LayerNorm(layer_dim), mlp(layer_dim, layer_dim)) for _ in range(num_layers)
        )
        self.norm_out = _LayerNorm(layer_dim)
        self.mlp_out = mlp(layer_dim, 1)
        if params is not None:
            self.load_state_dict(wakeword_params_from_numpy(params), strict=True)
        self.device = resolve_device(device)
        self.to(self.device).eval()
        self._half_idx = [torch.tensor(i, device=self.device) for i in self.half_indices]

    @property
    def half_indices(self) -> List[List[int]]:
        return HALF_LAYER_INDICES if self.use_half_layers else []

    def config(self) -> Dict[str, Any]:
        return {
            "architecture": self.architecture,
            "input_shape": list(self.input_shape),
            "layer_dim": self.layer_dim,
            "num_layers": self.num_layers,
            "use_gating": self.use_gating,
            "use_half_layers": self.use_half_layers,
            "dropout": self.dropout,
            "activation": self.activation,
        }

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None,
        batch_rows: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        x = x.float()
        if train:
            x = _dropout(x, self.dropout, generator, batch_rows)
        b = x.shape[0]
        states = self.mlp_in(self.norm_in(x.reshape(b, -1)))
        for idx, half in zip(self._half_idx, self.half_layers):
            states = states + half(x[:, idx, :].reshape(b, -1))
        for layer in self.layers:
            states = layer(states)
        return torch.sigmoid(self.mlp_out(self.norm_out(states)))

    @classmethod
    def from_torch_file(cls, path: str, device: DeviceLike = "cuda") -> "WakeWordMLPModel":
        """
        Import a reference ``.pt`` state dict (``torch.load(weights_only=True)``):
        the layer width from ``norm_out``, the layer count, gating and half
        layers from the keys present, the weights (out, in) transposed into
        the JAX parameter tree, as the JAX package imports it.
        """
        state = torch.load(path, weights_only=True, map_location="cpu")
        layer_dim = state["norm_out.weight"].shape[0]
        num_layers = 0
        while f"layers.{num_layers}.0.weight" in state:
            num_layers += 1
        n_half = 0
        while f"half_layers.{n_half}.0.weight" in state:
            n_half += 1

        def t(name: str) -> np.ndarray:
            return state[name].float().numpy()

        def mlp(prefix: str) -> Dict[str, Any]:
            p = {
                "hidden": {"w": t(f"{prefix}.hidden.weight").T, "b": t(f"{prefix}.hidden.bias")},
                "output": {"w": t(f"{prefix}.output.weight").T, "b": t(f"{prefix}.output.bias")},
            }
            if f"{prefix}.gate.weight" in state:
                p["gate"] = {"w": t(f"{prefix}.gate.weight").T, "b": t(f"{prefix}.gate.bias")}
            return p

        def norm_mlp(prefix: str) -> Dict[str, Any]:
            return {"norm": {"g": t(f"{prefix}.0.weight"), "b": t(f"{prefix}.0.bias")}, "mlp": mlp(f"{prefix}.1")}

        params = {
            "norm_in": {"g": t("norm_in.weight"), "b": t("norm_in.bias")},
            "mlp_in": mlp("mlp_in"),
            "half_layers": [norm_mlp(f"half_layers.{i}") for i in range(n_half)],
            "layers": [norm_mlp(f"layers.{i}") for i in range(num_layers)],
            "norm_out": {"g": t("norm_out.weight"), "b": t("norm_out.bias")},
            "mlp_out": mlp("mlp_out"),
        }
        return cls(layer_dim=layer_dim, num_layers=num_layers, use_gating="mlp_in.gate.weight" in state,
                   use_half_layers=n_half > 0, params=params, device=device)

    def save_onnx(self, path: str, opset_version: int = 19) -> None:
        from heybuddy_tpu_torch.export.onnx_export import export_mlp_model

        export_mlp_model(wakeword_params_to_numpy(self), self.config(), path, opset_version)


class _Attention(nn.Module):
    """Bias-free q/k/v/output projections, LayerNorm on q and k, softmax scale 1.0."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator) -> None:
        super().__init__()
        inner = (dim // num_heads) * num_heads
        self.num_heads = num_heads
        self.queries = _Linear(dim, inner, generator, bias=False)
        self.keys = _Linear(dim, inner, generator, bias=False)
        self.values = _Linear(dim, inner, generator, bias=False)
        self.output = _Linear(inner, dim, generator, bias=False)
        self.query_norm = _LayerNorm(inner)
        self.key_norm = _LayerNorm(inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, s, self.num_heads, -1).transpose(1, 2)

        q = heads(self.query_norm(self.queries(x)))
        k = heads(self.key_norm(self.keys(x)))
        v = heads(self.values(x))
        # the reference's scale_by_num_heads=False: no 1/sqrt(d) on the logits
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, -1)
        return self.output(out)


class _TransformerBlock(nn.Module):
    def __init__(
        self, dim: int, num_heads: int, multiple_of: int, norm_epsilon: float,
        activation: str, generator: torch.Generator,
    ) -> None:
        super().__init__()
        self.attention_norm = _LayerNorm(dim, norm_epsilon)
        self.attention = _Attention(dim, num_heads, generator)
        self.feed_forward_norm = _LayerNorm(dim, norm_epsilon)
        self.feed_forward = _GatedMLP(dim, dim * 4, dim, True, activation, generator, multiple_of)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.attention_norm(x))
        return x + self.feed_forward(self.feed_forward_norm(x))


class _FinalLayer(nn.Module):
    """Affine-free norm over the frames, then one (frames -> 1) linear, zero-initialised."""

    def __init__(self, frames: int) -> None:
        super().__init__()
        self.fc = _Linear(frames, 1, torch.Generator())
        with torch.no_grad():
            self.fc.w.zero_()
            self.fc.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (b, frames, dim) -> (b, dim, frames): one logit per channel
        return self.fc(_normalize(x.transpose(1, 2), 1e-6))[:, :, 0]


class WakeWordTransformerModel(_WakeWordHead):
    """Transformer wake-word classifier: (batch, 16, 96) -> (batch, 1) probability."""

    architecture = "transformer"

    def __init__(
        self,
        input_shape: Tuple[int, int] = (FEATURE_FRAMES, EMBEDDING_DIM),
        dim: int = DEFAULT_LAYER_DIM,
        num_layers: int = DEFAULT_LAYERS,
        num_heads: int = DEFAULT_HEADS,
        multiple_of: int = 18,
        norm_epsilon: float = 1e-5,
        dropout: float = 0.1,
        activation: str = "silu",
        params: Optional[Any] = None,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> None:
        nn.Module.__init__(self)
        self.input_shape = tuple(input_shape)
        frames, input_dim = input_shape
        self.dim = dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.multiple_of = multiple_of
        self.norm_epsilon = norm_epsilon
        self.dropout = dropout
        self.activation = activation
        gen = torch.Generator().manual_seed(seed)
        self.linear_in = _Linear(input_dim, dim, gen)
        self.layernorm = _LayerNorm(dim)
        self.blocks = nn.ModuleList(
            _TransformerBlock(dim, num_heads, multiple_of, norm_epsilon, activation, gen)
            for _ in range(num_layers)
        )
        self.final = _FinalLayer(frames)
        self.act = ACTIVATIONS[activation]
        if params is not None:
            self.load_state_dict(wakeword_params_from_numpy(params), strict=True)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    def config(self) -> Dict[str, Any]:
        return {
            "architecture": self.architecture,
            "input_shape": list(self.input_shape),
            "layer_dim": self.dim,
            "num_layers": self.num_layers,
            "num_heads": self.num_heads,
            "multiple_of": self.multiple_of,
            "norm_epsilon": self.norm_epsilon,
            "dropout": self.dropout,
            "activation": self.activation,
        }

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None,
        batch_rows: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        x = x.float()
        if train:
            x = _dropout(x, self.dropout, generator, batch_rows)
        x = self.act(self.layernorm(self.linear_in(x)))
        for block in self.blocks:
            x = block(x)
        probs = torch.sigmoid(self.final(x))  # (b, dim)
        return probs.amax(dim=1, keepdim=True)

    def save_onnx(self, path: str, opset_version: int = 19) -> None:
        raise NotImplementedError(
            "ONNX export currently supports the perceptron architecture; "
            "use architecture='perceptron' for browser deployment."
        )


ModelType = Union[WakeWordMLPModel, WakeWordTransformerModel]


def save_model(model: ModelType, path: str) -> None:
    """Write the flat parameters and ``__config__`` to one npz (the JAX package's layout)."""
    flat = flatten_params(wakeword_params_to_numpy(model))
    flat["__config__"] = np.frombuffer(json.dumps(model.config()).encode("utf-8"), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A checkpoint npz as (config, numpy parameter tree); no torch tensors, no device."""
    with np.load(path) as loaded:
        config = json.loads(bytes(loaded["__config__"]).decode("utf-8"))
        flat = {k: np.asarray(loaded[k]) for k in loaded.files if k != "__config__"}
    return config, restore_empty_lists(unflatten_params(flat), config["architecture"])


def load_model(path: str, device: DeviceLike = "cuda") -> ModelType:
    """Load a checkpoint npz (either architecture) onto ``device``."""
    config, params = read_checkpoint(path)
    arch = config.pop("architecture")
    if arch == "perceptron":
        return WakeWordMLPModel(
            input_shape=tuple(config["input_shape"]),
            layer_dim=config["layer_dim"],
            num_layers=config["num_layers"],
            use_gating=config["use_gating"],
            use_half_layers=config["use_half_layers"],
            dropout=config.get("dropout", 0.1),
            activation=config.get("activation", "silu"),
            params=params,
            device=device,
        )
    if arch == "transformer":
        return WakeWordTransformerModel(
            input_shape=tuple(config["input_shape"]),
            dim=config["layer_dim"],
            num_layers=config["num_layers"],
            num_heads=config.get("num_heads", DEFAULT_HEADS),
            multiple_of=config.get("multiple_of", 18),
            norm_epsilon=config.get("norm_epsilon", 1e-5),
            dropout=config.get("dropout", 0.1),
            activation=config.get("activation", "silu"),
            params=params,
            device=device,
        )
    raise ValueError(f"Unknown architecture in checkpoint: {arch}")
