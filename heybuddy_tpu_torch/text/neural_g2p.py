"""
Neural grapheme-to-phoneme model, the ``HEYBUDDY_PHONEMIZER=neural`` option.

Counterpart of the JAX package's ``text/neural_g2p.py``: a character
encoder (char + position embeddings, ``layers`` pre-LN self-attention
blocks over the masked characters) and a non-autoregressive phone decoder
(``max_phones`` learned queries cross-attend to the encoded characters once
and emit per-position phone logits, PAD past the end). Checkpoints are the
JAX package's npz (``__config__`` JSON bytes + flat ``blocks/0/q/w`` keys),
read and written by both packages; the bundled
``heybuddy_tpu/assets/g2p-neural.npz`` is read by path.

``NeuralG2P`` is an ``nn.Module`` whose parameters train on a device
(``train_neural_g2p``: full-batch Adam under the cosine decay of optax's
``cosine_decay_schedule``). Inference (``NeuralPhonemizer``) runs the numpy
forward ``apply_np`` on numpy weights, because phonemization happens inside
TTS producer threads, which must not touch the card. The seeded
initialisation draws from a ``torch.Generator``, so its values differ from
the JAX function's ``jax.random`` ones.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from heybuddy_tpu_torch.device import DeviceLike, resolve_device

__all__ = [
    "ARPABET",
    "NeuralG2P",
    "NeuralPhonemizer",
    "encode_word",
    "encode_phones",
    "train_neural_g2p",
]

# stress-free ARPAbet; id 0 is PAD ("no phone at this position")
ARPABET: List[str] = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]
_PHONE_TO_ID = {p: i + 1 for i, p in enumerate(ARPABET)}
_CHARS = "abcdefghijklmnopqrstuvwxyz'"
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(_CHARS)}
_DECODER_LINEARS = ("xq", "xk", "xv", "xo", "out")

Params = Dict[str, Any]


def encode_word(word: str, max_word: int) -> np.ndarray:
    """Word -> padded int32 char ids (unknown characters drop out)."""
    ids = [_CHAR_TO_ID[c] for c in word.lower() if c in _CHAR_TO_ID][:max_word]
    return np.array(ids + [0] * (max_word - len(ids)), dtype=np.int32)


def encode_phones(phones: Sequence[str], max_phones: int) -> np.ndarray:
    """Phone list -> padded int32 phone ids (PAD=0 beyond the sequence)."""
    ids = [_PHONE_TO_ID[p] for p in phones if p in _PHONE_TO_ID][:max_phones]
    return np.array(ids + [0] * (max_phones - len(ids)), dtype=np.int32)


# ----------------------------------------------------------------- torch


class _Linear(nn.Module):
    """x @ w + b with w stored (in, out), as in the checkpoint."""

    def __init__(self, fan_in: int, fan_out: int) -> None:
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class _Block(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        for name in ("q", "k", "v", "o"):
            setattr(self, name, _Linear(dim, dim))
        self.up = _Linear(dim, 4 * dim)
        self.down = _Linear(4 * dim, dim)


def _layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head attention; ``mask`` is [batch, kv_len] validity."""
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // heads
    qh = q.reshape(b, lq, heads, dh).transpose(1, 2)
    kh = k.reshape(b, lk, heads, dh).transpose(1, 2)
    vh = v.reshape(b, lk, heads, dh).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, -1e9))
    out = torch.softmax(logits, dim=-1) @ vh
    return out.transpose(1, 2).reshape(b, lq, d)


# ----------------------------------------------------------------- numpy


def _np_linear(p: Params, x: np.ndarray) -> np.ndarray:
    return x @ np.asarray(p["w"]) + np.asarray(p["b"])


def _np_layernorm(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps)


def _np_attention(q: np.ndarray, k: np.ndarray, v: np.ndarray, mask: np.ndarray, heads: int) -> np.ndarray:
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // heads
    qh = q.reshape(b, lq, heads, dh).transpose(0, 2, 1, 3)
    kh = k.reshape(b, lk, heads, dh).transpose(0, 2, 1, 3)
    vh = v.reshape(b, lk, heads, dh).transpose(0, 2, 1, 3)
    logits = (qh @ kh.transpose(0, 1, 3, 2)) / np.sqrt(dh)
    logits = np.where(mask[:, None, None, :], logits, -1e9)
    logits = logits - logits.max(axis=-1, keepdims=True)
    weights = np.exp(logits)
    weights = weights / weights.sum(axis=-1, keepdims=True)
    out = weights @ vh
    return out.transpose(0, 2, 1, 3).reshape(b, lq, d)


class NeuralG2P(nn.Module):
    """Character encoder + learned-query phone decoder (module docstring).

    The module's parameters (names as the checkpoint's flat keys, ``/`` for
    ``.``) are what ``forward`` and training use; the JAX package's
    functional calls take a parameter tree instead: ``apply_torch(params,
    chars)`` (torch, on the module's device; JAX's ``apply``), ``apply_np(params, chars)`` (numpy),
    ``decode(params, words, numpy=...)``, ``save(params, path)``.
    """

    def __init__(self, dim: int = 128, heads: int = 4, layers: int = 2,
                 max_word: int = 16, max_phones: int = 16) -> None:
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.layers = layers
        self.max_word = max_word
        self.max_phones = max_phones
        self.n_phones = len(ARPABET) + 1
        self.n_chars = len(_CHARS) + 1
        self.char_emb = nn.Parameter(torch.zeros(self.n_chars, dim))
        self.pos_emb = nn.Parameter(torch.zeros(max_word, dim))
        self.queries = nn.Parameter(torch.zeros(max_phones, dim))
        self.blocks = nn.ModuleList(_Block(dim) for _ in range(layers))
        for name in _DECODER_LINEARS:
            setattr(self, name, _Linear(dim, self.n_phones if name == "out" else dim))

    @property
    def config(self) -> Dict[str, Any]:
        return {
            "dim": self.dim, "heads": self.heads, "layers": self.layers,
            "max_word": self.max_word, "max_phones": self.max_phones,
        }

    def init_params(self, generator: torch.Generator) -> Params:
        """A fresh parameter tree (float32 numpy) in the JAX function's
        distributions and order of draws: embeddings and queries 0.02 N(0, 1),
        linear weights uniform in +-1/sqrt(fan_in), biases zero."""
        d, dev = self.dim, generator.device

        def normal(*shape: int) -> np.ndarray:
            return (torch.randn(shape, generator=generator, device=dev) * 0.02).cpu().numpy()

        def linear(fan_in: int, fan_out: int) -> Params:
            scale = math.sqrt(1.0 / fan_in)
            w = torch.rand((fan_in, fan_out), generator=generator, device=dev) * (2.0 * scale) - scale
            return {"w": w.cpu().numpy(), "b": np.zeros((fan_out,), np.float32)}

        params: Params = {
            "char_emb": normal(self.n_chars, d),
            "pos_emb": normal(self.max_word, d),
            "queries": normal(self.max_phones, d),
            "blocks": [],
        }
        for name in _DECODER_LINEARS:
            params[name] = linear(d, self.n_phones if name == "out" else d)
        for _ in range(self.layers):
            params["blocks"].append({
                "q": linear(d, d), "k": linear(d, d), "v": linear(d, d), "o": linear(d, d),
                "up": linear(d, 4 * d), "down": linear(4 * d, d),
            })
        return params

    # --- parameters as a tree ---------------------------------------------------

    def load_params(self, params: Params) -> "NeuralG2P":
        """Copy a parameter tree (numpy or tensors) into the module's parameters."""
        state = {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in _flatten(params).items()}
        self.load_state_dict({k.replace("/", "."): v for k, v in state.items()}, strict=True)
        return self

    def params_numpy(self) -> Params:
        """The module's parameters as a float32 numpy tree."""
        flat = {k.replace(".", "/"): v.detach().cpu().numpy() for k, v in self.state_dict().items()}
        return _unflatten(flat, self.layers)

    # --- forward ---------------------------------------------------------------

    def forward(self, chars: torch.Tensor) -> torch.Tensor:
        """[batch, max_word] int char ids -> [batch, max_phones, n_phones] logits."""
        mask = chars > 0
        x = self.char_emb[chars] + self.pos_emb[None]
        x = torch.where(mask[..., None], x, torch.zeros_like(x))
        for blk in self.blocks:
            h = _layernorm(x)
            x = x + blk.o(_attention(blk.q(h), blk.k(h), blk.v(h), mask, self.heads))
            h = _layernorm(x)
            x = x + blk.down(torch.nn.functional.gelu(blk.up(h), approximate="tanh"))
        q = self.queries[None].expand(chars.shape[0], -1, -1)
        enc = _layernorm(x)
        dec = q + self.xo(_attention(self.xq(q), self.xk(enc), self.xv(enc), mask, self.heads))
        return self.out(_layernorm(dec))

    def loss(self, chars: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over all positions, PAD targets included (the
        model learns the sequence length; ``decode`` strips PAD)."""
        logits = self(chars)
        return torch.nn.functional.cross_entropy(logits.reshape(-1, self.n_phones), targets.reshape(-1).long())

    def apply_torch(self, params: Params, chars: Any) -> torch.Tensor:
        """``forward`` with the parameter tree ``params`` in place of the module's own."""
        dev = self.char_emb.device
        state = {k.replace("/", "."): torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
                 for k, v in _flatten(params).items()}
        return torch.func.functional_call(self, state, (torch.as_tensor(np.asarray(chars), device=dev).long(),))

    def apply_np(self, params: Params, chars: np.ndarray) -> np.ndarray:
        """Numpy copy of ``forward`` (the JAX package's, held equal to it)."""
        mask = chars > 0
        x = np.asarray(params["char_emb"])[chars] + np.asarray(params["pos_emb"])[None]
        x = np.where(mask[..., None], x, 0.0)
        for blk in params["blocks"]:
            h = _np_layernorm(x)
            x = x + _np_linear(blk["o"], _np_attention(
                _np_linear(blk["q"], h), _np_linear(blk["k"], h), _np_linear(blk["v"], h), mask, self.heads,
            ))
            h = _np_layernorm(x)
            up = _np_linear(blk["up"], h)
            gelu = 0.5 * up * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (up + 0.044715 * up ** 3)))
            x = x + _np_linear(blk["down"], gelu)
        q = np.broadcast_to(
            np.asarray(params["queries"])[None], (chars.shape[0],) + np.asarray(params["queries"]).shape,
        )
        dec = q + _np_linear(params["xo"], _np_attention(
            _np_linear(params["xq"], q), _np_linear(params["xk"], _np_layernorm(x)),
            _np_linear(params["xv"], _np_layernorm(x)), mask, self.heads,
        ))
        return _np_linear(params["out"], _np_layernorm(dec))

    def decode(self, params: Params, words: Sequence[str], numpy: bool = False) -> List[List[str]]:
        """Words -> phone lists (argmax per position, PAD stripped). ``numpy=True``
        runs ``apply_np`` on the host (thread-safe, no device); otherwise
        ``apply_torch`` on the module's device."""
        if not words:
            return []
        chars = np.stack([encode_word(w, self.max_word) for w in words])
        if numpy:
            ids = np.argmax(self.apply_np(params, chars), -1)
        else:
            with torch.no_grad():
                ids = torch.argmax(self.apply_torch(params, chars), -1).cpu().numpy()
        return [[ARPABET[i - 1] for i in row if i > 0] for row in ids]

    def save(self, params: Params, path: str) -> None:
        """Write ``params`` as the JAX package's checkpoint npz."""
        flat = {"__config__": np.frombuffer(json.dumps(self.config).encode(), dtype=np.uint8)}
        flat.update({k: np.asarray(v) for k, v in _flatten(params).items()})
        np.savez(path, **flat)

    @classmethod
    def load(cls, path: str) -> Tuple["NeuralG2P", Params]:
        """Read a checkpoint npz (either package's) -> (model on the CPU, numpy parameter tree)."""
        with np.load(path) as data:
            cfg = json.loads(bytes(data["__config__"]).decode())
            flat = {k: np.asarray(data[k]) for k in data.files if k != "__config__"}
        return cls(**cfg), _unflatten(flat, cfg["layers"])


def _flatten(params: Params) -> Dict[str, Any]:
    """Parameter tree -> flat ``blocks/0/q/w`` keys, in the JAX package's save order."""
    flat: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "blocks":
            for i, blk in enumerate(v):
                for n, lin in blk.items():
                    for wn, arr in lin.items():
                        flat[f"blocks/{i}/{n}/{wn}"] = arr
        elif isinstance(v, dict):
            for wn, arr in v.items():
                flat[f"{k}/{wn}"] = arr
        else:
            flat[k] = v
    return flat


def _unflatten(flat: Dict[str, np.ndarray], layers: int) -> Params:
    """Flat checkpoint keys -> parameter tree (the JAX package's ``load`` layout)."""
    params: Params = {"blocks": [dict() for _ in range(layers)]}
    for k, v in flat.items():
        parts = k.split("/")
        if parts[0] == "blocks":
            params["blocks"][int(parts[1])].setdefault(parts[2], {})[parts[3]] = v
        elif len(parts) == 2:
            params.setdefault(parts[0], {})[parts[1]] = v
        else:
            params[k] = v
    return params


def cosine_decay(steps: int) -> Callable[[int], float]:
    """The factor of optax's ``cosine_decay_schedule(lr, steps)`` at a step: 0.5 (1 + cos(pi min(step, steps) / steps))."""
    steps = max(steps, 1)
    return lambda step: 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps))


def optimizer(model: NeuralG2P, lr: float, steps: int) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam at ``lr`` under the per-step cosine decay: step ``i``'s update uses ``lr * cosine_decay(steps)(i)``."""
    adam = torch.optim.Adam(model.parameters(), lr=lr)
    return adam, torch.optim.lr_scheduler.LambdaLR(adam, cosine_decay(steps))


def train_neural_g2p(
    table: Dict[str, List[str]],
    steps: int = 4000,
    lr: float = 3e-4,
    seed: int = 0,
    model: Optional[NeuralG2P] = None,
    log_every: int = 0,
    device: DeviceLike = "cuda",
    params: Optional[Params] = None,
) -> Tuple[NeuralG2P, Params]:
    """
    Fit a :class:`NeuralG2P` to ``word -> phone list`` pairs on ``device``:
    full-batch Adam (the tables hold ~1.5k words) with cosine decay. It starts
    from ``params`` when given, else from ``init_params`` seeded with ``seed``.
    Returns the model (on ``device``) and its trained numpy parameter tree.
    """
    dev = resolve_device(device)
    model = model or NeuralG2P()
    words = sorted(w for w in table if w)
    chars = torch.from_numpy(np.stack([encode_word(w, model.max_word) for w in words])).long().to(dev)
    targets = torch.from_numpy(np.stack([encode_phones(table[w], model.max_phones) for w in words])).long().to(dev)
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(seed))
    model.load_params(params).to(dev)
    adam, schedule = optimizer(model, lr, steps)
    for i in range(steps):
        adam.zero_grad(set_to_none=True)
        loss = model.loss(chars, targets)
        loss.backward()
        adam.step()
        schedule.step()
        if log_every and (i % log_every == 0 or i == steps - 1):
            from heybuddy_tpu_torch.utils.log import logger

            logger.info(f"neural-g2p step {i}/{steps}: loss={loss.item():.4f}")
    return model, model.params_numpy()


class NeuralPhonemizer:
    """
    Phonemizer backed by a :class:`NeuralG2P` checkpoint: ``weights``, else
    ``HEYBUDDY_G2P_WEIGHTS``, else the bundled ``g2p-neural.npz`` of the JAX
    package. ``SimplePhonemizer``'s contract (``word_phones("hello") ->
    ["HH", "AH", "L", "OW"]``, ``__call__`` brackets per word); inference is
    the numpy forward on numpy weights, memoised per word.
    """

    name = "neural"

    def __init__(self, weights: Optional[str] = None) -> None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        bundled = os.path.join(root, "heybuddy_tpu", "assets", "g2p-neural.npz")
        path = weights or os.environ.get("HEYBUDDY_G2P_WEIGHTS", "") or (bundled if os.path.exists(bundled) else "")
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "NeuralPhonemizer needs a checkpoint: set HEYBUDDY_G2P_WEIGHTS "
                "or train one with train_neural_g2p"
            )
        self.model, self.params = NeuralG2P.load(path)
        self._cache: Dict[str, List[str]] = {}

    def word_phones(self, word: str) -> List[str]:
        word = word.lower().strip()
        if word not in self._cache:
            self._cache[word] = self.model.decode(self.params, [word], numpy=True)[0]
        return self._cache[word]

    def __call__(self, text: str) -> str:
        words = re.findall(r"[a-z']+", text.lower())
        missing = sorted({w for w in words if w not in self._cache})
        if missing:
            for w, phones in zip(missing, self.model.decode(self.params, missing, numpy=True)):
                self._cache[w] = phones
        return " ".join("".join(f"[{p}]" for p in self._cache[w]) for w in words if self._cache[w])
