"""The two wake-word heads on (batch, 16, 96) features, float32.

``perceptron``: flatten -> LayerNorm -> gated MLP -> N x [LayerNorm, gated
MLP] -> LayerNorm -> gated MLP to 1 -> sigmoid. A gated MLP is
``output(silu(hidden(x)) * gate(x))``.

``transformer``: linear -> LayerNorm -> silu -> N pre-norm blocks (one
attention with LayerNorm on queries and keys and no 1/sqrt(d) on the
logits, then a gated MLP, each added back) -> an affine-free norm of each
channel over the 16 frames (eps 1e-6) -> one (16 -> 1) linear shared by the
channels -> sigmoid -> the largest channel.

Parameters are float32 tensors under the flat names the checkpoints use
(``mlp_in/hidden/w``; dense weights (in, out)). LayerNorms take eps 1e-5.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def _norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _ln(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _norm(x, eps) * p[name + "/g"] + p[name + "/b"]


def _lin(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    out = x @ p[name + "/w"]
    return out + p[name + "/b"] if name + "/b" in p else out


def _gated(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(_lin(p, name + "/hidden", x))
    if name + "/gate/w" in p:
        h = h * _lin(p, name + "/gate", x)
    return _lin(p, name + "/output", h)


def _count(p: Params, prefix: str) -> int:
    return len({k.split("/")[1] for k in p if k.startswith(prefix + "/")})


def perceptron(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(b, 16, 96) -> (b,) probabilities."""
    s = _gated(p, "mlp_in", _ln(p, "norm_in", x.reshape(x.shape[0], -1)))
    for i in range(_count(p, "layers")):
        s = _gated(p, f"layers/{i}/mlp", _ln(p, f"layers/{i}/norm", s))
    return torch.sigmoid(_gated(p, "mlp_out", _ln(p, "norm_out", s)))[:, 0]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose keep mask is ``rand(x.shape) < 1 - rate`` from ``generator``."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def transformer(p: Params, x: torch.Tensor, heads: int = 1) -> torch.Tensor:
    """(b, 16, 96) -> (b,) probabilities."""
    h = torch.nn.functional.silu(_ln(p, "layernorm", _lin(p, "linear_in", x)))
    b, s, _ = h.shape
    for i in range(_count(p, "blocks")):
        pre = f"blocks/{i}/"
        a = _ln(p, pre + "attention_norm", h)
        q = _ln(p, pre + "attention/query_norm", _lin(p, pre + "attention/queries", a))
        k = _ln(p, pre + "attention/key_norm", _lin(p, pre + "attention/keys", a))
        v = _lin(p, pre + "attention/values", a)

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, s, heads, -1).transpose(1, 2)

        w = torch.softmax(split(q) @ split(k).transpose(-1, -2), dim=-1)
        att = (w @ split(v)).transpose(1, 2).reshape(b, s, -1)
        h = h + _lin(p, pre + "attention/output", att)
        h = h + _gated(p, pre + "feed_forward", _ln(p, pre + "feed_forward_norm", h))
    logits = _lin(p, "final/fc", _norm(h.transpose(1, 2), 1e-6))[:, :, 0]  # (b, channels)
    return torch.sigmoid(logits).amax(dim=1)


def for_config(head: Dict[str, Any]) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """The head that a configuration's ``head`` group names, as (params, x) -> probabilities."""
    if head["architecture"] == "transformer":
        return lambda p, x: transformer(p, x, heads=head["num_heads"])
    if head["architecture"] == "perceptron":
        return perceptron
    raise ValueError(f"no reference head for {head['architecture']!r}")
