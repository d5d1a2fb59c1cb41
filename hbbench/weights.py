"""Weights made from the seed on the device, a few large draws each, under
the flat names the program's checkpoints use (``patch_proj/w``; dense
weights (in, out)).

Dense weights are uniform in +-1/sqrt(fan_in); biases and the embedding's
positional code 0.02 N(0, 1); LayerNorm gains 1 + 0.1 N(0, 1) and shifts
0.1 N(0, 1). Every leaf is random, the heads' last layer too, so that every
leaf has a gradient from the first step on.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]


def embedding_shapes(e: Dict) -> Shapes:
    d, h, heads = e["hidden_dim"], e["trunk_hidden_dim"], e["pool_heads"]
    patch = e["patch_frames"] * e["mel_bins"]
    shapes: Shapes = [("patch_proj/w", (patch, d)), ("patch_proj/b", (d,))]
    for i in range(e["trunk_blocks"]):
        shapes += [(f"trunk/{i}/up/w", (d, h)), (f"trunk/{i}/up/b", (h,)),
                   (f"trunk/{i}/down/w", (h, d)), (f"trunk/{i}/down/b", (d,))]
    return shapes + [("pos", (e["window_size"] // e["patch_frames"], d)), ("pool_query", (d, heads)),
                     ("head/w", (d * heads, e["embedding_dim"])), ("head/b", (e["embedding_dim"],))]


def _mlp(name: str, fan_in: int, hidden: int, fan_out: int, gated: bool) -> Shapes:
    shapes = [(f"{name}/hidden/w", (fan_in, hidden)), (f"{name}/hidden/b", (hidden,)),
              (f"{name}/output/w", (hidden, fan_out)), (f"{name}/output/b", (fan_out,))]
    if gated:
        shapes += [(f"{name}/gate/w", (fan_in, hidden)), (f"{name}/gate/b", (hidden,))]
    return shapes


def _norm(name: str, dim: int) -> Shapes:
    return [(f"{name}/g", (dim,)), (f"{name}/b", (dim,))]


def head_shapes(head: Dict, frames: int = 16, features: int = 96) -> Shapes:
    d, layers = head["layer_dim"], head["num_layers"]
    if head["architecture"] == "perceptron":
        hid, gated = head["hidden_dim"], head["use_gating"]
        shapes = _norm("norm_in", frames * features) + _mlp("mlp_in", frames * features, hid, d, gated)
        for i in range(layers):
            shapes += _norm(f"layers/{i}/norm", d) + _mlp(f"layers/{i}/mlp", d, hid, d, gated)
        return shapes + _norm("norm_out", d) + _mlp("mlp_out", d, hid, 1, gated)
    inner = (d // head["num_heads"]) * head["num_heads"]
    shapes = [("linear_in/w", (features, d)), ("linear_in/b", (d,))] + _norm("layernorm", d)
    for i in range(layers):
        p = f"blocks/{i}/"
        shapes += _norm(p + "attention_norm", d)
        shapes += [(p + f"attention/{k}/w", (d, inner) if k != "output" else (inner, d))
                   for k in ("queries", "keys", "values", "output")]
        shapes += _norm(p + "attention/query_norm", inner) + _norm(p + "attention/key_norm", inner)
        shapes += _norm(p + "feed_forward_norm", d) + _mlp(p + "feed_forward", d, head["ffn_dim"], d, True)
    return shapes + [("final/fc/w", (frames, 1)), ("final/fc/b", (1,))]


def make(shapes: Shapes, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 leaves on ``device`` from one uniform and one normal draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    total = sum(sizes)
    uniform = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(total, generator=gen, device=device)
    norms = {name[: -len("/g")] for name, _ in shapes if name.endswith("/g")}
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (name, shape), size in zip(shapes, sizes):
        u = uniform[offset : offset + size].reshape(shape)
        n = normal[offset : offset + size].reshape(shape)
        offset += size
        leaf = name.rsplit("/", 1)[-1]
        if len(shape) == 2 and leaf != "pos":
            out[name] = u / float(shape[0]) ** 0.5
        elif leaf == "g":
            out[name] = 1.0 + 0.1 * n
        elif leaf == "b" and name[: -len("/b")] in norms:
            out[name] = 0.1 * n
        else:
            out[name] = 0.02 * n
    return {k: v.contiguous() for k, v in out.items()}


def to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
