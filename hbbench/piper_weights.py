"""A Piper VITS voice's inference weights made from the seed, in Piper's
state-dict layout (``piper_train/vits``: ``enc_p``, ``dp``, ``flow``,
``dec``, ``emb_g``; the layers Piper wraps in weight norm as ``weight_g`` /
``weight_v``, ``dec.conv_post`` without a bias).

Every leaf is random, the layers Piper zero-initialises too (each
coupling's ``post``, each spline flow's ``proj``, the affine flow), so that
no flow is the identity. Convolutions and their biases are uniform in
+-1/sqrt(fan_in) (a transposed conv's fan is out x kernel), a weight norm's
``weight_g`` is the norm of its ``weight_v`` row times 1 + 0.1 u, the text
embedding N(0, 1/hidden), the relative-position tables N(0, 1/head_dim),
LayerNorm gains 1 + 0.1 N(0, 1) and shifts 0.1 N(0, 1), the speaker table
0.1 N(0, 1), the zero-initialised layers 0.1 N(0, 1) (their biases 0.1
N(0, 1) / sqrt(fan_in)).

Random weights speak at a rate that moves with the seed (1.2-4.7 frames an
id), and the host's share of the work (resampling, augmentation) moves with
the clips' lengths. So the duration predictor's last layer, the affine flow
(``dp.flows.0``: log-durations = (z - m) exp(-logs)), is then set so that
the log-durations of a fixed batch (``CALIBRATION``) have mean
``LOGW_MEAN`` and standard deviation ``LOGW_STD``: about 2.9 frames an id
at length scale 1, or "hey buddy" in 0.6 s, as read aloud. A seed still
changes every weight and every draw.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from hbbench.reference import vits as rv

# log-durations (frames an id, natural log) and the fixed batch they are set on
LOGW_MEAN, LOGW_STD = 0.75, 0.5
CALIBRATION = ("hey buddy", "hey buddy.", "hay bunny", "hey body", "a buddy", "what time is it", "hello there",
               "hey you")

Shapes = List[Tuple[str, Tuple[int, ...]]]


def _conv(name: str, out_ch: int, in_ch: int, kernel: int, bias: bool = True) -> Shapes:
    return [(name + ".weight", (out_ch, in_ch, kernel))] + ([(name + ".bias", (out_ch,))] if bias else [])


def _normed(name: str, out_ch: int, in_ch: int, kernel: int, transposed: bool = False) -> Shapes:
    shape = (in_ch, out_ch, kernel) if transposed else (out_ch, in_ch, kernel)
    return [(name + ".weight_g", (shape[0], 1, 1)), (name + ".weight_v", shape), (name + ".bias", (out_ch,))]


def _norm(name: str, ch: int) -> Shapes:
    return [(name + ".gamma", (ch,)), (name + ".beta", (ch,))]


def _dds(name: str, ch: int, kernel: int, layers: int) -> Shapes:
    shapes: Shapes = []
    for i in range(layers):
        shapes += _conv(f"{name}.convs_sep.{i}", ch, 1, kernel) + _conv(f"{name}.convs_1x1.{i}", ch, ch, 1)
        shapes += _norm(f"{name}.norms_1.{i}", ch) + _norm(f"{name}.norms_2.{i}", ch)
    return shapes


def shapes(cfg: Dict[str, Any]) -> Shapes:
    """Every inference leaf of the voice at the configuration's widths, in Piper's order."""
    h, f, k, inter, gin = (cfg[key] for key in ("hidden_channels", "filter_channels", "kernel_size",
                                                  "inter_channels", "gin_channels"))
    head_dim, window = h // cfg["n_heads"], cfg["window_size"]
    out: Shapes = [("enc_p.emb.weight", (cfg["n_vocab"], h))]
    for i in range(cfg["n_layers"]):
        e = "enc_p.encoder"
        for w in "qkvo":
            out += _conv(f"{e}.attn_layers.{i}.conv_{w}", h, h, 1)
        out += [(f"{e}.attn_layers.{i}.emb_rel_k", (1, 2 * window + 1, head_dim)),
                (f"{e}.attn_layers.{i}.emb_rel_v", (1, 2 * window + 1, head_dim))]
        out += _norm(f"{e}.norm_layers_1.{i}", h)
        out += _conv(f"{e}.ffn_layers.{i}.conv_1", f, h, k) + _conv(f"{e}.ffn_layers.{i}.conv_2", h, f, k)
        out += _norm(f"{e}.norm_layers_2.{i}", h)
    out += _conv("enc_p.proj", 2 * inter, h, 1)
    out += _conv("dp.pre", h, h, 1) + _conv("dp.proj", h, h, 1) + _dds("dp.convs", h, k, cfg["sdp_layers"])
    out += _conv("dp.cond", h, gin, 1) + [("dp.flows.0.m", (2, 1)), ("dp.flows.0.logs", (2, 1))]
    for j in range(cfg["sdp_flows"]):
        name = f"dp.flows.{2 * j + 1}"
        out += _conv(name + ".pre", h, 1, 1) + _dds(name + ".convs", h, k, cfg["sdp_layers"])
        out += _conv(name + ".proj", 3 * cfg["sdp_bins"] - 1, h, 1)
    layers = cfg["flow_layers"]
    for j in range(cfg["flow_couplings"]):
        name = f"flow.flows.{2 * j}"
        out += _conv(name + ".pre", h, inter // 2, 1)
        for i in range(layers):
            out += _normed(f"{name}.enc.in_layers.{i}", 2 * h, h, cfg["flow_kernel"])
        for i in range(layers):
            out += _normed(f"{name}.enc.res_skip_layers.{i}", 2 * h if i < layers - 1 else h, h, 1)
        out += _normed(name + ".enc.cond_layer", 2 * h * layers, gin, 1)
        out += _conv(name + ".post", inter // 2, h, 1)
    ch = cfg["upsample_initial_channel"]
    out += _conv("dec.conv_pre", ch, inter, 7)
    blocks: Shapes = []
    for i, kernel in enumerate(cfg["upsample_kernel_sizes"]):
        out += _normed(f"dec.ups.{i}", ch // 2, ch, kernel, transposed=True)
        ch //= 2
        for j, (size, dilations) in enumerate(zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"])):
            for c in range(len(dilations)):
                blocks += _normed(f"dec.resblocks.{i * len(cfg['resblock_kernel_sizes']) + j}.convs.{c}", ch, ch,
                                  size)
    out += blocks + _conv("dec.conv_post", 1, ch, 7, bias=False) + _conv("dec.cond", cfg["upsample_initial_channel"],
                                                                         gin, 1)
    return out + [("emb_g.weight", (cfg["n_speakers"], gin))]


def _zero_initialised(name: str) -> bool:
    """Piper's zero-initialised layers: coupling posts, spline projections, the affine flow."""
    return name.startswith("dp.flows.0.") or (name.startswith("flow.") and ".post." in name) or \
        (name.startswith("dp.flows.") and ".proj." in name)


def make(cfg: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 leaves on ``device`` from one uniform and one normal draw."""
    leaves = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(torch.Size(s).numel()) for _, s in leaves]
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    kernels = {name.rsplit(".", 1)[0]: shape for name, shape in leaves
               if len(shape) == 3 and name.endswith((".weight", ".weight_v"))}
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (name, shape), size in zip(leaves, sizes):
        u = uniform[offset: offset + size].reshape(shape)
        n = normal[offset: offset + size].reshape(shape)
        offset += size
        prefix, leaf = name.rsplit(".", 1)
        # (out, in, k) convs and (in, out, k) transposed ones both take fan = shape[1] x k
        fan = kernels[prefix][1] * kernels[prefix][2] if prefix in kernels else 1
        if name == "enc_p.emb.weight":
            value = n / shape[1] ** 0.5
        elif name == "emb_g.weight":
            value = 0.1 * n
        elif leaf in ("weight", "weight_v"):
            value = 0.1 * n if _zero_initialised(name) else u / fan ** 0.5
        elif leaf == "bias":
            value = (0.1 * n if _zero_initialised(name) else u) / fan ** 0.5
        elif leaf == "weight_g":
            value = u  # replaced by the row norms of weight_v below
        elif leaf in ("emb_rel_k", "emb_rel_v"):
            value = n / shape[2] ** 0.5
        elif leaf == "gamma":
            value = 1.0 + 0.1 * n
        else:  # LayerNorm shifts, the affine flow's m and logs
            value = 0.1 * n
        out[name] = value
    for name in [k for k in out if k.endswith(".weight_g")]:
        v = out[name[: -len("_g")] + "_v"]
        out[name] = v.reshape(v.shape[0], -1).norm(dim=1).reshape(-1, 1, 1) * (1.0 + 0.1 * out[name].reshape(-1, 1, 1))
    out = {k: v.contiguous() for k, v in out.items()}
    _set_durations(out, cfg, device)
    return out


@torch.no_grad()
def _set_durations(state: Dict[str, torch.Tensor], cfg: Dict[str, Any], device: torch.device) -> None:
    """The affine flow's m[0] and logs[0] such that the log-durations of
    ``CALIBRATION`` (speakers 2i and 2i + 1 slerped halfway, duration noise
    0.8 from a fixed generator) have mean ``LOGW_MEAN`` and deviation ``LOGW_STD``."""
    p = rv.fold(state, device)
    ids, lengths = rv.batch_ids(CALIBRATION)
    ids, lengths = ids.to(device), lengths.to(device)
    n = cfg["n_speakers"]
    speaker = rv.speaker_vectors(p["emb_g.weight"], [(2 * i % n, (2 * i + 1) % n) for i in range(len(ids))], 0.5)
    noise = torch.randn((ids.shape[0], 2, ids.shape[1]), generator=torch.Generator(device=device).manual_seed(0),
                        device=device)
    with rv.precision():
        x_mask = rv.sequence_mask(lengths, ids.shape[1]).unsqueeze(1)
        x, _, _ = rv.text_encoder(p, cfg, ids, x_mask)
        logw = rv.duration_reverse(p, cfg, x, x_mask, speaker.unsqueeze(-1), noise, 0.8)
    values = logw[x_mask.bool()].double()
    mu, sigma = float(values.mean()), float(values.std())
    m, logs = state["dp.flows.0.m"], state["dp.flows.0.logs"]
    m0, logs0 = float(m[0, 0]), float(logs[0, 0])
    # (z - m) exp(-logs): a new logs scales the deviation, a new m moves the mean
    m[0, 0] = m0 + (mu - LOGW_MEAN * sigma / LOGW_STD) * math.exp(logs0)
    logs[0, 0] = logs0 + math.log(sigma / LOGW_STD)
