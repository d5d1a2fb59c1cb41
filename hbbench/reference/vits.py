"""VITS inference at Piper's medium voice, written out again in plain PyTorch
(float32, TF32 off) from a Piper-layout state dict.

The functions follow Piper's modules (``piper_train/vits``: ``models.py``
``SynthesizerTrn.infer``, ``TextEncoder``, ``StochasticDurationPredictor``,
``ResidualCouplingBlock``, ``Generator``; ``attentions.py``; ``modules.py``
``DDSConv``, ``WN``, ``ResBlock2``, ``ConvFlow``; ``transforms.py``'s
rational-quadratic spline with linear tails; ``commons.generate_path``), one
function a module, over a flat state dict whose weight-normed tensors
(``weight_g`` / ``weight_v``) ``fold`` folds as ``torch.nn.utils.weight_norm``
computes them. The voice's text comes in as ids made here
(``phoneme_ids``: the rule G2P of ``g2p.py``, ARPAbet -> IPA, Piper's ids
with the pad between symbols).

Departures from Piper, each where the program under test departs the same
way (its JAX original's choices):

* a static frame budget: the durations' total is clipped to ``max_frames``
  and every latent has ``max_frames`` frames, so the longest clips lose
  their tail (Piper's length is the durations' total);
* the prior's noise is drawn at (b, inter, max_frames) after the duration
  noise (b, 2, t_x), from one generator, instead of ``randn_like`` at the
  clip's own length;
* the speaker vector is given (two table rows slerped by ``speaker_vectors``)
  instead of one row of ``emb_g``;
* DDSConv's GELU is the tanh approximation (Piper: exact ``F.gelu``);
* the decoder's last leaky ReLU before ``conv_post`` has slope 0.1 (Piper:
  ``F.leaky_relu``'s default 0.01);
* dropout is absent (inference).

``infer(..., logw=...)`` takes log-durations as given, so that the audio can
be compared from the program's own integer durations.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hbbench.reference.g2p import word_phones

State = Dict[str, torch.Tensor]

# ARPAbet -> the IPA Piper's voices were trained on, and Piper's ids of those symbols
ARPA_TO_IPA: Dict[str, str] = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ", "EH": "ɛ", "ER": "ɚ", "EY": "eɪ",
    "IH": "ɪ", "IY": "i", "OW": "oʊ", "OY": "ɔɪ", "UH": "ʊ", "UW": "u", "B": "b", "CH": "tʃ", "D": "d",
    "DH": "ð", "F": "f", "G": "ɡ", "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t", "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z",
    "ZH": "ʒ",
}
IDS: Dict[str, int] = {
    " ": 3, "a": 14, "b": 15, "d": 17, "e": 18, "f": 19, "h": 20, "i": 21, "j": 22, "k": 23, "l": 24, "m": 25,
    "n": 26, "o": 27, "p": 28, "s": 31, "t": 32, "u": 33, "v": 34, "w": 35, "z": 38, "æ": 39, "ð": 41, "ŋ": 44,
    "ɑ": 51, "ɔ": 54, "ɚ": 60, "ɛ": 61, "ɡ": 66, "ɪ": 74, "ɹ": 88, "ʃ": 96, "ʊ": 100, "ʌ": 102, "ʒ": 108,
    "θ": 126,
}
PAD, BOS, EOS = 0, 1, 2
LRELU_SLOPE = 0.1
MIN_BIN, MIN_DERIVATIVE = 1e-3, 1e-3


@contextlib.contextmanager
def precision(tf32: bool = False) -> Iterator[None]:
    """float32 products with TF32 off (``tf32`` on: the control one precision down)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ inputs


def phoneme_ids(text: str) -> List[int]:
    """BOS, each IPA symbol followed by the pad, EOS."""
    words = ["".join(ARPA_TO_IPA.get(p, "") for p in word_phones(w)) for w in text.split()]
    ipa = " ".join(w for w in words if w)
    ids = [BOS]
    for char in ipa:
        if char in IDS:
            ids += [IDS[char], PAD]
    return ids + [EOS]


def batch_ids(texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, t_x) ids zero-padded to a multiple of 16 and (b,) lengths, int64 on the CPU."""
    lists = [phoneme_ids(t) for t in texts]
    t_x = 16 * math.ceil(max(len(x) for x in lists) / 16)
    ids = torch.zeros((len(lists), t_x), dtype=torch.int64)
    for i, x in enumerate(lists):
        ids[i, : len(x)] = torch.tensor(x)
    return ids, torch.tensor([len(x) for x in lists])


def frame_budget(t_x: int, length_scale: float) -> int:
    return 64 * math.ceil(2 * t_x * max(length_scale, 1.0) / 64)


def speaker_vectors(table: torch.Tensor, pairs: Sequence[Tuple[int, int]], weight: float) -> torch.Tensor:
    """Each pair's two rows of the speaker table slerped by ``weight`` (a linear
    blend where any pair is nearly parallel), float32."""
    a = table[[p[0] for p in pairs]].double()
    b = table[[p[1] for p in pairs]].double()
    cos = ((a / (a.norm(dim=-1, keepdim=True) + 1e-9)) * (b / (b.norm(dim=-1, keepdim=True) + 1e-9))).sum(-1)
    cos = cos.clamp(-1.0, 1.0)
    if bool((cos.abs() > 0.9995).any()):
        return ((1 - weight) * a + weight * b).float()
    theta = torch.arccos(cos)
    s1 = torch.sin(theta - theta * weight) / torch.sin(theta)
    s2 = torch.sin(theta * weight) / torch.sin(theta)
    return (s1[:, None] * a + s2[:, None] * b).float()


def fold(state: Dict[str, Any], device: torch.device) -> State:
    """float32 tensors on ``device``, each ``weight_g`` / ``weight_v`` pair
    folded into ``weight`` = v g / ||v|| (the norm over all but dim 0)."""
    out: State = {}
    for key, value in state.items():
        t = torch.as_tensor(value).to(device=device, dtype=torch.float32)
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            prefix = key[: -len(".weight_v")]
            g = torch.as_tensor(state[prefix + ".weight_g"]).to(device=device, dtype=torch.float32)
            norm = t.reshape(t.shape[0], -1).norm(dim=1).reshape((-1,) + (1,) * (t.dim() - 1))
            out[prefix + ".weight"] = t * (g / norm)
        else:
            out[key] = t
    return out


# ------------------------------------------------------------------ building blocks


def conv(p: State, name: str, x: torch.Tensor, padding: int = 0, dilation: int = 1,
         groups: int = 1) -> torch.Tensor:
    return F.conv1d(x, p[name + ".weight"], p.get(name + ".bias"), padding=padding, dilation=dilation,
                    groups=groups)


def layer_norm(p: State, name: str, x: torch.Tensor) -> torch.Tensor:
    """modules.LayerNorm: over the channels of (b, c, t)."""
    y = F.layer_norm(x.transpose(1, -1), (x.shape[1],), p[name + ".gamma"], p[name + ".beta"], 1e-5)
    return y.transpose(1, -1)


def sequence_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    return (torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]).float()


def _rel_embeddings(table: torch.Tensor, length: int, window: int) -> torch.Tensor:
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    padded = F.pad(table, [0, 0, pad, pad, 0, 0]) if pad > 0 else table
    return padded[:, start: start + 2 * length - 1]


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    b, h, n, _ = x.shape
    x = F.pad(x, [0, 1, 0, 0, 0, 0, 0, 0])
    flat = F.pad(x.reshape(b, h, n * 2 * n), [0, n - 1, 0, 0, 0, 0])
    return flat.reshape(b, h, n + 1, 2 * n - 1)[:, :, :n, n - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    b, h, n, _ = x.shape
    x = F.pad(x, [0, n - 1, 0, 0, 0, 0, 0, 0])
    flat = F.pad(x.reshape(b, h, n * n + n * (n - 1)), [n, 0, 0, 0, 0, 0])
    return flat.reshape(b, h, n, 2 * n)[:, :, :, 1:]


def attention(p: State, name: str, x: torch.Tensor, mask: torch.Tensor, heads: int, window: int) -> torch.Tensor:
    """attentions.MultiHeadAttention (self-attention, relative keys and values shared by the heads)."""
    b, c, n = x.shape
    d = c // heads
    q, k, v = (conv(p, f"{name}.conv_{w}", x).view(b, heads, d, n).transpose(2, 3) for w in "qkv")
    q = q / math.sqrt(d)
    scores = torch.matmul(q, k.transpose(-2, -1))
    rel_k = _rel_embeddings(p[name + ".emb_rel_k"], n, window)
    scores = scores + _rel_to_abs(torch.matmul(q, rel_k.unsqueeze(0).transpose(-2, -1)))
    scores = scores.masked_fill(mask == 0, -1e4)
    weights = F.softmax(scores, dim=-1)
    out = torch.matmul(weights, v)
    rel_v = _rel_embeddings(p[name + ".emb_rel_v"], n, window)
    out = out + torch.matmul(_abs_to_rel(weights), rel_v.unsqueeze(0))
    return conv(p, name + ".conv_o", out.transpose(2, 3).contiguous().view(b, c, n))


def text_encoder(p: State, cfg: Dict[str, Any], ids: torch.Tensor, x_mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TextEncoder -> (hidden, prior mean, prior log-std)."""
    h = F.embedding(ids, p["enc_p.emb.weight"]) * math.sqrt(cfg["hidden_channels"])
    x = h.transpose(1, -1)
    attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    x = x * x_mask
    pad = cfg["kernel_size"] // 2
    for i in range(cfg["n_layers"]):
        e = f"enc_p.encoder.{{}}.{i}"
        y = attention(p, e.format("attn_layers"), x, attn_mask, cfg["n_heads"], cfg["window_size"])
        x = layer_norm(p, e.format("norm_layers_1"), x + y)
        y = torch.relu(conv(p, e.format("ffn_layers") + ".conv_1", x * x_mask, padding=pad))
        y = conv(p, e.format("ffn_layers") + ".conv_2", y * x_mask, padding=pad) * x_mask
        x = layer_norm(p, e.format("norm_layers_2"), x + y)
    x = x * x_mask
    stats = conv(p, "enc_p.proj", x) * x_mask
    m, logs = torch.split(stats, cfg["inter_channels"], dim=1)
    return x, m, logs


def dds_conv(p: State, name: str, x: torch.Tensor, x_mask: torch.Tensor, kernel: int, layers: int,
             g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """modules.DDSConv (tanh GELU: see the module's docstring)."""
    if g is not None:
        x = x + g
    for i in range(layers):
        dilation = kernel ** i
        y = conv(p, f"{name}.convs_sep.{i}", x * x_mask, padding=(kernel * dilation - dilation) // 2,
                 dilation=dilation, groups=x.shape[1])
        y = F.gelu(layer_norm(p, f"{name}.norms_1.{i}", y), approximate="tanh")
        y = F.gelu(layer_norm(p, f"{name}.norms_2.{i}", conv(p, f"{name}.convs_1x1.{i}", y)), approximate="tanh")
        x = x + y
    return x * x_mask


def spline_inverse(x: torch.Tensor, widths: torch.Tensor, heights: torch.Tensor, derivatives: torch.Tensor,
                   tail_bound: float) -> torch.Tensor:
    """transforms.unconstrained_rational_quadratic_spline, inverse, linear tails."""
    inside = (x >= -tail_bound) & (x <= tail_bound)
    out = x.clone()
    xi, w, h, d = x[inside], widths[inside], heights[inside], derivatives[inside]
    constant = np.log(np.exp(1 - MIN_DERIVATIVE) - 1)
    d = F.pad(d, (1, 1))
    d[..., 0] = constant
    d[..., -1] = constant
    bins = w.shape[-1]

    def knots(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        size = MIN_BIN + (1 - MIN_BIN * bins) * F.softmax(u, dim=-1)
        cum = F.pad(torch.cumsum(size, dim=-1), (1, 0), mode="constant", value=0.0)
        cum = 2 * tail_bound * cum - tail_bound
        cum[..., 0] = -tail_bound
        cum[..., -1] = tail_bound
        return cum, cum[..., 1:] - cum[..., :-1]

    cumwidths, w = knots(w)
    derivs = MIN_DERIVATIVE + F.softplus(d)
    cumheights, h = knots(h)
    locations = cumheights.clone()
    locations[..., -1] += 1e-6
    idx = (torch.sum(xi[..., None] >= locations, dim=-1) - 1)[..., None]

    def at(t: torch.Tensor) -> torch.Tensor:
        return t.gather(-1, idx)[..., 0]

    in_cw, in_w, in_ch, in_h = at(cumwidths), at(w), at(cumheights), at(h)
    delta = at(h / w)
    d0, d1 = at(derivs), at(derivs[..., 1:])
    y = xi - in_ch
    slope = d0 + d1 - 2 * delta
    a = y * slope + in_h * (delta - d0)
    b = in_h * d0 - y * slope
    c = -delta * y
    root = (2 * c) / (-b - torch.sqrt(b.pow(2) - 4 * a * c))
    out[inside] = root * in_w + in_cw
    return out


def conv_flow_reverse(p: State, name: str, cfg: Dict[str, Any], x: torch.Tensor, x_mask: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """modules.ConvFlow, reverse."""
    fc, bins = cfg["hidden_channels"], cfg["sdp_bins"]
    x0, x1 = torch.split(x, [1, 1], dim=1)
    h = conv(p, name + ".pre", x0)
    h = dds_conv(p, name + ".convs", h, x_mask, cfg["kernel_size"], cfg["sdp_layers"], g=g)
    h = conv(p, name + ".proj", h) * x_mask
    b, c, t = x0.shape
    h = h.reshape(b, c, -1, t).permute(0, 1, 3, 2)
    x1 = spline_inverse(x1, h[..., :bins] / math.sqrt(fc), h[..., bins: 2 * bins] / math.sqrt(fc),
                        h[..., 2 * bins:], cfg["sdp_tail_bound"])
    return torch.cat([x0, x1], dim=1) * x_mask


def duration_reverse(p: State, cfg: Dict[str, Any], x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                     noise: torch.Tensor, noise_scale: float) -> torch.Tensor:
    """StochasticDurationPredictor, reverse -> log durations (b, 1, t_x)."""
    x = conv(p, "dp.pre", x) + conv(p, "dp.cond", g)
    x = dds_conv(p, "dp.convs", x, x_mask, cfg["kernel_size"], cfg["sdp_layers"])
    x = conv(p, "dp.proj", x) * x_mask
    # reversed(flows) without the first ConvFlow ("a useless vflow"): flip,
    # ConvFlow 4, flip, ConvFlow 3, flip, ConvFlow 2, flip, the affine
    z = noise * noise_scale
    for k in range(cfg["sdp_flows"], 1, -1):
        z = conv_flow_reverse(p, f"dp.flows.{2 * k - 1}", cfg, torch.flip(z, [1]), x_mask, x)
    z = torch.flip(z, [1])
    z = (z - p["dp.flows.0.m"]) * torch.exp(-p["dp.flows.0.logs"]) * x_mask
    return z[:, :1]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """commons.generate_path: duration (b, 1, t_x), mask (b, 1, t_y, t_x)."""
    b, _, t_y, t_x = mask.shape
    cum = torch.cumsum(duration, -1).view(b * t_x)
    path = sequence_mask(cum, t_y).view(b, t_x, t_y)
    path = path - F.pad(path, [0, 0, 1, 0, 0, 0])[:, :-1]
    return path.unsqueeze(1).transpose(2, 3) * mask


def wavenet(p: State, name: str, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor, kernel: int,
            layers: int) -> torch.Tensor:
    """modules.WN (dilation rate 1)."""
    hidden = x.shape[1]
    output = torch.zeros_like(x)
    g = conv(p, name + ".cond_layer", g)
    for i in range(layers):
        x_in = conv(p, f"{name}.in_layers.{i}", x, padding=(kernel - 1) // 2)
        total = x_in + g[:, i * 2 * hidden: (i + 1) * 2 * hidden]
        acts = torch.tanh(total[:, :hidden]) * torch.sigmoid(total[:, hidden:])
        res_skip = conv(p, f"{name}.res_skip_layers.{i}", acts)
        if i < layers - 1:
            x = (x + res_skip[:, :hidden]) * x_mask
            output = output + res_skip[:, hidden:]
        else:
            output = output + res_skip
    return output * x_mask


def flow_reverse(p: State, cfg: Dict[str, Any], z: torch.Tensor, y_mask: torch.Tensor, g: torch.Tensor
                 ) -> torch.Tensor:
    """ResidualCouplingBlock, reverse: flip then each mean-only coupling, last first."""
    half = cfg["inter_channels"] // 2
    for k in range(cfg["flow_couplings"] - 1, -1, -1):
        name = f"flow.flows.{2 * k}"
        z = torch.flip(z, [1])
        x0, x1 = torch.split(z, [half, half], dim=1)
        h = conv(p, name + ".pre", x0) * y_mask
        h = wavenet(p, name + ".enc", h, y_mask, g, cfg["flow_kernel"], cfg["flow_layers"])
        m = conv(p, name + ".post", h) * y_mask
        z = torch.cat([x0, (x1 - m) * y_mask], dim=1)
    return z


def decoder(p: State, cfg: Dict[str, Any], z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Generator (ResBlock2) -> (b, frames x hop) audio."""
    x = conv(p, "dec.conv_pre", z, padding=3) + conv(p, "dec.cond", g)
    kernels = cfg["resblock_kernel_sizes"]
    for i, (rate, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = F.conv_transpose1d(x, p[f"dec.ups.{i}.weight"], p[f"dec.ups.{i}.bias"], stride=rate,
                               padding=(k - rate) // 2)
        xs = None
        for j, (size, dilations) in enumerate(zip(kernels, cfg["resblock_dilation_sizes"])):
            y = x
            for c, dilation in enumerate(dilations):
                r = conv(p, f"dec.resblocks.{i * len(kernels) + j}.convs.{c}", F.leaky_relu(y, LRELU_SLOPE),
                         padding=(size * dilation - dilation) // 2, dilation=dilation)
                y = r + y
            xs = y if xs is None else xs + y
        x = xs / len(kernels)
    x = F.leaky_relu(x, LRELU_SLOPE)
    return torch.tanh(conv(p, "dec.conv_post", x, padding=3))[:, 0]


# ------------------------------------------------------------------ inference


@torch.no_grad()
def infer(p: State, cfg: Dict[str, Any], ids: torch.Tensor, lengths: torch.Tensor, speaker: torch.Tensor,
          noise_scale: float, length_scale: float, noise_scale_w: float, max_frames: int,
          generator: Optional[torch.Generator] = None, logw: Optional[torch.Tensor] = None,
          tf32: bool = False) -> Dict[str, torch.Tensor]:
    """SynthesizerTrn.infer on (b, t_x) ids and (b, gin) speaker vectors ->
    ``logw`` (b, 1, t_x) log durations, ``frames`` (b,) the clipped frame
    counts, ``audio`` (b, max_frames x hop). The noise comes from
    ``generator``: the duration flow's (b, 2, t_x), then the prior's (b,
    inter, max_frames). A given ``logw`` replaces the predicted one (its
    noise is drawn all the same)."""
    with precision(tf32):
        dev = ids.device
        b, t_x = ids.shape
        x_mask = sequence_mask(lengths, t_x).unsqueeze(1)
        x, m_p, logs_p = text_encoder(p, cfg, ids, x_mask)
        g = speaker.unsqueeze(-1)
        noise = torch.randn((b, 2, t_x), generator=generator, device=dev)
        predicted = duration_reverse(p, cfg, x, x_mask, g, noise, noise_scale_w)
        logw = predicted if logw is None else logw
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
        frames = torch.clamp(torch.sum(w_ceil, [1, 2]), 1, max_frames).long()
        y_mask = sequence_mask(frames, max_frames).unsqueeze(1)
        attn = generate_path(w_ceil, x_mask.unsqueeze(2) * y_mask.unsqueeze(-1))
        m_p = torch.matmul(attn.squeeze(1), m_p.transpose(1, 2)).transpose(1, 2)
        logs_p = torch.matmul(attn.squeeze(1), logs_p.transpose(1, 2)).transpose(1, 2)
        prior = torch.randn((b, cfg["inter_channels"], max_frames), generator=generator, device=dev)
        z_p = m_p + prior * torch.exp(logs_p) * noise_scale
        z = flow_reverse(p, cfg, z_p, y_mask, g)
        audio = decoder(p, cfg, z * y_mask, g)
    return {"logw": predicted, "frames": frames, "audio": audio}


def clip_pcm(audio: np.ndarray, sample_rate: int, target_rate: int, target_samples: int) -> np.ndarray:
    """One clip as the training features see it: polyphase resampling to
    ``target_rate``, peak-normalised int16 (the peak at least 0.01), zeros
    trimmed at both ends, back to float32 in [-1, 1), cut to ``target_samples``."""
    from scipy.signal import resample_poly

    g = math.gcd(sample_rate, target_rate)
    x = resample_poly(np.asarray(audio, np.float32), target_rate // g, sample_rate // g).astype(np.float32)
    peak = max(0.01, float(np.abs(x).max()))
    pcm = np.trim_zeros(np.clip(x * (32767.0 / peak), -32768, 32767).astype(np.int16))
    return (pcm.astype(np.float32) / 32768.0)[:target_samples]
