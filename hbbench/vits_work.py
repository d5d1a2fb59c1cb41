"""The work of one VITS ``infer`` call, counted clip by clip from each clip's
ids and latent frames and the configuration's ``vits`` widths. Given the
call's padded shapes (``t_x`` ids, the frame budget) it is what the call
computes; given each clip's own ids and the frames it uses it is the least
work, which leaves out the padding of the ids and of the static budget.

Operations are the multiply-adds (2 FLOP each) of every convolution and
product of the inference graph: the text encoder (its 1x1 projections, the
attention's scores and sums with the relative keys and values over 2 t_x - 1
positions, the FFN's two convolutions, the prior's projection), the
duration predictor (its conditioning, the DDSConv stack and the spline
flows that the reverse pass runs: all but the first), the monotonic path's
two products (mean and log-std), the flow's couplings (pre, the WaveNet's
dilated convolutions, its res / skip 1x1s, post), and the decoder
(``conv_pre``, each transposed convolution, every ResBlock2 convolution at
its stage's length, ``conv_post``). The speaker conditions (one frame a
clip) count once a clip. Element-wise work (norms, activations, the spline's
arithmetic) is left out: under 2% of the products at these widths. Bytes
are the weights read once in float32, the ids, the two noise draws, the
speaker vectors and the audio written.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple


def param_count(cfg: Dict[str, Any]) -> int:
    """Parameters of the inference graph (folded weights, ``conv_post`` without a bias)."""
    h, f, k, inter, gin = (cfg[key] for key in ("hidden_channels", "filter_channels", "kernel_size",
                                                  "inter_channels", "gin_channels"))
    head_dim, window, sdp_layers = h // cfg["n_heads"], cfg["window_size"], cfg["sdp_layers"]
    conv = lambda out_ch, in_ch, kernel: out_ch * in_ch * kernel + out_ch  # noqa: E731
    dds = sdp_layers * (conv(h, 1, k) + conv(h, h, 1) + 4 * h)
    enc = cfg["n_vocab"] * h + cfg["n_layers"] * (4 * conv(h, h, 1) + 2 * (2 * window + 1) * head_dim
                                                    + conv(f, h, k) + conv(h, f, k) + 4 * h) + conv(2 * inter, h, 1)
    dp = 2 * conv(h, h, 1) + dds + conv(h, gin, 1) + 4 + cfg["sdp_flows"] * (
        conv(h, 1, 1) + dds + conv(3 * cfg["sdp_bins"] - 1, h, 1))
    n = cfg["flow_layers"]
    wn = n * conv(2 * h, h, cfg["flow_kernel"]) + (n - 1) * conv(2 * h, h, 1) + conv(h, h, 1) + conv(2 * h * n, gin, 1)
    flow = cfg["flow_couplings"] * (conv(h, inter // 2, 1) + wn + conv(inter // 2, h, 1))
    ch = cfg["upsample_initial_channel"]
    dec = conv(ch, inter, 7) + conv(ch, gin, 1)
    for kernel in cfg["upsample_kernel_sizes"]:
        dec += conv(ch // 2, ch, kernel)
        ch //= 2
        dec += sum(len(d) * conv(ch, ch, size)
                   for size, d in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
    dec += ch * 7
    return enc + dp + flow + dec + cfg["n_speakers"] * gin


def clip_macs(t_x: int, frames: int, cfg: Dict[str, Any]) -> int:
    """Multiply-adds of one clip of ``t_x`` ids and ``frames`` latent frames."""
    h, f, k, inter, gin = (cfg[key] for key in ("hidden_channels", "filter_channels", "kernel_size",
                                                  "inter_channels", "gin_channels"))
    rel = 2 * t_x - 1
    macs = cfg["n_layers"] * (4 * h * h * t_x + 2 * h * t_x * t_x + 2 * h * t_x * rel + 2 * f * h * k * t_x)
    macs += 2 * inter * h * t_x
    dds = cfg["sdp_layers"] * (h * k + h * h) * t_x
    macs += 2 * h * h * t_x + gin * h + dds
    macs += (cfg["sdp_flows"] - 1) * (h * t_x + dds + (3 * cfg["sdp_bins"] - 1) * h * t_x)
    macs += 2 * inter * frames * t_x
    n = cfg["flow_layers"]
    wn = n * 2 * h * h * cfg["flow_kernel"] * frames + (n - 1) * 2 * h * h * frames + h * h * frames \
        + 2 * h * n * gin
    macs += cfg["flow_couplings"] * (2 * (inter // 2) * h * frames + wn)
    ch, length = cfg["upsample_initial_channel"], frames
    macs += inter * ch * 7 * frames + gin * ch
    for rate, kernel in zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]):
        macs += ch * (ch // 2) * kernel * length
        ch, length = ch // 2, length * rate
        macs += sum(len(d) * ch * ch * size * length
                    for size, d in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
    return macs + ch * 7 * length


def infer_work(ids: Sequence[int], frames: Sequence[int], cfg: Dict[str, Any]) -> Tuple[float, float]:
    """(operations, bytes) of one ``infer`` call whose clip i has ``ids[i]``
    ids and ``frames[i]`` latent frames: the weights are read once a call."""
    hop = math.prod(cfg["upsample_rates"])
    per_clip = sum(t * 2 + 2 * t + cfg["inter_channels"] * n + cfg["gin_channels"] + n * hop
                   for t, n in zip(ids, frames))
    return float(2 * sum(clip_macs(t, n, cfg) for t, n in zip(ids, frames))), float(4 * (param_count(cfg) + per_clip))
