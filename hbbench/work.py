"""The yardstick's peaks and the least work of each measured kernel and step,
computed from shapes.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): HBM
3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores.

K1 (``mel_patches``) computes the log-mel of whole 4-frame patches. A frame's
least work is the window on its 400 taps, a real 512-point FFT as a
256-point complex split-radix FFT (4 N log2 N - 6 N + 8), for each bin a
filter reads the post-twiddle (12) and the power (3), the filterbank's
non-zero products and the log and scale of each band; its bytes are the
audio read once, the (b, p_pad, 128) patches written once and its
constants. K2 (``embedding_pool``) is counted as the dense network it
computes: the trunk over every patch, the pooling scores and sums of every
window and head, and the head product; its bytes are the patches read, the
features written and the bf16 weights.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12

N_FFT = 512
HOP = 160
TAPS = 400
N_FREQ_PAD = 128
MEL_BINS = 32
PATCH_FRAMES = 4


def patch_geometry(t: int) -> Tuple[int, int, int]:
    """(frames in whole patches, patches, patches padded to 8) of a ``t``-sample clip."""
    frames = (t - N_FFT) // HOP + 1
    patches = frames // PATCH_FRAMES
    return patches * PATCH_FRAMES, patches, -(-patches // 8) * 8


def mel_frame_ops() -> int:
    from hbbench.reference.mel import _filterbank

    fb = _filterbank()
    half = N_FFT // 2
    return int(TAPS + 4 * half * np.log2(half) - 6 * half + 8
               + (12 + 3) * int((fb != 0).any(axis=1).sum()) + 2 * int(np.count_nonzero(fb)) + 3 * fb.shape[1])


def k1_work(b: int, t: int) -> Tuple[float, float]:
    """(operations, bytes) of K1 on a (b, t) batch."""
    usable, _, p_pad = patch_geometry(t)
    consts = (TAPS * 256 + N_FREQ_PAD * MEL_BINS) * 4
    return float(b * usable * mel_frame_ops()), float(b * t * 4 + b * p_pad * PATCH_FRAMES * MEL_BINS * 4 + consts)


def embedding_param_count(e: Dict[str, Any]) -> int:
    d, h, blocks = e["hidden_dim"], e["trunk_hidden_dim"], e["trunk_blocks"]
    patch = e["patch_frames"] * e["mel_bins"]
    heads, out, wp = e["pool_heads"], e["embedding_dim"], e["window_size"] // e["patch_frames"]
    return (patch * d + d + blocks * (d * h + h + h * d + d) + wp * d + d * heads
            + d * heads * out + out)


def k2_work(b: int, t: int, e: Dict[str, Any]) -> Tuple[float, float]:
    """(operations, bytes) of K2 on the patches of a (b, t) batch; ``e`` is the
    configuration's ``embedding`` group."""
    from hbbench.reference.embedding import window_starts

    _, n, _ = patch_geometry(t)
    windows = len(window_starts(t))
    d, h, blocks, heads = e["hidden_dim"], e["trunk_hidden_dim"], e["trunk_blocks"], e["pool_heads"]
    patch = e["patch_frames"] * e["mel_bins"]
    wp = e["window_size"] // e["patch_frames"]
    ops = b * (n * (patch * d + blocks * 2 * d * h + d * heads) * 2
               + windows * heads * wp * d * 2 * 2
               + windows * heads * d * e["embedding_dim"] * 2)
    nbytes = b * n * patch * 4 + b * windows * e["embedding_dim"] * 4 + embedding_param_count(e) * 2
    return float(ops), float(nbytes)


def least_seconds(ops: float, nbytes: float, peak: float) -> float:
    """The roofline's least time: the larger of operations at ``peak`` and bytes at HBM's rate."""
    return max(ops / peak, nbytes / PEAK_BYTES)


def transformer_row_flops(head: Dict[str, Any], frames: int = 16, features: int = 96) -> float:
    """Forward multiply-add FLOPs of one (16, 96) row through the transformer head."""
    d, layers, ffn = head["layer_dim"], head["num_layers"], head["ffn_dim"]
    per_block = 4 * frames * d * d * 2 + 2 * frames * frames * d * 2 + 3 * frames * d * ffn * 2
    return float(frames * features * d * 2 + layers * per_block + d * frames * 2)


def perceptron_row_flops(head: Dict[str, Any], frames: int = 16, features: int = 96) -> float:
    """Forward multiply-add FLOPs of one (16, 96) row through the gated-MLP head."""
    d, hid, layers = head["layer_dim"], head["hidden_dim"], head["num_layers"]
    gated = 3 if head["use_gating"] else 2

    def mlp(fan_in: int, fan_out: int) -> int:
        return ((gated - 1) * fan_in * hid + hid * fan_out) * 2

    return float(mlp(frames * features, d) + layers * mlp(d, d) + mlp(d, 1))
