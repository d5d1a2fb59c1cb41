"""
Fixtures shared by the port's tests and ``chip_smoke.py`` (not part of the
package). Small ONNX graphs written with the port's protobuf writer, for
checking the importer where no third-party file is at hand: ``node`` /
``write_graph`` build a graph from numpy initializers, and
``silero_v4_graph`` writes a graph in the Silero VAD v4 layout (inputs
``input, sr, h, c``; outputs ``output, hn, cn``; a sample-rate ``If``; a
strided conv front end; two stacked ``LSTM`` nodes; a sigmoid head) with
seeded ``torch.nn`` weights, run through ``SileroOnnxVAD``. And
``perturbed_vits``, a VITS parameter tree with every flow non-trivial.

For the tests that hold the port to the JAX package: ``jax_draws``, the
augmentation draws JAX makes from a key, and ``assert_features_close``, the
rule for features against JAX's float32 features of the same audio. They
import JAX inside, so that ``chip_smoke.py`` imports this module without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.export.onnx_proto import (
    ATTR_FLOAT,
    ATTR_GRAPH,
    ATTR_INT,
    ATTR_INTS,
    ATTR_STRING,
    ATTR_TENSOR,
    OnnxAttribute,
    OnnxGraph,
    OnnxModel,
    OnnxNode,
    OnnxTensor,
    OnnxValueInfo,
    serialize_model,
)

__all__ = ["node", "write_graph", "lstm_to_onnx_weights", "silero_v4_graph", "perturbed_vits", "jax_draws",
           "FEATURE_ATOL", "FEATURE_MEAN", "FEATURE_MARGIN", "assert_features_close"]


def _attr(name: str, value: Any) -> OnnxAttribute:
    if isinstance(value, bool):
        return OnnxAttribute(name, int(value), ATTR_INT)
    if isinstance(value, int):
        return OnnxAttribute(name, value, ATTR_INT)
    if isinstance(value, float):
        return OnnxAttribute(name, value, ATTR_FLOAT)
    if isinstance(value, str):
        return OnnxAttribute(name, value, ATTR_STRING)
    if isinstance(value, (list, tuple)):
        return OnnxAttribute(name, [int(v) for v in value], ATTR_INTS)
    if isinstance(value, OnnxTensor):
        return OnnxAttribute(name, value, ATTR_TENSOR)
    if isinstance(value, OnnxGraph):
        return OnnxAttribute(name, value, ATTR_GRAPH)
    raise TypeError(type(value))


def node(op: str, inputs: Sequence[str], outputs: Sequence[str], **attrs: Any) -> OnnxNode:
    """One node; attributes typed from their Python values."""
    return OnnxNode(op, list(inputs), list(outputs), attributes=[_attr(k, v) for k, v in attrs.items()])


def write_graph(
    path: str,
    nodes: List[OnnxNode],
    initializers: Dict[str, np.ndarray],
    inputs: Sequence[Tuple[str, tuple]],
    outputs: Sequence[Tuple[str, tuple]],
) -> str:
    """Serialize a graph to ``path``; returns the path."""
    graph = OnnxGraph(
        "graph", nodes, [OnnxTensor(k, np.asarray(v)) for k, v in initializers.items()],
        [OnnxValueInfo(n, s) for n, s in inputs], [OnnxValueInfo(n, s) for n, s in outputs],
    )
    serialize_model(OnnxModel(graph), path)
    return path


def lstm_to_onnx_weights(lstm: torch.nn.LSTM, layer: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One layer of a ``torch.nn.LSTM`` as ONNX's W, R, B: gate blocks from torch's (i, f, g, o) to (i, o, f, c)."""
    hidden = lstm.hidden_size

    def reorder(mat: np.ndarray) -> np.ndarray:
        i, f, g, o = np.split(mat, 4, axis=0)
        return np.concatenate([i, o, f, g], axis=0)

    def weight(name: str) -> np.ndarray:
        return getattr(lstm, f"{name}_l{layer}").detach().numpy()

    b_ih = reorder(weight("bias_ih").reshape(4 * hidden, 1)).reshape(-1)
    b_hh = reorder(weight("bias_hh").reshape(4 * hidden, 1)).reshape(-1)
    return reorder(weight("weight_ih"))[None], reorder(weight("weight_hh"))[None], np.concatenate([b_ih, b_hh])[None]


def silero_v4_graph(path: str, seed: int = 8) -> Tuple[str, Tuple[torch.nn.Module, ...]]:
    """
    The Silero-v4-layout graph at ``path`` (hidden size 64) with weights of
    seeded torch layers; returns the path and the layers (conv, LSTM, head).
    """
    hidden = 64
    with torch.random.fork_rng(devices=[]):  # torch.nn draws from the global generator
        torch.manual_seed(seed)
        conv = torch.nn.Conv1d(1, hidden, 16, stride=8, padding=4)
        lstm = torch.nn.LSTM(hidden, hidden, num_layers=2)
        head = torch.nn.Linear(hidden, 1)
    w0, r0, b0 = lstm_to_onnx_weights(lstm, 0)
    w1, r1, b1 = lstm_to_onnx_weights(lstm, 1)
    then_g = OnnxGraph("then", [node("Identity", ["feat0"], ["tb_out"])], [], [], [OnnxValueInfo("tb_out", ())])
    else_g = OnnxGraph("else", [node("Mul", ["feat0", "half"], ["eb_out"])],
                       [OnnxTensor("half", np.float32(0.5).reshape(()))], [], [OnnxValueInfo("eb_out", ())])

    def ints(*values: int) -> np.ndarray:
        return np.array(values, np.int64)

    write_graph(
        path,
        [
            node("Unsqueeze", ["input", "ax1"], ["x3"]),
            node("Conv", ["x3", "cw", "cb"], ["c1"], strides=[8], pads=[4, 4], kernel_shape=[16]),
            node("Relu", ["c1"], ["cr"]),
            node("ReduceMean", ["cr"], ["feat0"], axes=[2], keepdims=0),
            node("Equal", ["sr", "sr16k"], ["is16k"]),
            node("If", ["is16k"], ["feat"], then_branch=then_g, else_branch=else_g),
            node("Unsqueeze", ["feat", "ax0"], ["seq"]),
            node("Slice", ["h", "i0", "i1", "iax0"], ["h0a"]),
            node("Slice", ["h", "i1", "i2", "iax0"], ["h0b"]),
            node("Slice", ["c", "i0", "i1", "iax0"], ["c0a"]),
            node("Slice", ["c", "i1", "i2", "iax0"], ["c0b"]),
            node("LSTM", ["seq", "w0", "r0", "b0", "", "h0a", "c0a"], ["ya", "ha", "ca"], hidden_size=hidden),
            node("Squeeze", ["ya", "ax1"], ["ya2"]),
            node("LSTM", ["ya2", "w1", "r1", "b1", "", "h0b", "c0b"], ["yb", "hb", "cb"], hidden_size=hidden),
            node("Squeeze", ["yb", "iax0"], ["yb2"]),
            node("Gemm", ["yb2", "hw", "hb2"], ["logit"], transB=1),
            node("Sigmoid", ["logit"], ["output"]),
            node("Concat", ["ha", "hb"], ["hn"], axis=0),
            node("Concat", ["ca", "cb"], ["cn"], axis=0),
        ],
        {"cw": conv.weight.detach().numpy(), "cb": conv.bias.detach().numpy(), "w0": w0, "r0": r0, "b0": b0,
         "w1": w1, "r1": r1, "b1": b1, "hw": head.weight.detach().numpy(), "hb2": head.bias.detach().numpy(),
         "sr16k": np.array(16000, np.int64), "ax0": ints(0), "ax1": ints(1), "i0": ints(0), "i1": ints(1),
         "i2": ints(2), "iax0": ints(0)},
        [("input", (1, "t")), ("sr", ()), ("h", (2, 1, hidden)), ("c", (2, 1, hidden))],
        [("output", (1, 1)), ("hn", (2, 1, hidden)), ("cn", (2, 1, hidden))],
    )
    return path, (conv, lstm, head)


def perturbed_vits(tree: Dict[str, Any], seed: int = 7) -> Dict[str, Any]:
    """A JAX-layout numpy VITS tree (``init_params``'s) with the zero-initialised flow posts,
    spline projections and affine flows made non-zero, so that every flow is non-trivial."""
    rng = np.random.default_rng(seed)

    def normal(scale: float, shape: Tuple[int, ...]) -> np.ndarray:
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    for layer in tree["flow"]["layers"]:
        layer["post"]["w"] = normal(0.1, layer["post"]["w"].shape)
    for flows in (tree["dp"].get("flows", []), tree.get("dp_posterior", {}).get("post_flows", [])):
        for layer in flows[1:]:
            layer["convflow"]["proj"]["w"] = normal(0.1, layer["convflow"]["proj"]["w"].shape)
        if flows:
            flows[0]["affine"] = {"m": normal(0.1, (2, 1)), "logs": normal(0.1, (2, 1))}
    return tree


def jax_draws(key, b: int, t: int, cfg) -> dict:
    """The draws the JAX ``augment_batch`` makes from ``key``, as the port's draw dict."""
    import jax

    keys = jax.random.split(key, 12)
    u = jax.random.uniform
    d = {}
    if cfg.seven_band_prob > 0:
        d["eq_apply"] = jax.random.bernoulli(keys[0], cfg.seven_band_prob, (b, 1))
        d["eq_gains_db"] = u(jax.random.split(keys[1])[0], (b, 7), minval=-cfg.seven_band_gain_db,
                             maxval=cfg.seven_band_gain_db)
    if cfg.tanh_distortion_prob > 0:
        d["tanh_apply"] = jax.random.bernoulli(keys[2], cfg.tanh_distortion_prob, (b, 1))
        d["tanh_amount"] = u(keys[3], (b, 1), minval=cfg.tanh_min_distortion, maxval=cfg.tanh_max_distortion)
    if cfg.pitch_shift_prob > 0:
        d["pitch_apply"] = jax.random.bernoulli(keys[4], cfg.pitch_shift_prob, ())
        d["pitch_ratio"] = 2.0 ** (u(keys[5], (), minval=-float(cfg.pitch_shift_semitones),
                                     maxval=float(cfg.pitch_shift_semitones)) / 12.0)
    if cfg.band_stop_prob > 0:
        d["band_stop_apply"] = jax.random.bernoulli(keys[6], cfg.band_stop_prob, (b, 1))
        k_center, k_width = jax.random.split(keys[7])
        d["band_stop_center"] = 2.0 ** u(k_center, (b, 1), minval=np.log2(200.0), maxval=np.log2(4000.0))
        d["band_stop_fraction"] = u(k_width, (b, 1), minval=0.5, maxval=1.99)
    if cfg.colored_noise_prob > 0:
        d["colored_apply"] = jax.random.bernoulli(keys[8], cfg.colored_noise_prob, (b, 1))
        k_noise, k_snr, k_decay = jax.random.split(keys[9], 3)
        d["colored_white"] = jax.random.normal(k_noise, (b, t))
        d["colored_decay"] = u(k_decay, (b, 1), minval=cfg.colored_noise_min_f_decay,
                               maxval=cfg.colored_noise_max_f_decay)
        d["colored_snr_db"] = u(k_snr, (b, 1), minval=cfg.colored_noise_min_snr_db,
                                maxval=cfg.colored_noise_max_snr_db)
    if cfg.gain_prob > 0:
        d["gain_apply"] = jax.random.bernoulli(keys[10], cfg.gain_prob, (b, 1))
        d["gain_db"] = u(keys[11], (b, 1), minval=cfg.gain_min_db, maxval=cfg.gain_max_db)
    k_pad, k_bg, k_bgp, k_rvp = jax.random.split(jax.random.fold_in(key, 1), 4)
    if cfg.placement == "edge":
        k_frac, k_mode = jax.random.split(k_pad)
        d["edge_fraction"] = u(k_frac, (b,), minval=cfg.edge_min_visible, maxval=cfg.edge_max_visible)
        d["edge_head"] = jax.random.bernoulli(k_mode, 0.5, (b,))
    else:
        d["pad_uniform"] = u(k_pad, (b,))
    if cfg.background_noise_prob > 0:
        d["background_snr_db"] = u(k_bg, (b, 1), minval=cfg.background_noise_min_snr_db,
                                   maxval=cfg.background_noise_max_snr_db)
        d["background_apply"] = jax.random.bernoulli(k_bgp, cfg.background_noise_prob, (b, 1))
    if cfg.reverb_prob > 0:
        d["reverb_apply"] = jax.random.bernoulli(k_rvp, cfg.reverb_prob, (b, 1))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


# Features against JAX's on the same audio. The featurizer's bound on noise
# (tests/test_torch_featurizer.py) is FEATURE_ATOL max and FEATURE_MEAN mean.
# Centred speech is worse conditioned (quiet bins at the clip's edges): JAX's
# own bf16 fused path sits further than that from its float32 banded
# reference there. So the port is held to that float32 reference, at
# FEATURE_MARGIN times JAX's own distance from it, or the featurizer's bound
# where that is larger. Measured on the CPU, max / mean from float32, JAX's
# then the port's: the host route's pad-only cache 0.100 / 0.0176 and
# 0.114 / 0.0184; the fused pad-only batch 0.093 / 0.0167 and 0.105 /
# 0.0169; the fused augmented batch 0.123 / 0.0201 and 0.127 / 0.0213. The
# port lies 0.119, 0.105 and 0.076 (max) from JAX's features themselves.
FEATURE_ATOL, FEATURE_MEAN = 0.05, 5e-3
FEATURE_MARGIN = 1.25


def assert_features_close(got: np.ndarray, ref: np.ndarray, mono: np.ndarray) -> None:
    """``got`` against JAX's float32 features of int16-range ``mono``, at
    FEATURE_MARGIN times the distance of JAX's fused features ``ref`` from them."""
    import jax.numpy as jnp
    from heybuddy_tpu.models import embedding_net as jax_net
    from heybuddy_tpu.models import featurizer as jax_featurizer

    exact = np.asarray(jax_featurizer.featurize_batch(
        jax_net.default_params(), jnp.asarray(mono), pooling="banded", compute_dtype=jnp.float32))
    gap = np.abs(ref - exact)
    err = np.abs(got - exact)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert err.max() <= max(FEATURE_ATOL, FEATURE_MARGIN * gap.max()), (err.max(), gap.max())
    assert err.mean() <= max(FEATURE_MEAN, FEATURE_MARGIN * gap.mean()), (err.mean(), gap.mean())
