"""
Kind ``listen``: ``heybuddy listen``'s scoring path with one client and no
pacing.

The client keeps listen's rolling buffer of ``rolling_samples``, hands each
chunk of ``chunk_samples`` to it and the whole buffer to the scoring model
(``runtime.listen._SerialModel``: the checkpoint's head on the shared
featurizer, K1 -> K2 at b = 1) and waits for the score, then sends the next
chunk. The stream is the benchmark's: noise with bursts of a voiced,
formant-like tone placed in it, made from the seed and read cyclically.
``listen_chunk_ms_p95`` is the 95th percentile over every chunk of the
window, each timed on the host from its hand-in to its score.

The check scores a sample of the window's chunks, drawn from the seed as the
window runs, again with the reference (log-mel, embedding, the head the
configuration names, the largest score of the context windows) on the same
buffers, and compares the logits of the scores (their mean gap over the
sample) and the log-mel patches that the program's featurizer made of each
sampled buffer.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from hbbench import weights
from hbbench.reference import embedding as remb
from hbbench.reference import heads as rheads
from hbbench.reference import mel as rmel
from hbbench.traffic import common


def _stream(ctx: Any) -> np.ndarray:
    """Noise at about -40 dBFS with a 0.6-1.2 s voiced burst every 2-4 s: a
    sum of harmonics of a gliding f0 under three moving formant peaks."""
    tr, dev, sr = ctx.traffic, ctx.device, ctx.config["sample_rate"]
    gen = torch.Generator(device=dev).manual_seed(ctx.seeds[1])
    n = int(tr["stream_seconds"] * sr)
    audio = 0.01 * torch.randn(n, generator=gen, device=dev)
    start = 0.5
    while True:
        length = 0.6 + 0.6 * float(torch.rand((), generator=gen, device=dev))
        if start + length > tr["stream_seconds"]:
            break
        m = int(length * sr)
        t = torch.arange(m, device=dev, dtype=torch.float32) / sr
        draw = torch.rand(8, generator=gen, device=dev)
        f0 = (100.0 + 120.0 * draw[0]) * (1.0 + 0.2 * (draw[1] - 0.5) * t / length)
        phase = 2.0 * math.pi * torch.cumsum(f0, 0) / sr
        formants = torch.stack([300 + 600 * draw[2] + 200 * torch.sin(3 * t), 900 + 1400 * draw[3] + 300 * t,
                                2200 + 800 * draw[4] + 0 * t])
        voice = torch.zeros(m, device=dev)
        for h in range(1, 30):
            freq = h * f0
            gain = sum(1.0 / (1.0 + ((freq - f) / 90.0) ** 2) for f in formants)
            voice = voice + gain * torch.sin(h * phase) / h
        envelope = torch.sin(math.pi * t / length) ** 0.5
        voice = voice * envelope / voice.abs().max().clamp(min=1e-6) * (0.2 + 0.6 * float(draw[5]))
        i = int(start * sr)
        audio[i : i + m] += voice
        start += length + 1.0 + 2.0 * float(draw[6])
    return audio.clamp(-1.0, 1.0).cpu().numpy().astype(np.float32)


def _write_checkpoint(path: str, params: Dict[str, torch.Tensor], head: Dict[str, Any]) -> None:
    """The head as the program's checkpoint file: flat ``a/0/b`` arrays and ``__config__``."""
    keys = ("architecture", "layer_dim", "num_layers", "use_gating", "use_half_layers", "num_heads",
            "multiple_of", "norm_epsilon", "dropout", "activation")
    config = {k: head[k] for k in keys if k in head}
    config["input_shape"] = [16, 96]
    arrays = weights.to_numpy(params)
    arrays["__config__"] = np.frombuffer(json.dumps(config).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def buffer(stream: np.ndarray, chunk: int, rolling: int, i: int) -> np.ndarray:
    """The rolling buffer after chunk ``i`` of the cyclic stream (zeros before the start)."""
    end = (i + 1) * chunk
    idx = np.arange(end - rolling, end)
    out = stream[np.mod(idx, len(stream))]
    out[idx < 0] = 0.0
    return out


def setup(ctx: Any) -> None:
    from heybuddy_tpu_torch.models import featurizer
    from heybuddy_tpu_torch.runtime.listen import _SerialModel

    tr, head, rec = ctx.traffic, ctx.config["head"], ctx.recorder
    params = weights.make(weights.embedding_shapes(ctx.config["embedding"]), ctx.seeds[0], ctx.device)
    common.shared_featurizer(ctx, params)
    head_params = weights.make(weights.head_shapes(head), ctx.seeds[2], ctx.device)
    path = os.path.join(ctx.workdir, "head.npz")
    _write_checkpoint(path, head_params, head)
    model = _SerialModel(path, threshold=0.5, device=ctx.device)
    stream = _stream(ctx)
    sample: Dict[str, Any] = {"chunk": None, "mel": None, "kept": {}}

    def mel(call: Any, *args: Any, **kwargs: Any) -> Any:
        out = call()
        if sample["chunk"] is not None:
            sample["mel"] = out  # the sampled chunk's log-mel patches
        return out

    rec.wrap(featurizer.SpeechEmbeddings, "__call__", "embed")
    rec.wrap(featurizer, "mel_patches", None, mel)
    ctx.extra.update(model=model, stream=stream, params=params, head_params=head_params, sample=sample,
                     sampler=np.random.default_rng(ctx.seeds[3]))
    _loop(ctx, tr["warm_chunks"], deadline=None)  # warm: the window's one shape
    rec.spans.clear()


def _loop(ctx: Any, chunks: int, deadline: Any) -> Dict[str, list]:
    tr, model, stream = ctx.traffic, ctx.extra["model"], ctx.extra["stream"]
    chunk, rolling_n = tr["chunk_samples"], tr["rolling_samples"]
    sample, sampler, keep = ctx.extra["sample"], ctx.extra["sampler"], tr["check_chunks"]
    rolling = np.zeros(rolling_n, dtype=np.float32)
    times, scores = [], []
    i = 0
    while (deadline is None and i < chunks) or (deadline is not None and time.perf_counter() < deadline):
        start = (i * chunk) % len(stream)
        piece = stream[start : start + chunk]
        if len(piece) < chunk:
            piece = np.concatenate([piece, stream[: chunk - len(piece)]])
        # a reservoir of ``check_chunks`` chunks, uniform over the window's
        slot = None if deadline is None else i if i < keep else int(sampler.integers(0, i + 1))
        sample["chunk"] = i if slot is not None and slot < keep else None
        t0 = time.perf_counter()
        rolling = np.roll(rolling, -chunk)
        rolling[-chunk:] = piece
        model.put(rolling.copy())
        score, _ = model.get(timeout=10.0)
        times.append(time.perf_counter() - t0)
        scores.append(score)
        if sample["chunk"] is not None:
            sample["kept"][slot] = (i, sample["mel"])
            sample["chunk"] = sample["mel"] = None
        i += 1
        if ctx.recorder.tracing and time.perf_counter() - ctx.extra.get("t0", 0.0) >= tr["trace_seconds"]:
            ctx.recorder.stop_trace()
    return {"times": times, "scores": scores}


def window(ctx: Any) -> None:
    if ctx.traced:
        ctx.recorder.start_trace()
    ctx.extra["t0"] = time.perf_counter()
    out = _loop(ctx, 0, deadline=ctx.extra["t0"] + ctx.seconds)
    elapsed = time.perf_counter() - ctx.extra["t0"] - ctx.recorder.stop_seconds
    ctx.recorder.stop_trace()
    ms = np.asarray(out["times"]) * 1e3
    blocks = np.array_split(ms, 10)
    ctx.diagnostics["p95_by_tenth"] = [round(float(np.percentile(b, 95)), 4) for b in blocks if len(b)]
    ctx.diagnostics["p50_by_tenth"] = [round(float(np.percentile(b, 50)), 4) for b in blocks if len(b)]
    ctx.extra["scores"] = out["scores"]
    ctx.results.update(listen_chunk_ms_p95=float(np.percentile(ms, 95)), attempted=len(ms), failed=0,
                       window_s=elapsed, chunks=len(ms))


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-12, 1.0 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


@torch.no_grad()
def reference_scores(ctx: Any, buffers: np.ndarray, operand: Any) -> Dict[str, torch.Tensor]:
    """The largest head score over the 16-embedding contexts (4 apart) of each
    buffer (``scores``), and the buffers' log-mel (``spec``)."""
    audio = torch.from_numpy(buffers).to(ctx.device) * 32767.0
    starts = remb.window_starts(buffers.shape[1])
    spec = rmel.log_mel(audio)
    feats = remb.embed(spec, ctx.extra["params"], starts, operand)  # (n, W, 96)
    n, w, _ = feats.shape
    contexts = torch.stack([feats[:, i : i + 16] for i in range(0, w - 16 + 1, 4)], dim=1)
    probs = rheads.for_config(ctx.config["head"])(ctx.extra["head_params"], contexts.reshape(-1, 16, feats.shape[2]))
    return {"scores": probs.reshape(n, -1).amax(dim=1), "spec": spec}


def check(ctx: Any) -> None:
    common.free(ctx, "model")
    tr, scores, kept = ctx.traffic, ctx.extra["scores"], ctx.extra["sample"]["kept"]
    picks = [i for i, _ in kept.values()]
    if not picks:
        for name in ("score_logit_gap_mean", "mel_gap"):
            common.check(ctx, name, float("inf"))
        return
    buffers = np.stack([buffer(ctx.extra["stream"], tr["chunk_samples"], tr["rolling_samples"], i) for i in picks])
    prog = torch.tensor([scores[i] for i in picks], dtype=torch.float64)
    ref = reference_scores(ctx, buffers, remb.exact)
    gaps = (_logit(prog) - _logit(ref["scores"].cpu())).abs()
    common.check(ctx, "score_logit_gap_mean", float(gaps.mean()))
    ctx.diagnostics.update(score_logit_gap_max=float(gaps.max()), score_logit_gap_median=float(gaps.median()))
    mel = max(common.mel_gap(m, ref["spec"][j : j + 1]) if m is not None else float("inf")
              for j, (_, m) in enumerate(kept.values()))
    common.check(ctx, "mel_gap", mel)
    if ctx.control:
        ctl = reference_scores(ctx, buffers, remb.fp8)["scores"].cpu()
        ctl_gaps = (_logit(ctl) - _logit(ref["scores"].cpu())).abs()
        ctx.controls.update(score_logit_gap_mean=float(ctl_gaps.mean()), score_logit_gap_max=float(ctl_gaps.max()),
                            score_logit_gap_median=float(ctl_gaps.median()))
