"""
Kind ``clipgen``: the ``train`` cache fill on the fused route.

The window calls ``TrainingFeaturesGenerator.generate`` (``formant-device``
backend, so ``fused_features_batch``: host plans -> device render ->
augmentation -> K1 -> K2, the next batch planned while the last runs) into
one positive and one adversarial cache, alternating the two kinds a call of
``chunk`` clips at a time, until ``--seconds`` have passed; the last call
ends the window. ``gen_clips_per_s`` is the clips written over the window's
seconds. The noise and impulse banks are the benchmark's, made from the seed.

The check takes a sample of the window's fused batches, drawn from the seed,
and computes each again with the reference: each clip planned anew from the
planner's inputs (the text, the two speakers, the settings and the batch
seed that the generator handed the program's ``plan_batch``), its noise from
the plan's seed, the batch's augmentation stream, log-mel and embedding. It
compares every feature of the sample, and the log-mel patches that the
program's featurizer made of the batch. The program and the reference both
run the rule G2P (the configuration's ``voice.g2p``).
"""

from __future__ import annotations

import inspect
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from hbbench import weights
from hbbench.reference import augment as raug
from hbbench.reference import embedding as remb
from hbbench.reference import formant as rformant
from hbbench.reference import mel as rmel
from hbbench.reference import planner as rplanner
from hbbench.traffic import common


def _banks(ctx: Any) -> Dict[str, torch.Tensor]:
    """Background noise (rows of clip length, unit RMS) and room impulses
    (a direct path and an exponentially decaying noise tail of random RT60)."""
    tr, dev = ctx.traffic, ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.seeds[1])
    rows, clip = tr["noise_bank_rows"], ctx.config["clip_samples"]
    noise = torch.randn((rows, clip), generator=gen, device=dev)
    noise = noise / noise.pow(2).mean(dim=1, keepdim=True).sqrt()
    n = tr["impulse_samples"]
    rt60 = 0.2 + 0.8 * torch.rand((rows, 1), generator=gen, device=dev)
    t = torch.arange(n, device=dev, dtype=torch.float32)[None, :] / ctx.config["sample_rate"]
    impulse = torch.randn((rows, n), generator=gen, device=dev) * torch.exp(-6.9 * t / rt60) * 0.3
    impulse[:, 0] = 1.0
    return {"noise": noise.contiguous(), "impulse": impulse.contiguous()}


def setup(ctx: Any) -> None:
    from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
    from heybuddy_tpu_torch.models import featurizer, formant_device
    from heybuddy_tpu_torch.models.tts import DeviceFormantTTS
    from heybuddy_tpu_torch.text.phonemizer import get_phonemizer
    from heybuddy_tpu_torch.utils.npy import AppendableNpyFile

    tr, rec = ctx.traffic, ctx.recorder
    os.environ["HEYBUDDY_FUSED_TTS_BATCH"] = str(tr["batch"])
    if ctx.config["voice"]["g2p"] != "rules":
        raise ValueError("the reference planner has the rule G2P alone")
    os.environ["HEYBUDDY_PHONEMIZER"] = "simple"
    os.environ.pop("HEYBUDDY_CMUDICT", None)
    params = weights.make(weights.embedding_shapes(ctx.config["embedding"]), ctx.seeds[0], ctx.device)
    common.shared_featurizer(ctx, params)
    banks = _banks(ctx)

    class Generator(TrainingFeaturesGenerator):
        def _fused_banks(self) -> Any:  # the benchmark's banks, not the offline synthetic ones
            return banks["noise"], banks["impulse"]

    gen = Generator(tr["phrase"], directory=ctx.workdir, tts_backend=tr["tts_backend"], seed=ctx.seeds[2],
                    device=ctx.device)
    g2p = get_phonemizer()
    if g2p.name != "simple" or g2p.cmudict is not None:
        raise RuntimeError(f"the program's G2P is {g2p.name!r}, not the rule engine the reference copies")
    stores = {kind: AppendableNpyFile(os.path.join(ctx.workdir, f"{kind}.npy")) for kind in tr["mix"]}
    sampler = np.random.default_rng(ctx.seeds[3])
    records: List[Dict[str, Any]] = []
    state = {"batches": 0, "recording": False, "render_start": None, "traced_sizes": []}
    bind_fused = inspect.signature(formant_device.fused_features_batch).bind
    bind_plan = inspect.signature(DeviceFormantTTS.plan_batch).bind
    inputs: Dict[int, Tuple[Any, ...]] = {}  # id of a live plan -> what its plan_batch call was given

    def plan(call: Any, *args: Any, **kwargs: Any) -> Any:
        items = call()
        a = bind_plan(*args, **kwargs).arguments
        for j, (item, text, pair) in enumerate(zip(items, a["texts"], a["speakers"])):
            if isinstance(item, formant_device.ClipPlan):
                inputs[id(item)] = (text, tuple(pair), a["slerp_weight"], a["length_scale"], a["noise_scale"],
                                    a["seed"], j)
        return items

    def fused(call: Any, *args: Any, **kwargs: Any) -> Any:
        a = bind_fused(*args, **kwargs)
        a.apply_defaults()
        g = a.arguments["generator"]
        before = g.get_state() if state["recording"] else None
        planned = [inputs.pop(id(p), None) for p in a.arguments["plans"]]
        out, n = call()
        mel = state.pop("mel", None)
        if state["recording"]:
            state["batches"] += 1
            if rec.tracing:
                state["traced_sizes"].append(n)
            # a reservoir of ``check_batches`` batches, uniform over the window's
            keep = tr["check_batches"]
            slot = state["batches"] - 1 if state["batches"] <= keep else int(sampler.integers(0, state["batches"]))
            if slot < keep:
                entry = {"inputs": planned, "state": before, "out": out, "n": n, "mel": mel,
                         "pad_only": a.arguments["pad_only"], "clip_samples": a.arguments["clip_samples"]}
                if slot < len(records):
                    records[slot] = entry
                else:
                    records.append(entry)
        return out, n

    def mel(call: Any, *args: Any, **kwargs: Any) -> Any:
        out = call()
        if state["recording"]:
            state["mel"] = out  # the batch's log-mel patches, kept while the batch may join the sample
        return out

    def noise_start(call: Any, *args: Any, **kwargs: Any) -> Any:
        if rec.tracing:
            state["render_start"] = torch.cuda.Event(enable_timing=True)
            state["render_start"].record()
        return call()

    def render_end(call: Any, *args: Any, **kwargs: Any) -> Any:
        out = call()
        if rec.tracing and state["render_start"] is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.values["render_events"].append((state["render_start"], end))
            state["render_start"] = None
        return out

    rec.wrap(formant_device, "fused_features_batch", "fused_batch", fused)
    rec.wrap(DeviceFormantTTS, "plan_batch", "plan", plan)
    rec.wrap(gen, "_drain", "drain")
    rec.wrap(featurizer, "mel_patches", None, mel)
    if ctx.device.type == "cuda":
        rec.wrap(formant_device, "clip_noise", None, noise_start)
        rec.wrap(formant_device, "render", None, render_end)
    # warm every shape of the window: one batch of each kind (its texts are made at first use)
    for i, kind in enumerate(tr["mix"]):
        gen.generate(tr["batch"], adversarial=kind == "adversarial", store=stores[kind],
                     seed_offset=tr["warm_offset"] + i)
    rec.spans.clear()
    ctx.extra.update(gen=gen, stores=stores, params=params, banks=banks, records=records, state=state)


def window(ctx: Any) -> None:
    tr, rec, state = ctx.traffic, ctx.recorder, ctx.extra["state"]
    gen, stores = ctx.extra["gen"], ctx.extra["stores"]
    state["recording"] = True
    written = requested = calls = 0
    if ctx.traced:
        rec.start_trace()
    t0 = time.perf_counter()
    while True:
        kind = tr["mix"][calls % len(tr["mix"])]
        written += gen.generate(tr["chunk"], adversarial=kind == "adversarial", store=stores[kind],
                                seed_offset=(calls // len(tr["mix"])) * tr["chunk"])
        requested += tr["chunk"]
        calls += 1
        now = time.perf_counter()
        if rec.tracing and now - t0 >= tr["trace_seconds"]:
            rec.stop_trace()
        if now - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0 - rec.stop_seconds
    state["recording"] = False
    rec.stop_trace()
    ctx.results.update(gen_clips_per_s=written / elapsed, attempted=requested, failed=requested - written,
                       window_s=elapsed, clips=written)


def reference_features(entry: Dict[str, Any], ctx: Any) -> Dict[str, torch.Tensor]:
    """The batch again by the reference; with ``ctx.control`` also the control's features."""
    dev, voice = ctx.device, ctx.config["voice"]
    plans = [rplanner.batch_clip(*given) if given is not None else None for given in entry["inputs"]]
    if any(p is None for p in plans):
        return {}  # a clip the reference does not plan (or whose inputs it never saw)
    b = len(plans)
    l_max, clip_samples = voice["max_samples"], entry["clip_samples"] or ctx.config["clip_samples"]

    def stack(key: str, dtype: Any) -> torch.Tensor:
        return torch.from_numpy(np.asarray([p[key] for p in plans], dtype=dtype)).to(dev)

    seeds = np.asarray([p["clip_seed"] for p in plans], np.int64)
    breath, white = rformant.clip_noise(seeds, l_max, dev)
    audio = rformant.render(stack("tracks", np.float32), stack("noise_table", np.float32),
                            stack("scale", np.float32), stack("noise_scale", np.float32),
                            stack("length", np.int64), breath, white, l_max=l_max,
                            harmonics=voice["harmonics"], sample_rate=ctx.config["sample_rate"])
    clip = audio[:, :clip_samples] * (1.0 / 0.7)
    lengths = torch.clamp(stack("length", np.int64), max=clip_samples)
    if entry["pad_only"]:
        staged = rformant.center_place(clip, lengths, clip_samples)
    else:
        banks, cfg = ctx.extra["banks"], raug.AugmentConfig()
        g = torch.Generator(device=dev)
        g.set_state(entry["state"])
        draws = raug.draw_augment(g, b, clip_samples, cfg, dev)
        noise_rows = torch.randint(0, banks["noise"].shape[0], (b,), generator=g, device=dev)
        impulse_rows = torch.randint(0, banks["impulse"].shape[0], (b,), generator=g, device=dev)
        staged = raug.augment_batch(clip, lengths, banks["noise"][noise_rows], banks["impulse"][impulse_rows],
                                    cfg, draws=draws)
    spec = rmel.log_mel(staged * 32767.0)
    starts = remb.window_starts(clip_samples)
    out = {"reference": remb.embed(spec, ctx.extra["params"], starts), "spec": spec}
    if ctx.control:
        out["control"] = remb.embed(spec, ctx.extra["params"], starts, remb.fp8)
    return out


@torch.no_grad()
def check(ctx: Any) -> None:
    common.free(ctx, "gen", "stores")
    gap = mel = control = 0.0
    records = ctx.extra["records"]
    for entry in records:
        ref = reference_features(entry, ctx)
        prog = entry["out"][: entry["n"]].float()
        gap = max(gap, common.max_gap(prog, ref["reference"]) if ref else float("inf"))
        mel = max(mel, common.mel_gap(entry["mel"], ref["spec"]) if ref and entry["mel"] else float("inf"))
        if ctx.control and ref:
            control = max(control, common.max_gap(ref["control"], ref["reference"]))
    common.check(ctx, "feature_gap", gap if records else float("inf"))
    common.check(ctx, "mel_gap", mel if records else float("inf"))
    if ctx.control:
        ctx.controls["feature_gap"] = control
