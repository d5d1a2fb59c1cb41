"""
Kind ``vitsgen``: the ``train`` cache fill on the VITS route (``train
--tts-backend vits``).

Set-up writes the benchmark's seeded voice (``piper_weights``) as a Piper
``.pt`` in the work directory and points ``HEYBUDDY_TTS_CHECKPOINT`` at it,
so that a fresh ``VitsTTS`` loads it through ``import_torch_checkpoint``.
The window calls ``TrainingFeaturesGenerator(..., tts_backend="vits")
.generate`` (the classic route: ``VitsTTS`` batches -> 16 kHz int16 clips ->
``AugmentedAudioGenerator`` -> K1 -> K2 -> the cache) into one positive and
one adversarial cache, alternating the two kinds a call of ``chunk`` clips
at a time, until ``--seconds`` have passed; the last call ends the window.
No batch size is set: the generator's own (``autoconfigure_batch_sizes``)
are printed. The augmentation's noise and impulse rows come from the
benchmark's banks (``clipgen``'s, made from the seed). ``gen_clips_per_s``
is the clips written over the window's seconds.

The check takes ``check_batches`` VITS calls of the window, drawn from the
seed, and computes them again with the reference (``reference/vits.py``)
from what the program was given: the texts (ids made anew by the
reference's G2P and id map), the speaker pairs and slerp weight, the
settings and the batch seed (both noise draws redrawn from it in the same
order). It compares the log-durations before the ceiling (``logw_gap``, max
abs), the clips whose frame count differs (``frames_mismatch``), the audio
built from the program's own log-durations (``audio_gap``: max abs over
each clip's length, over the clip's peak), and every feature of the calls'
clips (``feature_gap``): the program's 22,050 Hz audio (which ``audio_gap``
holds) through the reference's resampling and int16 step, at its row of the
augmentation batch (the batch's other rows silent: the augmentation treats
each row apart), the noise and impulse rows that the benchmark's banks
handed out for that batch (``BankNoise`` keeps their indices), the batch's
augmentation stream from the generator state the program seeded (the one
input taken as given), the reference's augmentation, log-mel and embedding. The features start from
the program's audio and not the reference's because a one-step flip of the
int16 rounding moves the log-mel of near-silent frames by up to half a unit:
rounding, not the program, would decide the check.
"""

from __future__ import annotations

import inspect
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hbbench import piper_weights, program_spans, tracing, weights
from hbbench.reference import augment as raug
from hbbench.reference import embedding as remb
from hbbench.reference import mel as rmel
from hbbench.reference import vits as rvits
from hbbench.traffic import clipgen, common

WIDTHS = ("n_vocab", "inter_channels", "hidden_channels", "filter_channels", "n_heads", "n_layers", "kernel_size",
          "resblock_kernel_sizes", "resblock_dilation_sizes", "upsample_rates", "upsample_initial_channel",
          "upsample_kernel_sizes", "n_speakers", "gin_channels", "use_sdp", "sample_rate")


class BankNoise:
    """``NoiseProvider``'s interface over the benchmark's banks: rows drawn by
    a seeded generator. The rows of its last draw of each kind are kept, so
    that the check indexes the banks itself."""

    def __init__(self, noise: np.ndarray, impulse: np.ndarray, seed: int) -> None:
        self.noise, self.impulse = noise, impulse
        self.rng = np.random.default_rng(seed)
        self.noise_rows = self.impulse_rows = np.zeros(0, np.int64)

    def noise_batch(self, batch: int, clip_samples: int) -> np.ndarray:
        self.noise_rows = self.rng.integers(0, len(self.noise), batch)
        return self.noise[self.noise_rows, :clip_samples]

    def impulse_batch(self, batch: int) -> np.ndarray:
        self.impulse_rows = self.rng.integers(0, len(self.impulse), batch)
        return self.impulse[self.impulse_rows]


def _widths(cfg: Dict[str, Any], program: Any) -> None:
    for key in WIDTHS:
        want = getattr(program, key)
        got = cfg[key]
        if (tuple(map(tuple, got)) if key == "resblock_dilation_sizes" else
                tuple(got) if isinstance(got, list) else got) != want:
            raise ValueError(f"the configuration's vits.{key} {got!r} is not the program's {want!r}")


COUNTERS = ("frames_budgeted", "frames_used", "clips_clipped")  # VitsTTS's, where the program has them
STAGES = ("vits/infer", "vits/encoder", "vits/duration", "vits/path", "vits/flow", "vits/decoder")


def infer_totals(ctx: Any) -> Optional[Tuple[int, int, float]]:
    """(calls, launches, device seconds) of the traced ``Vits.infer`` calls:
    the kernels and copies that the trace puts down to the program's
    ``vits/infer`` range and its stage ranges; None where it has none."""
    infer = program_spans.spans(ctx, "vits/infer")
    if infer is None:
        return None
    found = [program_spans.spans(ctx, name) or {"launches": 0, "device_s": 0.0} for name in STAGES]
    return len(infer["host_s"]), sum(f["launches"] for f in found), sum(f["device_s"] for f in found)


def _reduced(call: Any, events: Any, window_s: float) -> Dict[str, Any]:
    """``tracing.summary`` with the program's spans (``program_spans.reduce``) added."""
    trace = call()
    if "program_spans" not in trace:
        trace.update(program_spans.reduce(events, trace))
    return trace


def setup(ctx: Any) -> None:
    from heybuddy_tpu_torch.data import augmented
    from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
    from heybuddy_tpu_torch.models import featurizer, tts
    from heybuddy_tpu_torch.models.vits import Vits, VitsConfig
    from heybuddy_tpu_torch.models.vits.synthesizer import StochasticDurationPredictor
    from heybuddy_tpu_torch.text.phonemizer import get_phonemizer
    from heybuddy_tpu_torch.utils.npy import AppendableNpyFile

    tr, rec, cfg = ctx.traffic, ctx.recorder, ctx.config["vits"]
    if ctx.device.type == "cuda":
        # one core and one intra-op thread, as the trainer's cell: the route's host work is
        # one thread's dispatch, resampling and batching, and left to the scheduler of a
        # shared host its rate spread about twice as wide from run to run
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
        torch.set_num_threads(1)
    _widths(cfg, VitsConfig())
    if cfg["g2p"] != "rules":
        raise ValueError("the reference has the rule G2P alone")
    saved_env = {k: os.environ.get(k) for k in ("HEYBUDDY_PHONEMIZER", "HEYBUDDY_CMUDICT", "HEYBUDDY_TTS_CHECKPOINT",
                                                  "HEYBUDDY_TTS_CONFIG", "HEYBUDDY_TTS_BACKEND")}
    ctx.extra["saved_env"] = saved_env
    for key in saved_env:
        os.environ.pop(key, None)
    os.environ["HEYBUDDY_PHONEMIZER"] = "simple"
    params = weights.make(weights.embedding_shapes(ctx.config["embedding"]), ctx.seeds[0], ctx.device)
    common.shared_featurizer(ctx, params)
    banks = clipgen._banks(ctx)
    noise = BankNoise(banks["noise"].cpu().numpy(), banks["impulse"].cpu().numpy(), ctx.seeds[5])
    voice = piper_weights.make(cfg, ctx.seeds[4], ctx.device)
    path = os.path.join(ctx.workdir, "piper-seeded.pt")
    torch.save({k: v.cpu() for k, v in voice.items()}, path)
    os.environ["HEYBUDDY_TTS_CHECKPOINT"] = path
    tts._GLOBAL_TTS.pop(("vits", str(ctx.device)), None)  # a fresh VitsTTS reads the file

    class Generator(TrainingFeaturesGenerator):
        @property
        def noise_provider(self) -> Any:  # the benchmark's banks, not the offline synthetic noise
            return noise

    gen = Generator(tr["phrase"], directory=ctx.workdir, tts_backend=tr["tts_backend"], seed=ctx.seeds[2],
                    device=ctx.device)
    ctx.diagnostics.update(tts_batch_size=gen.tts_batch_size, augment_batch_size=gen.augment_batch_size,
                           embed_batch_size=gen.embed_batch_size)
    g2p = get_phonemizer()
    if g2p.name != "simple" or g2p.cmudict is not None:
        raise RuntimeError(f"the program's G2P is {g2p.name!r}, not the rule engine the reference copies")
    stores = {kind: AppendableNpyFile(os.path.join(ctx.workdir, f"{kind}.npy")) for kind in tr["mix"]}
    sampler = np.random.default_rng(ctx.seeds[3])
    records: List[Dict[str, Any]] = []
    state: Dict[str, Any] = {"recording": False, "calls": 0, "synth": 0, "augmented": 0, "featurized": 0,
                             "keep": set(), "augment": {}, "features": {}, "capture": None, "work": [],
                             "traced_sizes": [], "texts": [], "tts": None}
    bind_synth = inspect.signature(tts.VitsTTS.synthesize_batch).bind
    bind_infer = inspect.signature(Vits.infer).bind
    bind_augment = inspect.signature(augmented.augment_batch).bind

    def kept(start: int, n: int) -> bool:
        return any(i in state["keep"] for i in range(start, start + n))

    def prune() -> None:
        state["keep"] = {i for r in records for i in range(r["start"], r["start"] + len(r["texts"]))}
        for key in ("augment", "features"):
            state[key] = {s: e for s, e in state[key].items() if kept(s, e["n"])}

    def synth(call: Any, *args: Any, **kwargs: Any) -> Any:
        a = bind_synth(*args, **kwargs).arguments
        state["tts"] = a["self"]
        start, b = state["synth"], len(a["texts"])
        capture = None
        if state["recording"]:
            state["calls"] += 1
            state["texts"].append(a["texts"])
            # a reservoir of ``check_batches`` calls, uniform over the window's
            keep = tr["check_batches"]
            slot = state["calls"] - 1 if state["calls"] <= keep else int(sampler.integers(0, state["calls"]))
            if slot < keep:
                capture = {"start": start, "texts": list(a["texts"]), "speakers": [tuple(s) for s in a["speakers"]],
                           "settings": (a["slerp_weight"], a["length_scale"], a["noise_scale"],
                                        a["noise_scale_w"]), "seed": a["seed"]}
        state["capture"] = capture
        out = call()
        state["capture"] = None
        state["synth"] += b
        if capture is not None and "audio" in capture:
            if slot < len(records):
                records[slot] = capture
            else:
                records.append(capture)
            prune()
        return out

    def infer(call: Any, *args: Any, **kwargs: Any) -> Any:
        a = bind_infer(*args, **kwargs)
        a.apply_defaults()
        max_frames = a.arguments["max_frames"]
        out = call()
        if state["recording"]:  # each clip's ids and frames (device tensors, read after the window)
            state["work"].append((a.arguments["phoneme_lengths"], out[1], rec.tracing))
        capture = state["capture"]
        if capture is not None:
            capture.update(audio=out[0], lengths=out[1], max_frames=max_frames)
        return out

    def duration(call: Any, *args: Any, **kwargs: Any) -> Any:
        out = call()
        if state["capture"] is not None:
            state["capture"]["logw"] = out
        return out

    def augment(call: Any, *args: Any, **kwargs: Any) -> Any:
        a = bind_augment(*args, **kwargs)
        a.apply_defaults()
        audio, generator = a.arguments["audio"], a.arguments["generator"]
        start, b = state["augmented"], audio.shape[0]
        state["augmented"] += b
        if state["recording"] and kept(start, b) and generator is not None:
            # the rows the banks handed out for this batch, and the generator the program seeded
            state["augment"][start] = {"n": b, "samples": audio.shape[1], "noise": noise.noise_rows[:b].copy(),
                                       "impulse": noise.impulse_rows[:b].copy(), "state": generator.get_state()}
        return call()

    def featurize(call: Any, *args: Any, **kwargs: Any) -> Any:
        out, n = call()
        start = state["featurized"]
        state["featurized"] += n
        if state["recording"]:
            if rec.tracing:
                state["traced_sizes"].append(n)
            if kept(start, n):
                state["features"][start] = {"n": n, "out": out}
        return out, n

    rec.wrap(tts.VitsTTS, "synthesize_batch", "tts_batch", synth)
    rec.wrap(Vits, "infer", None, infer)
    rec.wrap(StochasticDurationPredictor, "reverse", None, duration)
    rec.wrap(augmented, "augment_batch", "augment", augment)
    rec.wrap(featurizer.SpeechEmbeddings, "featurize_device", None, featurize)
    rec.wrap(gen, "_drain", "drain")
    # a traced run's trace is reduced with the program's spans too
    rec.wrap(tracing, "summary", None, _reduced)
    # warm every shape of the window: one augmentation batch of each kind (its texts are made at first use)
    for i, kind in enumerate(tr["mix"]):
        gen.generate(tr["warm_clips"], adversarial=kind == "adversarial", store=stores[kind],
                     seed_offset=tr["warm_offset"] + i)
    rec.spans.clear()
    state["counters"] = tuple(getattr(state["tts"], k, 0) for k in COUNTERS)
    ctx.extra.update(gen=gen, stores=stores, params=params, voice=voice, banks=banks, records=records, state=state)


def window(ctx: Any) -> None:
    """``clipgen``'s window (the same calls, trace and results), then the VITS
    calls' counts, and each call's ids and frames a clip (``work``: every
    call of the window; ``traced_calls``: those in the trace)."""
    clipgen.window(ctx)
    state = ctx.extra["state"]
    hop = ctx.config["vits"]["hop"]
    work = [(ids.tolist(), (lengths // hop).tolist(), traced) for ids, lengths, traced in state["work"]]
    state["work"] = [(ids, frames) for ids, frames, _ in work]
    state["traced_calls"] = [(ids, frames) for ids, frames, traced in work if traced]
    clips = sum(len(texts) for texts in state["texts"])
    after = tuple(getattr(state["tts"], k, 0) for k in COUNTERS)
    if any(after) and clips:
        budgeted, used, clipped = (x - y for x, y in zip(after, state["counters"]))
        ids = sum(len(rvits.phoneme_ids(t)) for texts in state["texts"] for t in texts)
        ctx.diagnostics.update(frames_budgeted=budgeted, frames_used=used, clipped_share=clipped / clips,
                               frames_used_per_id=used / ids, budget_used_share=used / budgeted)
    ctx.diagnostics.update(vits_calls=state["calls"], clips_synthesized=clips,
                           clip_order_held=state["synth"] == state["augmented"] == state["featurized"])


def _find(table: Dict[int, Dict[str, Any]], index: int) -> Tuple[Any, int]:
    for start, entry in table.items():
        if start <= index < start + entry["n"]:
            return entry, index - start
    return None, -1


@torch.no_grad()
def check(ctx: Any) -> None:
    common.free(ctx, "gen", "stores")
    from heybuddy_tpu_torch.models import tts

    tts._GLOBAL_TTS.pop(("vits", str(ctx.device)), None)
    for key, value in ctx.extra["saved_env"].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    dev, cfg, state = ctx.device, ctx.config["vits"], ctx.extra["state"]
    voice = rvits.fold(ctx.extra["voice"], dev)
    rate, clip_samples = ctx.config["sample_rate"], ctx.config["clip_samples"]
    hop = cfg["hop"]
    logw_gap = audio_gap = feature_gap = control_logw = control_audio = control_feature = 0.0
    mismatched = 0
    placed: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}  # augmentation batch -> (row, clip, audio)
    records = ctx.extra["records"]
    for r in records:
        slerp, length_scale, noise_scale, noise_scale_w = r["settings"]
        ids, lengths = rvits.batch_ids(r["texts"])
        ids, lengths = ids.to(dev), lengths.to(dev)
        budget = rvits.frame_budget(ids.shape[1], length_scale)
        speaker = rvits.speaker_vectors(voice["emb_g.weight"], r["speakers"], slerp)
        given = r["logw"].float()
        if given.shape != (ids.shape[0], 1, ids.shape[1]) or budget != r["max_frames"]:
            logw_gap = audio_gap = feature_gap = math.inf
            continue

        def run(tf32: bool = False) -> Dict[str, torch.Tensor]:
            g = torch.Generator(device=dev).manual_seed(r["seed"])
            return rvits.infer(voice, cfg, ids, lengths, speaker, noise_scale, length_scale, noise_scale_w, budget,
                               generator=g, logw=given, tf32=tf32)

        ref = run()
        logw_gap = max(logw_gap, common.max_gap(ref["logw"], given))
        mask = rvits.sequence_mask(lengths, ids.shape[1]).unsqueeze(1)
        own = torch.clamp(torch.ceil(torch.exp(ref["logw"]) * mask * length_scale).sum((1, 2)), 1, budget).long()
        frames = (r["lengths"] // hop).long()
        mismatched += int((own != frames).sum())
        ours = [r["audio"][i, : int(n)].float() for i, n in enumerate(r["lengths"].tolist())]
        theirs = [ref["audio"][i, : int(n)] for i, n in enumerate(r["lengths"].tolist())]
        for a, b in zip(ours, theirs):
            audio_gap = max(audio_gap, common.max_gap(a, b) / max(float(b.abs().max()), 1e-12))
        if ctx.control:
            low = run(tf32=True)
            control_logw = max(control_logw, common.max_gap(low["logw"], ref["logw"]))
            for i, b in enumerate(theirs):
                control_audio = max(control_audio, common.max_gap(low["audio"][i, : b.shape[0]], b)
                                    / max(float(b.abs().max()), 1e-12))
        for j, a in enumerate(ours):
            entry, row = _find(state["augment"], r["start"] + j)
            if entry is None:
                feature_gap = math.inf
                continue
            clip = rvits.clip_pcm(a.cpu().numpy(), cfg["sample_rate"], rate, clip_samples)
            placed.setdefault(r["start"] + j - row, []).append((row, r["start"] + j, clip))
    if not state["synth"] == state["augmented"] == state["featurized"]:
        feature_gap = math.inf  # a clip left the stream: rows no longer follow the calls
    aug_cfg = raug.AugmentConfig()
    starts = remb.window_starts(clip_samples)
    banks = ctx.extra["banks"]
    for start, rows in placed.items():
        # the batch's other rows stay silent: the augmentation treats each row apart, so they
        # do not enter the rows compared
        entry = state["augment"][start]
        audio = torch.zeros((entry["n"], entry["samples"]), device=dev)
        lengths = torch.zeros(entry["n"], dtype=torch.int64, device=dev)
        for row, _, clip in rows:
            audio[row, : len(clip)] = torch.from_numpy(clip).to(dev)
            lengths[row] = len(clip)
        g = torch.Generator(device=dev)
        g.set_state(entry["state"])
        draws = raug.draw_augment(g, audio.shape[0], audio.shape[1], aug_cfg, dev)
        noise = banks["noise"][torch.from_numpy(entry["noise"]).to(dev), : entry["samples"]]
        impulse = banks["impulse"][torch.from_numpy(entry["impulse"]).to(dev)]
        staged = raug.augment_batch(audio, lengths, noise, impulse, aug_cfg, draws=draws)
        picked = torch.tensor([row for row, _, _ in rows], device=dev)
        spec = rmel.log_mel(staged[picked] * 32767.0)
        reference = remb.embed(spec, ctx.extra["params"], starts)
        for k, (_, index, _) in enumerate(rows):
            out, frow = _find(state["features"], index)
            if out is None:
                feature_gap = math.inf
                continue
            feature_gap = max(feature_gap, common.max_gap(out["out"][frow].float(), reference[k]))
            if ctx.control:
                low = remb.embed(spec[k: k + 1], ctx.extra["params"], starts, remb.fp8)[0]
                control_feature = max(control_feature, common.max_gap(low, reference[k]))
    empty = math.inf if not records else 0.0
    common.check(ctx, "logw_gap", max(logw_gap, empty))
    common.check(ctx, "frames_mismatch", max(float(mismatched), empty))
    common.check(ctx, "audio_gap", max(audio_gap, empty))
    common.check(ctx, "feature_gap", max(feature_gap, empty))
    if ctx.control:
        ctx.controls.update(logw_gap=control_logw, audio_gap=control_audio, feature_gap=control_feature)
