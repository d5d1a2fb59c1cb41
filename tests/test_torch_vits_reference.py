"""The port's VITS ``infer`` against the benchmark's plain reference
(``hbbench/reference/vits.py``) on the CPU, from one seeded Piper-layout state
dict (``hbbench/piper_weights.py``: weight norm as ``weight_g`` / ``weight_v``,
every flow non-trivial) that the port reads through ``import_torch_checkpoint``.

Small widths over several batches and length scales, then the published
widths (``VitsConfig()``) once. Compared in order: the log-durations before
the ceiling, the frame counts, then the audio built from the port's own
log-durations (so that a ceiling that flips on rounding cannot decide the
audio's comparison). Also: the spans leave the audio bit for bit as it is,
``VitsTTS``'s frame counters add up, and a skipped flow fails the limits.
This file imports no JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from hbbench import piper_weights
from hbbench.reference import vits as rv
from heybuddy_tpu_torch.models import tts
from heybuddy_tpu_torch.models.vits import VitsConfig, import_torch_checkpoint
from heybuddy_tpu_torch.models.vits import synthesizer as ps

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = json.load(open(os.path.join(ROOT, "hbbench", "configs", "piper-libritts-r-medium.json")))["vits"]
SMALL = dict(FULL, n_speakers=4, gin_channels=16, n_layers=2, hidden_channels=64, filter_channels=128,
             inter_channels=64, upsample_initial_channel=64)
TEXTS = ["hey buddy", "hey buddy. hello", "hay bunny", "what time is it"]
# float32 on both sides, the same arithmetic in other kernels and orders (F.layer_norm against the
# port's mean / variance, softplus against logaddexp, matmul against einsum, the weight norm folded
# in torch against numpy): measured at most 8.6e-6 on the log-durations and 9e-7 of the clip's
# peak on the audio (full width, CPU); the limits leave 10x
LOGW_ATOL = 1e-4
AUDIO_RTOL = 1e-5


def _config(cfg):
    keys = VitsConfig._fields
    return VitsConfig(**{k: tuple(map(tuple, v)) if k == "resblock_dilation_sizes" else
                         tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in keys})


def _voice(cfg, seed, tmp_path):
    """(the reference's folded tensors, the port's model read from the same .pt)."""
    state = piper_weights.make(cfg, seed, CPU)
    path = os.path.join(tmp_path, f"voice-{seed}.pt")
    torch.save(state, path)
    return rv.fold(state, CPU), import_torch_checkpoint(path, _config(cfg), CPU).eval()


def _port(model, ids, lengths, speaker, settings, budget, seed, monkeypatch):
    """The port's audio, lengths and log-durations (caught at the duration predictor)."""
    caught = {}
    reverse = ps.StochasticDurationPredictor.reverse

    def keep(self, *args, **kwargs):
        caught["logw"] = reverse(self, *args, **kwargs)
        return caught["logw"]

    monkeypatch.setattr(ps.StochasticDurationPredictor, "reverse", keep)
    ns, ls, nsw = settings
    with torch.no_grad():
        audio, audio_lengths = model.infer(
            ids, lengths, speaker, noise_scale=ns, length_scale=ls, noise_scale_w=nsw, max_frames=budget,
            generator=torch.Generator().manual_seed(seed))
    monkeypatch.setattr(ps.StochasticDurationPredictor, "reverse", reverse)
    return audio, audio_lengths, caught["logw"]


def _gaps(cfg, p, model, texts, pairs, slerp, settings, seed, monkeypatch):
    ids, lengths = rv.batch_ids(texts)
    ns, ls, nsw = settings
    budget = rv.frame_budget(ids.shape[1], ls)
    speaker = rv.speaker_vectors(p["emb_g.weight"], pairs, slerp)
    audio, audio_lengths, logw = _port(model, ids, lengths, speaker, settings, budget, seed, monkeypatch)
    ref = rv.infer(p, cfg, ids, lengths, speaker, ns, ls, nsw, budget, generator=torch.Generator().manual_seed(seed),
                   logw=logw)
    mask = rv.sequence_mask(lengths, ids.shape[1]).unsqueeze(1)
    own = torch.clamp(torch.ceil(torch.exp(ref["logw"]) * mask * ls).sum((1, 2)), 1, budget)
    n = (audio_lengths // cfg["hop"]).tolist()
    audio_gap = max(float((audio[i, : k * cfg["hop"]] - ref["audio"][i, : k * cfg["hop"]]).abs().max())
                    / float(ref["audio"][i, : k * cfg["hop"]].abs().max()) for i, k in enumerate(n))
    return {"logw": float((ref["logw"] - logw).abs().max()), "frames_equal": own.long().tolist() == n,
            "frames": n, "budget": budget, "audio": audio_gap}


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("length_scale", [0.75, 1.0, 1.5])
def test_small_widths_against_the_reference(seed, length_scale, tmp_path, monkeypatch):
    p, model = _voice(SMALL, seed, tmp_path)
    pairs = [(i % 4, (i + 1) % 4) for i in range(len(TEXTS))]
    for batch, settings in enumerate([(0.667, length_scale, 0.8), (1.0, length_scale, 1.0)]):
        gaps = _gaps(SMALL, p, model, TEXTS, pairs, 0.25 * (batch + 1), settings, 100 * seed + batch, monkeypatch)
        assert gaps["logw"] <= LOGW_ATOL and gaps["frames_equal"], gaps
        assert gaps["audio"] <= AUDIO_RTOL, gaps


def test_published_widths_once(tmp_path, monkeypatch):
    p, model = _voice(FULL, 5, tmp_path)
    gaps = _gaps(FULL, p, model, TEXTS[:2], [(0, 903), (17, 450)], 0.5, (0.667, 1.0, 0.8), 7, monkeypatch)
    assert gaps["logw"] <= LOGW_ATOL and gaps["frames_equal"], gaps
    assert gaps["audio"] <= AUDIO_RTOL, gaps


@pytest.mark.parametrize("fault", ["flow", "duration"])
def test_a_skipped_flow_fails_the_limits(fault, tmp_path, monkeypatch):
    """The couplings' reverse left out (the prior's sample goes to the decoder as it is), or the
    duration predictor's spline flows left out (the affine flow alone): the gaps leave the limits."""
    p, model = _voice(SMALL, 3, tmp_path)
    if fault == "flow":
        monkeypatch.setattr(ps.ResidualCouplingBlock, "reverse", lambda self, z, y_mask, g: z)
    else:
        from heybuddy_tpu_torch.models.vits import modules as pm

        def affine_only(self, x, x_mask, g, noise, noise_scale):
            z, _ = self.flows[0](pm.flip_flow(noise * noise_scale), x_mask, reverse=True)
            return z[:, 0:1]

        monkeypatch.setattr(ps.StochasticDurationPredictor, "reverse", affine_only)
    gaps = _gaps(SMALL, p, model, TEXTS, [(0, 1), (1, 2), (2, 3), (3, 0)], 0.5, (0.667, 1.0, 0.8), 9, monkeypatch)
    assert gaps["audio"] > AUDIO_RTOL if fault == "flow" else gaps["logw"] > LOGW_ATOL, gaps


def test_spans_leave_the_audio_and_the_counters_add_up(tmp_path, monkeypatch):
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.setattr(tts, "_GLOBAL_TTS", {})
    path = os.path.join(tmp_path, "voice.pt")
    torch.save(piper_weights.make(FULL, 4, CPU), path)
    voice = tts.VitsTTS(checkpoint_path=path, device="cpu")
    args = (TEXTS[:3], [(1, 2), (3, 4), (5, 6)], 0.5, 1.25, 0.667, 0.8, 21)
    plain = voice.synthesize_batch(*args)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = voice.synthesize_batch(*args)
    names = {e.name for e in prof.events()}
    assert {"vits/inputs", "vits/infer", "vits/encoder", "vits/duration", "vits/path", "vits/flow", "vits/decoder",
            "vits/download"} <= names
    assert all(np.array_equal(a, b) for a, b in zip(plain, traced)) and len(plain) == 3
    _, _, _, budget = voice.batch_inputs(*args[:4])
    hop = voice.config.hop_samples
    assert voice.frames_budgeted == 2 * 3 * budget
    assert voice.frames_used == 2 * sum(len(a) // hop for a in plain) <= voice.frames_budgeted
    # a clip counts as clipped where it fills the budget
    assert voice.clips_clipped == 2 * sum(len(a) == budget * hop for a in plain)
