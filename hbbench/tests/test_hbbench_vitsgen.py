"""The VITS cache-fill cell (``gen-vits.piper-libritts-r-medium``): a sound run
at small sizes on the CPU is correct; the reference with TF32 on (the control
one precision down, which only a card has) and two planted faults in the
program (the flow's reverse skipped, the duration predictor's spline flows
skipped) are not; ``vits_work`` counts one small call as a hand count and
torch's own FLOP counter do; and the seeded voice speaks at the set rate."""

from __future__ import annotations

import json
import os

import pytest
import torch

from hbbench import piper_weights, run, spec, vits_work
from hbbench.reference import vits as rv

CELL = "gen-vits.piper-libritts-r-medium"
SMALL = {"traffic": {"chunk": 16, "warm_clips": 8, "noise_bank_rows": 8, "check_batches": 2, "trace_seconds": 0.3}}


def _run(device: torch.device, seed: int = 2 ** 31 + 17, control: bool = False) -> dict:
    return run.run_cell(CELL, seed, 0.5, False, device, control=control, overrides=SMALL)


def test_a_sound_run_is_correct():
    result = _run(torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["attempted"] == 16 and result["diagnostics"]["clip_order_held"]
    assert set(result["checks"]) == {"logw_gap", "frames_mismatch", "audio_gap", "feature_gap"}


@pytest.mark.parametrize("fault", ["flow", "duration", "tf32"])
def test_the_controls_fail(fault, monkeypatch, request):
    from heybuddy_tpu_torch.models.vits import modules, synthesizer

    device = torch.device("cpu")
    if fault == "flow":
        monkeypatch.setattr(synthesizer.ResidualCouplingBlock, "reverse", lambda self, z, y_mask, g: z)
    elif fault == "duration":
        def affine_only(self, x, x_mask, g, noise, noise_scale):
            z, _ = self.flows[0](modules.flip_flow(noise * noise_scale), x_mask, reverse=True)
            return z[:, 0:1]

        monkeypatch.setattr(synthesizer.StochasticDurationPredictor, "reverse", affine_only)
    else:
        device = request.getfixturevalue("cuda_device")  # TF32 exists only on a card
    result = _run(device, control=fault == "tf32")
    if fault == "tf32":
        assert result["correct"], result["checks"]
        limits = spec.cell(spec.benchmark(), CELL)["limits"]
        assert result["controls"]["audio_gap"] > limits["audio_gap"], result["controls"]
    else:
        failed = {name for name, c in result["checks"].items() if c["value"] > c["limit"]}
        assert not result["correct"] and failed, result["checks"]


def test_the_work_of_one_small_call():
    full = json.load(open(os.path.join(spec.HERE, "configs", "piper-libritts-r-medium.json")))["vits"]
    cfg = dict(full, n_vocab=8, n_speakers=2, gin_channels=2, n_layers=1, hidden_channels=4, filter_channels=6,
               inter_channels=4, n_heads=2, sdp_flows=2, sdp_bins=2, flow_couplings=1, flow_layers=2,
               upsample_rates=[2], upsample_kernel_sizes=[4], upsample_initial_channel=4,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]])
    b, t_x, frames = 2, 3, 5
    # multiply-adds of one clip: h 4, f 6, k 3, inter 4, gin 2, 2 t_x - 1 = 5 relative positions
    # the four 1x1s, scores and sums, the relative keys and values, the FFN, the prior's projection
    encoder = 4 * 4 * 4 * 3 + 2 * 4 * 3 * 3 + 2 * 4 * 3 * 5 + 2 * 6 * 4 * 3 * 3 + 2 * 4 * 4 * 3
    dds = 3 * (4 * 3 + 4 * 4) * 3  # 3 layers: depthwise k 3, 1x1
    duration = 2 * 4 * 4 * 3 + 2 * 4 + dds + 1 * (4 * 3 + dds + 5 * 4 * 3)  # pre, proj, cond, stack, one spline flow
    path = 2 * 4 * 5 * 3
    flow = 2 * 2 * 4 * 5 + 2 * 2 * 4 * 4 * 5 * 5 + 2 * 4 * 4 * 5 + 4 * 4 * 5 + 2 * 4 * 2 * 2  # pre+post, WN, cond
    decoder = 4 * 4 * 7 * 5 + 2 * 4 + 4 * 2 * 4 * 5 + 2 * 2 * 2 * 3 * 10 + 2 * 7 * 10  # pre, cond, up, blocks, post
    ops, _ = vits_work.infer_work([t_x] * b, [frames] * b, cfg)
    assert ops == 2 * b * (encoder + duration + path + flow + decoder)
    # clip by clip: a call of two clips reads its weights once
    (one, read_one), (two, read_two) = (vits_work.infer_work([t_x] * n, [frames] * n, cfg) for n in (1, 2))
    assert two == 2 * one and read_two - read_one == read_one - 4 * vits_work.param_count(cfg)
    # a small voice's products, counted by torch itself on the reference's call
    small = dict(full, n_speakers=4, gin_channels=16, n_layers=2, hidden_channels=64, filter_channels=128,
                 inter_channels=64, upsample_initial_channel=64)
    voice = rv.fold(piper_weights.make(small, 1, torch.device("cpu")), torch.device("cpu"))
    ids, lengths = rv.batch_ids(["hey buddy", "hello there"])
    speaker = rv.speaker_vectors(voice["emb_g.weight"], [(0, 1), (2, 3)], 0.5)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        rv.infer(voice, small, ids, lengths, speaker, 0.667, 1.0, 0.8, 64, generator=torch.Generator().manual_seed(1))
    assert counter.get_total_flops() == vits_work.infer_work([ids.shape[1]] * 2, [64] * 2, small)[0]
    assert vits_work.param_count(small) == sum(v.numel() for v in voice.values())


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_the_voice_speaks_at_the_set_rate(seed):
    """``piper_weights.make`` sets the affine flow so that the calibration batch's
    log-durations have the set mean and deviation, whatever the seed."""
    cpu = torch.device("cpu")
    cfg = json.load(open(os.path.join(spec.HERE, "configs", "piper-libritts-r-medium.json")))["vits"]
    cfg = dict(cfg, n_speakers=4, gin_channels=16, n_layers=2, hidden_channels=64, filter_channels=128)
    p = rv.fold(piper_weights.make(cfg, seed, cpu), cpu)
    ids, lengths = rv.batch_ids(piper_weights.CALIBRATION)
    pairs = [(2 * i % 4, (2 * i + 1) % 4) for i in range(len(ids))]
    noise = torch.randn((ids.shape[0], 2, ids.shape[1]), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        x_mask = rv.sequence_mask(lengths, ids.shape[1]).unsqueeze(1)
        x, _, _ = rv.text_encoder(p, cfg, ids, x_mask)
        logw = rv.duration_reverse(p, cfg, x, x_mask, rv.speaker_vectors(p["emb_g.weight"], pairs, 0.5).unsqueeze(-1),
                                   noise, 0.8)
    values = logw[x_mask.bool()]
    assert abs(float(values.mean()) - piper_weights.LOGW_MEAN) < 1e-4
    assert abs(float(values.std()) - piper_weights.LOGW_STD) < 1e-4
