"""The plain reference against the program's CPU path (the kernels' plain
versions) at small sizes: where they share a formula they agree to float32
rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hbbench import spec, weights
from hbbench.reference import augment as raug
from hbbench.reference import embedding as remb
from hbbench.reference import formant as rformant
from hbbench.reference import heads as rheads
from hbbench.reference import mel as rmel
from hbbench.reference import planner as rplanner
from hbbench.reference import trainstep

CPU = torch.device("cpu")
EMB = spec.config("v8-mlp")["embedding"]


def _audio(b: int, t: int, seed: int = 0) -> torch.Tensor:
    return torch.randn(b, t, generator=torch.Generator().manual_seed(seed)) * 3000.0


@pytest.mark.parametrize("t", [23040, 32000])
def test_mel_and_window_plan(t):
    from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_spectrogram_plain
    from heybuddy_tpu_torch.ops.windows import embedding_window_starts

    audio = _audio(2, t)
    assert torch.allclose(rmel.log_mel(audio), mel_spectrogram_plain(audio), atol=2e-6)
    assert list(remb.window_starts(t)) == list(embedding_window_starts(t))


def test_embedding_matches_the_float32_formulation_and_brackets_bf16():
    from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings, featurize_batch

    params = weights.make(weights.embedding_shapes(EMB), 3, CPU)
    net = SpeechEmbeddings(params=weights.to_numpy(params), device="cpu").net
    audio = _audio(3, 23040, 1)
    spec_ = rmel.log_mel(audio)
    starts = remb.window_starts(23040)
    ref = remb.embed(spec_, params, starts)
    assert torch.allclose(ref, net.apply_spectrogram(spec_, starts, compute_dtype=torch.float32), atol=1e-5)
    bf16_gap = (featurize_batch(net, audio) - ref).abs().max().item()
    fp8_gap = (remb.embed(spec_, params, starts, remb.fp8) - ref).abs().max().item()
    assert bf16_gap < 0.05 < fp8_gap


@pytest.mark.parametrize("config", ["v8-mlp", "v8-transformer"])
def test_heads(config):
    from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel, WakeWordTransformerModel

    head = spec.config(config)["head"]
    params = weights.make(weights.head_shapes(head), 5, CPU)
    model = (WakeWordMLPModel if head["architecture"] == "perceptron" else WakeWordTransformerModel)(device="cpu")
    model.load_state_dict({k.replace("/", "."): v for k, v in params.items()}, strict=True)
    x = torch.randn(6, 16, 96, generator=torch.Generator().manual_seed(2))
    forward = rheads.for_config(head)
    assert torch.allclose(model(x)[:, 0], forward(params, x), atol=1e-6)


def test_the_planner():
    from heybuddy_tpu_torch.models.formant_device import ClipPlan
    from heybuddy_tpu_torch.models.tts import DeviceFormantTTS
    from heybuddy_tpu_torch.text.phonemizer import get_phonemizer

    assert get_phonemizer().name == "simple"
    tts = DeviceFormantTTS(device="cpu")
    texts = ["hey buddy", "hey body", "hey bunny", "okay buddy", "hey there", "buddy", "a daddy", "hey judy"]
    speakers = [(3, 7), (0, 0), (903, 12), (55, 41), (7, 3), (100, 800), (1, 2), (640, 9)]
    for weight, length, noise, seed in ((0.0, 1.0, 0.667, 4), (0.5, 0.75, 0.98, 12345), (1.0, 1.25, 0.333, 99)):
        items = tts.plan_batch(texts, speakers, weight, length, noise, 0.8, seed)
        for j, (text, pair, item) in enumerate(zip(texts, speakers, items)):
            ref = rplanner.batch_clip(text, pair, weight, length, noise, seed, j)
            assert isinstance(item, ClipPlan) and ref is not None
            for key in ("length", "scale", "noise_scale", "clip_seed"):
                assert getattr(item, key) == ref[key]
            assert np.array_equal(item.tracks, ref["tracks"]) and np.array_equal(item.noise_table, ref["noise_table"])


def test_render_and_augmentation():
    from heybuddy_tpu_torch.models import formant_device
    from heybuddy_tpu_torch.models.tts import DeviceFormantTTS
    from heybuddy_tpu_torch.ops import augment

    assert raug.AugmentConfig()._asdict() == augment.AugmentConfig()._asdict()
    tts = DeviceFormantTTS(device="cpu")
    plans = [p for _, p in tts(texts=[("hey buddy", 1.0)], num_samples=3, batch_size=3, seed=4, as_plans=True)]
    packed = formant_device.pack_plans(plans, 48000)
    t = {k: torch.from_numpy(v) for k, v in packed.items() if k != "seeds"}
    breath, white = rformant.clip_noise(packed["seeds"], 48000, CPU)
    b2, w2 = formant_device.clip_noise(packed["seeds"], 48000, "cpu")
    assert torch.equal(breath, b2) and torch.equal(white, w2)
    args = (t["tracks"], t["table"], t["scale"], t["noise_scale"], t["length"], breath, white)
    audio = rformant.render(*args, l_max=48000)
    assert torch.equal(audio, formant_device.render(*args, l_max=48000))
    clip = audio[:, :23040] / 0.7
    lengths = torch.clamp(t["length"], max=23040)
    noise, impulse = torch.randn(3, 23040), torch.randn(3, 800) * 0.1
    draws = raug.draw_augment(torch.Generator().manual_seed(9), 3, 23040, raug.AugmentConfig(), CPU)
    again = augment.draw_augment(torch.Generator().manual_seed(9), 3, 23040, augment.AugmentConfig(), CPU)
    assert draws.keys() == again.keys() and all(torch.equal(draws[k], again[k]) for k in draws)
    ref = raug.augment_batch(clip, lengths, noise, impulse, raug.AugmentConfig(), draws=draws)
    assert torch.equal(ref, augment.augment_batch(clip, lengths, noise, impulse, augment.AugmentConfig(), draws=draws))


def test_train_step_schedule():
    from heybuddy_tpu_torch.training.trainer import get_learning_rate

    for total in (3, 5000):
        for step in (0, 1, 2, 999, 1000, 2665, 4999):
            assert trainstep.learning_rate(step, total) == get_learning_rate(
                step, total // 5, total // 3, total, 1e-3)


def test_trainer_first_steps_follow_the_reference(tmp_path):
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer

    head = spec.config("v8-transformer")["head"]
    params = weights.make(weights.head_shapes(head), 8, CPU)
    trainer = WakeWordTrainer(checkpoint_dir=str(tmp_path), seed=21, device="cpu", architecture="transformer",
                              layer_dim=96, num_layers=2, num_heads=1, dropout=0.1)
    with torch.no_grad():
        trainer.model.load_state_dict({k.replace("/", "."): v for k, v in params.items()}, strict=True)
    ref = trainstep.Reference(params)
    carry = trainer._init_carry(CPU)
    gen_p, gen_r = torch.Generator().manual_seed(22), torch.Generator().manual_seed(22)
    y = torch.cat([torch.ones(20), torch.zeros(120)])
    for k in range(3):
        x = torch.randn(140, 16, 96, generator=torch.Generator().manual_seed(k))
        lr = trainstep.learning_rate(k, 3)
        carry, m = trainer._train_step(carry, x, y, lr, 1.0, 1e-4, 0.5, gen_p)
        loss, fired = ref.step(rheads.transformer, x, y, lr, 1.0, gen_r, 0.1)
        assert bool(m[4] > 0) == fired
        assert m[0].item() == pytest.approx(loss, rel=1e-5)
    for name, value in trainer.model.named_parameters():
        assert np.allclose(value.detach().numpy(), ref.params[name.replace(".", "/")].numpy(), atol=3e-3)
