"""
`heybuddy train` wall-clock decomposition on the card, extrapolated to the
reference's default scale.

    python -m heybuddy_tpu_torch.tools.end_to_end_bench [--clips 512] [--train-steps 300]
        [--json PATH] [--md PATH] [--seed 0] [--device cpu]

The counterpart of the JAX package's ``scripts/end_to_end_bench.py``: its
arguments, its stages, its ``REF_SCALE``, its extrapolation and its JSON
keys, plus ``device`` (``nvidia-smi``'s card name and power limit, or
``cpu``). The north star is finishing ``train "hey buddy"`` at the
reference's default scale (100k positive + 100k adversarial + 25k
validation + 50k testing clips, 3 stages x 5,000 steps). Each stage is
measured alone at a small scale:

1. **TTS synthesis**: clips/s of ``SpeechSampleGenerator`` with the host
   ``formant`` backend (batch 8) and the ``formant-device`` one (batch
   ``TTS_DEVICE_BATCH``, 128),
   ``--clips`` clips timed after one batch of warm-up.
2. **TTS -> augment -> featurize pipeline**: clips/s of
   ``TrainingFeaturesGenerator.generate`` into a store, the host route on
   ``--clips`` clips after 8, the fused device route on at least
   ``PIPELINE_DEVICE_CLIPS`` (2048) after one full dispatch batch
   (``PIPELINE_DEVICE_WARM``, 512). Each route generates into a fresh
   directory (the JAX script's ``use_cache=False``).
3. **Featurize only**: clips/s of ``featurize_batch`` ("fused": K1 -> K2) on
   a card-resident batch of ``FEATURIZE_BATCH`` (2048) clips, the best of
   3 x ``FEATURIZE_ITERS`` (10) calls timed by CUDA events.
4. **Training steps**: steps/s of ``WakeWordTrainer.train_epoch`` at the
   reference's default batch (50 positive + 50 adversarial + 1000 negative
   rows) on seeded fake pools.

The extrapolation takes the better pipeline rate for all clips and the
training rate for 15,000 steps. ``--md PATH`` writes the report as text.
Everything runs on ``cuda`` unless ``--device cpu`` (the kernels' plain
versions; the tests rehearse it with the sizes above cut).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.tts import DEVICE_TTS_BATCH

__all__ = ["REF_SCALE", "time_tts", "time_pipeline", "time_featurize", "time_training", "extrapolate",
           "write_md", "main"]

PHRASE = "hey buddy"
REF_SCALE = {
    "positive": 100_000,
    "adversarial": 100_000,
    "validation": 25_000,
    "testing": 50_000,
    "steps": 15_000,  # 3 stages x 5000 (constants.py)
}
TTS_DEVICE_BATCH = DEVICE_TTS_BATCH
PIPELINE_DEVICE_CLIPS = 2048  # the fewest clips the fused route is timed on
PIPELINE_DEVICE_WARM = 512  # its warm-up: one full dispatch batch
FEATURIZE_BATCH = 2048
FEATURIZE_ITERS = 10


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_tts(n: int, seed: int, backend: str = "formant", batch_size: int = 8, device: DeviceLike = "cuda") -> float:
    """TTS clips/s through the production sample generator: ``n`` clips after one batch of warm-up."""
    from heybuddy_tpu_torch.data.tts_generator import SpeechSampleGenerator

    dev = resolve_device(device)
    gen = SpeechSampleGenerator(PHRASE, batch_size=batch_size, seed=seed, tts_backend=backend, device=dev)
    it = gen(n + batch_size)
    for _ in range(batch_size):  # warm (phonemizer, the device backend's first batch): not timed
        next(it)
    _sync(dev)
    t0 = time.perf_counter()
    count = sum(1 for _ in it)
    _sync(dev)
    return count / (time.perf_counter() - t0)


def time_pipeline(n: int, seed: int, backend: str = "formant", warm: int = 8, device: DeviceLike = "cuda") -> float:
    """
    TTS -> augment -> featurize -> store, the production path, in a fresh
    directory: ``n`` clips/s after ``warm`` clips (one full dispatch batch on
    the fused device route, or the timed window pays its first-batch costs).
    """
    from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
    from heybuddy_tpu_torch.utils.npy import AppendableNpyFile

    dev = resolve_device(device)
    directory = tempfile.mkdtemp(prefix=f"e2e-pipeline-{backend}-")
    try:
        gen = TrainingFeaturesGenerator(PHRASE, directory=directory, tts_backend=backend, seed=seed, device=dev)
        store = AppendableNpyFile(os.path.join(directory, f"e2e-probe-{backend}.npy"))
        gen.generate(warm, store=store, seed_offset=900000)
        _sync(dev)
        t0 = time.perf_counter()
        written = gen.generate(n, store=store, seed_offset=0)
        _sync(dev)
        return written / (time.perf_counter() - t0)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def time_featurize(batch: int, iters: int, device: DeviceLike = "cuda") -> float:
    """Featurization clips/s ("fused": K1 -> K2) on a device-resident batch: the best of 3 x ``iters`` calls."""
    from heybuddy_tpu_torch.constants import CLIP_SAMPLES
    from heybuddy_tpu_torch.convert import embedding_params_from_numpy
    from heybuddy_tpu_torch.models import embedding_net
    from heybuddy_tpu_torch.models.featurizer import featurize_batch
    from heybuddy_tpu_torch.utils.cuda_timing import elapsed_ms

    dev = resolve_device(device)
    net = embedding_params_from_numpy(embedding_net.default_params()).to(dev).eval()
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.normal(0.0, 1000.0, (batch, CLIP_SAMPLES)).astype(np.float32)).to(dev)
    with torch.no_grad():
        for _ in range(3):
            featurize_batch(net, audio)
        best_ms = min(elapsed_ms(lambda: featurize_batch(net, audio), iters, dev) for _ in range(3))
    return batch * iters / (best_ms / 1e3)


def time_training(steps: int, seed: int, tmpdir: str, device: DeviceLike = "cuda") -> float:
    """Trainer steps/s at the reference's default batch composition, on seeded fake pools."""
    from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator
    from heybuddy_tpu_torch.data.training import WakeWordTrainingDatasetIterator
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def fake(n: int) -> PrecalculatedDatasetIterator:
        return PrecalculatedDatasetIterator(
            "e2e", data=rng.normal(0, 1, (n, 16, 96)).astype(np.float32), seed=seed
        )

    training = WakeWordTrainingDatasetIterator(
        num_batch_threads=1,
        positive=[(fake(2000), 50)],
        negative=[(fake(2000), 50), (fake(4000), 1000)],
    )
    trainer = WakeWordTrainer(checkpoint_dir=tmpdir, seed=seed, device=dev)
    t0 = time.perf_counter()
    trainer.train_epoch(
        training, num_steps=steps, validation_steps=steps + 1,
        checkpoint_steps=steps + 1, logging_steps=max(steps // 3, 1),
        name="e2e-bench",
    )
    _sync(dev)
    dt = time.perf_counter() - t0
    training.stop()
    return steps / dt


def extrapolate(results: Dict) -> Dict:
    """The JAX script's extrapolation of the measured rates to ``REF_SCALE``."""
    total_clips = sum(v for k, v in REF_SCALE.items() if k != "steps")
    best_pipeline = max(results["pipeline_clips_per_s"], results["pipeline_device_clips_per_s"])
    gen_s = total_clips / best_pipeline
    train_s = REF_SCALE["steps"] / results["train_steps_per_s"]
    return {
        "total_clips": total_clips,
        "pipeline_clips_per_s": best_pipeline,
        "feature_generation_s": round(gen_s, 0),
        "training_s": round(train_s, 0),
        "end_to_end_s": round(gen_s + train_s, 0),
        "end_to_end_h": round((gen_s + train_s) / 3600.0, 2),
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--clips", type=int, default=512, help="clips for the TTS/pipeline probes")
    p.add_argument("--train-steps", type=int, default=300)
    p.add_argument("--json", default=None)
    p.add_argument("--md", default=None, help="write the report as text here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("HEYBUDDY_OFFLINE", "1")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from heybuddy_tpu_torch.utils.cuda_timing import nvidia_smi_line

        card = nvidia_smi_line()
    else:
        card = "cpu"
    results: Dict = {}
    t_all = time.perf_counter()
    results["tts_clips_per_s"] = round(time_tts(args.clips, args.seed, device=dev), 2)
    print(f"TTS (host): {results['tts_clips_per_s']} clips/s")
    results["tts_device_clips_per_s"] = round(
        time_tts(args.clips, args.seed, backend="formant-device", batch_size=TTS_DEVICE_BATCH, device=dev), 2)
    print(f"TTS (formant-device): {results['tts_device_clips_per_s']} clips/s")
    results["pipeline_clips_per_s"] = round(time_pipeline(args.clips, args.seed, device=dev), 2)
    print(f"pipeline (TTS+augment+featurize): {results['pipeline_clips_per_s']} clips/s")
    results["pipeline_device_clips_per_s"] = round(
        time_pipeline(max(args.clips, PIPELINE_DEVICE_CLIPS), args.seed, backend="formant-device",
                      warm=PIPELINE_DEVICE_WARM, device=dev), 2)
    print(f"pipeline (device TTS): {results['pipeline_device_clips_per_s']} clips/s")
    results["featurize_clips_per_s"] = round(time_featurize(FEATURIZE_BATCH, FEATURIZE_ITERS, dev), 0)
    print(f"featurize only (device): {results['featurize_clips_per_s']} clips/s")
    tmpdir = tempfile.mkdtemp(prefix="e2e-bench-")
    try:
        results["train_steps_per_s"] = round(time_training(args.train_steps, args.seed, tmpdir, dev), 2)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    print(f"training (50+50+1000 batch): {results['train_steps_per_s']} steps/s")
    results["probe_wall_s"] = round(time.perf_counter() - t_all, 1)
    results["extrapolated"] = extrapolate(results)
    results["device"] = card
    print(json.dumps(results, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    if args.md:
        write_md(args.md, results, args)
    return 0


def write_md(path: str, r: Dict, args: argparse.Namespace) -> None:
    """The report: the measured stage rates and the extrapolation, beside the card they ran on."""
    e = r["extrapolated"]
    body = f"""# `train` wall clock of the PyTorch / CUDA port (measured + extrapolated)

North star: finish `train "hey buddy"` at the reference's default scale:
100k positive + 100k adversarial + 25k validation + 50k testing TTS clips,
3 stages x 5,000 steps. Measured on {r['device']} (`nvidia-smi`: name,
power limit) by `python -m heybuddy_tpu_torch.tools.end_to_end_bench
--clips {args.clips} --train-steps {args.train_steps}`.

## Measured stage rates ({time.strftime('%Y-%m-%d')})

| Stage | Rate | Notes |
|---|---|---|
| TTS synthesis (host, formant) | {r['tts_clips_per_s']} clips/s | the host numpy renderer |
| TTS synthesis (formant-device) | {r['tts_device_clips_per_s']} clips/s | host plans, the card renders |
| TTS -> augment -> featurize pipeline (host TTS) | {r['pipeline_clips_per_s']} clips/s | the host route |
| TTS -> augment -> featurize pipeline (device TTS) | {r['pipeline_device_clips_per_s']} clips/s | the fused route (formant-device) |
| featurize only (K1 -> K2) | {r['featurize_clips_per_s']:.0f} clips/s | a device-resident batch of {FEATURIZE_BATCH} |
| training steps (50+50+1000 batch) | {r['train_steps_per_s']} steps/s | `WakeWordTrainer.train_epoch` |

## Extrapolation to the reference default scale

Using the best measured pipeline rate ({e['pipeline_clips_per_s']} clips/s):

| Phase | Time |
|---|---|
| feature generation ({e['total_clips']:,} clips) | {e['feature_generation_s']:.0f} s |
| training ({REF_SCALE['steps']:,} steps) | {e['training_s']:.0f} s |
| **end-to-end** | **{e['end_to_end_s']:.0f} s ({e['end_to_end_h']} h)** |

Each stage ran alone, so the extrapolation assumes no overlap between
generation and training, as `train` runs them.
"""
    with open(path, "w") as f:
        f.write(body)
    print(f"wrote {path}")


if __name__ == "__main__":
    raise SystemExit(main())
