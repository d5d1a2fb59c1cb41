"""
End-to-end wake-word training through the port's public API.

    python -m heybuddy_tpu_torch.examples.train_wake_word [--checkpoint-dir ./checkpoints]
        [--dataset-dir DIR] [--positive-samples 256] [--adversarial-samples 256]
        [--validation-samples 64] [--steps 300] [--stages 2] [--audio file.wav]
        [--device cpu | --cpu]

The counterpart of the JAX package's ``examples/train_wake_word.py``: its
counts as the defaults, its phrase, batch sizes and schedule as constants.
It builds the training and validation iterators (feature generation,
TTS -> augmentation -> featurization, runs lazily and is
cached under the dataset directory), trains with ``WakeWordTrainer`` and its
dynamic false-positive control, exports the final checkpoint to ONNX for
the browser runtime and, given ``--audio``, prints the detection times in
that file. Runs offline at toy scale; scale the counts up for a real model,
or use the CLI: ``python -m heybuddy_tpu_torch train "hey computer"``.
Everything runs on ``cuda`` unless ``--device cpu`` (or ``--cpu``) is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from heybuddy_tpu_torch.device import resolve_device

__all__ = ["parse_args", "main"]

PHRASE = "hey computer"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", default="./checkpoints")
    p.add_argument("--dataset-dir", default=None, help="feature cache directory (default: HEYBUDDY_DATASET_DIR)")
    p.add_argument("--positive-samples", type=int, default=256)
    p.add_argument("--adversarial-samples", type=int, default=256)
    p.add_argument("--validation-samples", type=int, default=64)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--audio", default=None, help="a wav file to detect the phrase in")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    from heybuddy_tpu_torch import WakeWordTrainer, WakeWordTrainingDatasetIterator, load_model

    features = {"device": device}
    if args.dataset_dir:
        features["directory"] = args.dataset_dir

    # 1. Training and validation iterators; the hosted negative set is optional offline
    training = WakeWordTrainingDatasetIterator.default(
        PHRASE,
        positive_samples=args.positive_samples,
        adversarial_samples=args.adversarial_samples,
        adversarial_phrases=16,
        positive_batch_size=32,
        adversarial_batch_size=32,
        negative_batch_size=0,
        num_batch_threads=2,
        **features,
    )
    validation = WakeWordTrainingDatasetIterator.validation(
        PHRASE, validation_samples=args.validation_samples, positive_batch_size=32,
        negative_batch_size=0, **features,
    )

    # 2. Train in stages with dynamic false-positive control
    name = PHRASE.replace(" ", "-")
    trainer = WakeWordTrainer(checkpoint_dir=args.checkpoint_dir, device=device)
    trainer(
        training,
        validation=validation,
        num_steps=args.steps,
        num_stages=args.stages,
        validation_steps=100,
        checkpoint_steps=10_000,
        name=name,
    )

    # 3. Export for the browser runtime
    final = os.path.join(args.checkpoint_dir, f"{name}_final.npz")
    model = load_model(final, device=device)
    onnx_path = final.replace(".npz", ".onnx")
    model.save_onnx(onnx_path)
    print("exported", onnx_path)

    # 4. Detect in a file
    times = model.predict_timecodes(args.audio) if args.audio and os.path.exists(args.audio) else []
    print("detections:", times)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
