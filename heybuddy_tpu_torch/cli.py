"""
Command line of the port (argparse):

    python -m heybuddy_tpu_torch predict CHECKPOINT AUDIO [--threshold T] [--device cuda|cpu]
    python -m heybuddy_tpu_torch extract NAME SOURCE [--local-files] [--directory D]
        [--samples-per-file N] [--process-batch-size N] [--tokenizer-max-length N]
        [--hours H] [--device cuda|cpu] [Hugging Face dataset options]

``predict`` prints the wake-word timecodes found in AUDIO (a WAV file), one
line each, or "No wake words detected.", as the JAX package's ``heybuddy
predict`` does. ``extract`` writes labeled negative-feature shards
``NAME-<i>.npy`` ([n, 17, 96] float32) from SOURCE, a Hugging Face dataset id
or, with ``--local-files``, a glob of WAV files with sidecar ``.txt``
transcripts, and prints "Wrote N shard(s):" and their paths, as ``heybuddy
extract`` does. Its multi-device ``--mesh`` option is not ported.
"""

from __future__ import annotations

import argparse
import glob
import sys
from typing import List, Optional

from heybuddy_tpu_torch.constants import DEFAULT_ACTIVATION_THRESHOLD

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="heybuddy_tpu_torch", description="heybuddy wake-word tools (PyTorch / CUDA port)"
    )
    commands = parser.add_subparsers(dest="command", required=True)
    predict = commands.add_parser("predict", help="print wake-word timecodes found in AUDIO")
    predict.add_argument("checkpoint", help="wake-word checkpoint (.npz)")
    predict.add_argument("audio", help="audio file (.wav)")
    predict.add_argument("--threshold", type=float, default=DEFAULT_ACTIVATION_THRESHOLD)
    predict.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    extract = commands.add_parser(
        "extract", help="extract labeled negative-feature shards from an audio dataset"
    )
    extract.add_argument("name", help="shard name prefix")
    extract.add_argument("source", help="Hugging Face dataset id, or a glob with --local-files")
    extract.add_argument("--directory", default=None, help="directory to save the shards to")
    extract.add_argument("--local-files", action="store_true",
                         help="treat SOURCE as a glob of local wav files")
    extract.add_argument("--hours", type=float, default=1000.0)
    extract.add_argument("--samples-per-file", type=int, default=10000)
    extract.add_argument("--process-batch-size", type=int, default=100)
    extract.add_argument("--tokenizer-max-length", type=int, default=96)
    extract.add_argument("--config", default=None, help="dataset configuration name")
    extract.add_argument("--split", default="train")
    extract.add_argument("--audio-key", default="audio")
    extract.add_argument("--audio-array-key", default="array")
    extract.add_argument("--audio-sample-rate-key", default="sampling_rate")
    extract.add_argument("--transcript-key", default="transcript")
    extract.add_argument("--streaming", action=argparse.BooleanOptionalAction, default=True)
    extract.add_argument("--trust-remote-code", action=argparse.BooleanOptionalAction,
                         default=False)
    extract.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def _predict(args: argparse.Namespace) -> int:
    from heybuddy_tpu_torch.models.wakeword import load_model

    model = load_model(args.checkpoint, device=args.device)
    times = model.predict_timecodes(args.audio, threshold=args.threshold)
    if not times:
        print("No wake words detected.")
    for t in times:
        print(f"Wake word detected at {t:.1f}s")
    return 0


def _extract(args: argparse.Namespace) -> int:
    from heybuddy_tpu_torch.data.extract import (
        LabeledFeatureExtractor,
        get_default_dataset_dir,
        iter_hf_dataset,
        iter_wav_files,
    )

    extractor = LabeledFeatureExtractor(
        directory=args.directory or get_default_dataset_dir(),
        name=args.name,
        samples_per_file=args.samples_per_file,
        process_batch_size=args.process_batch_size,
        tokenizer_max_length=args.tokenizer_max_length,
        device=args.device,
    )
    if args.local_files:
        source = iter_wav_files(sorted(glob.glob(args.source)))
    else:
        source = iter_hf_dataset(
            args.source,
            config=args.config,
            split=args.split,
            streaming=args.streaming,
            audio_key=args.audio_key,
            audio_array_key=args.audio_array_key,
            audio_sample_rate_key=args.audio_sample_rate_key,
            transcript_key=args.transcript_key,
            trust_remote_code=args.trust_remote_code,
        )
    paths = extractor(source, max_hours=args.hours)
    print(f"Wrote {len(paths)} shard(s):")
    for path in paths:
        print(f"  {path}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "predict":
        return _predict(args)
    if args.command == "extract":
        return _extract(args)
    raise AssertionError(args.command)
