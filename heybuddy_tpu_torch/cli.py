"""
Command line of the port (argparse):

    python -m heybuddy_tpu_torch predict CHECKPOINT AUDIO [--threshold T] [--device cuda|cpu]

``predict`` prints the wake-word timecodes found in AUDIO (a WAV file), one
line each, or "No wake words detected.", as the JAX package's ``heybuddy
predict`` does.
"""

from __future__ import annotations

import argparse
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


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "predict":
        return _predict(args)
    raise AssertionError(args.command)
