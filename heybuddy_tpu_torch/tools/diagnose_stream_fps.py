"""
Attribute sliding-window stream false positives to the phrases under them.

    python -m heybuddy_tpu_torch.tools.diagnose_stream_fps --checkpoint ckpt.npz
        [--embedding emb.npz] [--phrase "hey buddy"] [--threshold 0.5] [--minutes 15]
        [--seed 31] [--out fps.json] [--device cpu | --cpu]

The counterpart of the JAX package's ``scripts/diagnose_stream_fps.py``, with
its arguments, its printed lines and its JSON. It rebuilds the quality
harness's speech stream (``data/streams.synth_speech_stream``, the same
seeds and audio as the JAX package's), scores every runtime window position
with a trained checkpoint (``WakeWordMLPModel.from_file``) and lists, for
each window at or above the threshold, the phrases whose rendered span
overlaps it. That separates the two failure modes a bare fp/hour number
hides:

* SPECIFIC collisions: a handful of phrases account for most false
  positives (fix: adversarial or mined coverage of those phrases), vs
* DIFFUSE overlap: they scatter across unrelated phrases (fix: a stronger
  embedding or classifier).

Scoring is ``tools/quality_eval.sliding_scores``: one upload a 1024-window
segment, K1 on its row-strided window view, K2 and the head on the card.
``--embedding`` sets ``HEYBUDDY_EMBEDDING_WEIGHTS`` and the tool builds a
featurizer of its own, so a shared one built earlier in the process cannot
shadow the candidate. ``--cpu`` (or ``--device cpu``) runs the kernels'
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from heybuddy_tpu_torch.constants import CLIP_SAMPLES, SAMPLE_RATE
from heybuddy_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["parse_args", "stream_and_schedule", "attribute", "report_lines", "main"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--embedding", default=None)
    p.add_argument("--phrase", default="hey buddy")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--minutes", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=31, help="stream seed (harness: args.seed + 31)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def stream_and_schedule(minutes: float, seed: int, phrase: str,
                        device: DeviceLike = "cuda") -> Tuple[np.ndarray, List[Tuple[int, int, str]]]:
    """The harness's speech stream without ``phrase``'s words, and its
    schedule of ``(start, end, text)`` sample spans (formant TTS)."""
    from heybuddy_tpu_torch.data.streams import synth_speech_stream

    return synth_speech_stream(minutes, seed, exclude_phrase=phrase, tts_backend="formant",
                               return_schedule=True, device=device)


def attribute(scores: np.ndarray, schedule: Sequence[Tuple[int, int, str]],
              threshold: float) -> Tuple[np.ndarray, List[Dict], collections.Counter]:
    """(indices of the windows at or above ``threshold``, one row a hit with
    its time, score and covering phrases, the count of hits under each phrase)."""
    from heybuddy_tpu_torch.data.streams import RUNTIME_WINDOW_STRIDE

    def covering(start: int, end: int) -> List[str]:
        return [t for (s, e, t) in schedule if s < end and e > start]

    hits = np.flatnonzero(scores >= threshold)
    by_phrase: collections.Counter = collections.Counter()
    rows = []
    for idx in hits:
        s = int(idx) * RUNTIME_WINDOW_STRIDE
        phrases = covering(s, s + CLIP_SAMPLES)
        rows.append({"t": round(s / float(SAMPLE_RATE), 2), "score": round(float(scores[idx]), 4),
                     "phrases": phrases})
        for ph in phrases:
            by_phrase[ph] += 1
    return hits, rows, by_phrase


def report_lines(n_hits: int, n_windows: int, minutes: float, threshold: float,
                 by_phrase: collections.Counter) -> List[str]:
    """The JAX script's printed report: the hit count, the top 15 phrases,
    the top-3 share and the SPECIFIC / DIFFUSE verdict."""
    lines = [f"{n_hits} above-threshold windows / {n_windows} total ({minutes:.0f} min, thr={threshold})",
             "\nTop phrases under FP windows:"]
    for ph, c in by_phrase.most_common(15):
        lines.append(f"  {c:4d}  {ph!r}")
    uniq = len(by_phrase)
    top3 = sum(c for _, c in by_phrase.most_common(3))
    total_attr = sum(by_phrase.values())
    verdict = "SPECIFIC collisions" if total_attr and top3 / total_attr > 0.5 else "DIFFUSE overlap"
    lines.append(f"\n{uniq} distinct phrases; top-3 cover {top3}/{total_attr} attributions ({verdict})")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.embedding:
        os.environ["HEYBUDDY_EMBEDDING_WEIGHTS"] = os.path.abspath(args.embedding)
    os.environ.setdefault("HEYBUDDY_OFFLINE", "1")
    device = resolve_device("cpu" if args.cpu else args.device)

    from heybuddy_tpu_torch.data.streams import stream_window_count
    from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings
    from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel
    from heybuddy_tpu_torch.tools.quality_eval import sliding_scores

    # the SAME stream distribution the training negatives and fp/hour use
    stream, schedule = stream_and_schedule(args.minutes, args.seed, args.phrase, device)
    model = WakeWordMLPModel.from_file(args.checkpoint, device=device)
    emb = SpeechEmbeddings(device=device)  # reads HEYBUDDY_EMBEDDING_WEIGHTS now
    scores = sliding_scores(model, stream, device=device, emb=emb)
    hits, rows, by_phrase = attribute(scores, schedule, args.threshold)
    print("\n".join(report_lines(len(hits), stream_window_count(stream), args.minutes, args.threshold, by_phrase)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"hits": rows, "by_phrase": dict(by_phrase)}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
