"""
Train the neural G2P by distillation and report its held-out golden accuracy.

    python -m heybuddy_tpu_torch.tools.train_neural_g2p [-o g2p-neural.npz] [--steps 6000]
        [--dim 128] [--layers 2] [--lr 3e-4] [--seed 0] [--heldout-every 4]
        [--cmudict-sample 20000] [--json metrics.json] [--device cpu | --cpu]

The counterpart of the JAX package's ``scripts/train_neural_g2p.py``, with its
arguments, its log lines, its checkpoint and its metrics JSON. The training
table, in priority order:

* the golden lexicon (``tools/g2p_accuracy.GOLDEN``, stress-stripped CMUdict
  truth) minus a held-out split (every ``--heldout-every``-th word in
  sorted order),
* a seeded sample of a full CMU dictionary when ``HEYBUDDY_CMUDICT`` points
  at one,
* the rule engine's silver labels over ``text/wordlist.WORDS``.

The held-out words are never trained on, so the reported word and phone
accuracy measure generalization to unseen words. Training is
``text/neural_g2p.train_neural_g2p`` on ``--device``: the card by default,
like every entry point of the port (the JAX script trains on the CPU unless
``--tpu``; ``--device cpu`` or ``--cpu`` is its counterpart here). The
checkpoint loads in either package.
"""

from __future__ import annotations

import argparse
import json
import random
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from heybuddy_tpu_torch.device import resolve_device
from heybuddy_tpu_torch.text.neural_g2p import NeuralG2P, train_neural_g2p
from heybuddy_tpu_torch.tools.g2p_accuracy import GOLDEN, edit_distance
from heybuddy_tpu_torch.utils.log import logger

__all__ = ["parse_args", "training_table", "score", "main"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--out", default="g2p-neural.npz")
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--heldout-every", type=int, default=4, help="hold out every Nth golden word for eval")
    p.add_argument("--cmudict-sample", type=int, default=20000, help="max CMUdict entries to add when available")
    p.add_argument("--json", default=None, help="write metrics JSON here")
    p.add_argument("--cpu", action="store_true", help="train on the CPU")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def training_table(
    heldout_every: int = 4, cmudict_sample: int = 20000, seed: int = 0,
    cmu: Optional[Dict[str, List[str]]] = None,
) -> Tuple[List[Tuple[str, str]], Dict[str, str], Dict[str, List[str]]]:
    """(the sorted golden pairs, the held-out golden words -> phones, the
    training table word -> phone list), in the JAX script's order: golden
    minus the held-out words, then the CMUdict sample (``cmu``), then the
    rule engine's labels of the word list for words not yet in the table."""
    from heybuddy_tpu_torch.text.phonemizer import SimplePhonemizer
    from heybuddy_tpu_torch.text.wordlist import WORDS

    golden = sorted(GOLDEN.items())
    heldout = dict(golden[::heldout_every])
    table = {w: ph.split() for w, ph in golden if w not in heldout}
    if cmu:
        rng = random.Random(seed)
        words = [w for w in cmu if w not in heldout and w.isalpha()]
        for w in rng.sample(words, min(cmudict_sample, len(words))):
            table.setdefault(w, [ph.rstrip("012") for ph in cmu[w]])
        logger.info(f"CMUdict available: training table {len(table)} words")
    rule = SimplePhonemizer(use_cmudict=False)
    for w in WORDS:
        if w not in heldout:
            table.setdefault(w, re.findall(r"\[([A-Z]+)\]", rule(w)))
    return golden, heldout, table


def score(model: NeuralG2P, params: Any, pairs: Dict[str, Any]) -> Dict[str, Any]:
    """Word accuracy and phone error rate of the model's decoding of ``pairs``' words."""
    words = sorted(pairs)
    preds = model.decode(params, words)
    exact, dist, total = 0, 0, 0
    for w, pred in zip(words, preds):
        truth = pairs[w].split() if isinstance(pairs[w], str) else pairs[w]
        exact += pred == truth
        dist += edit_distance(pred, truth)
        total += len(truth)
    return {
        "words": len(words),
        "word_accuracy": round(exact / max(len(words), 1), 4),
        "phone_error_rate": round(dist / max(total, 1), 4),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    from heybuddy_tpu_torch.text.phonemizer import load_cmudict

    cmu = load_cmudict()
    golden, heldout, table = training_table(args.heldout_every, args.cmudict_sample, args.seed, cmu)
    logger.info(
        f"training on {len(table)} words "
        f"({len(golden) - len(heldout)} golden + silver), "
        f"holding out {len(heldout)} golden words"
    )
    model, params = train_neural_g2p(
        table, steps=args.steps, lr=args.lr, seed=args.seed,
        model=NeuralG2P(dim=args.dim, layers=args.layers),
        log_every=max(args.steps // 10, 1), device=device,
    )
    train_golden = {w: ph for w, ph in golden if w not in heldout}
    metrics = {
        "train_golden": score(model, params, train_golden),
        "heldout_golden": score(model, params, heldout),
        "config": model.config,
        "steps": args.steps,
        "table_words": len(table),
        "cmudict": bool(cmu),
    }
    logger.info(f"train-golden: {metrics['train_golden']}")
    logger.info(f"heldout-golden: {metrics['heldout_golden']}")
    model.save(params, args.out)
    logger.info(f"saved {args.out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
