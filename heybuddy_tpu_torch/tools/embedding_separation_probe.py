"""
Embedding-space probe: does a candidate embedding separate the wake phrase
from its swap-collision family better than the bundled one?

    python -m heybuddy_tpu_torch.tools.embedding_separation_probe [--augment] [cand.npz ...]
        [--swaps 24] [--per-text 4] [--phrase-renders 48] [--device cpu | --cpu]

The counterpart of the JAX package's ``scripts/embedding_separation_probe.py``,
with its arguments, its phrase (``HEYBUDDY_PROBE_PHRASE``, default "hey
buddy") and its printed line a candidate. It renders clips of the phrase
(12 renders for each of ``--per-text``) and of held-out-style swap texts
(single and double swaps, ``single_swap_collision_texts(phrase, 24,
seed=31337, max_swaps=2)``, a seed apart from every training pool) with the
host formant synthesizer (bit-equal to the JAX package's renders),
mean-pools each clip's (16, 96) features over its windows, L2-normalizes,
and reports:

* phrase<->phrase cosine (same text, other speakers): invariance, keep HIGH;
* phrase<->swap cosine, the mean and the nearest swap per phrase clip: the
  collision family, want LOW;
* the margin between phrase<->phrase and the nearest swap.

With no candidate it probes only the bundled embedding. The features come
from ``SpeechEmbeddings(params=embedding_net.load_params(cand))`` on the
card (K1 -> K2 a call). ``--augment`` first passes every rendered clip
through the production augmentation chain (``ops/augment.augment_batch``
with ``NoiseProvider`` banks), its draws from ``seeded_generator(device,
seed)``: the distribution FAR_adv is measured on. A margin that holds clean
but collapses augmented says the confusion is acoustic, not
representational. ``--swaps``, ``--per-text`` and ``--phrase-renders`` cut
the sizes (the defaults are the JAX script's). ``--cpu`` (or ``--device
cpu``) runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from heybuddy_tpu_torch.constants import CLIP_SAMPLES
from heybuddy_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["parse_args", "swap_texts", "render_pool", "pooled", "augment", "separation", "main"]

SWAP_SEED = 31337  # shared by no training pool: the swaps stand in for an unseen family
PHRASE_SEED, SWAP_RENDER_SEED = 7, 11
AUGMENT_SEEDS = (5, 6)  # phrase clips, swap clips


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("candidates", nargs="*", help="candidate embedding .npz files (the bundled one is always probed)")
    p.add_argument("--augment", action="store_true", help="augment every clip before featurizing")
    p.add_argument("--swaps", type=int, default=24, help="swap-collision texts")
    p.add_argument("--per-text", type=int, default=4, help="renders of each swap text")
    p.add_argument("--phrase-renders", type=int, default=None, help="renders of the phrase (default 12 x --per-text)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def swap_texts(phrase: str, n: int = 24) -> List[str]:
    """The held-out-style single and double swaps of ``phrase``."""
    from heybuddy_tpu_torch.text.adversarial import single_swap_collision_texts

    return single_swap_collision_texts(phrase, num_samples=n, seed=SWAP_SEED, max_swaps=2)


def render_pool(texts: Sequence[str], per_text: int, seed: int) -> np.ndarray:
    """(len(texts) * per_text, 23040) float32 formant renders in [-1, 1], a
    seeded speaker each, zero-padded or cut to the clip length."""
    from heybuddy_tpu_torch.models.formant import FormantSynthesizer

    synth = FormantSynthesizer()
    rng = np.random.default_rng(seed)
    clips = []
    for text in texts:
        for _ in range(per_text):
            audio = synth.synthesize(text, speaker=int(rng.integers(0, 200)))
            padded = np.zeros(CLIP_SAMPLES, dtype=np.float32)
            padded[: min(len(audio), CLIP_SAMPLES)] = audio[:CLIP_SAMPLES]
            clips.append(padded)
    return np.stack(clips)


def pooled(weights: Optional[str], audio: np.ndarray, device: DeviceLike = "cuda") -> np.ndarray:
    """(n, 23040) audio -> (n, 96) L2-normalized mean-pooled embeddings of the
    embedding at ``weights`` (None: the default one)."""
    from heybuddy_tpu_torch.models import embedding_net
    from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings

    params = embedding_net.load_params(weights) if weights else None
    feats = SpeechEmbeddings(params=params, device=device)(audio)  # (n, 16, 96)
    mean = feats.mean(axis=1)
    return mean / (np.linalg.norm(mean, axis=1, keepdims=True) + 1e-9)


def augment(audio: np.ndarray, seed: int = 5, device: DeviceLike = "cuda",
            draws: Optional[Dict[str, torch.Tensor]] = None) -> np.ndarray:
    """Clips through the production augmentation chain on ``device``, as
    the JAX script passes them (divided by 32768, the chain, times 32768):
    ``NoiseProvider(seed)``'s banks, the draws from ``seeded_generator(device,
    seed)`` unless ``draws`` are given."""
    from heybuddy_tpu_torch.data.augmented import NoiseProvider
    from heybuddy_tpu_torch.ops.augment import AugmentConfig, augment_batch, draw_augment, seeded_generator

    dev = resolve_device(device)
    cfg = AugmentConfig()
    noise = NoiseProvider(seed=seed)
    b, t = audio.shape
    lengths = torch.full((b,), t, dtype=torch.int64, device=dev)
    if draws is None:
        draws = draw_augment(seeded_generator(dev, seed), b, t, cfg, dev)
    x = torch.from_numpy(audio.astype(np.float32) / 32768.0).to(dev)
    out = augment_batch(x, lengths, torch.from_numpy(noise.noise_batch(b, t)).to(dev),
                        torch.from_numpy(noise.impulse_batch(b)).to(dev), cfg,
                        draws={k: v.to(dev) for k, v in draws.items()})
    return out.cpu().numpy().astype(np.float32) * 32768.0


def separation(pos: np.ndarray, neg: np.ndarray) -> Dict[str, float]:
    """The probe's cosines of unit phrase rows ``pos`` and swap rows ``neg``."""
    pp = pos @ pos.T
    iu = np.triu_indices_from(pp, k=1)
    phrase_phrase = float(pp[iu].mean())
    phrase_swap_all = pos @ neg.T
    # the nearest swap is what the head's decision boundary fights
    nearest = float(phrase_swap_all.max(axis=0).mean())
    return {"phrase_phrase_cosine": phrase_phrase, "phrase_swap_cosine_mean": float(phrase_swap_all.mean()),
            "phrase_swap_cosine_nearest": nearest, "margin": phrase_phrase - nearest}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("HEYBUDDY_OFFLINE", "1")
    device = resolve_device("cpu" if args.cpu else args.device)
    phrase = os.environ.get("HEYBUDDY_PROBE_PHRASE", "hey buddy")
    swaps = swap_texts(phrase, args.swaps)
    phrase_renders = args.phrase_renders if args.phrase_renders is not None else args.per_text * 12
    pos_audio = render_pool([phrase], phrase_renders, seed=PHRASE_SEED)
    swap_audio = render_pool(swaps, args.per_text, seed=SWAP_RENDER_SEED)
    if args.augment:
        pos_audio = augment(pos_audio, AUGMENT_SEEDS[0], device)
        swap_audio = augment(swap_audio, AUGMENT_SEEDS[1], device)
    for cand in [None] + list(args.candidates):
        s = separation(pooled(cand, pos_audio, device), pooled(cand, swap_audio, device))
        print(
            f"{cand or 'bundled-default'}: phrase<->phrase {s['phrase_phrase_cosine']:.4f}, "
            f"phrase<->swap mean {s['phrase_swap_cosine_mean']:.4f} / nearest "
            f"{s['phrase_swap_cosine_nearest']:.4f}, margin {s['margin']:.4f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
