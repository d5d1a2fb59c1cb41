"""The wake-word trainer's step, stage schedule and Adam, written out again.

One step: dropout on the input rows; predictions clipped to [1e-7, 1 - 1e-7];
the hard examples are the negatives scoring >= 1e-4 and the positives
scoring < 1 - 1e-4; the BCE over them, negatives weighted by the negative
weight, is averaged over max(n_hard, 1) and divided by the accumulation
counter. The optimizer fires when the accumulated plus the current hard
count reaches 128 and the batch has a hard example, and then applies this
batch's gradient alone: Adam (0.9, 0.999, eps 1e-8 outside the root, bias
corrections counting fired steps) scaled by the step's learning rate. The
rate follows a linear warm-up over a fifth of the stage, a hold at the
target for a third, then a half cosine.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hbbench.reference.heads import dropout

B1, B2, EPS = 0.9, 0.999, 1e-8
HIGH_LOSS = 1e-4
ACCUMULATION = 128


def learning_rate(step: int, total: int, target: float = 1e-3) -> float:
    warmup, hold = total // 5, total // 3
    denom = max(float(total - warmup - hold), 1.0)
    lr = 0.5 * target * (1.0 + np.cos(np.pi * (step - warmup - hold) / denom))
    if hold > 0 and step <= warmup + hold:
        lr = target
    return float(target * step / warmup if step < warmup else lr)


class Reference:
    """The parameters (a dict of float32 leaves), Adam's moments and the
    accumulation carry; from the initial parameters, or from a state
    (``mu`` / ``nu`` leaves, fired ``count``, ``accum_samples`` / ``accum_steps``).
    ``grads`` holds the last step's gradient."""

    def __init__(self, params: Dict[str, torch.Tensor], state: Optional[Dict[str, Any]] = None) -> None:
        self.params = {k: v.detach().clone() for k, v in params.items()}
        state = state or {}
        self.mu = {k: state["mu"][k].clone() if "mu" in state else torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: state["nu"][k].clone() if "nu" in state else torch.zeros_like(v) for k, v in self.params.items()}
        self.count = int(state.get("count", 0))
        self.accum_samples = int(state.get("accum_samples", 0))
        self.accum_steps = int(state.get("accum_steps", 1))
        self.grads: Dict[str, torch.Tensor] = {}
        self.n_hard = 0

    def step(self, forward: Callable, x: torch.Tensor, y: torch.Tensor, lr: float, neg_weight: float,
             generator: torch.Generator, rate: float) -> Tuple[float, bool]:
        """One step; returns (loss, fired)."""
        leaves = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
        preds = forward(leaves, dropout(x, rate, generator)).clamp(1e-7, 1.0 - 1e-7)
        hard = ((y == 0) & (preds >= HIGH_LOSS)) | ((y == 1) & (preds < 1.0 - HIGH_LOSS))
        mask = hard.float()
        n_hard = int(hard.sum().item())
        self.n_hard = n_hard
        weights = torch.where(y == 1, 1.0, neg_weight) * mask
        bce = -(y * torch.log(preds) + (1.0 - y) * torch.log(1.0 - preds))
        loss = (weights * bce).sum() / max(n_hard, 1) / self.accum_steps
        names: List[str] = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        self.grads = {n: g.detach() for n, g in grads.items()}
        total = self.accum_samples + n_hard
        fire = total >= ACCUMULATION and n_hard > 0
        if fire:
            self.count += 1
            bc1 = 1.0 - B1 ** self.count
            bc2 = 1.0 - B2 ** self.count
            for n in names:
                g = grads[n].detach()
                self.mu[n] = B1 * self.mu[n] + (1.0 - B1) * g
                self.nu[n] = B2 * self.nu[n] + (1.0 - B2) * g * g
                self.params[n] = self.params[n] - (lr / bc1) * self.mu[n] / (
                    torch.sqrt(self.nu[n]) / np.sqrt(bc2) + EPS)
            self.accum_samples, self.accum_steps = 0, 1
        else:
            self.accum_samples = total
            self.accum_steps += int(n_hard > 0)
        return float(loss.item()), fire
