"""
Kind ``trainloop``: stage-1 steps of ``WakeWordTrainer`` on device-resident
feature pools.

Set-up makes the pools from the seed (positive, adversarial, negative and
the two validation pools, float32 (16, 96) rows), builds the trainer with
the configuration's head, loads the benchmark's seeded parameters into it
and drives it through its first ``check_steps`` steps by ``train_epoch``
(the window's own call and feed: each step gathers its rows on the device
by the trainer's index draws), with an evaluation, which warms every shape
the window uses. That same trainer then runs the window: one stage of
``stage_steps`` steps, the validation pools scored every
``validation_steps`` steps and the negative weight adjusted as ``train``
does; it ends at the first log boundary (every ``validation_steps`` steps)
after ``--seconds`` once the window's checked steps and an evaluation are
done. ``train_eval_rows_per_s`` is the validation rows that the window's
evaluations scored over their seconds (each timed from the end of the steps
dispatched before it to its counts on the host); ``steps_per_s`` (a per-layer
metric) is the steps completed over the window's seconds, evaluations
included.

The check follows two stretches of steps with the reference. The start:
set-up's first ``check_steps`` steps from the seeded parameters, with the
reference's own learning rates (the set-up stage's schedule), dropout
stream and negative weight. The window: ``check_steps`` steps from a step
``k`` of the window's stage drawn from the seed in ``check_window_steps``
(more, up to ``check_cap``, until one of them fires the optimizer), from
the program's state before step ``k`` (parameters, Adam's moments and
count, the accumulation carry) with the reference's own learning rates of
the stage's schedule and its own dropout stream advanced by ``k`` steps;
the negative weight, which the window's evaluations set, is the program's.
Both take the trainer's index draws as the rows (checked to be distinct
within a pass) and give each step's loss, the first fired step's gradient
leaf by leaf (from Adam's first moment before and after it) and the norm of
each leaf's change over the stretch; the cell's limits name the numbers
compared (the window's by its median leaf and its first step's loss, since
a trained state's worst leaf swings with rounding).
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hbbench import weights
from hbbench.reference import heads as rheads
from hbbench.reference import trainstep
from hbbench.traffic import common

ROW = (16, 96)
SOURCES = ("positive", "adversarial", "negative")


def _leaf_order(names: List[str]) -> List[str]:
    """The order of the trainer's flat buffer (and of its optimizer leaves):
    names sorted with their integer parts compared as integers."""
    return sorted(names, key=lambda n: tuple(int(p) if p.isdigit() else p for p in n.split(".")))


def _pools(ctx: Any) -> Dict[str, np.ndarray]:
    sizes = ctx.config["pools"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seeds[1])
    out = {}
    for name in SOURCES + ("validation_positive", "validation_negative"):
        rows = torch.randn((sizes[name],) + ROW, generator=gen, device=ctx.device)
        out[name] = rows.cpu().numpy()
        del rows
    return out


class Stretch:
    """The program's side of the steps a check follows, from step ``first`` of
    a stage: ``steps`` of them, more (up to ``cap``) until one fires the
    optimizer. Records each step's rows, loss, fire flag and negative weight,
    the state before the first step, the first fired step's gradient (from
    Adam's first moment before and after it) and the parameters after."""

    def __init__(self, first: int, steps: int, cap: int) -> None:
        self.first, self.steps, self.cap = first, steps, cap
        self.idxs: List[List[np.ndarray]] = []
        self.losses: List[float] = []
        self.fires: List[bool] = []
        self.neg_weights: List[float] = []
        self.hard: List[float] = []
        self.before: Dict[str, Any] = {}
        self.fired_at: Optional[int] = None
        self.grad: Dict[str, np.ndarray] = {}
        self.after: Dict[str, np.ndarray] = {}
        self._mu: Dict[str, np.ndarray] = {}

    def wants(self, step: int) -> bool:
        return not self.after and step >= self.first

    @property
    def done(self) -> bool:
        return bool(self.after)


def _state(trainer: Any, names: List[str]) -> Dict[str, Any]:
    """The program's parameters, Adam's moments and count, by leaf name."""
    leaves = trainer.optimizer_leaves()
    order, n = _leaf_order(names), len(names)
    return {"params": {k: p.detach().cpu().numpy().copy() for k, p in trainer.model.named_parameters()},
            "mu": dict(zip(order, leaves[1 : 1 + n])), "nu": dict(zip(order, leaves[1 + n :])),
            "count": int(leaves[0])}


def setup(ctx: Any) -> None:
    from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator
    from heybuddy_tpu_torch.data.training import WakeWordTrainingDatasetIterator
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer

    tr, head, batch, rec = ctx.traffic, ctx.config["head"], ctx.config["batch"], ctx.recorder
    if ctx.device.type == "cuda":
        # one core and one intra-op thread: a step's host work is the dispatching
        # thread and the autograd engine's device thread handing the step back
        # and forth, and on one core that hand-over costs the same in every run
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
        torch.set_num_threads(1)
    lo, hi = tr["check_window_steps"]
    if not 0 <= lo < hi <= tr["stage_steps"] - tr["check_cap"]:
        raise ValueError("check_window_steps has to lie inside the stage, check_cap before its end")
    pools = _pools(ctx)

    def source(name: str, i: int) -> Any:
        return PrecalculatedDatasetIterator(name, data=pools[name], seed=ctx.seeds[4] + i)

    training = WakeWordTrainingDatasetIterator(
        num_batch_threads=1, positive=[(source("positive", 0), batch["positive"])],
        negative=[(source("adversarial", 1), batch["adversarial"]), (source("negative", 2), batch["negative"])])
    validation = WakeWordTrainingDatasetIterator(
        num_batch_threads=1, positive=[(source("validation_positive", 3), batch["validation_positive"])],
        negative=[(source("validation_negative", 4), batch["validation_negative"])])
    kwargs = {"num_heads": head["num_heads"]} if head["architecture"] == "transformer" else {
        "use_gating": head["use_gating"], "use_half_layers": head["use_half_layers"]}
    trainer = WakeWordTrainer(checkpoint_dir=ctx.workdir, seed=ctx.seeds[2], device=ctx.device,
                              architecture=head["architecture"], layer_dim=head["layer_dim"],
                              num_layers=head["num_layers"], dropout=head["dropout"], **kwargs)
    params0 = weights.make(weights.head_shapes(head), ctx.seeds[0], ctx.device)
    with torch.no_grad():
        trainer.model.load_state_dict({k.replace("/", "."): v for k, v in params0.items()}, strict=True)

    k = int(np.random.default_rng(ctx.seeds[5]).integers(lo, hi))
    stretches = {"start": Stretch(0, tr["check_steps"], tr["check_cap"]),
                 "window": Stretch(k, tr["check_steps"], tr["check_cap"])}
    seen: Dict[str, Any] = {"phase": "start", "step": 0, "evals": 0, "eval_s": []}
    names = [n for n, _ in trainer.model.named_parameters()]

    def recording() -> Optional[Stretch]:
        s = stretches.get(seen["phase"])
        return s if s is not None and s.wants(seen["step"]) else None

    def gather(call: Any, pools_: Any, idxs: Any) -> Any:
        s = recording()
        if s is not None:
            s.idxs.append([np.array(i, copy=True) for i in idxs])
        return call()

    def step(call: Any, carry: Any, *args: Any, **kwargs: Any) -> Any:
        s = recording()
        if s is not None:
            if not s.losses:
                s.before = dict(_state(trainer, names), accum_samples=int(carry["accum_samples"]),
                                accum_steps=int(carry["accum_steps"]))
                s._mu = s.before["mu"]
            elif s.fired_at is None:
                s._mu = _state(trainer, names)["mu"]
        new_carry, metrics = call()
        if s is not None:
            m = metrics.detach().cpu().numpy()
            s.losses.append(float(m[0]))
            s.fires.append(bool(m[4] > 0))
            s.neg_weights.append(float(args[3]))
            s.hard.append(float(m[5]))
            if s.fired_at is None and s.fires[-1]:
                s.fired_at = len(s.losses) - 1
                mu = _state(trainer, names)["mu"]
                s.grad = {n: (mu[n] - trainstep.B1 * s._mu[n]) / (1.0 - trainstep.B1) for n in mu}
            if len(s.losses) >= s.steps and (s.fired_at is not None or len(s.losses) >= s.cap):
                s.after = {n: p.detach().cpu().numpy().copy() for n, p in trainer.model.named_parameters()}
        seen["step"] += 1
        return new_carry, metrics

    def evaluate(call: Any, *args: Any, **kwargs: Any) -> Any:
        seen["evals"] += 1
        if seen["phase"] == "start":
            return call()
        if ctx.device.type == "cuda":  # the steps dispatched before it are not its time
            torch.cuda.synchronize(ctx.device)
        t = time.perf_counter()
        out = call()  # returns once its counts are on the host
        seen["eval_s"].append(time.perf_counter() - t)
        return out

    rec.wrap(trainer, "_gather", "gather", gather)
    rec.wrap(trainer, "_train_step", "step", step)
    rec.wrap(trainer, "_run_eval", "eval", evaluate)
    trainer.train_epoch(training, validation, num_steps=tr["check_steps"], validation_steps=tr["check_steps"] - 1,
                        checkpoint_steps=10 ** 9, negative_weight_schedule=1.0, name="hbbench",
                        description="set-up")
    seen.update(phase="window", step=0, evals=0, eval_s=[])
    rec.spans.clear()
    ctx.extra.update(trainer=trainer, training=training, validation=validation, pools=pools, params0=params0,
                     seen=seen, stretches=stretches)


class _WindowClosed(Exception):
    pass


def window(ctx: Any) -> None:
    tr, rec, trainer, seen = ctx.traffic, ctx.recorder, ctx.extra["trainer"], ctx.extra["seen"]
    checked = ctx.extra["stretches"]["window"]
    done = {"steps": 0, "base": 0, "traced_steps": None}

    def boundary(step: int, _details: Dict[str, float]) -> None:
        done["steps"] = done["base"] + step + 1
        now = time.perf_counter()
        ctx.diagnostics.setdefault("boundaries", []).append((done["steps"], round(now - t0, 4)))
        if rec.tracing and now - t0 >= tr["trace_seconds"]:
            rec.stop_trace()
            done["traced_steps"] = done["steps"]
        if now - t0 >= ctx.seconds and seen["eval_s"] and (checked.done or done["steps"] >= checked.first + checked.cap):
            raise _WindowClosed

    if ctx.traced:
        rec.start_trace()
    t0 = time.perf_counter()
    try:
        while True:
            trainer.train_epoch(ctx.extra["training"], ctx.extra["validation"], num_steps=tr["stage_steps"],
                                validation_steps=tr["validation_steps"], logging_steps=tr["validation_steps"],
                                checkpoint_steps=10 ** 9, negative_weight_schedule=1.0,
                                negative_weight_adjust_ratio=tr["negative_weight_adjust_ratio"],
                                log_callback=boundary, name="hbbench", description="window")
            done["base"] += tr["stage_steps"]
            done["steps"] = done["base"]
            seen["phase"] = "later stages"
    except _WindowClosed:
        pass
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    elapsed = time.perf_counter() - t0 - rec.stop_seconds
    if rec.tracing:
        rec.stop_trace()
        done["traced_steps"] = done["steps"]
    b, pools = ctx.config["batch"], ctx.config["pools"]
    eval_rows = pools["validation_positive"] + pools["validation_negative"]
    ctx.diagnostics["window_check_steps"] = (checked.first, len(checked.losses), checked.fired_at)
    ctx.diagnostics["eval_ms"] = [round(1e3 * t, 3) for t in seen["eval_s"]]
    ctx.diagnostics["steps_per_s"] = done["steps"] / elapsed
    ctx.results.update(steps_per_s=done["steps"] / elapsed, attempted=done["steps"], failed=0,
                       window_s=elapsed, steps=done["steps"], evals=seen["evals"],
                       traced_steps=done["traced_steps"],
                       rows_per_step=b["positive"] + b["adversarial"] + b["negative"], eval_rows=eval_rows)
    if seen["eval_s"]:
        ctx.results["train_eval_rows_per_s"] = len(seen["eval_s"]) * eval_rows / sum(seen["eval_s"])


def _norms(leaves: Dict[str, Any]) -> Dict[str, float]:
    return {n: float(np.linalg.norm(np.asarray(v, np.float64))) for n, v in leaves.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap between the program's and the reference's norm,
    over the larger of the reference leaf's norm and the median leaf's."""
    median = statistics.median(ref[n] for n in keep)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median) for n in keep}


def follow(ctx: Any, part: str, tf32: bool) -> Dict[str, Any]:
    """The reference over the program's stretch ``part`` (with ``tf32`` the control)."""
    s, pools, head = ctx.extra["stretches"][part], ctx.extra["pools"], ctx.config["head"]
    b, dev, tr = ctx.config["batch"], ctx.device, ctx.traffic
    rows = b["positive"] + b["adversarial"] + b["negative"]
    forward = rheads.for_config(head)
    gen = torch.Generator(device=dev).manual_seed(ctx.seeds[2] + 1)  # the trainer's dropout stream, seed + 1
    if part == "start":
        start, total = ctx.extra["params0"], tr["check_steps"]
        ref = trainstep.Reference(start)
    else:
        def tensors(leaves: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
            return {n.replace(".", "/"): torch.from_numpy(np.asarray(v)).to(dev) for n, v in leaves.items()}

        start, total = tensors(s.before["params"]), tr["stage_steps"]
        ref = trainstep.Reference(start, dict(s.before, mu=tensors(s.before["mu"]), nu=tensors(s.before["nu"])))
        for _ in range(s.first):  # the stream as the stage's first k steps left it
            torch.rand((rows,) + ROW, generator=gen, device=dev)
    y = torch.cat([torch.ones(b["positive"]), torch.zeros(b["adversarial"] + b["negative"])]).to(dev)
    losses, grad, hard = [], {}, []
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        for j, idxs in enumerate(s.idxs[: len(s.losses)]):
            x = np.concatenate([pools[name][i] for name, i in zip(SOURCES, idxs)])
            weight = 1.0 if part == "start" else s.neg_weights[j]
            loss, _ = ref.step(forward, torch.from_numpy(x).to(dev), y,
                               trainstep.learning_rate(s.first + j, total), weight, gen, head["dropout"])
            losses.append(loss)
            hard.append(ref.n_hard)
            if j == s.fired_at:
                grad = {n: v.cpu().numpy() for n, v in ref.grads.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    delta = {n: (ref.params[n] - start[n]).cpu().numpy() for n in ref.params}
    return {"losses": losses, "grad": _norms(grad), "delta": _norms(delta), "hard": hard}


def numbers(side: Dict[str, Any], ref: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    """Every number the check can compare; ``limits`` of the cell pick those compared."""
    if not ref["grad"] or set(side["grad"]) != set(ref["grad"]) or set(side["delta"]) != set(ref["delta"]):
        return {prefix + n: float("inf") for n in ("loss_gap", "grad_gap", "delta_gap")}
    keep = [n for n in ref["grad"] if ref["grad"][n] >= 1e-3 * statistics.median(ref["grad"].values())]
    same = len(side["losses"]) == len(ref["losses"]) and bool(ref["losses"])
    steps = [abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"])] if same else [float("inf")]
    grad = leaf_gaps(side["grad"], ref["grad"], keep)
    delta = leaf_gaps(side["delta"], ref["delta"], keep)
    return {prefix + "loss_gap": max(steps), prefix + "first_loss_gap": steps[0], prefix + "grad_gap": max(grad.values()),
            prefix + "grad_gap_median": statistics.median(grad.values()), prefix + "delta_gap": max(delta.values()),
            prefix + "delta_gap_median": statistics.median(delta.values())}


def _program_side(s: Stretch, start: Dict[str, np.ndarray]) -> Dict[str, Any]:
    grad = {n.replace(".", "/"): v for n, v in s.grad.items()}
    delta = {n.replace(".", "/"): v - start[n] for n, v in s.after.items()}
    return {"losses": s.losses, "grad": _norms(grad), "delta": _norms(delta)}


def _distinct_run(rows: np.ndarray) -> int:
    """The length of the longest prefix of ``rows`` with no row twice."""
    seen = set()
    for i, row in enumerate(rows.tolist()):
        if row in seen:
            return i
        seen.add(row)
    return len(rows)


def _repeated(s: Stretch) -> int:
    """Rows a source gave twice within one pass of its shuffled cursor: the
    draws past the longest distinct prefix and suffix (a stretch draws fewer
    rows than a pool holds, so it crosses at most one reshuffle)."""
    if not s.idxs:
        return 0
    rows = [np.concatenate([step[j] for step in s.idxs]) for j in range(len(s.idxs[0]))]
    return sum(max(0, len(r) - _distinct_run(r) - _distinct_run(r[::-1])) for r in rows)


def check(ctx: Any) -> None:
    ctx.extra["training"].stop()
    ctx.extra["validation"].stop()
    common.free(ctx, "trainer", "training", "validation")
    stretches = ctx.extra["stretches"]
    common.check(ctx, "repeated_rows", float(sum(_repeated(s) for s in stretches.values())))
    params0 = {n.replace("/", "."): v.cpu().numpy() for n, v in ctx.extra["params0"].items()}
    for part, prefix in (("start", ""), ("window", "window_")):
        s = stretches[part]
        prog = _program_side(s, params0 if part == "start" else s.before.get("params", {}))
        with torch.enable_grad():
            ref = follow(ctx, part, tf32=False)
        found = numbers(prog, ref, prefix)
        for name, value in found.items():
            if name in ctx.cell["limits"]:
                common.check(ctx, name, value)
            else:
                ctx.diagnostics[name] = value
        ctx.diagnostics[prefix + "fires"] = s.fires
        ctx.diagnostics[prefix + "hard"] = (s.hard, ref["hard"])
        ctx.diagnostics[prefix + "neg_weights"] = s.neg_weights
        if ctx.control:
            if found[prefix + "grad_gap"] != float("inf"):
                keep = [n for n in ref["grad"] if ref["grad"][n] >= 1e-3 * statistics.median(ref["grad"].values())]
                for kind in ("grad", "delta"):
                    gaps = leaf_gaps(prog[kind], ref[kind], keep)
                    worst = sorted(gaps, key=gaps.get, reverse=True)[:4]
                    ctx.diagnostics[f"{prefix}worst_{kind}_leaves"] = [(n, gaps[n], prog[kind][n], ref[kind][n])
                                                                     for n in worst]
                ctx.diagnostics[prefix + "excluded"] = sorted(set(ref["grad"]) - set(keep))
            ctx.diagnostics[prefix + "losses"] = (prog["losses"], ref["losses"])
            with torch.enable_grad():
                ctx.controls.update(numbers(follow(ctx, part, tf32=True), ref, prefix))
