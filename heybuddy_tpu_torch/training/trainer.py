"""
Wake-word trainer: the train step and the three-stage schedule, in PyTorch.

Counterpart of the JAX package's ``training/trainer.py``. The train step keeps
the JAX step's rules as they are:

* predictions are clipped to [1e-7, 1 - 1e-7]; the hard examples are the
  negatives scoring >= ``high_loss_threshold`` and the positives scoring
  < 1 - ``high_loss_threshold``; the BCE over them is weighted by the
  negative weight, averaged over max(n_hard, 1) and divided by the
  accumulation counter;
* the optimizer fires only when the accumulated plus the current hard count
  reaches 128 and the current batch has a hard example, and it then applies
  the current batch's gradient alone (gradients are not summed over the
  accumulated batches);
* a batch with at least 128 hard examples replaces the metric statistics
  instead of adding to them;
* each step yields ``[loss, n_hard / batch, recall, fp_rate, did_step,
  n_hard]``.

The optimizer is Adam (b1 0.9, b2 0.999, eps 1e-8, no eps inside the root)
scaled by the step's learning rate, with the bias correction counting fired
steps only: ``optax.scale_by_adam`` in the JAX package, and the update
``torch.optim.Adam`` makes when its ``step()`` is called on fired steps alone.
Whether a step fires is known only on the device, so ``_MaskedAdam`` applies
that update under a device-side flag over one flat parameter buffer, and no
step waits on the host; the per-step metrics stay on the device until a
boundary (log, eval, checkpoint, the last step), where they are fetched
stacked in one copy.

When the training iterator can serve row indices (``device_plan``), its
feature pools are uploaded to the device once per source, kept across stages
in a cache keyed by the source's identity and checked through a weakref, and
each step gathers its rows by index on the device. The budget is 35% of the
card's memory (``HEYBUDDY_DEVICE_DATA_BYTES`` overrides it);
``HEYBUDDY_DEVICE_DATA=0`` streams host batches instead.

Checkpoints are the JAX package's: the model npz, the optimizer pickle (the
leaf list ``count, mu..., nu...`` in JAX's sorted-key order of the parameter
tree) and ``<name>_state.json`` (stage, step, negative weight), so each
package resumes the other's. ``checkpoint_backend="dcp"`` also writes
``<name>_dcp/`` with ``torch.distributed.checkpoint`` (the counterpart of the
JAX package's Orbax backend, which the port does not have: ``"orbax"``
raises), read back by ``resume_dcp``.

``mesh`` (``parallel.get_mesh``) trains data-parallel over the mesh's data
axis, as the JAX trainer's mesh does: every rank holds the parameters, the
optimizer state and the resident pools, runs the same host program on the
same data and takes its own rows of each batch, padded to a multiple of the
data axis (zero rows labelled -1, neither positive nor negative). Per step,
one ``all_reduce`` of the counts ``[n_hard, tp, fn, fp, n_neg]`` precedes the
loss's division by ``max(n_hard, 1)``, and one of the flat gradient (with the
loss) precedes the update, so every rank takes the same fire branch and the
same update; ``n_hard / batch`` divides by the padded global batch.
Evaluation counts are reduced and pool scores gathered in order. Dropout
draws the whole padded batch's mask on every rank and slices it. Rank 0
writes the npz, the pickle, the json and the plot while the others wait; the
DCP save is a collective that every rank calls.
"""

from __future__ import annotations

import json
import os
import pickle
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from heybuddy_tpu_torch.constants import (
    CLIP_SECONDS,
    DEFAULT_ACCUMULATION_TARGET,
    DEFAULT_ACTIVATION_THRESHOLD,
    DEFAULT_ARCHITECTURE,
    DEFAULT_BATCH_SIZE_ADJUST_RATIO,
    DEFAULT_CHECKPOINT_STEPS,
    DEFAULT_DYNAMIC_NEGATIVE_WEIGHT,
    DEFAULT_HEADS,
    DEFAULT_HIGH_LOSS_THRESHOLD,
    DEFAULT_LAYER_DIM,
    DEFAULT_LAYERS,
    DEFAULT_LEARNING_RATE,
    DEFAULT_LEARNING_RATE_ADJUST_RATIO,
    DEFAULT_LOGGING_STEPS,
    DEFAULT_NEGATIVE_WEIGHT,
    DEFAULT_NEGATIVE_WEIGHT_ADJUST_RATIO,
    DEFAULT_STAGES,
    DEFAULT_STEP_ADJUST_RATIO,
    DEFAULT_STEPS,
    DEFAULT_TARGET_FALSE_POSITIVE_RATE,
    DEFAULT_USE_GATING,
    DEFAULT_USE_HALF_LAYERS,
    DEFAULT_VALIDATION_STEPS,
)
from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.models.wakeword import (
    ModelType,
    WakeWordMLPModel,
    WakeWordTransformerModel,
    load_model,
    save_model,
)
from heybuddy_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    barrier,
    gather_rows,
    is_main_process,
    row_range,
)
from heybuddy_tpu_torch.runtime.detection import count_detections
from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.profiling import span
from heybuddy_tpu_torch.utils.strings import human_duration

__all__ = ["WakeWordTrainer", "get_learning_rate", "adjust_negative_weight"]

DatasetType = Any  # anything iterable of (x, y) numpy batches

# rows per forward pass when a whole pool is scored (bounds activation memory)
_EVAL_CHUNK = 16384


def get_learning_rate(
    step: int,
    warmup_steps: int = 0,
    hold_steps: int = 0,
    total_steps: int = 0,
    target_learning_rate: float = DEFAULT_LEARNING_RATE,
) -> float:
    """Cosine decay with linear warmup and a hold at the target rate."""
    denom = max(float(total_steps - warmup_steps - hold_steps), 1.0)
    lr = 0.5 * target_learning_rate * (
        1.0 + np.cos(np.pi * (step - warmup_steps - hold_steps) / denom)
    )
    warmup_lr = target_learning_rate * (step / warmup_steps) if warmup_steps > 0 else 0.0
    if hold_steps > 0 and step <= warmup_steps + hold_steps:
        lr = target_learning_rate
    return float(warmup_lr if step < warmup_steps else lr)


def adjust_negative_weight(current: float, fp_per_hour: float, target: float, ratio: float) -> float:
    """One step of the negative-weight controller: raise above the target,
    lower only below half of it (real headroom), hold in between."""
    if fp_per_hour > target:
        return current * ratio
    if fp_per_hour < 0.5 * target:
        return max(1.0, current / ratio)
    return current


_CACHE_MISS = object()  # sentinel: None is a legitimate cached plan value


def _jax_leaf_order(names: Sequence[str]) -> List[str]:
    """State-dict names in ``jax.tree_util.tree_leaves`` order of the parameter
    tree: dict keys sorted, list items by index."""
    return sorted(names, key=lambda name: tuple(int(p) if p.isdigit() else p for p in name.split(".")))


class _MaskedAdam:
    """
    Adam over one flat float32 buffer that applies only where a device-side
    flag is set. With the flag set it computes ``torch.optim.Adam``'s update
    (``lerp`` for the first moment, the bias corrections in float64); with it
    clear, the parameters, moments and count stay bit for bit.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, flat: torch.Tensor) -> None:
        self.flat = flat
        self.mu = torch.zeros_like(flat)
        self.nu = torch.zeros_like(flat)
        self.count = torch.zeros((), dtype=torch.float64, device=flat.device)

    def reset(self) -> None:
        self.mu.zero_()
        self.nu.zero_()
        self.count.zero_()

    @torch.no_grad()
    def update(self, grad: torch.Tensor, fire: torch.Tensor, lr: float) -> None:
        self.count.add_(fire.to(torch.float64))
        count = self.count.clamp(min=1.0)  # bias corrections stay finite before the first fire
        bc1 = 1.0 - torch.pow(self.b1, count)
        bc2_sqrt = (1.0 - torch.pow(self.b2, count)).sqrt().float()
        self.mu.copy_(torch.where(fire, self.mu.lerp(grad, 1.0 - self.b1), self.mu))
        nu = self.nu * self.b2
        nu.addcmul_(grad, grad, value=1.0 - self.b2)
        self.nu.copy_(torch.where(fire, nu, self.nu))
        denom = (self.nu.sqrt() / bc2_sqrt).add_(self.eps)
        step = torch.where(fire, -lr / bc1, torch.zeros_like(bc1)).float()
        self.flat.addcdiv_(self.mu * step, denom)


class WakeWordTrainer:
    """Three-stage wake-word training on one device, or data-parallel over ``mesh``."""

    def __init__(
        self,
        checkpoint_dir: str = "./checkpoints",
        learning_rate: float = DEFAULT_LEARNING_RATE,
        input_shape: Tuple[int, int] = (16, 96),
        num_layers: int = DEFAULT_LAYERS,
        layer_dim: int = DEFAULT_LAYER_DIM,
        num_heads: int = DEFAULT_HEADS,
        architecture: str = DEFAULT_ARCHITECTURE,
        use_gating: bool = DEFAULT_USE_GATING,
        use_half_layers: bool = DEFAULT_USE_HALF_LAYERS,
        seed: int = 0,
        device: DeviceLike = "cuda",
        mesh: Optional[Mesh] = None,
        checkpoint_backend: str = "npz",
        **model_kwargs: Any,
    ) -> None:
        if checkpoint_backend == "orbax":
            raise ValueError(
                "the port has no Orbax checkpoints: use checkpoint_backend='dcp' "
                "(torch.distributed.checkpoint) for the sharding-aware format"
            )
        if checkpoint_backend not in ("npz", "dcp"):
            raise ValueError(f"unknown checkpoint_backend {checkpoint_backend!r}; expected 'npz' or 'dcp'")
        self.checkpoint_backend = checkpoint_backend
        self.mesh = mesh
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.learning_rate = learning_rate
        self.architecture = architecture
        self.layer_dim = layer_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.seed = seed
        self.device = mesh.device if mesh is not None else resolve_device(device)

        self.model: ModelType
        if architecture == "perceptron":
            self.model = WakeWordMLPModel(
                input_shape=input_shape, num_layers=num_layers, layer_dim=layer_dim,
                use_gating=use_gating, use_half_layers=use_half_layers, seed=seed,
                device=self.device, **model_kwargs,
            )
        elif architecture == "transformer":
            self.model = WakeWordTransformerModel(
                input_shape=input_shape, dim=layer_dim, num_layers=num_layers,
                num_heads=num_heads, seed=seed, device=self.device, **model_kwargs,
            )
        else:
            raise ValueError(f"Invalid architecture: {architecture}")

        # the parameters become views into one flat buffer, in the JAX
        # tree's leaf order, so the optimizer and its pickle walk one array
        named = dict(self.model.named_parameters())
        self._params = [named[n] for n in _jax_leaf_order(list(named))]
        flat = torch.cat([p.detach().reshape(-1) for p in self._params])
        offset = 0
        for p in self._params:
            p.data = flat[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        self._adam = _MaskedAdam(flat)

        self.start_stage = 0
        self.start_step = 0
        self.resumed_negative_weight: Optional[float] = None
        # device-resident training data: pools keyed by source identity
        # (reused across stages, weakref-checked: see _cache_get), the plans
        # per iterator, and label vectors per batch composition / eval pool
        self._device_pools: Dict[int, Tuple[Any, Any]] = {}
        self._device_plans: Dict[int, Tuple[Any, Any]] = {}
        self._resident_y: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._eval_labels: Dict[Tuple[int, float], torch.Tensor] = {}

    @staticmethod
    def _cache_get(cache: Dict[int, Tuple[Any, Any]], obj: Any) -> Any:
        entry = cache.get(id(obj))
        if entry is not None and entry[0]() is obj:
            return entry[1]
        return _CACHE_MISS

    @staticmethod
    def _cache_put(cache: Dict[int, Tuple[Any, Any]], obj: Any, value: Any) -> None:
        key = id(obj)
        cache[key] = (weakref.ref(obj, lambda _: cache.pop(key, None)), value)

    # --- the train step -------------------------------------------------------------

    @staticmethod
    def _init_carry(device: torch.device) -> Dict[str, torch.Tensor]:
        def scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
            return torch.full((), value, dtype=dtype, device=device)

        return {
            "accum_samples": scalar(0, torch.int32),
            "accum_steps": scalar(1, torch.int32),
            "tp": scalar(0.0, torch.float32),
            "fn": scalar(0.0, torch.float32),
            "fp": scalar(0.0, torch.float32),
            "n_neg": scalar(0.0, torch.float32),
        }

    def _train_step(
        self,
        carry: Dict[str, torch.Tensor],
        x: torch.Tensor,
        y: torch.Tensor,
        lr: float,
        neg_weight: float,
        high_loss_threshold: float,
        activation_threshold: float,
        generator: torch.Generator,
        accumulation_target: int = DEFAULT_ACCUMULATION_TARGET,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One step; returns the new carry and the (6,) metric vector, all on the
        device. Under a mesh ``x`` / ``y`` are this rank's rows of the padded
        batch and the counts, the loss and the gradient are the whole batch's."""
        mesh = self.mesh
        rows = None if mesh is None else (mesh.rank * x.shape[0], mesh.size * x.shape[0])
        batch = x.shape[0] if rows is None else rows[1]
        with span("trainer/step"):
            with span("trainer/forward"):
                preds = self.model(x, train=True, generator=generator, batch_rows=rows)[:, 0]
                preds = preds.clamp(1e-7, 1.0 - 1e-7)
                hard_neg = (y == 0) & (preds >= high_loss_threshold)
                hard_pos = (y == 1) & (preds < 1.0 - high_loss_threshold)
                mask = (hard_neg | hard_pos).float()
                n_hard = mask.sum()
                with torch.no_grad():
                    # metric statistics over the hard subset
                    held = preds.detach()
                    b_tp = (hard_pos & (held > activation_threshold)).sum().float()
                    b_fn = (hard_pos & (held <= activation_threshold)).sum().float()
                    b_fp = (hard_neg & (held >= activation_threshold)).sum().float()
                    b_nneg = hard_neg.sum().float()
                    if mesh is not None:
                        counts = all_reduce_sum(torch.stack([n_hard, b_tp, b_fn, b_fp, b_nneg]), mesh)
                        n_hard, b_tp, b_fn, b_fp, b_nneg = counts.unbind()
                weights = torch.where(y == 1, 1.0, neg_weight) * mask
                bce = -(y * torch.log(preds) + (1.0 - y) * torch.log(1.0 - preds))
                masked_loss = (weights * bce).sum() / n_hard.clamp(min=1.0)
                loss = masked_loss / carry["accum_steps"].float()
            with span("trainer/backward"):
                grads = torch.autograd.grad(loss, self._params)
            with span("trainer/adam"), torch.no_grad():
                flat_grad = torch.cat([g.reshape(-1) for g in grads])
                loss = loss.detach()
                if mesh is not None:
                    # the rank's share of the loss rides on the gradient's all_reduce
                    summed = all_reduce_sum(torch.cat([flat_grad, loss[None]]), mesh)
                    flat_grad, loss = summed[:-1], summed[-1]
                n_hard_i = n_hard.to(torch.int32)
                total = carry["accum_samples"] + n_hard_i
                fire = (total >= accumulation_target) & (n_hard_i > 0)
                self._adam.update(flat_grad, fire, lr)

                # a batch of >= 128 hard examples replaces the accumulated
                # statistics, otherwise the metrics come from what was accumulated
                # before this step
                big = n_hard_i >= accumulation_target
                zero = torch.zeros_like(b_tp)
                stats = {
                    k: torch.where(big, b, carry[k])
                    for k, b in (("tp", b_tp), ("fn", b_fn), ("fp", b_fp), ("n_neg", b_nneg))
                }
                added = {"tp": b_tp, "fn": b_fn, "fp": b_fp, "n_neg": b_nneg}
                new_carry = {
                    "accum_samples": torch.where(fire, torch.zeros_like(total), total),
                    "accum_steps": torch.where(
                        fire, torch.ones_like(total), carry["accum_steps"] + (n_hard_i > 0).int()
                    ),
                    **{
                        k: torch.where(fire, zero, stats[k] + torch.where(big, zero, added[k]))
                        for k in stats
                    },
                }
                recall = stats["tp"] / (stats["tp"] + stats["fn"]).clamp(min=1.0)
                fp_rate = stats["fp"] / stats["n_neg"].clamp(min=1.0)
                # n_hard / batch as XLA computes a division by a constant: times its float32 reciprocal
                metrics = torch.stack([loss, n_hard * (1.0 / batch), recall, fp_rate, fire.float(), n_hard])
        return new_carry, metrics

    @torch.no_grad()
    def _chunk_scores(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row scores of ``x``, in order, in chunks (none for no rows: a rank
        of a mesh wider than a pool holds none of its rows)."""
        chunks = [self.model(x[i : i + _EVAL_CHUNK])[:, 0] for i in range(0, x.shape[0], _EVAL_CHUNK)]
        return torch.cat(chunks) if chunks else x.new_zeros(0)

    @torch.no_grad()
    def _scores(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row scores of a whole (replicated) pool, in order; under a mesh
        each rank scores its rows and the scores are gathered in rank order."""
        if self.mesh is None:
            return self._chunk_scores(x)
        lo, hi, per = row_range(x.shape[0], self.mesh)
        local = torch.zeros(per, dtype=torch.float32, device=x.device)
        local[: hi - lo] = self._chunk_scores(x[lo:hi])
        return gather_rows(local, x.shape[0], self.mesh)

    @torch.no_grad()
    def _eval_counts(self, x: torch.Tensor, y: torch.Tensor, activation_threshold: float) -> torch.Tensor:
        """[fp, tp, fn, tn, n_neg] of one batch or pool, on the device: under a
        mesh ``x`` / ``y`` are this rank's rows, and the counts are summed."""
        preds = self._chunk_scores(x)
        # labels of -1 (padding) are neither positive nor negative
        counts = torch.stack(
            [
                ((y == 0) & (preds >= activation_threshold)).sum(),
                ((y == 1) & (preds > activation_threshold)).sum(),
                ((y == 1) & (preds <= activation_threshold)).sum(),
                ((y == 0) & (preds < activation_threshold)).sum(),
                (y == 0).sum(),
            ]
        ).float()
        return counts if self.mesh is None else all_reduce_sum(counts, self.mesh)

    # --- device-resident training data ------------------------------------------

    def _device_data_budget(self) -> int:
        env = os.environ.get("HEYBUDDY_DEVICE_DATA_BYTES")
        if env:
            return int(env)
        if self.device.type == "cuda":
            # leave most of the card to activations, parameters and the featurizer
            return int(torch.cuda.get_device_properties(self.device).total_memory * 0.35)
        return 4 * 1024 ** 3

    def _device_plan_for(self, training: Any) -> Optional[Tuple[Any, Tuple[torch.Tensor, ...]]]:
        """(plan, device pools) when the training data can live on the device."""
        if os.environ.get("HEYBUDDY_DEVICE_DATA", "1") == "0":
            return None
        plan_fn = getattr(training, "device_plan", None)
        if plan_fn is None:
            return None
        # id()-keyed entries are checked against a weakref (a dead object's
        # id can be reused by a new iterator) and evict themselves on gc, so
        # their device pools free
        plan = self._cache_get(self._device_plans, training)
        if plan is _CACHE_MISS:
            try:
                plan = plan_fn(self._device_data_budget())
            except Exception as ex:  # noqa: BLE001 - the host path still trains
                logger.warning(f"device-resident training unavailable: {ex}")
                plan = None
            self._cache_put(self._device_plans, training, plan)
        if plan is None:
            return None
        pools: List[torch.Tensor] = []
        total = 0
        for (ds, _), pool in zip(plan.sources, plan.pools):
            dev = self._cache_get(self._device_pools, ds)
            if dev is _CACHE_MISS:
                # a memory-mapped pool is read-only, and torch tensors are writable
                dev = torch.from_numpy(np.require(pool, requirements=["W"])).to(self.device)
                self._cache_put(self._device_pools, ds, dev)
                total += pool.nbytes
            pools.append(dev)
        if total:
            logger.info(
                f"training data device-resident: {len(plan.sources)} sources, "
                f"{total / 1e6:.1f} MB uploaded once; steps send indices only"
            )
        return plan, tuple(pools)

    def _resident_labels(self, counts: Tuple[int, ...], labels: Tuple[float, ...]) -> torch.Tensor:
        """The label vector of a per-source batch composition (cached); under a
        mesh this rank's rows of it, padded with -1."""
        if counts not in self._resident_y:
            y = np.concatenate(
                [np.full(n, label, np.float32) for n, label in zip(counts, labels)]
            ) if counts else np.zeros(0, np.float32)
            self._resident_y[counts] = torch.from_numpy(self._local_rows(y, -1.0)).to(self.device)
        return self._resident_y[counts]

    def _local_rows(self, array: np.ndarray, fill: float) -> np.ndarray:
        """This rank's rows of ``array`` padded with ``fill`` to a multiple of
        the data axis (the array itself without a mesh)."""
        if self.mesh is None:
            return array
        lo, hi, per = row_range(array.shape[0], self.mesh)
        out = np.full((per,) + array.shape[1:], fill, dtype=array.dtype)
        out[: hi - lo] = array[lo:hi]
        return out

    def _h2d(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the device; to a card through pinned memory, so that
        the copy queues behind the step's kernels instead of waiting for them."""
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            tensor = tensor.pin_memory()
        return tensor.to(self.device, non_blocking=True)

    def _gather(self, pools: Sequence[torch.Tensor], idxs: Sequence[np.ndarray]) -> torch.Tensor:
        """The step's rows, gathered on the device from one host->device copy of
        the indices; under a mesh only this rank's rows of the padded batch
        (its slice of the index vector, then zero rows)."""
        with span("trainer/gather"):
            pad = 0
            if self.mesh is not None:
                lo, hi, per = row_range(sum(len(i) for i in idxs), self.mesh)
                offsets = np.cumsum([0] + [len(i) for i in idxs])
                idxs = [i[max(lo - a, 0) : max(min(hi - a, len(i)), 0)] for i, a in zip(idxs, offsets)]
                pad = per - (hi - lo)
            flat = self._h2d(np.concatenate(idxs))
            parts = [pool.index_select(0, idx) for pool, idx in zip(pools, flat.split([len(i) for i in idxs]))]
            if pad:
                parts.append(parts[0].new_zeros((pad,) + tuple(parts[0].shape[1:])))
            return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _to_device(self, x: np.ndarray, y: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host batch on the device; under a mesh this rank's rows of it,
        padded with zero rows labelled -1."""
        x = self._local_rows(x.astype(np.float32, copy=False), 0.0)
        y = self._local_rows(y.astype(np.float32, copy=False), -1.0)
        return self._h2d(x), self._h2d(y)

    # --- checkpoints --------------------------------------------------------------

    def optimizer_leaves(self) -> List[np.ndarray]:
        """The Adam state as ``jax.tree_util.tree_leaves`` of ``optax.scale_by_adam``'s gives it."""
        shapes = [p.shape for p in self._params]
        sizes = [p.numel() for p in self._params]

        def leaves(buf: torch.Tensor) -> List[np.ndarray]:
            host = buf.detach().cpu().numpy()
            return [a.reshape(s).copy() for a, s in zip(np.split(host, np.cumsum(sizes)[:-1]), shapes)]

        count = np.asarray(int(self._adam.count.item()), dtype=np.int32)
        return [count] + leaves(self._adam.mu) + leaves(self._adam.nu)

    def load_optimizer_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        n = len(self._params)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, expected {1 + 2 * n}")
        for p, a, b in zip(self._params, leaves[1 : 1 + n], leaves[1 + n :]):
            if tuple(np.shape(a)) != tuple(p.shape) or tuple(np.shape(b)) != tuple(p.shape):
                raise ValueError(f"optimizer leaf shape {np.shape(a)} does not match {tuple(p.shape)}")

        def flat(arrays: Sequence[np.ndarray]) -> torch.Tensor:
            return torch.from_numpy(
                np.concatenate([np.asarray(a, dtype=np.float32).reshape(-1) for a in arrays])
            ).to(self.device)

        self._adam.mu.copy_(flat(leaves[1 : 1 + n]))
        self._adam.nu.copy_(flat(leaves[1 + n :]))
        self._adam.count.fill_(float(np.asarray(leaves[0])))

    def save_checkpoint(self, name: str, optimizer: bool = True, step: Optional[int] = None) -> None:
        """
        Model npz + optimizer pickle + trainer-state json. ``step`` records the
        in-progress step of the current stage so that resume can fast-forward;
        ``self.start_step`` is not changed here (it is consumed once when a
        stage starts, and setting it would make the next stage skip steps).
        """
        recorded_step = self.start_step if step is None else step
        if is_main_process(self.mesh):
            save_model(self.model, os.path.join(self.checkpoint_dir, f"{name}.npz"))
            if optimizer:
                with open(os.path.join(self.checkpoint_dir, f"{name}_optimizer.pkl"), "wb") as f:
                    pickle.dump(self.optimizer_leaves(), f)
            state = {"stage": self.start_stage, "step": recorded_step, "negative_weight": self.resumed_negative_weight}
            with open(os.path.join(self.checkpoint_dir, f"{name}_state.json"), "w") as f:
                json.dump(state, f)
        if self.checkpoint_backend == "dcp":
            self._save_dcp(name)  # a collective: every rank calls it
        barrier(self.mesh)

    def _dcp_state(self) -> Dict[str, torch.Tensor]:
        return {"params": self._adam.flat, "mu": self._adam.mu, "nu": self._adam.nu, "count": self._adam.count}

    def _save_dcp(self, name: str) -> None:
        """Parameters and Adam state to ``<name>_dcp/`` (torch.distributed.checkpoint)."""
        import torch.distributed.checkpoint as dcp

        dcp.save(self._dcp_state(), checkpoint_id=os.path.join(self.checkpoint_dir, f"{name}_dcp"))

    def resume_dcp(self, name: str) -> None:
        """Restore the parameters and the Adam state from ``<name>_dcp/`` (every rank reads it)."""
        import torch.distributed.checkpoint as dcp

        state = self._dcp_state()
        dcp.load(state, checkpoint_id=os.path.join(self.checkpoint_dir, f"{name}_dcp"))
        for key, tensor in self._dcp_state().items():
            if state[key] is not tensor:
                tensor.copy_(state[key])

    def resume(self, name: str) -> None:
        """
        Resume from the newest model checkpoint ``name*.npz`` and the optimizer
        pickle written within 2 s of it, restoring stage / step / negative
        weight from the state json when present.
        """
        files = os.listdir(self.checkpoint_dir)
        models = [f for f in files if f.startswith(name) and f.endswith(".npz") and not f.endswith("_optimizer.npz")]
        optimizers = [f for f in files if f.startswith(name) and f.endswith("_optimizer.pkl")]
        if not models:
            raise FileNotFoundError(f"Checkpoint {name} not found.")

        def mtime(f: str) -> float:
            return os.path.getmtime(os.path.join(self.checkpoint_dir, f))

        models.sort(key=mtime, reverse=True)
        optimizers.sort(key=mtime, reverse=True)
        model_file = models[0]
        opt_file = next((o for o in optimizers if abs(mtime(o) - mtime(model_file)) < 2), None)
        logger.info(f"Resuming training from {model_file}" + (f" and {opt_file}" if opt_file else ""))
        loaded = load_model(os.path.join(self.checkpoint_dir, model_file), device=self.device)
        with torch.no_grad():  # copied into the flat buffer's views
            self.model.load_state_dict(loaded.state_dict())
        self._adam.reset()
        if opt_file is not None:
            # the pickle is one this trainer or the JAX package's wrote
            with open(os.path.join(self.checkpoint_dir, opt_file), "rb") as f:
                self.load_optimizer_leaves(pickle.load(f))
        state_file = os.path.join(self.checkpoint_dir, model_file.replace(".npz", "_state.json"))
        if os.path.exists(state_file):
            with open(state_file) as f:
                state = json.load(f)
            self.start_stage = state.get("stage", 0) or 0
            self.start_step = state.get("step", 0) or 0
            self.resumed_negative_weight = state.get("negative_weight")

    # --- one stage ----------------------------------------------------------------

    def train_epoch(
        self,
        training: DatasetType,
        validation: Optional[DatasetType] = None,
        testing: Optional[DatasetType] = None,
        num_steps: int = DEFAULT_STEPS,
        warmup_steps: Optional[int] = None,
        hold_steps: Optional[int] = None,
        negative_weight_schedule: Union[float, List[float]] = DEFAULT_NEGATIVE_WEIGHT,
        negative_weight_adjust_ratio: Optional[float] = None,
        target_false_positive_rate: float = DEFAULT_TARGET_FALSE_POSITIVE_RATE,
        validation_gate_consecutive: int = 1,
        validation_gate_debounce_windows: int = 16,
        validation_steps: int = DEFAULT_VALIDATION_STEPS,
        checkpoint_steps: int = DEFAULT_CHECKPOINT_STEPS,
        logging_steps: int = DEFAULT_LOGGING_STEPS,
        learning_rate: float = DEFAULT_LEARNING_RATE,
        high_loss_threshold: float = DEFAULT_HIGH_LOSS_THRESHOLD,
        activation_threshold: float = DEFAULT_ACTIVATION_THRESHOLD,
        description: str = "Training",
        name: str = "heybuddy",
        log_callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ) -> Dict[str, Any]:
        """One stage of training; returns metric histories (numpy arrays)."""
        if warmup_steps is None:
            warmup_steps = num_steps // 5
        if hold_steps is None:
            hold_steps = num_steps // 3

        carry = self._init_carry(self.device)
        generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        quantum_warned = False
        history: Dict[str, List[float]] = {
            k: []
            for k in (
                "learning_rate",
                "negative_weight",
                "loss",
                "high_loss_rate",
                "recall",
                "false_positive_rate",
                "validation_false_positive_per_hour",
                "validation_recall",
                "testing_accuracy",
                "testing_recall",
                "testing_false_positive_rate",
            )
        }
        has_validation = validation is not None
        has_testing = testing is not None
        log_every = max(1, num_steps // 20)
        epoch_start = time.perf_counter()

        # resume mid-stage: continue the step counter (and with it the LR
        # schedule), then clear it so that later stages start from 0
        first_step = self.start_step
        self.start_step = 0
        if first_step:
            logger.info(f"Resuming stage at step {first_step}/{num_steps}")

        device_plan = self._device_plan_for(training)
        if device_plan is not None:
            plan, device_pools = device_plan
            step_source: Any = ((s, None) for s in range(first_step, num_steps))
        else:
            step_source = enumerate(training, start=first_step)

        pending: List[Tuple[float, float, torch.Tensor]] = []
        last_m = np.zeros(6, np.float32)

        def flush_pending() -> None:
            nonlocal last_m
            if not pending:
                return
            with span("trainer/flush"):
                # one stack and one copy for the whole window between boundaries
                stacked = torch.stack([p[2] for p in pending]).cpu().numpy()
                for (p_lr, p_nw, _), m in zip(pending, stacked):
                    last_m = m
                    history["learning_rate"].append(p_lr)
                    history["negative_weight"].append(p_nw)
                    if m[4] > 0 or not history["loss"]:
                        history["loss"].append(float(m[0]))
                        history["recall"].append(float(m[2]))
                        history["false_positive_rate"].append(float(m[3]))
                    else:
                        history["loss"].append(history["loss"][-1])
                        history["recall"].append(history["recall"][-1])
                        history["false_positive_rate"].append(history["false_positive_rate"][-1])
                    history["high_loss_rate"].append(float(m[1]))
                pending.clear()

        for step, host_batch in step_source:
            if step >= num_steps:
                break
            lr = get_learning_rate(
                step, warmup_steps=warmup_steps, hold_steps=hold_steps,
                total_steps=num_steps, target_learning_rate=learning_rate,
            )
            if isinstance(negative_weight_schedule, (float, int)):
                neg_weight = float(negative_weight_schedule)
            elif step < len(negative_weight_schedule):
                neg_weight = float(negative_weight_schedule[step])
            else:
                neg_weight = float(negative_weight_schedule[-1])

            if device_plan is None:
                x, y = self._to_device(*host_batch)
            else:
                x = self._gather(device_pools, plan.sample())
                y = self._resident_labels(plan.counts(), plan.labels)
            carry, metrics = self._train_step(
                carry, x, y, lr, neg_weight, high_loss_threshold, activation_threshold, generator
            )
            pending.append((lr, neg_weight, metrics))

            ran_eval = step > 0 and step % validation_steps == 0
            boundary = (
                device_plan is None
                or ran_eval
                or step % log_every == 0
                or step == num_steps - 1
                or (step > 0 and step % checkpoint_steps == 0)
                or (log_callback is not None and (step == 0 or step % logging_steps == 0))
            )
            if boundary:
                flush_pending()
            m = last_m
            if ran_eval and has_validation:
                val = self._run_eval(
                    validation,
                    gate_consecutive=validation_gate_consecutive,
                    gate_debounce_windows=validation_gate_debounce_windows,
                    gate_threshold=activation_threshold,
                )
                # false accepts per hour of negative audio: per-clip FPs over
                # clip hours plus gated fire events over true stream hours
                hours = val["n_neg"] * CLIP_SECONDS / 3600.0 + val["stream_hours"]
                fp_per_hour = (val["fp"] + val["gated_fp"]) / max(hours, 1e-9)
                val_recall = val["tp"] / max(val["tp"] + val["fn"], 1.0)
                if (
                    negative_weight_adjust_ratio is not None
                    and not quantum_warned
                    and hours > 0
                    and 1.0 / hours > target_false_positive_rate
                ):
                    quantum_warned = True
                    need_hours = 1.0 / target_false_positive_rate
                    logger.warning(
                        f"validation set spans {hours:.2f} negative-hours, so ONE "
                        f"false accept already measures "
                        f"{1.0 / hours:.2f} fp/hr > the {target_false_positive_rate} "
                        f"target: the negative-weight controller can only settle at "
                        f"ZERO validation FPs, which over-weights negatives and "
                        f"raises FRR. Provide >= {need_hours:.2f} negative-hours "
                        f"({int(need_hours * 3600.0 / CLIP_SECONDS) + 1} disjoint "
                        f"clips, or the stream-window equivalent at the runtime "
                        f"stride) to resolve the target."
                    )
                history["validation_false_positive_per_hour"].append(fp_per_hour)
                history["validation_recall"].append(val_recall)
                if negative_weight_adjust_ratio is not None:
                    if not isinstance(negative_weight_schedule, (float, int)):
                        raise ValueError("Dynamic negative weight requires a scalar schedule")
                    negative_weight_schedule = adjust_negative_weight(
                        float(negative_weight_schedule), fp_per_hour,
                        target_false_positive_rate, negative_weight_adjust_ratio,
                    )
            elif has_validation and history["validation_false_positive_per_hour"]:
                history["validation_false_positive_per_hour"].append(
                    history["validation_false_positive_per_hour"][-1]
                )
                history["validation_recall"].append(history["validation_recall"][-1])
            elif has_validation:
                history["validation_false_positive_per_hour"].append(0.0)
                history["validation_recall"].append(0.0)

            if ran_eval and has_testing:
                test = self._run_eval(
                    testing,
                    gate_consecutive=validation_gate_consecutive,
                    gate_debounce_windows=validation_gate_debounce_windows,
                    gate_threshold=activation_threshold,
                )
                total = test["tp"] + test["fn"] + test["fp"] + test["tn"]
                history["testing_accuracy"].append((test["tp"] + test["tn"]) / max(total, 1.0))
                history["testing_recall"].append(test["tp"] / max(test["tp"] + test["fn"], 1.0))
                history["testing_false_positive_rate"].append(test["fp"] / max(test["n_neg"], 1.0))
            elif has_testing and history["testing_accuracy"]:
                for k in ("testing_accuracy", "testing_recall", "testing_false_positive_rate"):
                    history[k].append(history[k][-1])
            elif has_testing:
                for k in ("testing_accuracy", "testing_recall", "testing_false_positive_rate"):
                    history[k].append(0.0)

            if step > 0 and step % checkpoint_steps == 0:
                self.save_checkpoint(f"{name}_{step}", step=step)

            if log_callback is not None and (
                step == 0 or step % logging_steps == 0 or ran_eval or step == num_steps - 1
            ):
                log_callback(step, {k: v[-1] for k, v in history.items() if v})

            if step % log_every == 0:
                logger.info(
                    f"{description} step {step}/{num_steps}: loss={history['loss'][-1]:.5f} "
                    f"recall={history['recall'][-1]:.3f} fp={history['false_positive_rate'][-1]:.4f} "
                    f"hard={float(m[1]):.3f} lr={lr:.2e} nw={neg_weight:g}"
                )

        flush_pending()
        logger.info(f"{description} finished in {human_duration(time.perf_counter() - epoch_start)}")
        return {k: np.asarray(v, dtype=np.float64) for k, v in history.items()}

    def _run_eval(
        self,
        dataset: DatasetType,
        gate_consecutive: int = 1,
        gate_debounce_windows: int = 16,
        gate_threshold: float = 0.5,
    ) -> Dict[str, float]:
        """
        Eval counts over a validation / testing dataset. Clip sources give the
        confusion counts. Negative sources tagged with
        ``stream_stride_seconds`` (ordered sliding windows of a stream) are
        scored in order and gated like the deployed runtime
        (``runtime/detection.count_detections``): they give ``gated_fp`` fire
        events and ``stream_hours`` of stream time, not per-window counts.
        Gate-aware counting needs the device-resident plan (its pools keep
        row order); the streamed fallback keeps per-clip counting.
        """
        with span("trainer/eval"):
            totals = {"fp": 0.0, "tp": 0.0, "fn": 0.0, "tn": 0.0, "n_neg": 0.0, "gated_fp": 0.0, "stream_hours": 0.0}
            keys = ("fp", "tp", "fn", "tn", "n_neg")
            resident = self._device_plan_for(dataset)
            if resident is not None:
                # each source pool scored exactly once per eval
                plan, pools = resident
                for (ds, label), pool in zip(plan.sources, pools):
                    stride = getattr(ds, "stream_stride_seconds", None)
                    if stride and label == 0.0:
                        preds = self._scores(pool).cpu().numpy()
                        totals["gated_fp"] += float(
                            count_detections(
                                preds, gate_threshold, consecutive=gate_consecutive,
                                debounce_windows=gate_debounce_windows,
                            )
                        )
                        totals["stream_hours"] += pool.shape[0] * stride / 3600.0
                        continue
                    key = (int(pool.shape[0]), float(label))
                    if key not in self._eval_labels:
                        self._eval_labels[key] = torch.full((pool.shape[0],), label, device=self.device)
                    lo, hi = (0, pool.shape[0]) if self.mesh is None else row_range(pool.shape[0], self.mesh)[:2]
                    counts = self._eval_counts(pool[lo:hi], self._eval_labels[key][lo:hi], gate_threshold).cpu().numpy()
                    for k, v in zip(keys, counts):
                        totals[k] += float(v)
                return totals
            for x_np, y_np in dataset:
                counts = self._eval_counts(*self._to_device(x_np, y_np), gate_threshold).cpu().numpy()
                for k, v in zip(keys, counts):
                    totals[k] += float(v)
            return totals

    # --- the stages ---------------------------------------------------------------

    def __call__(
        self,
        training: DatasetType,
        validation: Optional[DatasetType] = None,
        testing: Optional[DatasetType] = None,
        num_steps: int = DEFAULT_STEPS,
        num_stages: int = DEFAULT_STAGES,
        max_negative_weight: float = DEFAULT_NEGATIVE_WEIGHT,
        logging_steps: int = DEFAULT_LOGGING_STEPS,
        validation_steps: int = DEFAULT_VALIDATION_STEPS,
        checkpoint_steps: int = DEFAULT_CHECKPOINT_STEPS,
        target_false_positive_rate: float = DEFAULT_TARGET_FALSE_POSITIVE_RATE,
        validation_gate_consecutive: int = 1,
        validation_gate_debounce_windows: int = 16,
        negative_weight_adjust_ratio: float = DEFAULT_NEGATIVE_WEIGHT_ADJUST_RATIO,
        dynamic_negative_weight: bool = DEFAULT_DYNAMIC_NEGATIVE_WEIGHT,
        batch_size_adjust_ratio: float = DEFAULT_BATCH_SIZE_ADJUST_RATIO,
        learning_rate_adjust_ratio: float = DEFAULT_LEARNING_RATE_ADJUST_RATIO,
        step_adjust_ratio: float = DEFAULT_STEP_ADJUST_RATIO,
        learning_rate: float = DEFAULT_LEARNING_RATE,
        high_loss_threshold: float = DEFAULT_HIGH_LOSS_THRESHOLD,
        activation_threshold: float = DEFAULT_ACTIVATION_THRESHOLD,
        wandb_entity: Optional[str] = None,
        name: str = "heybuddy",
        graph_dir: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """The stages: per stage the LR x ``learning_rate_adjust_ratio``, the
        steps x ``step_adjust_ratio`` (at least ``validation_steps``) and,
        after it, the batch x ``batch_size_adjust_ratio``."""
        start_time = time.perf_counter()
        overall: Dict[str, List[np.ndarray]] = {}

        for ds in (training, validation, testing):
            if ds is None or not hasattr(ds, "start"):
                continue
            if self._device_plan_for(ds) is not None:
                # steps and evals gather on the device: producer threads would
                # only assemble batches nobody reads
                continue
            ds.start()

        wandb_run = self._maybe_init_wandb(wandb_entity, name, locals())
        log_callback = None
        if wandb_run is not None:
            log_callback = lambda step, details: wandb_run.log(details)  # noqa: E731

        if self.resumed_negative_weight:
            max_negative_weight = self.resumed_negative_weight

        if self.start_stage and hasattr(training, "multiply_batch_size"):
            # resuming at stage N: re-apply the completed stages' batch changes
            training.multiply_batch_size(batch_size_adjust_ratio ** self.start_stage)

        for stage in range(self.start_stage, num_stages):
            stage_learning_rate = learning_rate * (learning_rate_adjust_ratio ** stage)
            stage_steps = num_steps
            for _ in range(stage):
                stage_steps = max(validation_steps, int(stage_steps * step_adjust_ratio))
            if dynamic_negative_weight:
                weights: Union[float, List[float]] = max_negative_weight
                adjust: Optional[float] = negative_weight_adjust_ratio
            else:
                weights = np.linspace(1, max_negative_weight, stage_steps).tolist()
                adjust = None

            logger.info(
                f"=== Stage {stage + 1}/{num_stages}: {stage_steps} steps, "
                f"lr={stage_learning_rate:.2e}, negative_weight={max_negative_weight:g} ==="
            )
            history = self.train_epoch(
                training,
                validation=validation,
                testing=testing,
                num_steps=stage_steps,
                negative_weight_schedule=weights,
                negative_weight_adjust_ratio=adjust,
                target_false_positive_rate=target_false_positive_rate,
                validation_gate_consecutive=validation_gate_consecutive,
                validation_gate_debounce_windows=validation_gate_debounce_windows,
                learning_rate=stage_learning_rate,
                warmup_steps=stage_steps // 5,
                hold_steps=stage_steps // 3,
                logging_steps=logging_steps,
                validation_steps=validation_steps,
                checkpoint_steps=checkpoint_steps,
                description=f"Training Stage {stage + 1}",
                high_loss_threshold=high_loss_threshold,
                activation_threshold=activation_threshold,
                name=f"{name}_{stage}",
                log_callback=log_callback,
            )
            for key, series in history.items():
                overall.setdefault(key, []).append(series)

            if dynamic_negative_weight and history["negative_weight"].size:
                max_negative_weight = float(history["negative_weight"][-1])
            if hasattr(training, "multiply_batch_size"):
                training.multiply_batch_size(batch_size_adjust_ratio)
            self.start_stage = stage + 1
            self.resumed_negative_weight = max_negative_weight

        merged = {k: np.concatenate(v) if v else np.array([]) for k, v in overall.items()}
        logger.info(f"Training overall duration: {human_duration(time.perf_counter() - start_time)}")
        self.log_metrics(merged, description="Training Overall")
        if is_main_process(self.mesh):
            self.graph_metrics(merged, name=name, directory=graph_dir or self.checkpoint_dir)
        self.save_checkpoint(f"{name}_final")
        if wandb_run is not None:
            wandb_run.finish()

        for ds in (training, validation, testing):
            if ds is not None and hasattr(ds, "stop"):
                ds.stop()
        return merged

    # --- logging and graphs -----------------------------------------------------------

    @staticmethod
    def _maybe_init_wandb(entity: Optional[str], name: str, config: Dict[str, Any]) -> Any:
        if entity is None:
            return None
        try:
            import wandb  # type: ignore[import-not-found]
        except ImportError:
            logger.warning("wandb requested but not installed; skipping")
            return None
        safe_config = {k: v for k, v in config.items() if isinstance(v, (int, float, str, bool, type(None)))}
        return wandb.init(project=f"hey-buddy-{name}", entity=entity, config=safe_config)

    def log_metrics(self, metrics: Dict[str, np.ndarray], description: str = "Training") -> None:
        for key, series in metrics.items():
            if series.size == 0:
                continue
            logger.info(
                f"{description} {key}: start={series[0]:.5f} end={series[-1]:.5f} "
                f"min={series.min():.5f} max={series.max():.5f} mean={series.mean():.5f}"
            )

    def graph_metrics(self, metrics: Dict[str, np.ndarray], name: str, directory: str) -> Optional[str]:
        """A multi-panel metric summary PNG; skipped with a warning without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            logger.warning("matplotlib unavailable; skipping metric graphs")
            return None
        panels = [(k, v) for k, v in metrics.items() if v.size > 0]
        if not panels:
            return None
        cols = 3
        rows = (len(panels) + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3 * rows), squeeze=False)
        for i, (key, series) in enumerate(panels):
            ax = axes[i // cols][i % cols]
            ax.plot(series, linewidth=0.8)
            ax.set_title(key.replace("_", " "))
            ax.grid(True, alpha=0.3)
        for j in range(len(panels), rows * cols):
            axes[j // cols][j % cols].axis("off")
        fig.tight_layout()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{name}_metrics.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        logger.info(f"Saved metric graphs to {path}")
        return path
