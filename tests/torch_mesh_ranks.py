"""
One rank of the port's mesh tests (tests/test_torch_mesh.py), run as a process
of its own on the CPU with gloo:

    python tests/torch_mesh_ranks.py RANK WORLD WORKDIR SCENARIO[,SCENARIO...]

The ranks meet through a ``FileStore`` file in WORKDIR, read their inputs from
the npz files the test wrote there and write ``<scenario>-<rank>.npz``. This
module imports the port only (the test process has JAX loaded); the test
imports its helpers to run the same code at one rank.
"""

from __future__ import annotations

import contextlib
import glob
import os
import subprocess
import sys
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

TRAIN_KW = dict(num_layers=1, layer_dim=32, dropout=0.0)
THRESHOLDS = (1e-4, 0.5)  # high-loss threshold, activation threshold


def step_schedule(i: int):
    """(learning rate, negative weight) of step ``i``."""
    return 2e-3 * (1 + i % 3), 1.0 + 0.25 * i


def load_batches(workdir: str) -> List:
    data = np.load(os.path.join(workdir, "batches.npz"))
    return [(data[f"x{i}"], data[f"y{i}"]) for i in range(len(data.files) // 2)]


def trainer(workdir: str, ckpt: str, mesh=None, **kw):
    from heybuddy_tpu_torch.models.wakeword import read_checkpoint
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer

    _, params = read_checkpoint(os.path.join(workdir, "init.npz"))
    return WakeWordTrainer(checkpoint_dir=ckpt, device="cpu", params=params, mesh=mesh, **TRAIN_KW, **kw)


def train_steps(workdir: str, mesh=None) -> Dict[str, np.ndarray]:
    """The train step on every batch of batches.npz: the (steps, 6) metrics and the flat parameters."""
    t = trainer(workdir, os.path.join(workdir, f"steps-ckpt-{0 if mesh is None else mesh.size}"), mesh)
    carry = t._init_carry(t.device)
    generator = torch.Generator().manual_seed(1)
    metrics = []
    for i, (x, y) in enumerate(load_batches(workdir)):
        carry, m = t._train_step(carry, *t._to_device(x, y), *step_schedule(i), *THRESHOLDS, generator)
        metrics.append(m.numpy())
    # a pool of 2 rows: under 3 ranks the last holds none of them
    tiny = torch.from_numpy(load_batches(workdir)[0][0][:2])
    return {"metrics": np.stack(metrics), "flat": t._adam.flat.numpy().copy(),
            "count": t._adam.count.numpy().copy(), "tiny_scores": t._scores(tiny).numpy(),
            "tiny_counts": t._eval_counts(*t._to_device(tiny.numpy(), np.array([1.0, 0.0], np.float32)), 0.5).numpy()}


def resident_iterator(workdir: str):
    """The device-resident composition over the seeded pools of pools.npz."""
    from heybuddy_tpu_torch.data.precalculated import PrecalculatedDatasetIterator
    from heybuddy_tpu_torch.data.training import WakeWordTrainingDatasetIterator

    pools = np.load(os.path.join(workdir, "pools.npz"))

    def source(name: str, seed: int) -> PrecalculatedDatasetIterator:
        return PrecalculatedDatasetIterator("resident", data=pools[name], seed=seed)

    return WakeWordTrainingDatasetIterator(
        num_batch_threads=1,
        positive=[(source("pos", 1), 25)],
        negative=[(source("neg", 2), 24), (source("neg2", 3), 40)],
    )


def resident_run(workdir: str, mesh=None) -> Dict[str, np.ndarray]:
    """Two stages through the resident path with evaluation on a resident
    validation set (89 rows a step: not a multiple of 2 or 3)."""
    t = trainer(workdir, os.path.join(workdir, f"resident-ckpt-{0 if mesh is None else mesh.size}"), mesh)
    history = t(
        resident_iterator(workdir), validation=resident_iterator(workdir), num_steps=8, num_stages=2,
        validation_steps=3, checkpoint_steps=1000, dynamic_negative_weight=True, max_negative_weight=2.0,
        batch_size_adjust_ratio=1.0, step_adjust_ratio=1.0, learning_rate=1e-2,
    )
    return {**{f"history/{k}": v for k, v in history.items()}, "flat": t._adam.flat.numpy().copy()}


def dcp_round_trip(workdir: str, mesh) -> Dict[str, np.ndarray]:
    """Train 6 steps, save with the DCP backend, resume into a fresh trainer."""
    ckpt = os.path.join(workdir, "dcp-ckpt")
    t = trainer(workdir, ckpt, mesh, checkpoint_backend="dcp")
    t.train_epoch(iter(load_batches(workdir)[:6]), num_steps=6, validation_steps=1000, checkpoint_steps=1000,
                  learning_rate=2e-3)
    t.save_checkpoint("mesh")
    fresh = trainer(workdir, ckpt, mesh, checkpoint_backend="dcp", seed=7)
    before = fresh._adam.flat.clone()
    fresh.resume_dcp("mesh")
    return {"saved": torch.cat([t._adam.flat, t._adam.mu, t._adam.nu]).numpy(),
            "restored": torch.cat([fresh._adam.flat, fresh._adam.mu, fresh._adam.nu]).numpy(),
            "count": np.array([t._adam.count.item(), fresh._adam.count.item()]),
            "moved": np.array(float((before - fresh._adam.flat).abs().max())),
            "files": np.array(sorted(os.listdir(ckpt)))}


def featurize(workdir: str, mesh) -> Dict[str, np.ndarray]:
    from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings

    clips = np.load(os.path.join(workdir, "clips.npy"))
    emb = SpeechEmbeddings(mesh=mesh)
    device, n = emb.featurize_device(clips)
    return {"call": emb(clips), "device": device.numpy(), "n": np.array(n)}


def extract(workdir: str, mesh, out_dir: str) -> Dict[str, np.ndarray]:
    """``extract --mesh`` through the CLI entry on the wavs of WORKDIR/wavs."""
    from heybuddy_tpu_torch.cli import main as cli_main

    rc = cli_main(["extract", "noise", os.path.join(workdir, "wavs", "*.wav"), "--local-files",
                   "--directory", out_dir, "--process-batch-size", "4", "--mesh", "--device", "cpu"])
    return {"rc": np.array(rc), "shards": np.array(sorted(glob.glob(os.path.join(out_dir, "noise-*.npy"))))}


def pretrainer(workdir: str, mesh=None):
    from heybuddy_tpu_torch.training.embedding_pretrain import EmbeddingPretrainer

    data = np.load(os.path.join(workdir, "pretrain.npz"))
    p = EmbeddingPretrainer(texts=[f"text {i}" for i in range(data["pool"].shape[0])], speakers_per_text=2,
                            batch_size=int(data["text_idx"].shape[0]), seed=0, device="cpu",
                            init_weights=os.path.join(workdir, "pretrain-init.npz"), mesh=mesh)
    p._pool, p._pool_lengths = data["pool"], data["lengths"]
    return p


def pretrain_inputs(workdir: str):
    """The step's batch and its two views' draws, as the test wrote them."""
    from heybuddy_tpu_torch.training.embedding_pretrain import PretrainBatch

    data = np.load(os.path.join(workdir, "pretrain.npz"))
    batch = PretrainBatch(data["text_idx"], data["spk_idx"], data["noise_idx"], data["imp_idx"], data["pair_mask"])
    draws = tuple({k.split("/", 1)[1]: torch.from_numpy(data[k]) for k in data.files if k.startswith(f"draw{v}/")}
                  for v in range(2))
    return batch, draws


def flat_grad(p) -> np.ndarray:
    return torch.cat([q.grad.reshape(-1) for q in p.net.parameters()]).numpy().copy()


def pretrain(workdir: str, mesh=None) -> Dict[str, np.ndarray]:
    """One float32 step's losses and gradient, the same gradient without the
    division by W (the control), then the bf16 step's metrics."""
    from heybuddy_tpu_torch.parallel.mesh import all_reduce_sum

    p = pretrainer(workdir, mesh)
    batch, draws = pretrain_inputs(workdir)
    loss = torch.stack(p.backward(batch, 0, draws=draws, compute_dtype=torch.float32)).detach().numpy()
    out = {"loss": loss, "grad": flat_grad(p)}
    if mesh is not None:
        p.optimizer.zero_grad(set_to_none=True)
        p.loss(batch, 0, draws=draws, compute_dtype=torch.float32)[0].backward()
        out["grad_unscaled"] = all_reduce_sum(torch.from_numpy(flat_grad(p)), mesh).numpy()
    out["bf16_metrics"] = p.step(batch, 0, draws=draws).numpy()
    return out


STREAM_STEPS = 24
STREAM_CUSTOM_ROWS = 300  # the unseeded --training-dataset, 1000 rows a step: it wraps and reshuffles


def stream_args(workdir: str, ckpt: str, threads: int) -> List[str]:
    """``train`` on the seeded caches of WORKDIR/streams-data and an unseeded
    ``--training-dataset`` (no hosted set, no evaluation), STREAM_STEPS steps."""
    return ["train", "hey buddy", "--device", "cpu", "--positive-samples", "40", "--adversarial-samples", "40",
            "--validation-samples", "0", "--testing-positive-samples", "0", "--testing-adversarial-samples", "0",
            "--steps", str(STREAM_STEPS), "--stages", "1", "--validation-steps", "1000",
            "--checkpoint-steps", "1000", "--positive-batch-size", "8", "--adversarial-batch-size", "8",
            "--training-no-default-dataset", "--num-batch-threads", str(threads),
            "--training-dataset", os.path.join(workdir, "streams-data", "custom-negatives.npy"),
            "--checkpoint-dir", ckpt]


@contextlib.contextmanager
def recorded_streams(record: Dict[str, list]) -> Iterator[None]:
    """Record what every step serves: the resident plan's index vector (the
    sources' indices, concatenated) and each host batch's per-row sums and
    labels; and the seed rank 0 broadcast."""
    from heybuddy_tpu_torch.data import training
    from heybuddy_tpu_torch.parallel import mesh
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer

    sample, to_device = training.DeviceBatchPlan.sample, WakeWordTrainer._to_device
    broadcast_seed = getattr(mesh, "broadcast_seed", None)  # absent where the ranks drew their own

    def recorded_sample(plan):
        idx = sample(plan)
        record["indices"].append(np.concatenate(idx))
        return idx

    def recorded_to_device(self, x, y):
        record["rows"].append(np.asarray(x, np.float64).sum(axis=(1, 2)))
        record["labels"].append(np.asarray(y).copy())
        return to_device(self, x, y)

    def recorded_seed(mesh):
        record["seed"].append(broadcast_seed(mesh))
        return record["seed"][-1]

    training.DeviceBatchPlan.sample = recorded_sample
    WakeWordTrainer._to_device = recorded_to_device
    if broadcast_seed is not None:
        mesh.broadcast_seed = recorded_seed
    try:
        yield
    finally:
        training.DeviceBatchPlan.sample, WakeWordTrainer._to_device = sample, to_device
        if broadcast_seed is not None:
            mesh.broadcast_seed = broadcast_seed


def index_streams(workdir: str, mesh=None, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``train`` through the CLI entry with ``--mesh`` (or, at one rank, with
    ``seed`` as the sets' ``negative_seed``, as rank 0's draw is under the
    mesh): the resident path's index vectors and final parameters; on the
    mesh also the threaded host path's batches (HEYBUDDY_DEVICE_DATA=0, 2
    producer threads)."""
    from heybuddy_tpu_torch import cli

    saved = {k: os.environ.get(k) for k in ("HEYBUDDY_DATASET_DIR", "HEYBUDDY_DEVICE_DATA")}
    os.environ["HEYBUDDY_DATASET_DIR"] = os.path.join(workdir, "streams-data")
    tag = "mesh" if mesh is not None else "one"
    out: Dict[str, np.ndarray] = {}
    try:
        for label, threads in (("resident", 1), ("threaded", 2)):
            if label == "threaded":
                if mesh is None:
                    break
                os.environ["HEYBUDDY_DEVICE_DATA"] = "0"
            ckpt = os.path.join(workdir, f"streams-ckpt-{tag}-{label}")
            record: Dict[str, list] = {"indices": [], "rows": [], "labels": [], "seed": []}
            args = stream_args(workdir, ckpt, threads)
            train_data = cli._train_data
            if mesh is None:
                cli._train_data = lambda *a, **k: train_data(*a, **{**k, "negative_seed": seed})
            try:
                with recorded_streams(record):
                    assert cli.main(args + (["--mesh"] if mesh is not None else [])) == 0
            finally:
                cli._train_data = train_data
            for key in ("indices", "rows", "labels"):
                if record[key]:
                    out[f"{label}/{key}"] = np.stack(record[key])
            out[f"{label}/seed"] = np.array(record["seed"], np.int64)
            if mesh is None or mesh.rank == 0:
                with np.load(os.path.join(ckpt, "hey-buddy_final.npz")) as final:
                    out[f"{label}/flat"] = np.concatenate(
                        [final[k].astype(np.float32).reshape(-1) for k in sorted(final.files) if k != "__config__"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def main(argv: Sequence[str]) -> None:
    from heybuddy_tpu_torch.parallel.mesh import distributed_init, get_mesh

    torch.set_num_threads(1)
    rank, world, workdir, scenarios = int(argv[0]), int(argv[1]), argv[2], argv[3].split(",")
    os.environ["HEYBUDDY_OFFLINE"] = "1"
    rendezvous = os.path.join(workdir, f"rendezvous-{argv[3]}")
    distributed_init(f"file://{rendezvous}", world, rank, device="cpu")
    mesh = get_mesh(device="cpu")
    for scenario in scenarios:
        t0 = time.perf_counter()
        if scenario == "trainer":
            out = {**{f"steps/{k}": v for k, v in train_steps(workdir, mesh).items()},
                   **{f"resident/{k}": v for k, v in resident_run(workdir, mesh).items()}}
        elif scenario == "featurize":
            out = featurize(workdir, mesh)
        elif scenario == "extract":
            out = extract(workdir, mesh, os.path.join(workdir, "shards-mesh"))
        elif scenario == "dcp":
            out = dcp_round_trip(workdir, mesh)
        elif scenario == "pretrain":
            out = pretrain(workdir, mesh)
        elif scenario == "streams":
            out = index_streams(workdir, mesh)
        else:
            raise ValueError(f"unknown scenario {scenario!r}")
        np.savez(os.path.join(workdir, f"{scenario}-{rank}.npz"), **out)
        print(f"rank {rank}: {scenario} in {time.perf_counter() - t0:.1f} s", flush=True)


class Ranks:
    """``world`` ranks of this module started as processes; ``wait`` joins them."""

    def __init__(self, workdir: str, world: int, scenarios: str) -> None:
        env = {k: v for k, v in os.environ.items() if k not in ("PYTEST_CURRENT_TEST", "PYTHONPATH")}
        env.update(OMP_NUM_THREADS="1", HEYBUDDY_OFFLINE="1")
        self.procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), str(world), workdir, scenarios],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
            for rank in range(world)
        ]

    def wait(self, timeout: float) -> List[str]:
        outputs = []
        try:
            for proc in self.procs:
                outputs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for rank, (proc, out) in enumerate(zip(self.procs, outputs)):
            assert proc.returncode == 0, f"rank {rank} failed (rc={proc.returncode}):\n{out[-4000:]}"
        return outputs


if __name__ == "__main__":
    main(sys.argv[1:])
