"""
Multi-rank dry run: the FULL training path (featurize -> classify -> BCE ->
Adam, plus the production trainer's evaluation and checkpoints, plus sharded
contrastive pretraining) over an N-rank mesh.

Counterpart of the JAX package's ``parallel/dryrun.py``::

    python -m heybuddy_tpu_torch.parallel.dryrun N [--device cuda|cpu] [--backend nccl|gloo]

spawns N ranks as processes of their own (one card each by default, rank i
on ``cuda:i``; ``--device cpu`` on the CPU with gloo; ``--backend gloo``
lets ranks share cards), rendezvous through a file in a temporary directory
that also holds the checkpoints, and waits for them. Each rank runs:

1. K1 -> K2 featurization of its rows of a 2N-clip batch, then one step of
   the head with the gradient summed over the ranks;
2. ``WakeWordTrainer(mesh=...)`` on batches of 2N + 3 rows (not a multiple
   of N: the padding), with evaluation and checkpoints (npz and DCP);
3. two steps of ``EmbeddingPretrainer(mesh=...)`` on a synthetic pool of
   4N + 1 texts (not a multiple of N: the pool's padding).

The embedding weights are the bundled npz's. Rank 0 prints
``dryrun(N): OK`` at the end; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(n: int, rank: int, workdir: str, device: str = "cuda", backend: Optional[str] = None) -> None:
    """One rank's dry run; ``workdir`` is shared by the ranks (rendezvous file, checkpoints)."""
    from heybuddy_tpu_torch.constants import CLIP_SAMPLES
    from heybuddy_tpu_torch.convert import embedding_params_from_numpy
    from heybuddy_tpu_torch.models import embedding_net
    from heybuddy_tpu_torch.models.featurizer import featurize_batch
    from heybuddy_tpu_torch.parallel.distributed_smoke import smoke_step
    from heybuddy_tpu_torch.parallel.mesh import barrier, distributed_init, get_mesh, shard_batch
    from heybuddy_tpu_torch.training.embedding_pretrain import EmbeddingPretrainer
    from heybuddy_tpu_torch.training.trainer import WakeWordTrainer

    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    distributed_init(f"file://{os.path.join(workdir, 'rendezvous')}", n, rank, backend=backend, device=device)
    mesh = get_mesh(data=n, model=1, device=device)
    rng = np.random.default_rng(0)

    # --- 1. audio -> features -> loss -> update, the batch sharded over the data axis ---
    net = embedding_params_from_numpy(embedding_net.default_params()).to(mesh.device).eval()
    batch = 2 * n
    audio = rng.normal(0, 1000.0, (batch, CLIP_SAMPLES)).astype(np.float32)
    labels = (np.arange(batch) % 2).astype(np.float32)
    with torch.no_grad():
        feats = featurize_batch(net, shard_batch(audio, mesh))
    _, loss, _ = smoke_step(feats, shard_batch(labels, mesh), mesh, mesh.device)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun: non-finite loss {loss} of the featurize + train step")
    print(f"[dryrun rank {rank}] fused featurize+train step over {n} ranks OK, loss={loss:.5f}", flush=True)

    # --- 2. the production trainer under the mesh: train + eval + checkpoints ---
    ckpt_dir = os.path.join(workdir, "checkpoints")
    trainer = WakeWordTrainer(checkpoint_dir=ckpt_dir, num_layers=1, mesh=mesh, seed=0, checkpoint_backend="dcp")
    n_train = 3  # deliberately NOT a multiple of n: the padding
    feats_np = rng.normal(0, 1, (4, n * 2 + n_train, 16, 96)).astype(np.float32)
    ys = (rng.random((4, n * 2 + n_train)) < 0.5).astype(np.float32)
    history = trainer.train_epoch(
        list(zip(feats_np, ys)), validation=[(feats_np[0], np.zeros_like(ys[0]))], num_steps=4,
        validation_steps=2, checkpoint_steps=2, name="dryrun", description="Dryrun",
    )
    barrier(mesh)
    written = os.listdir(ckpt_dir)
    if "dryrun_2.npz" not in written or "dryrun_2_dcp" not in written:
        raise RuntimeError(f"dryrun: the trainer did not write its checkpoints under the mesh: {written}")
    if not np.isfinite(history["loss"]).all():
        raise RuntimeError(f"dryrun: non-finite training loss: {history['loss']}")
    trainer.resume_dcp("dryrun_2")
    print(f"[dryrun rank {rank}] production trainer over {n} ranks OK (train + padded eval + npz and DCP "
          f"checkpoints), final loss={history['loss'][-1]:.5f}", flush=True)

    # --- 3. contrastive embedding pretraining sharded over the mesh ---
    os.environ.setdefault("HEYBUDDY_OFFLINE", "1")
    n_texts = 4 * n + 1  # NOT divisible: the pool's padding
    pretrainer = EmbeddingPretrainer(
        texts=[f"dryrun text {i}" for i in range(n_texts)], speakers_per_text=2, batch_size=n,
        mesh=mesh, seed=0,
    )
    # a synthetic pool: the TTS is host work, beside the sharding under test
    pretrainer._pool = rng.normal(0, 0.1, (n_texts, 2, CLIP_SAMPLES)).astype(np.float32)
    pretrainer._pool_lengths = np.full((n_texts, 2), CLIP_SAMPLES, dtype=np.int32)
    pretrainer.train(steps=2, log_every=1)
    if not all(np.isfinite(np.asarray(v)).all() for v in embedding_net.flatten_params(pretrainer.net).values()):
        raise RuntimeError("dryrun: non-finite embedding parameters after the sharded pretrain steps")
    print(f"[dryrun rank {rank}] sharded contrastive pretrain steps over {n} ranks OK", flush=True)
    barrier(mesh)
    if rank == 0:
        print(f"dryrun({n}): OK", flush=True)


def launch(n: int, device: str = "cuda", backend: Optional[str] = None, timeout: float = 600.0) -> List[str]:
    """Start ``n`` ranks of this module and wait for them; returns their outputs
    and raises if any rank failed."""
    if device == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("CUDA is not available; pass --device cpu to run the ranks on the CPU")
        if n > cards and (backend or "nccl") == "nccl":
            raise RuntimeError(f"{n} ranks on {cards} card(s): NCCL needs a card a rank; pass --backend gloo "
                               "to let ranks share cards")
    with tempfile.TemporaryDirectory() as workdir:
        extra = ["--device", device] + ([] if backend is None else ["--backend", backend])
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "heybuddy_tpu_torch.parallel.dryrun", str(n), "--rank", str(rank),
                 "--workdir", workdir, *extra],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
            )
            for rank in range(n)
        ]
        outputs = []
        try:
            for proc in procs:
                outputs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    failed = [(rank, p.returncode) for rank, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun ranks failed {failed}:\n" + "\n".join(o[-3000:] for o in outputs))
    return outputs


def main() -> None:
    parser = argparse.ArgumentParser(description="data-parallel dry run over N ranks")
    parser.add_argument("n", type=int, nargs="?", default=2)
    parser.add_argument("--device", default="cuda", help="cuda (default: rank i on cuda:i) or cpu")
    parser.add_argument("--backend", default=None, help="nccl (the default on cards) or gloo")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        run(args.n, args.rank, args.workdir, args.device, args.backend)
        return
    for out in launch(args.n, args.device, args.backend):
        sys.stdout.write(out)


if __name__ == "__main__":
    main()
