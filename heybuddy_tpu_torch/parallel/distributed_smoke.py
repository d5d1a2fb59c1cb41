"""
Multi-process distributed smoke: one data-parallel train step across N ranks.

Counterpart of the JAX package's ``parallel/distributed_smoke.py``. Each rank
joins the process group (``distributed_init``), builds the mesh, draws its
OWN rows from ``default_rng(100 + rank)`` and runs one production-shaped
step of the head (classifier forward -> BCE over the global batch ->
gradient summed over the ranks -> Adam), so that the ranks can only agree
if the gradient's ``all_reduce`` crossed the process boundary.

Run one rank (a launcher starts ``num_processes`` of these, or torchrun
without the positional arguments)::

    python -m heybuddy_tpu_torch.parallel.distributed_smoke \\
        <process_id> <num_processes> <coordinator> [--device cpu] [--backend gloo] [--out step.npz]

The coordinator is ``host:port``, ``tcp://host:port`` or ``file:///path``.
Prints ``DISTRIBUTED-SMOKE-OK pid=<i> loss=<f> gsum=<f> digest=<hex>``:
``gsum`` sums every rank's batch rows, and ``digest`` hashes the updated
parameters; the launcher checks that both agree across ranks. ``--out``
writes the rank's rows, the loss and the updated parameters as an npz (a
``{rank}`` in the path is replaced by the rank), so that one process's step
on the concatenated batch can be compared.
"""

from __future__ import annotations

import argparse
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

ROWS = 8  # rows each rank draws


def local_batch(process_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """The rank's own rows: features from ``default_rng(100 + rank)``, labels alternating."""
    rng = np.random.default_rng(100 + process_id)
    x = rng.normal(0, 1, (ROWS, 16, 96)).astype(np.float32)
    y = (np.arange(ROWS) % 2).astype(np.float32)
    return x, y


def smoke_step(x: torch.Tensor, y: torch.Tensor, mesh: Optional[object] = None,
               device: torch.device = torch.device("cpu")) -> Tuple[torch.nn.Module, float, float]:
    """One Adam step (lr 1e-3) of a one-layer head from its seed-0 parameters on
    the BCE of the global batch; under ``mesh`` ``x`` / ``y`` are this rank's
    rows. Returns the model, the loss and the global sum of the batch."""
    from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel
    from heybuddy_tpu_torch.parallel.mesh import all_reduce_sum

    model = WakeWordMLPModel(num_layers=1, seed=0, device=device)
    params = list(model.parameters())
    optimizer = torch.optim.Adam(params, lr=1e-3)
    rows = x.shape[0] * (1 if mesh is None else mesh.size)
    preds = model(x)[:, 0].clamp(1e-7, 1 - 1e-7)
    loss = -(y * torch.log(preds) + (1 - y) * torch.log(1 - preds)).sum() / rows
    grads = torch.autograd.grad(loss, params)
    gsum = x.sum() + y.sum()
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach()[None], gsum[None]])
    if mesh is not None:
        all_reduce_sum(flat, mesh)
    for p, g in zip(params, flat[:-2].split([p.numel() for p in params])):
        p.grad = g.view_as(p)
    optimizer.step()
    return model, float(flat[-2]), float(flat[-1])


def run(process_id: Optional[int], num_processes: Optional[int], coordinator: Optional[str],
        device: str = "cuda", backend: Optional[str] = None, out: Optional[str] = None) -> None:
    from heybuddy_tpu_torch.parallel.mesh import distributed_init, get_mesh, shard_batch

    distributed_init(coordinator, num_processes, process_id, backend=backend, device=device)
    mesh = get_mesh(device=device)
    x_local, y_local = local_batch(mesh.rank)
    x = shard_batch(x_local, mesh, process_local=True)
    y = shard_batch(y_local, mesh, process_local=True)
    model, loss, gsum = smoke_step(x, y, mesh, mesh.device)

    digest = hashlib.sha256()
    flat = {name: p.detach().cpu().numpy() for name, p in model.named_parameters()}
    for name in sorted(flat):
        digest.update(np.ascontiguousarray(flat[name]).tobytes())
    if out is not None:
        np.savez(out.format(rank=mesh.rank), x=x_local, y=y_local, loss=loss, gsum=gsum,
                 **{f"param/{k}": v for k, v in flat.items()})
    print(
        f"DISTRIBUTED-SMOKE-OK pid={mesh.rank} loss={loss:.6f} "
        f"gsum={gsum:.3f} digest={digest.hexdigest()[:16]}",
        flush=True,
    )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("process_id", type=int, nargs="?")
    parser.add_argument("num_processes", type=int, nargs="?")
    parser.add_argument("coordinator", nargs="?")
    parser.add_argument("--device", default="cuda", help="cuda (default, cuda:LOCAL_RANK) or cpu")
    parser.add_argument("--backend", default=None, help="nccl (the default on cards) or gloo")
    parser.add_argument("--out", default=None, help="write the rank's rows, loss and parameters here")
    args = parser.parse_args()
    run(args.process_id, args.num_processes, args.coordinator, args.device, args.backend, args.out)


if __name__ == "__main__":
    main()
