"""
The device mesh of the port: data parallelism on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one program
over a global batch: the batch is sharded over the mesh's ``"data"`` axis,
parameters, optimizer state and resident pools are replicated, and XLA
inserts the reductions. PyTorch runs one process per rank (``torchrun``), so
the port maps that program onto ranks:

* every rank runs the same host program on the same seeded data (the single
  controller's program, replicated) and takes its own rows of each batch,
  padded to a multiple of the data axis; where that program draws from fresh
  entropy (a negative set built without a seed), rank 0 draws and
  ``broadcast_seed`` gives every rank its draw, and where batches are
  ordered by thread timing, ``broadcast_batch`` gives every rank rank 0's;
* collectives over the ``"data"`` group give every rank the global value of
  every count, loss and gradient, so a W-rank run equals the one-rank run on
  the same padded batch up to summation order;
* a ``(data, model)`` mesh with ``model > 1`` is inert along ``model``, as
  the JAX mesh is.

The collectives are the ones gloo runs on CUDA tensors as well as NCCL:
``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier``. Two ranks may
share one card on gloo (NCCL refuses two ranks on one device). A backend
error is never caught and retried on the host.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.utils.log import logger

__all__ = [
    "Mesh",
    "distributed_init",
    "get_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "pad_batch_to_multiple",
    "row_range",
    "gather_rows",
    "all_gather_rows",
    "all_reduce_sum",
    "barrier",
    "broadcast_seed",
    "broadcast_batch",
    "is_main_process",
    "main_process_first",
    "world_size",
]

# the device of this process's rank, set by distributed_init
_DEVICE: Optional[torch.device] = None


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` ``DeviceMesh`` and the device of this rank."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def shape(self) -> dict:
        sizes = self.device_mesh.shape
        return {"data": int(sizes[0]), "model": int(sizes[1])}

    @property
    def size(self) -> int:
        """Ranks along the data axis."""
        return self.shape["data"]

    @property
    def rank(self) -> int:
        """This rank's coordinate along the data axis."""
        return int(self.device_mesh.get_local_rank("data"))

    @property
    def group(self) -> dist.ProcessGroup:
        """The process group of the data axis."""
        return self.device_mesh.get_group("data")

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, device={self.device})"


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"  # torchrun's MASTER_ADDR / MASTER_PORT
    if "://" in coordinator_address:
        return coordinator_address  # tcp://host:port or file:///path
    return f"tcp://{coordinator_address}"


def world_size() -> int:
    """Ranks of the process group, or of the launcher's environment before it exists."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
    timeout: Optional[datetime.timedelta] = None,
) -> None:
    """
    Join the process group (a no-op for one process, or when this process
    already joined). By default the group comes from torchrun's environment:
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``. ``coordinator_address`` is ``host:port``, ``tcp://...``
    or ``file://...``. The rank's device is ``cuda:LOCAL_RANK`` (``cuda:RANK``
    without ``LOCAL_RANK``) unless ``device`` names one with its index;
    ``device="cpu"`` runs the rank on the CPU. The backend is NCCL for a card
    and gloo for the CPU; ``backend="gloo"`` asks for gloo on cards (two
    ranks may then share one). A failing ``init_process_group`` raises.
    """
    global _DEVICE
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address), world_size=num_processes,
        rank=process_id, **kwargs,
    )
    _DEVICE = dev
    logger.info(f"torch.distributed initialized: rank {process_id}/{num_processes} on {dev}, {backend}")


@functools.lru_cache(maxsize=None)
def get_mesh(data: Optional[int] = None, model: int = 1, device: Optional[DeviceLike] = None) -> Mesh:
    """
    The global ``(data, model)`` mesh. ``data`` defaults to the world size
    over ``model``. Without a process group (one process, no launcher) this
    joins a one-rank group on an in-process store, as JAX's mesh over one
    device; ``device`` is then the rank's device (default ``"cuda"``).
    """
    global _DEVICE
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dev = resolve_device("cuda" if device is None else device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
                                world_size=1, rank=0)
        _DEVICE = dev
    dev = _DEVICE if device is None else resolve_device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is None:
        raise RuntimeError("the process group was joined outside distributed_init: pass get_mesh(device=...)")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model > world:
        raise ValueError(f"Mesh {data}x{model} needs {data * model} devices, have {world}")
    if data * model < world:
        logger.warning(
            f"Mesh {data}x{model} uses {data * model} of {world} devices; "
            f"{world - data * model} devices will sit idle"
        )
    device_mesh = init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
    return Mesh(device_mesh, dev)


def batch_sharding(mesh: Mesh) -> Tuple[object, ...]:
    """The DTensor placements of a batch: its leading axis split over the data axis."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated(mesh: Mesh) -> Tuple[object, ...]:
    """The DTensor placements of parameters, optimizer state and scalars: a copy on every rank."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def pad_batch_to_multiple(batch: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """
    Pad axis 0 so it divides evenly across the data axis. Returns (padded, n_real).
    Padding rows are zeros; callers mask them out of losses and metrics.
    """
    n = batch.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    padded = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], dtype=batch.dtype)], axis=0)
    return padded, n


def row_range(n: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(first, end, per_rank) of this rank's rows of an ``n``-row batch padded to
    a multiple of the data axis; rows at or past ``n`` are padding."""
    per = -(-n // mesh.size)
    lo = mesh.rank * per
    return min(lo, n), min(lo + per, n), per


def shard_batch(batch: Union[np.ndarray, torch.Tensor], mesh: Mesh, process_local: bool = False) -> torch.Tensor:
    """
    This rank's rows of a host batch, on its device. By default ``batch`` is
    the global batch (every rank holds all of it) and its rows must divide
    over the data axis (``pad_batch_to_multiple``). With ``process_local``
    the batch is already this rank's rows (the counterpart of
    ``make_array_from_process_local_data``): the global batch is the ranks'
    rows in rank order.
    """
    tensor = torch.as_tensor(batch)
    if not process_local:
        if tensor.shape[0] % mesh.size:
            raise ValueError(f"{tensor.shape[0]} rows do not divide over {mesh.size} ranks of the data axis")
        per = tensor.shape[0] // mesh.size
        tensor = tensor[mesh.rank * per : (mesh.rank + 1) * per]
    return tensor.contiguous().to(mesh.device)


def gather_rows(local: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``local`` rows (``row_range``'s ``per_rank`` each, padding
    included) in rank order, the padding rows past ``n`` dropped."""
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)[:n]


class _AllGatherRows(torch.autograd.Function):
    """``all_gather`` in rank order whose backward sums every rank's upstream
    gradient and keeps this rank's rows: the reduce-scatter of
    ``torch.distributed.nn.functional.all_gather``, through ``all_reduce``,
    which gloo runs on CUDA tensors (gloo has no ``all_to_all``, which that
    function's backward takes on gloo in some PyTorch versions)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:  # type: ignore[override]
        ctx.mesh, ctx.rows = mesh, local.shape[0]
        parts = [torch.empty_like(local) for _ in range(mesh.size)]
        dist.all_gather(parts, local.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):  # type: ignore[override]
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        lo = ctx.mesh.rank * ctx.rows
        return grad[lo : lo + ctx.rows], None


def all_gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``local`` rows in rank order, differentiable. The backward
    pass sums the ranks' gradients: when every rank computes the same loss of
    the gathered rows, the gradient of each rank's rows comes out ``size``
    times the loss's, and the caller scales it."""
    return _AllGatherRows.apply(local, mesh)


def all_reduce_sum(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``tensor`` over the data axis in place; returns it."""
    dist.all_reduce(tensor, group=mesh.group)
    return tensor


def broadcast_seed(mesh: Mesh) -> int:
    """A seed that rank 0 draws from fresh entropy, the same on every rank of
    the data axis: what JAX's one program draws once, the mesh draws once."""
    value = torch.zeros(1, dtype=torch.int64, device=mesh.device)
    if mesh.rank == 0:
        value[0] = int(np.random.SeedSequence().generate_state(1, np.uint64)[0] >> np.uint64(1))
    dist.broadcast(value, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return int(value.item())


def broadcast_batch(batch: Optional[Tuple[np.ndarray, np.ndarray]], mesh: Mesh
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Rank 0's host batch ``(x, y)`` on every rank of the data axis (the other
    ranks' ``batch`` is not read); ``None`` on rank 0, the end of its stream,
    gives ``None`` everywhere."""
    box = [batch if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, 0), group=mesh.group, device=mesh.device)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the data axis (nothing without a mesh)."""
    if mesh is None:
        return
    if mesh.device.type == "cuda" and dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def is_main_process(mesh: Optional[Mesh] = None) -> bool:
    """True on the rank that writes files and prints results (rank 0, or without a mesh)."""
    return mesh is None or mesh.rank == 0


@contextlib.contextmanager
def main_process_first(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the body on rank 0 first and on the other ranks after it (for work
    whose files the others then read, such as generated feature caches)."""
    if not is_main_process(mesh):
        barrier(mesh)
    yield
    if is_main_process(mesh) and mesh is not None:
        barrier(mesh)

