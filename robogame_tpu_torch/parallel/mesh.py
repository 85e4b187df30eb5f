"""A mesh of processes for sharding game batches across cards.

Counterpart of the JAX package's ``parallel/mesh.py``.  The batch of games
is the parallel axis: a 1-D ``DeviceMesh`` named ``"games"`` over the
job's processes, one card a process, NCCL between cards and Gloo between
CPU processes.  Each rank steps its own contiguous slice of the batch
(:func:`shard_batch`), so on the card every rank launches its own kernel
grid, and the results are all-gathered at the end
(:func:`..parallel.monte_carlo.monte_carlo`).

Launch a job with ``torchrun --nproc-per-node <cards> <script>`` (the
default ``env://`` rendezvous), or call :func:`init_distributed` with a
coordinator address, the process count and this process's id.  A mesh
made with no process group in place is a mesh of one process.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..config import resolve_device
from ..utils.tree import leaves, tree_map

BATCH_AXIS = "games"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda") -> None:
    """Join the job's process group: NCCL where ``device`` is a card (this
    process then takes card ``LOCAL_RANK`` or its rank, modulo the cards
    it sees), Gloo on the CPU.  Without a coordinator the rendezvous is
    ``env://`` (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as torchrun
    sets them); ``coordinator`` is a ``host:port`` or any init-method URL
    (``tcp://...``, ``file://...``)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator is None:
        dist.init_process_group(backend)
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def _init_single(device) -> None:
    """A process group of this process alone, on a file rendezvous."""
    fd, path = tempfile.mkstemp(prefix="robogame_pg_")
    os.close(fd)               # a new empty file, as the store needs
    init_distributed(f"file://{path}", 1, 0, device)


def make_mesh(n_devices: int | None = None, device="cuda") -> DeviceMesh:
    """The 1-D mesh ``"games"`` over every process of the job (one card a
    process).  With no process group in place and no torchrun
    environment, the job is this process alone."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            init_distributed(device=dev)
        else:
            _init_single(dev)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the job has {world} processes (one card each); "
                         f"a mesh of {n_devices} cannot be made")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if kind != dev.type:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"which does not serve device {dev}")
    return init_device_mesh(kind, (world,), mesh_dim_names=(BATCH_AXIS,))


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """The placements that shard the leading (game) axis over the mesh."""
    return (Shard(0),)


def replicated(mesh: DeviceMesh) -> tuple:
    """The placements that replicate a tensor on every rank."""
    return (Replicate(),)


def shard_batch(tree, mesh: DeviceMesh, batch: int | None = None):
    """This rank's contiguous slice of every batch-leading tensor of a
    nest of named tuples, tuples, lists and dicts; other leaves pass
    through.  ``batch`` is the batch size (by default the leading size of
    the first tensor leaf) and must divide by the mesh's size."""
    n, r = mesh.size(), mesh.get_local_rank(BATCH_AXIS)
    if batch is None:
        batch = next(a.shape[0] for a in leaves(tree)
                     if isinstance(a, torch.Tensor) and a.ndim)
    if batch % n:
        raise ValueError(f"a batch of {batch} does not divide over "
                         f"{n} processes")
    k = batch // n

    def cut(a):
        if isinstance(a, torch.Tensor) and a.ndim and a.shape[0] == batch:
            return a[r * k:(r + 1) * k]
        return a

    return tree_map(cut, tree)
