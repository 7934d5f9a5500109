"""Multi-process initialisation and data distribution, on torch.distributed.

Counterpart of fibers_tpu/parallel/distributed.py.  `initialize()` starts
the process group (NCCL on CUDA, gloo on the CPU), `global_mesh()` builds
a ("data", "model") mesh over every process's devices, and
`shard_voxel_batch()` places each process's rows of the global voxel
batch as the shards of that mesh.  The cross-shard functions of
parallel/mesh.py (`shard_sum`, `shard_max`, `gather_rows`, the TV
reshard) then run `all_reduce`, `all_gather` and `all_to_all_single`
across the processes.  Each process owns whole data rows of the mesh, in
rank order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from .mesh import Mesh, ShardedRows, put_batch

__all__ = ["initialize", "global_mesh", "shard_voxel_batch",
           "process_local_rows"]


def _dist():
    import torch.distributed as dist
    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Start the default process group of a multi-process run.

    `coordinator_address` "host:port" of rank 0, `num_processes` the world
    size and `process_id` this rank; with none of them torchrun's
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) is used.
    The backend is NCCL when `device` (None: the card) is CUDA, gloo on
    the CPU; on CUDA each process takes the card of its local rank.
    Call once per process; a one-process run may skip it."""
    dist = _dist()
    dev = resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, **kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _world():
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(model_axis: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh over every process's devices.

    `devices`: this process's devices (default: its current card, or the
    CPU when the process group runs gloo).  Every process must pass as
    many; the mesh lists them in rank order.  `model_axis` must divide
    each process's count, so no data row spans two processes."""
    world, _ = _world()
    if devices is None:
        dist = _dist()
        gloo = dist.is_initialized() and dist.get_backend() == "gloo"
        devices = [torch.device("cpu") if gloo or not
                   torch.cuda.is_available() else
                   torch.device("cuda", torch.cuda.current_device())]
    local = [torch.device(d) for d in devices]
    if len(local) % model_axis:
        raise ValueError("model_axis must divide each process's device "
                         "count")
    n = len(local) * world
    # the other processes' devices are named like this one's; only the
    # owner's rank decides who touches a shard
    all_devs = local * world
    ranks = np.repeat(np.arange(world), len(local))
    shape = (n // model_axis, model_axis)
    return Mesh(np.array(all_devs, dtype=object).reshape(shape),
                ("data", "model"), ranks=ranks.reshape(shape))


def process_local_rows(n_global: int) -> slice:
    """The half-open row range of the global voxel batch this process
    owns under even sharding over the processes."""
    p, i = _world()
    per = -(-n_global // p)
    return slice(min(i * per, n_global), min((i + 1) * per, n_global))


def shard_voxel_batch(local_rows: np.ndarray, n_global: int,
                      mesh: Mesh) -> ShardedRows:
    """A globally sharded voxel batch from each process's local rows.

    It has `ceil(n_global / process_count) * process_count` rows (one
    process: n_global, then padded to the data axis as `put_batch`
    does); rows past n_global are zero padding that callers mask or cut
    before reductions.  Each process's rows split evenly over its data
    shards of `mesh`."""
    world, rank = _world()
    local_rows = np.ascontiguousarray(local_rows)
    if world == 1:
        buf = local_rows
        if buf.shape[0] != n_global:
            pad = np.zeros((n_global - buf.shape[0],) + buf.shape[1:],
                           buf.dtype)
            buf = np.concatenate([buf, pad], axis=0)
        return put_batch(buf, mesh)
    per = -(-n_global // world)
    if local_rows.shape[0] != per:
        pad = np.zeros((per - local_rows.shape[0],) + local_rows.shape[1:],
                       local_rows.dtype)
        local_rows = np.concatenate([local_rows, pad], axis=0)
    mine = [i for i in range(mesh.ndata) if mesh.is_local(i)]
    if per % len(mine):
        raise ValueError(f"{per} rows per process do not split over its "
                         f"{len(mine)} data shards")
    k = per // len(mine)
    shards = [None] * mesh.ndata
    for j, i in enumerate(mine):
        shards[i] = torch.from_numpy(local_rows[j * k:(j + 1) * k].copy()).to(
            mesh.data_devices[i])
    return ShardedRows(shards, mesh, [k] * mesh.ndata)
