"""Prepared voxel batches: gather once, fit many.

Counterpart of fibers_tpu/core/batch.py with the exact float32 wire
only.  The masked [N, nvol] signal rows are gathered on the host (the
shared numpy helpers of fibers_tpu/ops/masked.py) straight into one
pinned buffer, padded to the same bucketed size as the reference, and
copied to the device once; DTI, GQI and later fits reuse that batch.
With a mesh the padded rows split evenly over its data axis, one upload
per shard (parallel/mesh.py:ShardedRows).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..ops.masked import mask_indices, padded_size
from ..parallel.mesh import ShardedRows, as_mesh, pad_to_multiple, put_batch

__all__ = ["VoxelBatch", "prepare_batch"]


@dataclass
class VoxelBatch:
    idx: np.ndarray          # flat indices of masked voxels
    # [n_pad, nvol] float32 on device, zero pad rows; a ShardedRows when
    # the batch is sharded over a mesh
    signals: object
    n: int                   # number of real voxels

    @property
    def n_pad(self) -> int:
        return self.signals.shape[0]

    @property
    def mesh(self):
        """The mesh this batch is sharded over when it has more than one
        device, else None.  Fits take it from here, with no mesh
        argument of their own."""
        if isinstance(self.signals, ShardedRows) and \
                self.signals.mesh.size > 1:
            return self.signals.mesh
        return None

    @classmethod
    def from_numpy(cls, idx, signals, device=None, mesh=None) -> "VoxelBatch":
        """A batch from host arrays (e.g. a JAX `VoxelBatch` fetched with
        np.asarray): `signals` [n_pad, nvol], rows past len(idx) padding.
        With `mesh` the rows are sharded over its data axis."""
        idx = np.asarray(idx)
        sig = np.array(signals, np.float32)
        if as_mesh(mesh) is not None:
            return cls(idx=idx, signals=put_batch(sig, mesh), n=len(idx))
        return cls(idx=idx, signals=torch.from_numpy(sig).to(resolve(device)),
                   n=len(idx))


def prepare_batch(dwi, mask, mesh=None, wire: str = "auto",
                  device=None) -> VoxelBatch:
    """Gather the masked voxel signals and place them on `device` once.

    `wire`: "auto" and "f32" upload exact float32 rows.  The quantized
    wires of the reference ("u16", "u12", "u8", "auto8") are not ported
    yet and raise, rather than quietly uploading exact data.

    `mesh` (parallel/mesh.py): the padded rows, a multiple of the data
    axis, are sharded over it, one upload per shard; every fit that takes
    the batch then runs once per shard.  `device` is ignored then.
    """
    if wire in ("u16", "u12", "u8", "auto8"):
        raise NotImplementedError(
            f"prepare_batch(wire={wire!r}): the quantized upload wires are "
            "not ported yet (ROADMAP A14); use wire='f32'")
    if wire not in ("auto", "f32"):
        raise ValueError(f"Unknown batch wire {wire!r} "
                         "(expected auto/auto8/u16/u12/u8/f32)")
    mesh = as_mesh(mesh)
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh.flat_devices[0], None
    idx = mask_indices(mask.vol)
    n_pad = padded_size(len(idx))
    if mesh is not None:
        n_pad = pad_to_multiple(n_pad, mesh.ndata)
        devs = [mesh.data_devices[i] for i in range(mesh.ndata)
                if mesh.is_local(i)]
    else:
        devs = [resolve(device)]
    vol = np.asarray(dwi.vol)
    if vol.ndim == 3:
        vol = vol[..., None]
    flat = vol.reshape(-1, vol.shape[3])
    nvol = flat.shape[1]

    pinned = any(d.type == "cuda" for d in devs)
    host = torch.empty((n_pad, nvol), dtype=torch.float32,
                       pin_memory=pinned)
    h = host.numpy()
    if flat.dtype == np.float32:
        np.take(flat, idx, axis=0, out=h[:len(idx)])
    else:
        h[:len(idx)] = flat[idx]
    h[len(idx):] = 0.0
    if mesh is None:
        signals = host.to(devs[0], non_blocking=pinned)
        return VoxelBatch(idx=idx, signals=signals, n=len(idx))
    per = n_pad // mesh.ndata
    shards = [host[i * per:(i + 1) * per].to(d, non_blocking=pinned)
              if mesh.is_local(i) else None
              for i, d in enumerate(mesh.data_devices)]
    return VoxelBatch(idx=idx, signals=ShardedRows(shards, mesh,
                                                   [per] * mesh.ndata),
                      n=len(idx))
