"""Prepared voxel batches: gather once, fit many.

Counterpart of fibers_tpu/core/batch.py with the exact float32 wire
only.  The masked [N, nvol] signal rows are gathered on the host (the
shared numpy helpers of fibers_tpu/ops/masked.py) straight into one
pinned buffer, padded to the same bucketed size as the reference, and
copied to the device once; DTI, GQI and later fits reuse that batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..ops.masked import mask_indices, padded_size

__all__ = ["VoxelBatch", "prepare_batch"]


@dataclass
class VoxelBatch:
    idx: np.ndarray          # flat indices of masked voxels
    signals: torch.Tensor    # [n_pad, nvol] float32 on device, zero pad rows
    n: int                   # number of real voxels

    @property
    def n_pad(self) -> int:
        return self.signals.shape[0]

    @classmethod
    def from_numpy(cls, idx, signals, device=None) -> "VoxelBatch":
        """A batch from host arrays (e.g. a JAX `VoxelBatch` fetched with
        np.asarray): `signals` [n_pad, nvol], rows past len(idx) padding."""
        idx = np.asarray(idx)
        sig = torch.from_numpy(np.array(signals, np.float32))
        return cls(idx=idx, signals=sig.to(resolve(device)), n=len(idx))


def prepare_batch(dwi, mask, mesh=None, wire: str = "auto",
                  device=None) -> VoxelBatch:
    """Gather the masked voxel signals and place them on `device` once.

    `wire`: "auto" and "f32" upload exact float32 rows.  The quantized
    wires of the reference ("u16", "u12", "u8", "auto8") are not ported
    yet and raise, rather than quietly uploading exact data.  `mesh`
    (multi-device batches) is not ported yet either.
    """
    if wire in ("u16", "u12", "u8", "auto8"):
        raise NotImplementedError(
            f"prepare_batch(wire={wire!r}): the quantized upload wires are "
            "not ported yet (ROADMAP A14); use wire='f32'")
    if wire not in ("auto", "f32"):
        raise ValueError(f"Unknown batch wire {wire!r} "
                         "(expected auto/auto8/u16/u12/u8/f32)")
    if mesh is not None:
        raise NotImplementedError(
            "prepare_batch(mesh=): multi-device batches are not ported yet "
            "(ROADMAP A13)")
    dev = resolve(device)

    idx = mask_indices(mask.vol)
    n_pad = padded_size(len(idx))
    vol = np.asarray(dwi.vol)
    if vol.ndim == 3:
        vol = vol[..., None]
    flat = vol.reshape(-1, vol.shape[3])
    nvol = flat.shape[1]

    pinned = dev.type == "cuda"
    host = torch.empty((n_pad, nvol), dtype=torch.float32,
                       pin_memory=pinned)
    h = host.numpy()
    if flat.dtype == np.float32:
        np.take(flat, idx, axis=0, out=h[:len(idx)])
    else:
        h[:len(idx)] = flat[idx]
    h[len(idx):] = 0.0
    signals = host.to(dev, non_blocking=pinned)
    return VoxelBatch(idx=idx, signals=signals, n=len(idx))
