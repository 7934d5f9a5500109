"""Mask gather/scatter between volumes and dense voxel batches.

The TPU-native fit shape is: gather masked voxels into a dense
[Nmask, nvol] batch on host, run jitted batched kernels on device, scatter
results back into volumes.  Padding keeps jit shapes bucketed so recompiles
are rare.
"""

from __future__ import annotations

import numpy as np

__all__ = ["mask_indices", "gather_frames", "scatter_frames", "pad_rows",
           "padded_size"]


def mask_indices(mask_vol: np.ndarray) -> np.ndarray:
    """Flat indices (C order over x,y,z) of nonzero voxels in a 3D mask."""
    m = np.asarray(mask_vol)
    if m.ndim == 4:
        m = m[..., 0]
    return np.flatnonzero(m != 0)


def gather_frames(vol: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """[nx,ny,nz,(nframes)] volume -> [N, nframes] batch at flat indices."""
    v = np.asarray(vol)
    if v.ndim == 3:
        v = v[..., None]
    flat = v.reshape(-1, v.shape[3])
    return np.ascontiguousarray(flat[idx])


def scatter_frames(values: np.ndarray, idx: np.ndarray, shape3,
                   dtype=np.float32) -> np.ndarray:
    """[N, nframes] batch -> [nx,ny,nz,(nframes)] volume (zeros elsewhere)."""
    values = np.asarray(values)
    if values.ndim == 1:
        values = values[:, None]
    nframes = values.shape[1]
    out = np.zeros((int(np.prod(shape3)), nframes), dtype=dtype)
    out[idx] = values
    out = out.reshape(tuple(shape3) + (nframes,))
    if nframes == 1:
        out = out[..., 0]
    return out


def padded_size(n: int, granule: int = 1024) -> int:
    """Round n up to a bucketed size to bound jit recompiles: next power of
    two below 16*granule, then multiples of 16*granule."""
    if n <= granule:
        return granule
    cap = 16 * granule
    if n <= cap:
        p = granule
        while p < n:
            p *= 2
        return p
    return ((n + cap - 1) // cap) * cap


def pad_rows(batch: np.ndarray, n_pad: int, fill=0) -> np.ndarray:
    """Pad the leading axis of `batch` to n_pad rows with `fill`."""
    n = batch.shape[0]
    if n == n_pad:
        return batch
    pad = np.full((n_pad - n,) + batch.shape[1:], fill, dtype=batch.dtype)
    return np.concatenate([batch, pad], axis=0)
