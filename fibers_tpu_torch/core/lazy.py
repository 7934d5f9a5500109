"""Lazily-materialized MRI volumes and arrays backed by torch tensors.

Model fits produce their results as dense [Nmask, nframes] batches on the
device.  A `LazyVolume` keeps the batch there; `MRI.vol`
(core/mri.py) recognises it and materializes it into the usual
[nx,ny,nz,nframes] host array the first time any host code touches it.
Users that never read the field (e.g. a pipeline consuming only peaks +
FA) never pay the device->host copy.

Counterpart of fibers_tpu/core/lazy.py.  Only the fetch differs: the
reference goes through its chunked transfer path; here the tensor is
copied to the host (a volume's real rows, scattered with
`ops.masked.scatter_frames`).  The materialized array is identical to
what an eager path would produce.  The copy is the span `lazy.fetch`,
the scatter `lazy.scatter` (utils/profiling.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fetch
from ..ops.masked import scatter_frames
from ..utils.profiling import span

__all__ = ["LazyVolume", "LazyArray", "lazy_stack_volumes"]


class LazyArray:
    """A torch tensor on any device that copies to the host on first
    access (`np.asarray`, indexing or `materialize`).

    For fit outputs that are plain arrays rather than volumes (e.g. the
    structure tensor's eigenvector/eigenvalue fields): pipelines that
    keep consuming them on the device never pay the copy.
    """

    def __init__(self, values):
        self._values = values
        self._host = None

    @property
    def device(self):
        """The underlying tensor (None once materialized)."""
        return self._values

    @property
    def shape(self):
        return tuple(self._values.shape) if self._host is None \
            else self._host.shape

    @property
    def dtype(self):
        if self._host is None:
            return torch.empty(0, dtype=self._values.dtype).numpy().dtype
        return self._host.dtype

    def __getitem__(self, key):
        return self.materialize()[key]

    def materialize(self) -> np.ndarray:
        if self._host is None:
            with span("lazy.fetch"):
                self._host = fetch(self._values)
            self._values = None      # release device memory
        return self._host

    def __array__(self, dtype=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


class _StackFetch:
    """One [k, n_pad] tensor shared by k lazy volumes: the first access
    copies the whole stack to the host in one transfer."""

    def __init__(self, values):
        self._values = values
        self._host = None

    def row(self, i) -> np.ndarray:
        if self._host is None:
            with span("lazy.fetch"):
                self._host = fetch(self._values)
            self._values = None      # release device memory
        return self._host[i]


def lazy_stack_volumes(stack_dev, idx, shape3):
    """Split a [k, n_pad] stacked tensor into k single-frame
    `LazyVolume`s that share one device->host copy."""
    fetch = _StackFetch(stack_dev)
    k = int(stack_dev.shape[0])
    return [_LazySliceVolume(fetch, i, idx, shape3) for i in range(k)]


class LazyVolume:
    """Device-resident masked batch that scatters into a host volume on
    demand.

    values: [n_pad, nframes] (or [n_pad]) torch tensor on any device,
            rows beyond len(idx) are padding.
    idx:    flat voxel indices (C order) of the masked voxels.
    shape3: the volume's spatial shape.
    nframes: number of frames (1 -> 3D output volume).
    """

    def __init__(self, values, idx, shape3, nframes):
        self._values = values
        self._idx = np.asarray(idx)
        self._shape3 = tuple(int(s) for s in shape3)
        self._nframes = int(nframes)
        self._host = None

    @property
    def shape(self):
        if self._nframes == 1:
            return self._shape3
        return self._shape3 + (self._nframes,)

    @property
    def dtype(self):
        return np.dtype(np.float32)

    def materialize(self) -> np.ndarray:
        """Copy + scatter into the host volume (cached)."""
        if self._host is None:
            with span("lazy.fetch"):
                vals = fetch(self._values[:len(self._idx)])
            with span("lazy.scatter"):
                self._host = scatter_frames(vals, self._idx, self._shape3)
            self._values = None      # release device memory
        return self._host

    def __array__(self, dtype=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


class _LazySliceVolume(LazyVolume):
    """A `LazyVolume` whose batch is one row of a shared `_StackFetch`
    (see `lazy_stack_volumes`)."""

    def __init__(self, fetch, row, idx, shape3):
        super().__init__(None, idx, shape3, 1)
        self._fetch = fetch
        self._row = int(row)

    def materialize(self) -> np.ndarray:
        if self._host is None:
            vals = self._fetch.row(self._row)[:len(self._idx)]
            with span("lazy.scatter"):
                self._host = scatter_frames(vals, self._idx, self._shape3)
            self._fetch = None
        return self._host
