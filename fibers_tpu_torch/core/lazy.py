"""Lazily-materialized MRI volumes and arrays backed by torch tensors.

Model fits produce their results as dense [Nmask, nframes] batches on the
device.  A `LazyVolume` keeps the batch there; `MRI.vol`
(core/mri.py) recognises it and materializes it into the usual
[nx,ny,nz,nframes] host array the first time any host code touches it.
Users that never read the field (e.g. a pipeline consuming only peaks +
FA) never pay the device->host copy.

Counterpart of fibers_tpu/core/lazy.py.  Only the fetch differs: the
reference goes through its chunked transfer path; here a volume comes to
the host through `host_volumes`, the one route from device rows to host
volumes, which DTI's and ADC's results take too (models/dti.py).  The
rows are scattered on their device into one zeroed buffer that holds the
volumes back to back, the buffer comes to the host in one copy (from a
CUDA device into a pinned block of torch's caching host allocator), and
each volume is a numpy view of that copy.  Sibling volumes share one
`_LazyGroup`: the first touch of any of them brings every one of them
in one copy (GQI's and DSI's three peak and three QA volumes,
`lazy_peak_volumes`; `lazy_stack_volumes`).  A wide volume that a user
may never read (an ODF, a PDF, an fODF) stays a group of its own.

Every view keeps the whole block alive through its `base`, so a caller
who keeps one volume of a group holds the group's pinned memory;
`np.array(vol)` copies a volume out to keep it alone.  When the last
view is dropped the block goes back to the pool, still page-locked, and
the next subject takes it again without a new page-locked allocation.

The materialized array is identical to what an eager path would produce:
the values are copied, not computed, so every volume holds the same bits
as `ops.masked.scatter_frames` of the fetched rows.  The copy is the
span `lazy.fetch`, the scatter `lazy.scatter`; the counters
`lazy.volumes`, `lazy.copies` and `lazy.host_scatter` say how often each
route ran (utils/profiling.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import fetch, upload
from ..ops.masked import scatter_frames
from ..parallel.mesh import ShardedRows, map_shards
from ..utils.profiling import count, span

__all__ = ["LazyVolume", "LazyArray", "lazy_stack_volumes"]


def _columns(x):
    """An array or tensor [n, ...] as [n, ncol]."""
    return x.reshape(x.shape[0], int(np.prod(x.shape[1:])))


def _side_by_side(*parts):
    """Tensors [n, ...] as the columns of one [n, ncol] tensor."""
    cols = [_columns(x) for x in parts]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def host_volumes(rows, idx, shape3, cols, stage, free=None):
    """One host volume per column group `(lo, hi)` of the result `rows`
    [n, ncol] (or [n] for one column) at the flat voxel indices `idx`:
    float32, C-contiguous, `shape3` for one column and
    `shape3 + (hi - lo,)` for more, zero outside the mask.  The spans
    `<stage>.scatter` and `<stage>.fetch` hold the work, and the counters
    `<stage>.volumes`, `<stage>.copies` and `<stage>.host_scatter` count
    the volumes made, the buffers brought to the host for them (one a
    call; from a CPU device the buffer is the host array itself) and the
    volumes that took the host route (utils/profiling.py).

    The rows are scattered on their device into one zeroed buffer, each
    group's volume a contiguous slice; the buffer comes to the host in one
    copy (pinned from a CUDA device) and each volume is a view of it.  A
    `ShardedRows` result (rows on several devices) is first gathered onto
    one of them.  When the buffer does not fit in the device's `free`
    bytes (default: `torch.cuda.mem_get_info`'s on a CUDA device, no
    limit on others), the rows come to the host as they are and each
    volume is scattered there by `ops.masked.scatter_frames`.  Either
    way the volumes hold the same bits as `scatter_frames` of the fetched
    rows.  An index outside the grid raises `IndexError`."""
    shape3 = tuple(int(s) for s in shape3)
    nxyz = int(np.prod(shape3))
    idx = np.asarray(idx, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= nxyz):
        raise IndexError(f"voxel index outside the {shape3} grid: "
                         f"{idx.min()}..{idx.max()}")
    cols = [(int(lo), int(hi)) for lo, hi in cols]
    width = sum(hi - lo for lo, hi in cols)
    if free is None and rows.device.type == "cuda":
        free = torch.cuda.mem_get_info(rows.device)[0]
    count(stage + ".volumes", len(cols))
    count(stage + ".copies", 1)
    if free is not None and 4 * nxyz * width > free:
        count(stage + ".host_scatter", len(cols))
        with span(stage + ".fetch"):
            arr = _columns(fetch(rows))
        with span(stage + ".scatter"):
            return [scatter_frames(arr[:, lo:hi], idx, shape3)
                    for lo, hi in cols]
    with span(stage + ".scatter"):
        if isinstance(rows, ShardedRows):
            rows = rows.gather()
        rows = _columns(rows).to(torch.float32)
        idx_dev = upload(idx, rows.device)
        buf = torch.zeros(nxyz * width, dtype=torch.float32,
                          device=rows.device)
        host = (torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
                if buf.is_cuda else buf)
        flat = host.numpy()
        vols, off = [], 0
        for lo, hi in cols:
            n = nxyz * (hi - lo)
            buf[off:off + n].view(nxyz, hi - lo).index_copy_(
                0, idx_dev, rows[:, lo:hi])
            vols.append(flat[off:off + n].reshape(
                shape3 + ((hi - lo,) if hi - lo > 1 else ())))
            off += n
    with span(stage + ".fetch"):
        if host is not buf:
            count("transfer.d2h_bytes", buf.nbytes)
            host.copy_(buf)
    return vols


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
            self._host, = host_volumes(self._values[:len(self._idx)],
                                       self._idx, self._shape3,
                                       [(0, self._nframes)], "lazy")
            self._values = None      # release device memory
        return self._host

    def __array__(self, dtype=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


class _LazyGroup:
    """The device rows of sibling lazy volumes that reach the host
    together: `parts` (tensors or `ShardedRows` of at least len(idx) rows,
    each [n_pad, ...] taken as [n_pad, ncol]) side by side, and one column
    group `(lo, hi)` of them per member.  The first touch of any member
    brings every member to the host in one `host_volumes` call, and the
    device rows are dropped."""

    def __init__(self, parts, idx, shape3, cols):
        self._parts = tuple(parts)
        self._idx = np.asarray(idx)
        self._shape3 = tuple(int(s) for s in shape3)
        self._cols = [(int(lo), int(hi)) for lo, hi in cols]
        self._host = None

    def volumes(self):
        """The members, one `LazyVolume` per column group."""
        return [_GroupVolume(self, i) for i in range(len(self._cols))]

    def host(self, i) -> np.ndarray:
        if self._host is None:
            n = len(self._idx)
            rows = map_shards(_side_by_side, *(p[:n] for p in self._parts))
            self._host = host_volumes(rows, self._idx, self._shape3,
                                      self._cols, "lazy")
            self._parts = None       # release device memory
        return self._host[i]


class _GroupVolume(LazyVolume):
    """A `LazyVolume` that is member `i` of a `_LazyGroup`."""

    def __init__(self, group, i):
        lo, hi = group._cols[i]
        super().__init__(None, group._idx, group._shape3, hi - lo)
        self._group, self._i = group, i

    def materialize(self) -> np.ndarray:
        if self._host is None:
            self._host = self._group.host(self._i)
            self._group = None
        return self._host


def lazy_stack_volumes(stack_dev, idx, shape3):
    """Split a [k, n_pad] stacked tensor into k single-frame
    `LazyVolume`s that share one device->host copy."""
    k = int(stack_dev.shape[0])
    return _LazyGroup((stack_dev.T,), idx, shape3,
                      [(i, i + 1) for i in range(k)]).volumes()


def lazy_peak_volumes(vecs, amp, idx, shape3):
    """The k peak volumes of `vecs` [n_pad, k, 3] (3 frames each) and the
    k single-frame volumes of `amp` [n_pad, k], as lazy volumes that
    share one device->host copy: (peaks, amplitudes)."""
    k = int(vecs.shape[1])
    cols = [(3 * i, 3 * i + 3) for i in range(k)] + \
        [(3 * k + i, 3 * k + i + 1) for i in range(k)]
    vols = _LazyGroup((vecs, amp), idx, shape3, cols).volumes()
    return vols[:k], vols[k:]
