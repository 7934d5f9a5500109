"""Device meshes and row-sharded tensors for multi-device runs.

Counterpart of fibers_tpu/parallel/mesh.py and of the `jax.sharding.Mesh`
that the reference's tests build directly.  The workload is parallel over
masked voxels (fits) and seeds (tractography); the only cross-shard
dependencies are a few global reductions (GQI/DSI QA normalisation,
RUMBA's mean sigma^2 and lambda) and RUMBA's TV term, whose stencils need
whole volumes per component.  GSPMD inserts those collectives for the
reference; here they are the explicit functions at the end of this module,
and a fit runs its row-wise work once per data shard.

A fit is written once for one device and for a mesh.  Its row work goes
through `map_shards` or `per_shard`, which call it once on plain tensors;
its constants through `replicate`, `spread` and `per_device`, which give a
tensor without a mesh; its reductions through `shard_sum`, `shard_max` and
`row_mean`, whose one-shard case is the one value's own.  `resolve_mesh`
holds the rule that a one-device mesh runs unsharded on its device.

A `Mesh` is an array of `torch.device`s with named axes, "data" and
optionally "model".  A device may repeat: `Mesh(np.array([cuda0, cuda0]),
("data",))` runs two shards on one card, and `make_mesh(n, device="cpu")`
n shards on the CPU (the counterpart of XLA's forced host device count).
Rows sharded over "data" live in a `ShardedRows`: one tensor per data
index, on that index's first device (the reference's P("data") replicates
rows over the model axis; the model axis gets work only in the TV
reshard).  A mesh that spans processes (parallel/distributed.py) holds
only its own process's shards; the cross-shard functions then go through
`torch.distributed`.

Copies between devices are enqueued with `non_blocking=True`: PyTorch
orders a device-to-device copy after the current streams of both devices,
so no host synchronisation is needed.  Only a copy into host memory
(`ShardedRows.cpu()`) waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve, upload

__all__ = ["Mesh", "ShardedRows", "Sharding", "make_mesh", "batch_sharding",
           "batch_model_sharding", "put_batch", "pad_to_multiple",
           "shard_sum", "shard_max", "gather_rows", "rows_to_components",
           "components_to_rows", "as_mesh", "as_tensor", "map_shards",
           "replicate"]


class Mesh:
    """Devices with named axes.

    `devices`: an array (or nested list) of `torch.device`s (or strings)
    shaped by `axis_names`, which must include "data".  `ranks`: the
    process that owns each device (parallel/distributed.py); None means
    every device belongs to this process.  `shape` maps each axis name to
    its size, as `jax.sharding.Mesh.shape` does."""

    def __init__(self, devices, axis_names, ranks=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in np.ndenumerate(src):
            arr[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"Mesh: devices of shape {arr.shape} do not "
                             f"match the axes {self.axis_names}")
        if "data" not in self.axis_names:
            raise ValueError("Mesh: a 'data' axis is required")
        if arr.size == 0:
            raise ValueError("Mesh: no devices")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))
        me = _rank()
        self.ranks = (np.full(arr.shape, me, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(arr.shape))
        # [ndata, rest] in the reference's device order: the data index,
        # then the remaining axes in order (rumba.py:_tv_term's `ri`)
        ax = self.axis_names.index("data")
        self._by_data = np.moveaxis(arr, ax, 0).reshape(arr.shape[ax], -1)
        self._rank_by_data = np.moveaxis(self.ranks, ax, 0).reshape(
            arr.shape[ax], -1)
        if self.multiprocess:
            flat = self._rank_by_data.reshape(-1)
            if (np.diff(flat) < 0).any() or \
                    (self._rank_by_data != self._rank_by_data[:, :1]).any():
                raise ValueError(
                    "Mesh: across processes, each process must own whole "
                    "data rows, in rank order")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def ndata(self) -> int:
        return int(self.shape["data"])

    @property
    def multiprocess(self) -> bool:
        return len(np.unique(self.ranks)) > 1

    @property
    def flat_devices(self) -> List[torch.device]:
        """Every device, data index first (repeats kept)."""
        return list(self._by_data.reshape(-1))

    @property
    def data_devices(self) -> List[torch.device]:
        """The device that holds each data index's rows."""
        return list(self._by_data[:, 0])

    def is_local(self, i: int) -> bool:
        """Whether data shard i belongs to this process."""
        return int(self._rank_by_data[i, 0]) == _rank()

    def local_flat(self) -> List[int]:
        """Flat indices of this process's devices."""
        me = _rank()
        return [k for k, r in enumerate(self._rank_by_data.reshape(-1))
                if int(r) == me]

    def distinct_devices(self) -> List[torch.device]:
        """This process's devices, each once, in mesh order."""
        out = []
        for k in self.local_flat():
            d = self.flat_devices[k]
            if d not in out:
                out.append(d)
        return out

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.flat_devices})"


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def as_mesh(mesh) -> Optional[Mesh]:
    """`mesh` checked: None, or a `Mesh`."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    raise TypeError(f"mesh= must be a fibers_tpu_torch.parallel.mesh.Mesh "
                    f"(make_mesh), got {type(mesh).__name__}")


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              device=None) -> Mesh:
    """A ("data", "model") mesh over the first n devices.

    `device=None` (or "cuda") spans distinct CUDA devices and raises when
    fewer than `n_devices` exist; `device="cpu"` gives n CPU shards (one
    when n is None).  `model_axis` > 1 splits the devices of each data
    index over a model axis (RUMBA's TV term reshards its components over
    every device)."""
    dev = resolve(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev] * (1 if n_devices is None else int(n_devices))
    if n_devices is None:
        n_devices = len(devs)
    if n_devices < 1:
        raise ValueError(f"Requested {n_devices} devices")
    if n_devices > len(devs):
        raise ValueError(f"Requested {n_devices} devices, have {len(devs)}")
    if n_devices % model_axis:
        raise ValueError("model_axis must divide n_devices")
    arr = np.empty((n_devices // model_axis, model_axis), dtype=object)
    for k, d in enumerate(devs[:n_devices]):
        arr[k // model_axis, k % model_axis] = d
    return Mesh(arr, ("data", "model"))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class Sharding:
    """Where a batch goes on a mesh (the reference's NamedSharding):
    `spec` ("data",) or ("data", "model").  Both place whole rows per data
    index: the model axis takes its share of work only in RUMBA's TV
    reshard (`rows_to_components`), where the reference's P("data",
    "model") operands meet it."""

    mesh: Mesh
    spec: tuple

    def place(self, arr: np.ndarray) -> "ShardedRows":
        return put_batch(arr, self.mesh)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (voxel/seed) axis across the data axis."""
    return Sharding(mesh, ("data",))


def batch_model_sharding(mesh: Mesh) -> Sharding:
    """Shard [batch, feature] across (data, model)."""
    return Sharding(mesh, ("data", "model"))


class ShardedRows:
    """The rows of one [n, ...] tensor split over a mesh's data axis.

    `shards[i]` holds rows `offsets[i]:offsets[i] + rows[i]` on
    `mesh.data_devices[i]` (None when another process owns it).  Row
    counts may differ between shards, and may be 0.

    Supports what the fits need of a tensor: `shape`, `dtype`, `device`,
    `map`, a row slice with per-shard indexing (`x[:n, 0]`), `cpu()` and
    `numpy()` (the rows in order on the host), `gather(device)`."""

    def __init__(self, shards, mesh: Mesh, rows=None):
        self.mesh = mesh
        self.shards = list(shards)
        if rows is None:
            if any(s is None for s in self.shards):
                raise ValueError("ShardedRows: row counts of remote shards "
                                 "must be given")
            rows = [int(s.shape[0]) for s in self.shards]
        self.rows = [int(r) for r in rows]
        self.offsets = [0] + list(np.cumsum(self.rows)[:-1].astype(int))
        ref = next((s for s in self.shards if s is not None), None)
        if ref is None:
            raise ValueError("ShardedRows: this process holds no shard")
        self._tail = tuple(ref.shape[1:])
        self.dtype = ref.dtype
        self.device = ref.device

    @property
    def shape(self):
        return (sum(self.rows),) + self._tail

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def local(self):
        """(data index, shard) of this process's shards."""
        return [(i, s) for i, s in enumerate(self.shards) if s is not None]

    def map(self, fn) -> "ShardedRows":
        """fn applied to every local shard (fn keeps the row count)."""
        return ShardedRows([None if s is None else fn(s)
                            for s in self.shards], self.mesh, self.rows)

    def __getitem__(self, key):
        key = key if isinstance(key, tuple) else (key,)
        rsl, rest = key[0], key[1:]
        if not isinstance(rsl, slice) or rsl.step not in (None, 1):
            raise IndexError("ShardedRows: the row index must be a slice")
        lo, hi, _ = rsl.indices(self.shape[0])
        shards, rows = [], []
        for s, o, r in zip(self.shards, self.offsets, self.rows):
            a = min(max(lo - o, 0), r)
            b = max(min(hi - o, r), a)
            shards.append(None if s is None else s[(slice(a, b),) + rest])
            rows.append(b - a)
        return ShardedRows(shards, self.mesh, rows)

    def gather(self, device=None) -> torch.Tensor:
        """All rows, in order, as one tensor on `device` (default: the
        first shard's)."""
        return gather_rows(self, self.device if device is None else device)

    def cpu(self) -> torch.Tensor:
        return self.gather(torch.device("cpu"))

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()


def per_shard(fn, *xs):
    """fn's results over row-aligned arguments, a list with one per local
    shard in order: once per local shard where the first argument is a
    `ShardedRows` (a `ShardedRows` argument gives its shard, a dict keyed
    by device the entry for the shard's device, a list its entry for the
    shard's place among the local ones, anything else itself), else once
    on the arguments as they are (a list its one entry)."""
    x0 = xs[0]
    if not isinstance(x0, ShardedRows):
        return [fn(*(x[0] if isinstance(x, list) else x for x in xs))]

    def arg(x, k, i, d):
        if isinstance(x, ShardedRows):
            return x.shards[i]
        if isinstance(x, list):
            return x[k]
        return x[d] if isinstance(x, dict) else x

    return [fn(*(arg(x, k, i, s.device) for x in xs))
            for k, (i, s) in enumerate(x0.local())]


def map_shards(fn, *xs):
    """`per_shard`'s results laid out as the first argument: a
    `ShardedRows` over its shards, or the one result.  A tuple result
    becomes a tuple of them."""
    outs = per_shard(fn, *xs)
    if not isinstance(outs[0], tuple):
        return from_shards(outs, xs[0])
    return tuple(from_shards([o[k] for o in outs], xs[0])
                 for k in range(len(outs[0])))


def replicate(arr, mesh: Optional[Mesh], device=None):
    """A host array as a tensor on `device`, or with a mesh as {device: a
    copy} over the mesh's devices of this process (`map_shards` picks each
    shard's)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if mesh is None:
        return t.to(device)
    return {d: t.to(d) for d in mesh.distinct_devices()}


def spread(t: torch.Tensor, like):
    """A device tensor where `replicate` put `like`: {device: `t` there}
    over the devices of a {device: tensor}, else `t` itself."""
    if isinstance(like, dict):
        return {d: _move(t, d) for d in like}
    return t


def per_device(fn, x):
    """fn on each copy of a value `replicate` made: {device: fn(copy)}
    over a {device: tensor}, else fn(x)."""
    if isinstance(x, dict):
        return {d: fn(v) for d, v in x.items()}
    return fn(x)


def as_tensor(x, device=None) -> torch.Tensor:
    """`x` itself, the gathered rows of a `ShardedRows`, or the first copy
    of a {device: tensor} from `replicate`."""
    if isinstance(x, dict):
        return next(iter(x.values()))
    return x.gather(device) if isinstance(x, ShardedRows) else x


def resolve_mesh(mesh, device=None, default=None):
    """(mesh, device) that a fit runs on: `mesh`, else `default` (a
    batch's mesh); a one-device mesh runs unsharded on its device, (None,
    that device)."""
    mesh = as_mesh(default if mesh is None else mesh)
    if mesh is not None and mesh.size == 1:
        return None, mesh.flat_devices[0]
    return mesh, device


def put_rows(arr: np.ndarray, mesh: Optional[Mesh], device=None):
    """Host rows on `device` (a blocking copy from pageable memory), or
    over `mesh` (`put_batch`)."""
    if mesh is None:
        return torch.from_numpy(arr).to(device)
    return put_batch(arr, mesh)


def from_shards(parts, like):
    """One result per local shard of `like`, in order, laid out as `like`:
    a `ShardedRows` over its mesh with its row counts, or the one result
    where `like` is a tensor."""
    if not isinstance(like, ShardedRows):
        return parts[0]
    it = iter(parts)
    return ShardedRows([None if s is None else next(it) for s in like.shards],
                       like.mesh, like.rows)


def put_batch(arr: np.ndarray, mesh: Mesh) -> ShardedRows:
    """Pad the leading axis to a multiple of the data-axis size and place
    equal row blocks on the data devices (this process's only)."""
    arr = np.ascontiguousarray(arr)
    ndata = mesh.ndata
    n_pad = pad_to_multiple(arr.shape[0], ndata)
    if n_pad != arr.shape[0]:
        pad = np.zeros((n_pad - arr.shape[0],) + arr.shape[1:], arr.dtype)
        arr = np.concatenate([arr, pad], axis=0)
    per = n_pad // ndata
    shards = [upload(arr[i * per:(i + 1) * per], dev) if mesh.is_local(i)
              else None for i, dev in enumerate(mesh.data_devices)]
    return ShardedRows(shards, mesh, [per] * ndata)


# ------------------------------------------------------------------ #
# Cross-shard operations
# ------------------------------------------------------------------ #

def _move(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`: an asynchronous copy between devices, a blocking
    one into host memory (whose data must be valid on return)."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type != "cpu")


def _dist():
    import torch.distributed as dist
    return dist


def _reduce(parts, mesh: Mesh, op: str):
    """Combine one value per local shard (scalars or equal-shape tensors,
    on the shards' devices) over every shard; returns the result on each
    local shard's device, in the order of `parts`."""
    devs = [p.device for p in parts]
    acc = parts[0]
    for p in parts[1:]:
        p = _move(p, acc.device)
        acc = acc + p if op == "sum" else torch.maximum(acc, p)
    if mesh.multiprocess:
        dist = _dist()
        acc = acc.clone()
        dist.all_reduce(acc, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX)
    cache = {}
    out = []
    for d in devs:
        if d not in cache:
            cache[d] = _move(acc, d)
        out.append(cache[d])
    return out


def _over_shards(parts, mesh, op):
    """`_reduce` of one value per local shard (a list) over `mesh`; without
    a mesh the one shard's value is its own result."""
    parts = list(parts)
    if mesh is not None:
        return _reduce(parts, mesh, op)
    if len(parts) != 1:
        raise ValueError(f"{len(parts)} shards' values need a mesh")
    return parts


def shard_sum(parts, mesh: Mesh):
    """The sum over every shard of one value per local shard, on each
    shard's device (`_over_shards`)."""
    return _over_shards(parts, mesh, "sum")


def shard_max(parts, mesh: Mesh):
    """The maximum over every shard of one value per local shard, on each
    shard's device (`_over_shards`)."""
    return _over_shards(parts, mesh, "max")


def row_mean(x, n: int, var: bool = False):
    """The mean of the first `n` rows of `x` over every shard, a device
    scalar; with `var` (mean, variance with ddof=1).  On a tensor these
    are `x[:n].mean()` and `((x[:n] - m) ** 2).sum() / max(n - 1, 1)`; on
    a `ShardedRows` the same sums over every shard's rows, the mean's
    divided by n."""
    real = x[:n]
    if not isinstance(real, ShardedRows):
        m = real.mean()
        return (m, ((real - m) ** 2).sum() / max(n - 1, 1)) if var else m
    parts = [s for _, s in real.local()]
    ms = [t / n for t in shard_sum([p.sum() for p in parts], x.mesh)]
    if not var:
        return ms[0]
    return ms[0], shard_sum([((p - m) ** 2).sum() for p, m in
                             zip(parts, ms)], x.mesh)[0] / max(n - 1, 1)


def gather_rows(x: ShardedRows, device) -> torch.Tensor:
    """Every row of `x`, in order, on `device`.  Across processes this is
    a collective: every process must call it."""
    device = torch.device(device)
    local = [_move(s, device) for _, s in x.local()]
    mine = torch.cat(local) if len(local) > 1 else local[0]
    if not x.mesh.multiprocess:
        return mine
    dist = _dist()
    world = dist.get_world_size()
    rows_of = [0] * world
    for i, r in enumerate(x.rows):
        rows_of[int(x.mesh._rank_by_data[i, 0])] += r
    big = max(rows_of)
    wire = x.device
    buf = torch.zeros((big,) + tuple(mine.shape[1:]), dtype=mine.dtype,
                      device=wire)
    buf[:mine.shape[0]] = _move(mine, wire)
    got = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(got, buf)
    return _move(torch.cat([g[:r] for g, r in zip(got, rows_of)]), device)


def rows_to_components(x: ShardedRows, width: int):
    """The row -> component reshard of RUMBA's TV term
    (fibers_tpu/models/rumba.py:249-261): every row of `x` [n, C] on every
    mesh device, each device holding its `width` columns (device k of
    `mesh.flat_devices` the columns k*width:(k+1)*width; C must be
    devices.size * width).  Returns {flat index: [n, width]} for this
    process's devices.

    On one process it is a column slice and a `cat` per device (a copy
    between devices where they differ); across processes an all-to-all
    over the processes (each owns contiguous rows and devices), then a
    local column slice."""
    mesh = x.mesh
    devs = mesh.flat_devices
    if x.shape[1] != width * len(devs):
        raise ValueError(f"rows_to_components: {x.shape[1]} columns for "
                         f"{len(devs)} devices of {width}")
    if not mesh.multiprocess:
        return {k: torch.cat([_move(s[:, k * width:(k + 1) * width], d)
                              for s in x.shards])
                for k, d in enumerate(devs)}
    dist = _dist()
    world = dist.get_world_size()
    mine = mesh.local_flat()
    kw = len(mine) * width
    send = torch.cat([s for _, s in x.local()])
    n_loc = send.shape[0]
    if n_loc * world != x.shape[0]:
        raise ValueError("rows_to_components: processes hold unequal rows")
    send = send.reshape(n_loc, world, kw).permute(1, 0, 2).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    full = recv.reshape(world * n_loc, kw)
    return {k: _move(full[:, q * width:(q + 1) * width], devs[k])
            for q, k in enumerate(mine)}


def components_to_rows(blocks, like: ShardedRows) -> ShardedRows:
    """Inverse of `rows_to_components`: {flat index: [n, width]} back to
    rows sharded as `like`, all columns joined in device order."""
    mesh = like.mesh
    if not mesh.multiprocess:
        out = []
        for i, d in enumerate(mesh.data_devices):
            o, r = like.offsets[i], like.rows[i]
            out.append(torch.cat([_move(blocks[k][o:o + r], d)
                                  for k in sorted(blocks)], dim=1))
        return ShardedRows(out, mesh, like.rows)
    dist = _dist()
    world = dist.get_world_size()
    mine = mesh.local_flat()
    wire = like.device
    part = torch.cat([_move(blocks[k], wire) for k in mine],
                     dim=1)                                 # [n, kw]
    n_loc = part.shape[0] // world
    send = part.reshape(world, n_loc, -1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    rows = recv.permute(1, 0, 2).reshape(n_loc, -1)         # [n_loc, C]
    out, lo = [], 0
    for i, s in enumerate(like.shards):
        if s is None:
            out.append(None)
            continue
        r = like.rows[i]
        out.append(_move(rows[lo:lo + r], s.device))
        lo += r
    return ShardedRows(out, mesh, like.rows)
