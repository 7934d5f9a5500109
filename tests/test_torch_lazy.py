"""The maps layer (fibers_tpu_torch/core/lazy.py): every lazy volume reaches
the host through `host_volumes`, bit-equal to `scatter_frames` of its rows
on both of its routes (a scatter on the rows' device and one copy, or,
when the device's free memory is short, a fetch of the rows and a numpy
scatter), and sibling volumes share one copy that only their own first
touch makes."""

import gc

import numpy as np
import pytest
import torch

import fibers_tpu_torch as tt
from fibers_tpu_torch.core.lazy import (LazyVolume, host_volumes,
                                        lazy_peak_volumes,
                                        lazy_stack_volumes)
from fibers_tpu_torch.device import fetch
from fibers_tpu_torch.ops.masked import scatter_frames
from fibers_tpu_torch.parallel.mesh import Mesh, ShardedRows, make_mesh
from fibers_tpu_torch.utils import profiling

from test_torch_tracing import _subject


def _root(a):
    while a.base is not None and isinstance(a.base, np.ndarray):
        a = a.base
    return a


def _batch(shards, device="cpu"):
    """A small subject, its mask, and its batch on `device`, split over a
    mesh of `shards` copies of it when more than one."""
    dwi, mask = _subject(shape3=(5, 4, 3))
    dev = torch.device(device)
    mesh = None
    if shards > 1:
        mesh = (make_mesh(shards, device="cpu") if dev.type == "cpu" else
                Mesh(np.array([dev] * shards, dtype=object), ("data",)))
    return dwi, mask, tt.prepare_batch(dwi, mask, device=dev, mesh=mesh)


def _fit(model, dwi, mask, batch):
    if model == "gqi":
        return tt.gqi_rec(dwi, mask, tt.sphere_362, batch=batch)
    return tt.dsi_rec(dwi, mask, tt.sphere_362, batch=batch)


def _expected(out, mask):
    """{name: scatter_frames of the fetched rows} for every lazy volume
    of a GQI or DSI result, taken before any is touched."""
    pk = out._peak_dev
    n, shape3 = len(pk.idx), mask.vol.shape
    vecs, amp = fetch(pk.vecs)[:n], fetch(pk.amp)[:n]
    want = {}
    for ip in range(pk.nvec):
        want[f"peak{ip}"] = scatter_frames(vecs[:, ip], pk.idx, shape3)
        want[f"qa{ip}"] = scatter_frames(amp[:, ip], pk.idx, shape3)
    for name in ("odf", "pdf"):
        if hasattr(out, name):
            lv = getattr(out, name).__dict__["vol"]
            want[name] = scatter_frames(fetch(lv._values)[:n], pk.idx,
                                        shape3)
    return want


def _volumes(out):
    got = {f"peak{i}": m.vol for i, m in enumerate(out.peak)}
    got.update({f"qa{i}": m.vol for i, m in enumerate(out.qa)})
    for name in ("odf", "pdf"):
        if hasattr(out, name):
            got[name] = getattr(out, name).vol
    return got


def _assert_same_bits(got, want):
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("model", ["gqi", "dsi"])
def test_lazy_volumes_equal_the_host_scatter(model, shards):
    """Every volume, 1-frame (QA), 3-frame (peaks) and wide (ODF, PDF),
    holds the bits of `scatter_frames` of its rows; the six peak and QA
    volumes are views of one block."""
    dwi, mask, batch = _batch(shards)
    out = _fit(model, dwi, mask, batch)
    want = _expected(out, mask)
    got = _volumes(out)
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_same_bits(got[name], want[name])
    inside = mask.vol > 0
    assert got["qa0"].shape == inside.shape
    assert got["peak0"].shape == inside.shape + (3,)
    assert not got["peak0"][~inside].any() and got["qa0"][inside].any()
    group = [got[f"{k}{i}"] for k in ("peak", "qa") for i in range(3)]
    assert all(_root(v) is _root(group[0]) for v in group)
    assert _root(got["odf"]) is not _root(group[0])


@pytest.mark.parametrize("model", ["gqi", "dsi"])
def test_one_touch_brings_the_group_in_one_copy(model):
    """Touching one peak volume materializes the three peaks and three QA
    in one copy, and fetches nothing else: the ODF (and DSI's PDF) keep
    their rows on the device."""
    out = _fit(model, *_batch(1))
    with profiling.collect() as rec:
        first = out.peak[1].vol
    assert rec.counters["lazy.volumes"] == 6
    assert rec.counters["lazy.copies"] == 1
    assert "lazy.host_scatter" not in rec.counters
    assert rec.spans["lazy.scatter"].calls == rec.spans["lazy.fetch"].calls
    with profiling.collect() as again:
        rest = [m.vol for m in out.peak + out.qa]
    assert again.counters == {} and again.spans == {}
    assert rest[1] is first
    for name in ("odf", "pdf"):
        if hasattr(out, name):
            lv = getattr(out, name).__dict__["vol"]
            assert isinstance(lv, LazyVolume)
            assert isinstance(lv._values, torch.Tensor)


def _rows(layout, n, rng):
    """Result rows [n, 7] (or [n] for "vector") on the CPU, as a tensor
    or split over two CPU shards, and their column groups."""
    if layout == "vector":
        return torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)), [(0, 1)]
    rows = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32))
    rows[0, 2] = float("nan")
    cols = [(0, 1), (1, 4), (4, 7)]
    if layout == "sharded":
        mesh = make_mesh(2, device="cpu")
        rows = ShardedRows([rows[:n // 3], rows[n // 3:]], mesh)
    return rows, cols


@pytest.mark.parametrize("layout", ["tensor", "sharded", "vector"])
@pytest.mark.parametrize("route", ["device", "host"])
def test_both_routes_give_the_scatter_bits(route, layout):
    """A free-memory figure below the buffer's bytes sends every volume of
    the call to the host route; both routes give `scatter_frames`' bits
    (NaN included) and count what they did."""
    rng = np.random.default_rng(11)
    shape3 = (6, 5, 4)
    idx = np.flatnonzero(rng.random(shape3) < 0.6)
    rows, cols = _rows(layout, len(idx), rng)
    arr = fetch(rows).reshape(len(idx), -1)
    nbytes = 4 * int(np.prod(shape3)) * sum(hi - lo for lo, hi in cols)
    free = nbytes - 1 if route == "host" else nbytes
    with profiling.collect() as rec:
        vols = host_volumes(rows, idx, shape3, cols, "lazy", free=free)
    for v, (lo, hi) in zip(vols, cols):
        _assert_same_bits(v, scatter_frames(arr[:, lo:hi], idx, shape3))
    assert rec.counters["lazy.volumes"] == len(cols)
    assert rec.counters["lazy.copies"] == 1
    assert rec.counters.get("lazy.host_scatter", 0) == \
        (len(cols) if route == "host" else 0)
    assert rec.spans["lazy.fetch"].calls == rec.spans["lazy.scatter"].calls


@pytest.mark.parametrize("bad", [-1, 120])
@pytest.mark.parametrize("route", ["device", "host"])
def test_an_index_outside_the_grid_raises(route, bad):
    rows = torch.ones((3, 2))
    free = 0 if route == "host" else None
    with pytest.raises(IndexError, match="outside"):
        host_volumes(rows, np.array([0, bad, 7]), (6, 5, 4), [(0, 2)],
                     "lazy", free=free)


def test_stacked_volumes_share_one_copy():
    rng = np.random.default_rng(4)
    shape3 = (4, 3, 5)
    idx = np.flatnonzero(rng.random(shape3) > 0.5)
    stack = rng.standard_normal((4, len(idx) + 2)).astype(np.float32)
    vols = lazy_stack_volumes(torch.from_numpy(stack), idx, shape3)
    with profiling.collect() as rec:
        got = vols[2].materialize()
        rest = [v.materialize() for v in vols]
    assert rec.counters["lazy.copies"] == 1
    assert rec.counters["lazy.volumes"] == 4 and rest[2] is got
    for k, v in enumerate(rest):
        _assert_same_bits(v, scatter_frames(stack[k, :len(idx)], idx,
                                            shape3))


def test_peak_volumes_keep_their_shapes_before_the_copy():
    vecs, amp = torch.zeros((5, 2, 3)), torch.zeros((5, 2))
    peaks, amps = lazy_peak_volumes(vecs, amp, np.arange(4), (2, 2, 1))
    assert [p.shape for p in peaks] == [(2, 2, 1, 3)] * 2
    assert [a.shape for a in amps] == [(2, 2, 1)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_group_on_card_is_pinned_and_reused(shards):
    """On the card the six peak and QA volumes are views of one pinned
    block, and a second subject's group, the first's volumes dropped,
    takes the block from torch's caching host allocator.  Two shards of
    the one card: the mesh's rows gathered onto it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned copy from the card")
    dwi, mask, batch = _batch(shards, device="cuda")
    stats = torch.cuda.memory.host_memory_stats
    for subject in range(2):
        out = tt.gqi_rec(dwi, mask, tt.sphere_362, batch=batch)
        want = _expected(out, mask)
        before = stats()["num_host_alloc"]
        group = [m.vol for m in out.peak + out.qa]
        if subject:
            assert stats()["num_host_alloc"] == before
        _assert_pinned_group(group, want)
        del group, out
        gc.collect()


def _assert_pinned_group(group, want):
    names = [f"{k}{i}" for k in ("peak", "qa") for i in range(3)]
    for v, name in zip(group, names):
        _assert_same_bits(v, want[name])
        assert torch.from_numpy(v).is_pinned()
    assert all(_root(v) is _root(group[0]) for v in group)
