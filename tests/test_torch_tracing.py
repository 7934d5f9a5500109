"""The port's tracer (fibers_tpu_torch/utils/profiling.py): off it records
nothing, on it aggregates nested spans per thread and puts them in a
`torch.profiler` trace, and each span and counter of the package is
recorded where its work happens, on the CPU path."""

import threading
import time

import numpy as np
import pytest
import torch

import fibers_tpu_torch as tt
from fibers_tpu_torch.utils import profiling


def _mri(vol):
    m = tt.MRI(vol=np.asarray(vol, np.float32))
    shape3 = vol.shape[:3]
    m.vox2ras0 = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    m.volsize = np.asarray(shape3)
    m.width, m.height, m.depth = shape3
    m.nframes = vol.shape[3] if vol.ndim == 4 else 1
    m.set_geometry()
    return m


def _subject(shape3=(6, 5, 4), ndir=30, seed=0):
    """A small two-shell DWI of random single tensors, and its mask."""
    rng = np.random.default_rng(seed)
    g = tt.normalize_bvecs(rng.standard_normal((ndir, 3)).astype(np.float32))
    bvec = np.concatenate([np.zeros((1, 3), np.float32), g, g])
    bval = np.concatenate([[0.0], np.full(ndir, 1000.0),
                           np.full(ndir, 2000.0)]).astype(np.float32)
    axes = rng.standard_normal(shape3 + (3,))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    lam_para, lam_perp = 1.7e-3, 0.3e-3
    proj = np.einsum("xyzk,nk->xyzn", axes, bvec) ** 2
    adc = lam_perp + (lam_para - lam_perp) * proj
    vol = 100.0 * np.exp(-bval * adc)
    dwi = _mri(vol)
    dwi.bval, dwi.bvec = bval, bvec
    mask = tt.MRI.like(dwi, 1, np.float32)
    mv = np.ones(shape3, np.float32)
    mv[rng.random(shape3) < 0.3] = 0
    mask.vol = mv
    return dwi, mask


def _maps():
    dwi, mask = _subject()
    batch = tt.prepare_batch(dwi, mask, device="cpu")
    tt.dti_fit(dwi, mask, batch=batch)
    gqi = tt.gqi_rec(dwi, mask, tt.sphere_642, batch=batch)
    return [np.asarray(m.vol) for m in gqi.peak + gqi.qa]


def _rumba():
    dwi, mask = _subject()
    timings = {}
    tt.rumba_rec(dwi, mask, tt.sphere_362, niter=2, device="cpu",
                 timings=timings)
    return timings


def _structens():
    dwi, _ = _subject()
    vec, val = tt.st_recon(np.asarray(dwi.vol).mean(axis=3), 1.0, 2.0,
                           lazy=True, device="cpu")
    return np.asarray(vec), np.asarray(val)


def _stream(path):
    shape3 = (14, 12, 10)
    x, y, z = np.meshgrid(*[np.linspace(0, 1, s) for s in shape3],
                          indexing="ij")
    th = 0.6 * x + 0.9 * y + 0.3 * z
    ov = np.stack([np.cos(th), np.sin(th), 0.1 * np.ones_like(th)], -1)
    ov /= np.linalg.norm(ov, axis=-1, keepdims=True)
    ovm = _mri(ov)
    mask = tt.MRI.like(ovm, 1, np.float32)
    mask.vol = np.ones(shape3, np.float32)
    return tt.stream(ovm, mask=mask, nsub=2, device="cpu", chunk=200,
                     trk_sink=path)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Each CPU path once under `collect()`: {path: (record, result)}."""
    trk = str(tmp_path_factory.mktemp("trk") / "lines.trk")
    out = {}
    for name, run in (("maps", _maps), ("rumba", _rumba),
                      ("structens", _structens),
                      ("stream", lambda: _stream(trk))):
        with profiling.collect() as rec:
            result = run()
        out[name] = (rec, result)
    out["stream_file"] = trk
    return out


def _work(name, seconds):
    with profiling.span(name):
        time.sleep(seconds)


def test_off_the_span_is_one_shared_object_and_nothing_is_recorded():
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", 5)
    with profiling.collect() as rec:
        pass
    assert rec.spans == {} and rec.counters == {}
    with profiling.span("a"):             # a record ends with its block
        profiling.count("c", 5)
    assert rec.spans == {} and rec.counters == {}


def test_collections_do_not_nest():
    with profiling.collect():
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.collect():
                pass
    with profiling.collect() as rec:      # the flag came down
        profiling.count("c", 2)
        profiling.count("c", 3)
    assert rec.counters == {"c": 5}


def test_nested_spans_on_two_threads():
    """calls, total, self and parent per name, on each thread's own stack."""
    both = threading.Barrier(2, timeout=30)

    def body(tag):
        both.wait()
        with profiling.span("outer." + tag):
            time.sleep(0.02)
            for _ in range(2):
                _work("inner", 0.01)
            both.wait()

    with profiling.collect() as rec:
        side = threading.Thread(target=body, args=("side",))
        side.start()
        body("main")
        side.join(timeout=30)
    assert not side.is_alive()

    inner = rec.spans["inner"]
    assert inner.calls == 4
    assert inner.parents == {"outer.main", "outer.side"}
    assert inner.total_s == pytest.approx(inner.self_s)
    assert inner.total_s >= 4 * 0.01
    for tag in ("main", "side"):
        outer = rec.spans["outer." + tag]
        assert outer.calls == 1 and outer.parents == {None}
        assert outer.self_s >= 0.02
        assert outer.total_s - outer.self_s >= 2 * 0.01
    # self is total less the children on the span's own thread
    kids = sum(rec.spans["outer." + t].total_s - rec.spans["outer." + t]
               .self_s for t in ("main", "side"))
    assert kids == pytest.approx(inner.total_s, abs=1e-9)


@pytest.mark.parametrize("on", [True, False])
def test_spans_are_profiler_ranges_only_while_on(on):
    from torch.profiler import ProfilerActivity, profile

    def body():
        with profiling.span("outer"):
            _work("inner", 0.005)
            with profiling.span("inner"):
                pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if on:
            with profiling.collect():
                body()
        else:
            body()
    got = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(profiling.PREFIX))
    if not on:
        assert got == []
        return
    names = [n for _, _, n in got]
    assert names == ["fibers.outer", "fibers.inner", "fibers.inner"]
    (a0, a1, _), *inner = got
    for b0, b1, _ in inner:
        assert a0 <= b0 <= b1 <= a1
    assert inner[0][1] <= inner[1][0]


def test_a_span_raises_through_and_leaves_the_stack_as_it_was():
    with profiling.collect() as rec:
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                raise ValueError
        _work("after", 0)
    assert rec.spans["outer"].calls == 1
    assert rec.spans["after"].parents == {None}


@pytest.mark.parametrize("timings", [None, {}])
def test_lap_stores_the_stage_seconds_under_its_key(timings):
    with profiling.collect() as rec:
        with profiling.lap(timings, "model.stage", [torch.device("cpu")]):
            _work("inner", 0.01)
    s = rec.spans["model.stage"]
    assert s.calls == 1 and rec.spans["inner"].parents == {"model.stage"}
    if timings is not None:
        assert set(timings) == {"stage"}
        assert 0.01 <= timings["stage"] <= s.total_s
    with profiling.lap(timings, "model.stage") as stage:
        stage.devs = [torch.device("cpu")]


# span -> (path, the spans it runs inside)
SPANS = {
    "batch.gather": ("maps", {None}),
    "dti.fetch": ("maps", {None}),
    "dti.scatter": ("maps", {None}),
    "gqi.tables": ("maps", {None}),
    "lazy.fetch": ("maps", {None}),
    "lazy.scatter": ("maps", {None}),
    "rumba.signal": ("rumba", {None}),
    "rumba.iterate": ("rumba", {None}),
    "rumba.init": ("rumba", {"rumba.iterate"}),
    "rumba.post": ("rumba", {None}),
    "structens.recon": ("structens", {None}),
    "stream.work": ("stream", {None}),
    "stream.fetch": ("stream", {None}),
    "stream.wait": ("stream", {None}),
    "stream.write": ("stream", {None}),
}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_each_span_is_recorded_where_its_work_happens(records, name):
    path, parents = SPANS[name]
    rec = records[path][0]
    s = rec.spans[name]
    assert s.calls >= 1 and s.parents == parents
    assert 0 <= s.self_s <= s.total_s
    for other, (p, _) in SPANS.items():
        if p != path and not other.startswith("lazy."):   # every path's
            assert other not in rec.spans
    # on the CPU nothing is copied from a card
    assert rec.counters.get("transfer.d2h_bytes", 0) == 0


def test_lazy_arrays_fetch_without_a_scatter(records):
    rec = records["structens"][0]
    assert rec.spans["lazy.fetch"].calls == 2          # vectors, values
    assert "lazy.scatter" not in rec.spans


def test_the_maps_fetch_and_scatter_once_per_volume(records):
    rec = records["maps"][0]
    assert rec.spans["dti.fetch"].calls == 1
    assert rec.spans["dti.scatter"].calls == 1
    assert rec.spans["gqi.tables"].calls == 1
    # the 3 peak and 3 QA volumes are one group: one scatter, one copy
    assert rec.spans["lazy.fetch"].calls == 1
    assert rec.spans["lazy.scatter"].calls == 1
    assert rec.counters["lazy.volumes"] == 6
    assert rec.counters["lazy.copies"] == 1
    assert rec.counters["dti.volumes"] == 10
    assert rec.counters["dti.copies"] == 1
    assert "lazy.host_scatter" not in rec.counters


@pytest.mark.parametrize("mesh", [None, 2])
def test_dti_fetches_and_scatters_once_a_fit(mesh):
    """One `dti.scatter` and one `dti.fetch` a fit, a mesh's too (its rows
    gathered onto one device), with the unsharded fit's volumes; nothing
    is copied from a card on the CPU."""
    from fibers_tpu_torch.parallel.mesh import make_mesh
    dwi, mask = _subject()
    whole = tt.dti_fit(dwi, mask, batch=tt.prepare_batch(dwi, mask,
                                                         device="cpu"))
    batch = tt.prepare_batch(
        dwi, mask, device="cpu",
        mesh=None if mesh is None else make_mesh(mesh, device="cpu"))
    with profiling.collect() as rec:
        dti = tt.dti_fit(dwi, mask, batch=batch)
    assert rec.spans["dti.fetch"].calls == rec.spans["dti.scatter"].calls == 1
    assert rec.counters.get("transfer.d2h_bytes", 0) == 0
    for name in ("fa", "eigvec1", "s0"):
        got, want = getattr(dti, name).vol, getattr(whole, name).vol
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rumba_timings_keep_their_keys_and_hold_the_spans(records):
    rec, timings = records["rumba"]
    assert sorted(timings) == ["iterate", "post", "signal"]
    for key in timings:
        assert timings[key] <= rec.spans["rumba." + key].total_s
    it = rec.spans["rumba.iterate"]
    assert rec.spans["rumba.init"].total_s == pytest.approx(
        it.total_s - it.self_s)


def test_the_trk_bytes_are_the_file_size(records):
    import os
    rec, tract = records["stream"]
    assert tract.n_count > 0
    assert rec.counters["trk.bytes"] == os.path.getsize(
        records["stream_file"])
    assert rec.spans["stream.write"].calls >= 2      # one per chunk


def test_dsi_stages_are_spans_with_their_timings():
    dwi, mask = _subject(shape3=(4, 4, 3))
    tm = {}
    with profiling.collect() as rec:
        tt.dsi_rec(dwi, mask, tt.sphere_362, device="cpu", timings=tm)
    assert set(tm) == {"upload", "tables", "chunks", "finalize"}
    for key in tm:
        assert rec.spans["dsi." + key].calls == 1
        assert tm[key] <= rec.spans["dsi." + key].total_s


def test_the_d2h_counter_counts_only_copies_from_a_card():
    from fibers_tpu_torch.device import fetch
    with profiling.collect() as rec:
        got = fetch(torch.arange(6.0))
    assert np.array_equal(got, np.arange(6.0, dtype=np.float32))
    assert rec.counters == {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: counts copies from a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_copies_from_the_card_are_counted(card):
    """`transfer.d2h_bytes` at dti.fetch, lazy.fetch and stream.fetch."""
    dwi, mask = _subject()
    with profiling.collect() as rec:
        batch = tt.prepare_batch(dwi, mask, device=card)
        dti = tt.dti_fit(dwi, mask, batch=batch)
        gqi = tt.gqi_rec(dwi, mask, tt.sphere_642, batch=batch)
        maps = [np.asarray(m.vol) for m in gqi.peak + gqi.qa]
    from fibers_tpu_torch.models.dti import _DTI_COLS
    ncol = max(hi for _, hi in _DTI_COLS.values())
    nxyz = int(np.asarray(mask.vol).size)
    # the DTI volumes and the six maps (3 peaks, 3 QA), each scattered on
    # the card and copied whole in one go, float32
    assert rec.counters["transfer.d2h_bytes"] == \
        4 * nxyz * (ncol + 3 * 3 + 3)
    assert rec.spans["lazy.fetch"].calls == 1 and len(maps) == 6
    assert rec.counters["lazy.volumes"] == 6
    assert rec.counters["lazy.copies"] == 1
    assert dti.fa.vol.shape == mask.vol.shape
