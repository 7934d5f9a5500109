"""A microscopy block (the benchmark's `micro_block_10um`) through the
port: `st_recon` slab by slab against the whole-volume path, `stream`
in the microscopy regime from a device-resident field against the
host-volume route, the plain cone search `portbench/reference/micro.py`
against the program, the cell `micro_trk` at a tiny size through the
benchmark's harness on the CPU, the control and the faults its check
must catch, the readers of its metrics, and on the card the 3-D window
of the cone-search kernel.

Tolerances: the slab loop and the whole volume filter in float32 GEMMs
whose sums over the cut axis hold other zeros, so their eigenvalues
agree within 1e-5 of the largest (seen: ~1e-7) and their tensors
V diag(l) V' within 1e-5 of the largest element; a voxel's primary
eigenvector within |dot| >= 1 - 1e-4 wherever its two smallest
eigenvalues are apart by more than 1e-3 of the largest.  Lines are
exact: cone-search jumps land on whole voxels, so every comparison of
lines is equality.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import fibers_tpu_torch as tt
from fibers_tpu_torch.core.handoff import DevicePeaks
from fibers_tpu_torch.models import structens
from fibers_tpu_torch.ops.kernels import propagate_micro as PM
from fibers_tpu_torch.tract import modes
from fibers_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, microscopy  # noqa: E402
from portbench.calibrate import readings  # noqa: E402
from portbench.reference import micro as ref_micro  # noqa: E402

SHAPE = (48, 48, 32)


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


@pytest.fixture(scope="module")
def cfg(bench):
    return harness.load_config(bench, "micro_block_10um")


def tiny(cfg, shape=SHAPE, search_dist=3):
    """The configuration on a tiny block: the tubes, the regime, the
    mask's proportions and the limits as stated; the crossing slab, the
    seed lattice, the check's slabs and its line sample scaled down."""
    cfg = copy.deepcopy(cfg)
    cfg["block"]["shape"] = list(shape)
    cfg["block"]["tubes"]["crossing_z"] = [shape[2] / 2, 3.0]
    cfg["stream"]["seed_every"] = 4
    cfg["stream"]["search_dist"] = search_dist
    cfg["check"]["slab"] = 7
    cfg["check"]["line_every"] = 4
    return cfg


def _mri(vol, res=0.01):
    m = tt.MRI(vol=vol)
    m.vox2ras0 = np.diag([res, res, res, 1.0]).astype(np.float32)
    m.volsize = np.asarray(vol.shape[:3])
    m.width, m.height, m.depth = vol.shape[:3]
    m.nframes = 1 if vol.ndim == 3 else vol.shape[3]
    m.set_geometry()
    return m


@pytest.fixture(scope="module")
def block(cfg):
    """(image [X, Y, Z] float32, tissue mask, the structure tensor's
    eigenvectors and eigenvalues) of the tiny block."""
    blk = tiny(cfg)["block"]
    img = microscopy.make_block(blk, 2 ** 33 + 7, 0, "cpu").numpy()
    mask = microscopy.tissue_mask(blk, "cpu")
    ev, el = tt.st_recon(img, 1.0, 2.0, device="cpu")
    return img, mask, ev, el


def _tensor(ev, el):
    return np.einsum("...ik,...k,...jk->...ij", ev.astype(np.float64),
                     el.astype(np.float64), ev.astype(np.float64))


# ------------------------------------------------------------------ #
# the structure tensor slab by slab
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("per", [7, 1, 33])
def test_st_recon_slabs_equal_the_whole_volume(block, monkeypatch, per):
    """Slabs of `per` planes (48 = 6 x 7 + 6, 33 + 15: the last one
    short) against the whole volume at once: the same eigen-decomposition
    to float32 rounding, the slabs and voxels counted."""
    img, _, ev_w, el_w = block
    h = structens._halo(1.0, 2.0)
    plane = SHAPE[1] * SHAPE[2]
    monkeypatch.setattr(structens, "_SLAB_VOXELS", (per + 2 * h) * plane)
    with profiling.collect() as rec:
        ev, el = tt.st_recon(img, 1.0, 2.0, device="cpu")
    assert rec.counters["structens.slabs"] == -(-SHAPE[0] // per)
    assert rec.counters["structens.voxels"] > img.size
    assert rec.spans["structens.slab"].parents == {"structens.recon"}
    scale = float(np.abs(el_w).max())
    np.testing.assert_allclose(el, el_w, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(_tensor(ev, el), _tensor(ev_w, el_w),
                               atol=1e-5 * scale, rtol=0)
    sep = (el_w[..., 1] - el_w[..., 0]) > 1e-3 * scale
    dots = np.abs((ev[..., :, 0] * ev_w[..., :, 0]).sum(-1))
    assert sep.mean() > 0.5 and dots[sep].min() >= 1 - 1e-4


def test_st_recon_whole_volume_is_one_slab(block):
    img = block[0]
    with profiling.collect() as rec:
        tt.st_recon(img, 1.0, 2.0, device="cpu")
    assert rec.counters["structens.slabs"] == 1
    assert rec.counters["structens.voxels"] == img.size


def test_st_recon_reads_a_float32_block_in_place(block, monkeypatch):
    """No whole-volume host copy of a float32 input: the slabs handed to
    the device are views of the caller's array."""
    img = block[0]
    seen = []
    real = torch.from_numpy

    def spy(a):
        if a.ndim == 3:
            seen.append(np.shares_memory(a, img))
        return real(a)
    monkeypatch.setattr(structens.torch, "from_numpy", spy)
    monkeypatch.setattr(structens, "_SLAB_VOXELS", 21 * SHAPE[1] * SHAPE[2])
    tt.st_recon(img, 1.0, 2.0, lazy=True, device="cpu")
    assert len(seen) == 7 and all(seen)


def test_st_recon_slabs_lazy_equal_eager(block, monkeypatch):
    img, _, ev_w, el_w = block
    monkeypatch.setattr(structens, "_SLAB_VOXELS", 23 * SHAPE[1] * SHAPE[2])
    lv, ll = tt.st_recon(img, 1.0, 2.0, lazy=True, device="cpu")
    ev, el = tt.st_recon(img, 1.0, 2.0, device="cpu")
    assert np.array_equal(np.asarray(lv), ev)
    assert np.array_equal(np.asarray(ll), el)


# ------------------------------------------------------------------ #
# stream from a device-resident field
# ------------------------------------------------------------------ #

def _routes(block, search_dist, every, tmp_path=None, **kw):
    """(host-volume route, device-field route) Tracts of the primary
    eigenvector field of the tiny block, seeds every `every`-th voxel."""
    img, mask, ev, _ = block
    mask_m = _mri(mask.astype(np.float32))
    seed = _mri(microscopy.seed_lattice(mask, every))
    host = _mri(np.ascontiguousarray(ev[..., :, 0]))
    dev = torch.from_numpy(ev)[..., :, 0]
    args = dict(mask=mask_m, seed=seed, nsub=None, ang_thresh=None,
                step_size=None, smooth_coeff=None, search_dist=search_dist,
                device="cpu", **kw)
    out = []
    for k, ov in enumerate((host, dev)):
        if tmp_path is not None:
            args["trk_sink"] = str(tmp_path / f"{k}.trk")
        out.append(tt.stream(ov, **args))
    return out


@pytest.mark.parametrize("search_dist,every", [(3, 4), (15, 8)])
@pytest.mark.parametrize("wire", ["f32", "i6"])
def test_micro_from_a_device_field_equals_the_host_route(block, search_dist,
                                                         every, wire):
    a, b = _routes(block, search_dist, every, wire=wire)
    assert a.n_count == b.n_count > 10
    assert np.array_equal(a.npts, b.npts)
    assert np.array_equal(a.packed_xyz, b.packed_xyz)


def test_micro_trk_from_a_device_field_equals_the_host_route(block,
                                                            tmp_path):
    """The .trk bytes: the header from the mask (the same geometry as the
    orientation volume here), every record equal."""
    _routes(block, 3, 4, tmp_path, wire="i6")
    assert (tmp_path / "0.trk").read_bytes() == \
        (tmp_path / "1.trk").read_bytes()


def test_a_device_field_needs_a_mask_and_three_components(block):
    _, mask, ev, _ = block
    kw = dict(nsub=None, ang_thresh=None, step_size=None, smooth_coeff=None,
              search_dist=3, device="cpu")
    with pytest.raises(ValueError, match="mask"):
        tt.stream(torch.from_numpy(ev)[..., :, 0], **kw)
    full = torch.from_numpy(ev).reshape(SHAPE + (9,))
    with pytest.raises(ValueError, match=r"\[X, Y, Z, 3\]"):
        tt.stream(full, mask=_mri(mask.astype(np.float32)), **kw)


def test_micro_from_device_peaks_equals_the_host_route(block):
    """A `DevicePeaks` of the masked voxels' primary eigenvectors runs the
    microscopy mode too, with the lines of the host route."""
    img, mask, ev, _ = block
    idx = np.flatnonzero(mask)
    vecs = torch.from_numpy(ev[..., :, 0].reshape(-1, 3)[idx])[:, None]
    mask_m = _mri(mask.astype(np.float32))
    pk = DevicePeaks(vecs=vecs, amp=torch.ones(len(idx), 1), idx=idx,
                     ref=mask_m)
    got = tt.stream(pk, mask=mask_m,
                    seed=_mri(microscopy.seed_lattice(mask, 4)), nsub=None,
                    ang_thresh=None, step_size=None, smooth_coeff=None,
                    search_dist=3, device="cpu")
    want = _routes(block, 3, 4)[0]
    assert got.n_count == want.n_count > 10
    assert np.array_equal(got.packed_xyz, want.packed_xyz)


def test_lcm_still_needs_host_volumes(block):
    _, mask, ev, _ = block
    lcm = _mri(np.ones(SHAPE + (10,), np.float32))
    with pytest.raises(ValueError, match="host orientation"):
        tt.stream(torch.from_numpy(ev)[..., :, 0], lcms=lcm,
                  mask=_mri(mask.astype(np.float32)), device="cpu")


def test_the_micro_span_and_counters(block):
    img, mask, ev, _ = block
    with profiling.collect() as rec:
        tr = tt.stream(torch.from_numpy(ev)[..., :, 0],
                       mask=_mri(mask.astype(np.float32)),
                       seed=_mri(microscopy.seed_lattice(mask, 4)),
                       nsub=None, ang_thresh=None, step_size=None,
                       smooth_coeff=None, search_dist=3, device="cpu")
    win = len(modes._search_window([3, 3, 3])[0])
    assert rec.counters["micro.launches"] == 2
    assert rec.counters["micro.window_cells"] == 2 * win
    assert rec.spans["stream.micro"].calls == 1
    assert tr.n_count > 0


# ------------------------------------------------------------------ #
# the plain cone search
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("search_dist,every", [(3, 4), (15, 8)])
def test_the_reference_cone_search_equals_the_program(block, search_dist,
                                                      every):
    """`reference/micro.py` on the program's own field and mask: every
    line equal, the seeds it keeps the program's, and the first len_min
    steps alone tell the same seeds."""
    img, mask, ev, _ = block
    tr = _routes(block, search_dist, every)[1]
    field = torch.from_numpy(ev[..., :, 0] * mask[..., None]).reshape(-1, 3)
    m = torch.from_numpy(mask.reshape(-1))
    seeds = np.argwhere(microscopy.seed_lattice(mask, every) > 0)
    pts, npts, kept = ref_micro.track(field, m, SHAPE, seeds,
                                      search_dist=search_dist)
    assert np.array_equal(npts.numpy(), tr.npts)
    assert np.array_equal(pts.numpy().astype(np.float32), tr.packed_xyz)
    _, _, kept3 = ref_micro.track(field, m, SHAPE, seeds,
                                  search_dist=search_dist, max_steps=3)
    assert torch.equal(kept, kept3) and 0 < int(kept.sum()) < len(seeds)
    idx = ref_micro.line_index(kept)
    assert int(idx[-1]) == int(kept[:-1].sum())


def test_the_reference_window_is_the_programs():
    for d in (1, 3, 15):
        off, wdir = ref_micro.window(d)
        o, w = modes._search_window([d, d, d])
        assert np.array_equal(off, o)
        assert np.array_equal(wdir.astype(np.float32), w)
    assert len(ref_micro.window(15)[0]) == 15_514 > 7 * 2048


def test_the_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench.reference import micro, block_st; "
            "from portbench import microscopy; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'fibers_tpu', 'fibers_tpu_torch'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_the_slabbed_reference_tensor_equals_one_pass(block):
    from portbench.reference import block_st, structens as ref_st
    img = torch.from_numpy(block[0])
    whole = ref_st.tensor(img, 1.0, 2.0)
    parts = torch.cat([block_st.tensor(img, a, b, 1.0, 2.0, "cpu")
                       for a, b in block_st.slabs(SHAPE[0], 5)])
    assert torch.equal(parts, whole)


# ------------------------------------------------------------------ #
# the cell at a tiny size
# ------------------------------------------------------------------ #

@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    """The checked subject's .trk under this test's own directory."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))


def _run(bench, cfg, trace, seconds=0.3, every=4, **kw):
    cell = harness.find(bench["workloads"], "micro_trk", "workload")
    args = types.SimpleNamespace(seed=2 ** 33 + 5, seconds=seconds,
                                 trace=trace)
    c = tiny(cfg, **kw)
    c["stream"]["seed_every"] = every
    return harness.run_cell(bench, cell, args, 0.0, "cpu", c)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_is_correct(bench, cfg, trace, monkeypatch):
    """The cell runs and is correct; no run opens the program's tracer,
    whose spans the device-idle reader would count busy."""
    opened = []
    monkeypatch.setattr(profiling, "collect",
                        lambda: opened.append(1) or contextlib.nullcontext())
    result, checks = _run(bench, cfg, trace)
    assert not opened
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert [c[0] for c in checks] == ["st_tensor_gap", "st_dir_flips",
                                      "micro_lines_off"]
    assert result["checks"]["micro_lines_off"]["value"] == 0.0
    got = set(result["metrics"])
    if trace:
        # no device here: the device-trace rooflines read nothing
        assert got == {"device_idle_pct", "micro.st_s", "micro.stream_s",
                       "mfu.micro"}
    else:
        assert got == {"subject_s", "setup_s"}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    for k, v in result["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    json.dumps(result)


def test_the_cell_with_the_full_window(bench, cfg):
    result, _ = _run(bench, cfg, 0, seconds=0.05, every=8, search_dist=15)
    assert result["correct"] is True, result["checks"]


def test_the_control_fails_and_the_program_passes(cfg, tmp_path):
    c = tiny(cfg)
    rows = readings(c, harness.load_traffic("trk"), "micro_st",
                    [2 ** 34 + 1], 1, str(tmp_path), "cpu")
    prog = [g for _, side, g in rows if side == "program"][0]
    ctl = [g for _, side, g in rows if side == "control"][0]
    lim = c["limits"]
    assert all(prog[n] <= lim[n] for n in lim), prog
    assert [n for n in lim if not ctl[n] <= lim[n]] != [], ctl
    assert ctl["micro_lines_off"] > 0, ctl


def _thin_halo(monkeypatch):
    """Slabs whose halo is one plane short of the filters' reach."""
    monkeypatch.setattr(structens, "_SLAB_VOXELS", 21 * SHAPE[1] * SHAPE[2])
    real = structens._halo
    monkeypatch.setattr(structens, "_halo", lambda s, r: real(s, r) - 1)


def _no_post_smooth(monkeypatch):
    """The products' Gaussian post-smooth left out."""
    real = structens._st_kernel
    monkeypatch.setattr(structens, "_st_kernel",
                        lambda v, s, r, slab=None: real(v, s, 0.0, slab))


def _second_vector(monkeypatch):
    """The stream follows the middle eigenvector instead of the
    primary."""
    real = tt.stream

    def stream(field, **kw):
        second = field.as_strided(field.shape, field.stride(),
                                  field.storage_offset() + 1)
        return real(second, **kw)
    monkeypatch.setattr(tt, "stream", stream)


def _shift_lines(monkeypatch):
    """Every line moved by one voxel along x as the .trk sink decodes the
    wire into records."""
    from fibers_tpu_torch.io.trk import TrkSink
    real = TrkSink.append_deltas6

    def append(self, words, npts, anchors, qscale):
        return real(self, words, npts, anchors + np.float32([1, 0, 0]),
                    qscale)
    monkeypatch.setattr(TrkSink, "append_deltas6", append)


FAULTS = [_thin_halo, _no_post_smooth, _second_vector, _shift_lines]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(bench, cfg, monkeypatch,
                                            fault):
    fault(monkeypatch)
    result, _ = _run(bench, cfg, 0, seconds=0.05)
    assert result["correct"] is False, result["checks"]


# ------------------------------------------------------------------ #
# the metrics' readers
# ------------------------------------------------------------------ #

def test_the_roofline_work_at_the_cell(cfg):
    peaks = json.load(open(os.path.join(ROOT, "portbench", "peaks.json")))
    st = harness.load_metric("st_recon.roofline_pct")
    assert (st.taps(1.0), st.taps(2.0), st.taps(0.0)) == (5, 9, 0)
    n = 1024 * 1024 * 512
    nbytes, flops = st.work(n, 1.0, 2.0)
    assert nbytes == 52 * n and flops == n * (414 + st.EIGEN)
    facts = dict(n_voxels=n, sigma=1.0, rho=2.0, window_cells=15_625)
    assert st.bound_s(peaks, facts) == pytest.approx(52 * n / 3.35e12)
    pm = harness.load_metric("propagate_micro.roofline_pct")
    assert len(ref_micro.window(15)[0]) == 15_514
    facts["window_cells"] = 15_514
    assert pm.bound_s(peaks, facts, 1e8) == pytest.approx(
        1e8 * (6 * 15_514 + 11) / 67e12)


def test_the_readers_take_only_what_a_run_holds():
    ms = 1_000_000
    trace = types.SimpleNamespace(
        spans=[(0, 10 * ms, "micro_st"), (10 * ms, 30 * ms, "micro_stream")],
        ops=[(1 * ms, 2 * ms, "Memcpy HtoD (Pinned -> Device)"),
             (1 * ms, 9 * ms, "fibers.structens.slab"),
             (2 * ms, 5 * ms, "gemm"), (11 * ms, 19 * ms,
                                        "(anonymous namespace)::micro_kernel"
                                        "(MicroParams)"),
             (20 * ms, 21 * ms, "window_dot3_kernel")],
        window_s=0.04)
    trace.op_seconds = lambda p: harness.tracing.Trace.op_seconds(trace, p)
    st = harness.load_metric("st_recon.roofline_pct")
    assert st.device_seconds(trace) == (0.003, 1)
    run = types.SimpleNamespace(
        trace=trace, n=2, peaks={"hbm_bytes_s": 1.0, "fp32_flop_s": 1.0},
        facts=dict(n_voxels=1, sigma=1.0, rho=2.0, window_cells=10),
        counters={"stream_steps": 4.0})
    assert harness.load_metric("propagate_micro.roofline_pct").read(run) \
        == pytest.approx(100 * 4 * 71 / 0.008)
    assert st.read(run) == pytest.approx(100 * 714 * 2 / 0.003)
    assert harness.load_metric("mfu.micro").read(run) == pytest.approx(
        100 * (714 * 2 + 4 * 71) / 0.04)
    for name in ("st_recon.roofline_pct", "propagate_micro.roofline_pct",
                 "mfu.micro"):
        assert harness.load_metric(name).read(
            types.SimpleNamespace(facts={}, trace=trace)) is None


# ------------------------------------------------------------------ #
# on the card: the 3-D window
# ------------------------------------------------------------------ #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_3d_window_kernel_equals_plain_on_card(cuda, cfg):
    """The cone-search kernel against its plain loop on the card, on the
    block phantom's primary eigenvectors with search_dist 15 on 3-D
    vectors (15,514 cells, 8 tiles of 2,048): both directions' outputs
    bit-equal, on the float32 points and the one-voxel delta wire."""
    shape = (96, 96, 64)
    blk = tiny(cfg, shape)["block"]
    img = microscopy.make_block(blk, 2 ** 35 + 3, 0, cuda)
    mask = microscopy.tissue_mask(blk, cuda)
    ev, _ = tt.st_recon(img.numpy(), 1.0, 2.0, lazy=True, device=cuda)
    m = torch.from_numpy(mask).to(cuda)
    vf = (ev.device[..., :, 0] * m[..., None]).reshape(-1, 3).contiguous()
    off, wdir = modes._search_window([15, 15, 15])
    assert len(off) == 15_514
    seeds = np.argwhere(microscopy.seed_lattice(mask, 6) > 0)
    pos0 = torch.from_numpy(np.ascontiguousarray(seeds, np.float32)).to(cuda)
    flat = torch.from_numpy(np.ravel_multi_index(seeds.T, shape)).to(cuda)
    vec0 = vf[flat].contiguous()
    args = (m.reshape(-1), vf, torch.from_numpy(off.astype(np.int64))
            .to(cuda), torch.from_numpy(wdir).to(cuda), 98, shape, 1.0,
            float(np.cos(np.radians(20.0))), float(np.cos(np.radians(10.0))),
            0.0, 96)
    for emit, dmax in (("points", 127), ("deltas", 31)):
        zero = torch.zeros(len(pos0), dtype=torch.int32, device=cuda)
        fwd = PM.propagate_micro_dir(pos0, vec0, zero, *args, emit, 1.0,
                                     dmax)
        bwd = PM.propagate_micro_dir(pos0, -vec0, fwd[2], *args, emit, 1.0,
                                     dmax)
        fwd_p = PM.propagate_micro_dir_plain(pos0, vec0, zero, *args, emit,
                                             1.0, dmax)
        bwd_p = PM.propagate_micro_dir_plain(pos0, -vec0, fwd_p[2], *args,
                                             emit, 1.0, dmax)
        for g, w in zip(fwd + bwd, fwd_p + bwd_p):
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w)
        assert float(bwd[2].float().mean()) > 3


@pytest.mark.cuda
def test_3d_window_trk_equal_across_chunkings_on_card(cuda, cfg, tmp_path,
                                                     monkeypatch):
    """`stream` from the device field into a .trk on the i6 wire through
    the kernel, at the card's chunk and at chunks of 700 streams, and
    through the plain loop: the same bytes."""
    shape = (96, 96, 64)
    blk = tiny(cfg, shape)["block"]
    img = microscopy.make_block(blk, 2 ** 35 + 5, 1, cuda)
    mask = microscopy.tissue_mask(blk, cuda)
    ev, _ = tt.st_recon(img.numpy(), 1.0, 2.0, lazy=True, device=cuda)
    kw = dict(mask=_mri(mask.view(np.uint8)),
              seed=_mri(microscopy.seed_lattice(mask, 4)), nsub=None,
              ang_thresh=None, step_size=None, smooth_coeff=None,
              search_dist=15, wire="i6")
    field = ev.device[..., :, 0]
    before = PM.propagate_micro_dir.launches
    one = tt.stream(field, trk_sink=str(tmp_path / "one.trk"), **kw)
    assert PM.propagate_micro_dir.launches - before == 2
    monkeypatch.setattr(modes, "_micro_chunk", lambda *a: 700)
    tt.stream(field, trk_sink=str(tmp_path / "many.trk"), **kw)
    assert PM.propagate_micro_dir.launches - before > 6
    monkeypatch.setattr(modes, "propagate_micro_dir",
                        PM.propagate_micro_dir_plain)
    tt.stream(field, trk_sink=str(tmp_path / "plain.trk"), **kw)
    assert one.n_count > 1000
    data = (tmp_path / "one.trk").read_bytes()
    assert data == (tmp_path / "many.trk").read_bytes()
    assert data == (tmp_path / "plain.trk").read_bytes()
