"""DSI on the CMU 257-sample lattice (the benchmark's `cmu_dsi257`):
`dsi_rec` against the plain float64 reference `portbench/reference/dsi.py`,
the lattice's b-table, the cell `dsi_maps` at a tiny size through the
benchmark's harness on the CPU, the faults its check must catch, its
roofline's work, and the program's DSI stages and counters.

Tolerances against the float64 reference (the program computes in
float32: its FFT, its half-spectrum GEMM over the 2,304 half-spectrum
cells and the PDF sum):
- PDF and ODF: the largest gap over the largest reference value, 1e-5.
  float32 rounding over sums of a few thousand terms gives ~5e-7 here;
  the TF32 control gives 3e-4, 600x more.
- first peak: the same vertex wherever the reference's two largest
  peaks differ by more than 1e-4 in QA units (near ties may flip on
  rounding; nothing else may).
- QA: 2e-5 where the vertex agrees.  QA divides by the largest mean
  ODF, a few times below the largest ODF, so the ODF's ~5e-7 grows to
  the ~2e-6 seen here.
"""

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
from fibers_tpu_torch.models import dsi as tdsi
from fibers_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, lattice, phantoms  # noqa: E402
from portbench.calibrate import readings  # noqa: E402
from portbench.pipelines import dsi as pipe  # noqa: E402
from portbench.reference import dsi as ref_dsi  # noqa: E402

PDF_TOL = 1e-5
ODF_TOL = 1e-5
QA_TOL = 2e-5
TIE = 1e-4


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


@pytest.fixture(scope="module")
def cfg(bench):
    return harness.load_config(bench, "cmu_dsi257")


def tiny(cfg, shape=(14, 14, 10)):
    """The configuration on a tiny grid: every width, the lattice, the
    sphere, the window and the limits as stated."""
    cfg = copy.deepcopy(cfg)
    cfg["scan"]["shape"] = list(shape)
    return cfg


def _dwi(vol, bval, bvec):
    shape = vol.shape[:3]
    dwi = tt.MRI(vol=np.ascontiguousarray(vol, np.float32))
    dwi.vox2ras0 = np.eye(4, dtype=np.float32)
    dwi.volsize = np.asarray(shape)
    dwi.width, dwi.height, dwi.depth = shape
    dwi.nframes = vol.shape[3]
    dwi.set_geometry()
    dwi.bval, dwi.bvec = bval, bvec
    return dwi


def _fit_both(vol, mask, bval, bvec, sphere="sphere_642", hann=32):
    """(program rows, reference rows) of the masked voxels, mask order."""
    dwi = _dwi(vol, bval, bvec)
    m = tt.MRI.like(dwi, 1, np.float32)
    m.vol = mask.astype(np.float32)
    out = tt.dsi_rec(dwi, m, getattr(tt, sphere), hann_width=hann,
                     device="cpu")
    idx = np.flatnonzero(mask)

    def rows(v):
        v = v.vol
        return torch.from_numpy(v.reshape(-1, v.shape[-1])[idx]
                                if v.ndim == 4 else v.reshape(-1)[idx])
    got = dict(pdf=rows(out.pdf), odf=rows(out.odf),
               vecs=torch.stack([rows(p) for p in out.peak], 1),
               qa=torch.stack([rows(q) for q in out.qa], 1))
    sig = torch.from_numpy(vol.reshape(-1, vol.shape[-1])[idx])
    return got, ref_dsi.fit(sig, bval, bvec, sphere, hann)


def _assert_close(got, ref):
    gaps = pipe.compare(got, ref)
    assert gaps["dsi_pdf_gap"] <= PDF_TOL, gaps
    assert gaps["dsi_odf_gap"] <= ODF_TOL, gaps
    same = (got["vecs"][:, 0] == ref["vecs"][:, 0].float()).all(-1)
    tie = (ref["qa"][:, 0] - ref["qa"][:, 1]) <= TIE
    assert bool((same | tie).all())
    assert bool(same.any())
    qa_gap = (got["qa"][:, 0].double() - ref["qa"][:, 0]).abs()
    assert float(qa_gap[same].max()) <= QA_TOL


def test_the_lattice_is_the_cmu_scheme(cfg):
    bval, bvec = lattice.btable(cfg["scan"])
    assert len(bval) == 257 and bval.dtype == np.float32
    assert bval[0] == 0 and (bval[1:] > 0).all()
    assert bval.max() == 7000 and sorted(set(bval.tolist()))[1] == 437.5
    assert np.allclose(np.linalg.norm(bvec[1:], axis=1), 1, atol=1e-6)
    nfft, cell, _ = ref_dsi.grid(bval, bvec, 32)
    assert nfft == 16 and len(set(cell.tolist())) == 257
    assert tdsi._dsi_grid(bval, bvec, 32)[0] == 16
    q = np.rint(bvec * np.sqrt(bval / 437.5)[:, None])
    assert ((q * q).sum(1) <= 16).all()
    assert len({tuple(v) for v in q.tolist()}) == 257


def test_dsi_rec_matches_the_reference_on_random_signals(cfg):
    """Seeded random signals that decay with b as diffusion signals do:
    s0 exp(-b d) with s0 and each sample's d drawn, and noise.  (The
    PDF's sum is nfft^3 times the b0 sample, so signals whose b0 is small
    against the rest would make it a cancellation of ~2,300 terms, in
    the program's algorithm and the reference's alike.)"""
    bval, bvec = lattice.btable(cfg["scan"])
    rng = np.random.default_rng(11)
    shape = (5, 4, 3, len(bval))
    s0 = rng.uniform(50, 150, shape[:3] + (1,))
    d = rng.uniform(0.1e-3, 3e-3, shape)
    vol = np.abs(s0 * np.exp(-bval * d)
                 + rng.normal(0, 2, shape)).astype(np.float32)
    vol[0, 0, 0] = 0                                  # a voxel not fitted
    got, ref = _fit_both(vol, np.ones(vol.shape[:3], bool), bval, bvec)
    assert not bool(ref["valid"][0]) and bool(ref["valid"][1:].all())
    assert float(got["odf"][0].abs().max()) == 0
    _assert_close(got, ref)


@pytest.mark.parametrize("hann", [32, 0])
def test_dsi_rec_matches_the_reference_on_the_phantom(cfg, hann):
    scan = tiny(cfg)["scan"]
    bval, bvec = lattice.btable(scan)
    vol, mask = lattice.make_subject(scan, 2 ** 33 + 9, 0, "cpu")
    got, ref = _fit_both(vol.numpy(), mask, bval, bvec, hann=hann)
    assert int(ref["valid"].sum()) == int(mask.sum())
    _assert_close(got, ref)


def test_repeated_cells_keep_the_last_sample():
    """Two b0s in one cell: the reference keeps the later, as the
    program does (fibers_tpu_torch/models/dsi.py)."""
    bval, bvec = lattice.btable({"lattice": {"radius": 2, "bmax": 3000}})
    bval = np.concatenate([[0.0], bval]).astype(np.float32)
    bvec = np.concatenate([np.zeros((1, 3)), bvec]).astype(np.float32)
    rng = np.random.default_rng(3)
    vol = rng.uniform(1, 100, (3, 3, 2, len(bval))).astype(np.float32)
    got, ref = _fit_both(vol, np.ones(vol.shape[:3], bool), bval, bvec,
                         sphere="sphere_642")
    _assert_close(got, ref)
    vol[..., 0] *= 7                                  # the first b0 is lost
    _, ref2 = _fit_both(vol, np.ones(vol.shape[:3], bool), bval, bvec,
                        sphere="sphere_642")
    assert torch.equal(ref["odf"], ref2["odf"])


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench.reference import dsi; "
            "from portbench import lattice; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'fibers_tpu', 'fibers_tpu_torch'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def _run(bench, cfg, trace, seconds=0.4):
    cell = harness.find(bench["workloads"], "dsi_maps", "workload")
    args = types.SimpleNamespace(seed=2 ** 33 + 5, seconds=seconds,
                                 trace=trace)
    return harness.run_cell(bench, cell, args, 0.0, "cpu", tiny(cfg))


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_is_correct(bench, cfg, trace):
    result, checks = _run(bench, cfg, trace)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert [c[0] for c in checks] == ["dsi_pdf_gap", "dsi_odf_gap",
                                      "dsi_peak_flips", "dsi_qa_gap"]
    got = set(result["metrics"])
    if trace:
        # no device here: the roofline reads nothing
        assert got == {"device_idle_pct", "dsi.s", "dsi.tables_s",
                       "dsi.upload_s", "dsi.chunks_s", "mfu.dsi"}
    else:
        assert got == {"subject_s", "subject_p90_s", "setup_s"}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    for k, v in result["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    json.dumps(result)


def test_the_control_fails_and_the_program_passes(cfg, tmp_path):
    c = tiny(cfg)
    rows = readings(c, harness.load_traffic("maps"), "dsi", [2 ** 34 + 1],
                    1, str(tmp_path), "cpu")
    prog = [g for _, side, g in rows if side == "program"][0]
    ctl = [g for _, side, g in rows if side == "control"][0]
    lim = c["limits"]
    assert all(prog[n] <= lim[n] for n in lim), prog
    assert [n for n in lim if not ctl[n] <= lim[n]] != [], ctl


def _hann_off(monkeypatch):
    """The Hanning window left out: every sample weighted 1."""
    real = tdsi._dsi_grid

    def grid(bval, bvec, hann_width):
        nfft, iq, hann = real(bval, bvec, hann_width)
        return nfft, iq, np.ones_like(hann)
    monkeypatch.setattr(tdsi, "_dsi_grid", grid)


def _radius_dropped(monkeypatch):
    """The radial integral's outermost radius (0.9 of Nyquist) left out."""
    real = tdsi._radial_weight_matrix

    def weights(nfft, odf_dirs):
        w = real(nfft, odf_dirs).astype(np.float64)
        n = odf_dirs.nvert_half
        idx, sw = ref_dsi._stencils(
            nfft, odf_dirs.vertices[n:].astype(np.float64))
        for k in range(8):
            np.add.at(w, (idx[k, -1], np.arange(n)), -sw[k, -1])
        return w.astype(np.float32)
    monkeypatch.setattr(tdsi, "_radial_weight_matrix", weights)


@pytest.mark.parametrize("fault", [_hann_off, _radius_dropped],
                         ids=["hann_off", "radius_dropped"])
def test_a_broken_fit_is_not_correct(bench, cfg, monkeypatch, fault):
    fault(monkeypatch)
    result, _ = _run(bench, cfg, 0, seconds=0.1)
    assert result["correct"] is False, result["checks"]


def test_the_roofline_work_at_the_cell(cfg):
    _, _, _, mask, _ = phantoms.geometry(tuple(cfg["scan"]["shape"]), "cpu")
    n = int(mask.sum())
    assert n == 216_752
    m = harness.load_metric("dsi.roofline_pct")
    nbytes, flops = m.work(n, 257, 321, 16, 21)
    assert round(nbytes / 1e6) == 734
    assert round(flops / 1e9, 1) == 50.0
    peaks = json.load(open(os.path.join(ROOT, "portbench", "peaks.json")))
    facts = dict(n_voxels=n, nvol=257, nvert=321, nfft=16, nradii=21)
    assert round(m.bound_s(peaks, facts) * 1e3, 3) == 0.746


def test_the_roofline_reads_what_starts_inside_dsi_spans():
    m = harness.load_metric("dsi.roofline_pct")
    ms = 1_000_000
    trace = types.SimpleNamespace(
        spans=[(0, 10 * ms, "dsi"), (10 * ms, 20 * ms, "maps"),
               (20 * ms, 30 * ms, "dsi")],
        ops=[(1 * ms, 2 * ms, "Memcpy HtoD (Pinned -> Device)"),
             (2 * ms, 5 * ms, "fft_kernel"), (11 * ms, 12 * ms, "gather"),
             (21 * ms, 23 * ms, "sm90_gemm"), (24 * ms, 25 * ms, "Memset")])
    assert m.device_seconds(trace) == (0.006, 3)
    run = types.SimpleNamespace(trace=trace, n=2, peaks={"hbm_bytes_s": 1,
                                                         "fp32_flop_s": 1},
                                facts=dict(n_voxels=0, nvol=1, nvert=1,
                                           nfft=2, nradii=1))
    assert m.read(run) == 0.0
    run.trace = types.SimpleNamespace(spans=trace.spans, ops=[])
    assert m.read(run) is None


@pytest.mark.parametrize("name", ["dsi.tables_s", "dsi.upload_s",
                                  "dsi.chunks_s"])
def test_a_stage_the_program_lacks_reads_nothing(name):
    run = types.SimpleNamespace(counters={}, n=3)
    assert harness.load_metric(name).read(run) is None
    run.counters = {name.split(".")[1]: 0.6}
    assert harness.load_metric(name).read(run) == pytest.approx(0.2)


def test_the_tables_stage_and_counters_are_recorded(cfg):
    scan = tiny(cfg, (6, 6, 4))["scan"]
    bval, bvec = lattice.btable(scan)
    vol, mask = lattice.make_subject(scan, 5, 0, "cpu")
    dwi = _dwi(vol.numpy(), bval, bvec)
    m = tt.MRI.like(dwi, 1, np.float32)
    m.vol = mask.astype(np.float32)
    tm = {}
    with profiling.collect() as rec:
        tt.dsi_rec(dwi, m, tt.sphere_642, chunk=16, device="cpu",
                   timings=tm)
    n = int(mask.sum())
    assert rec.counters["dsi.rows"] == n
    assert rec.counters["dsi.chunk_launches"] == -(-n // 16)
    tables = rec.spans["dsi.tables"]
    assert tables.calls == 1 and tables.parents == {"dsi.upload"}
    assert tm["tables"] <= tm["upload"]
    with profiling.collect() as rec:
        pass
    assert rec.counters == {}
