"""DSI of the PyTorch port against the JAX package and the per-voxel
oracle (tests/oracle.py:dsi_voxel_oracle).

Tolerances: the host tables are copies and equal JAX's exactly.  The
device chain differs from XLA's in its FFT (pocketfft here) and GEMM
summation order, so PDF and ODF agree to atol=1e-6 (their values are
<= ~0.2; seen: 1.6e-7) and QA to atol=1e-5 (seen: 2.4e-6); peak
directions are equal wherever both packages find a valid peak, and the
validity masks are equal.  Against the float64 oracle: rtol=5e-4,
atol=5e-6, as tests/test_dsi.py.
"""

import os

import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.models import dsi as jdsi
from fibers_tpu_torch.models import dsi as tdsi
from fibers_tpu_torch.utils.phantom import dsi_qgrid, make_dsi_brain

from test_dsi import dsi_qspace_tables, make_dsi_phantom
from test_torch_stream import _compare_tracts


def _wrap(vol, bval, bvec):
    shape = vol.shape[:3]
    dwi = ft.MRI(vol=vol.astype(np.float32))
    dwi.vox2ras0 = np.eye(4, dtype=np.float32)
    dwi.volsize = np.asarray(shape)
    dwi.width, dwi.height, dwi.depth = shape
    dwi.nframes = vol.shape[3]
    dwi.set_geometry()
    dwi.bval, dwi.bvec = bval.astype(np.float32), bvec.astype(np.float32)
    mask = ft.MRI.like(dwi, 1, np.float32)
    mask.vol = np.ones(shape, np.float32)
    return dwi, mask


def _assert_dsi_close(j, t):
    for f in ("pdf", "odf"):
        np.testing.assert_allclose(np.asarray(getattr(t, f).vol),
                                   np.asarray(getattr(j, f).vol),
                                   atol=1e-6, rtol=0, err_msg=f)
    for i in range(3):
        qj, qt = j.qa[i].vol, t.qa[i].vol
        np.testing.assert_allclose(qt, qj, atol=1e-5, rtol=0)
        assert np.array_equal(qt > 0, qj > 0)
        valid = qj > 0
        assert np.array_equal(t.peak[i].vol[valid], j.peak[i].vol[valid])


@pytest.mark.parametrize("tables", ["test_dsi", "qgrid3", "qgrid5"])
def test_host_tables_equal_jax(tables):
    if tables == "test_dsi":
        bval, bvec = dsi_qspace_tables()
    else:
        bval, bvec = dsi_qgrid(int(tables[-1]))
    for hw in (32, 0):
        got, want = tdsi._dsi_grid(bval, bvec, hw), jdsi._dsi_grid(
            bval, bvec, hw)
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
    nfft = got[0]
    assert np.array_equal(tdsi._radial_weight_matrix(nfft, ft.sphere_362),
                          jdsi._radial_weight_matrix(nfft, ft.sphere_362))
    assert np.array_equal(tdsi._half_spectrum_map(nfft),
                          jdsi._half_spectrum_map(nfft))


def test_qgrid_and_phantom_match_the_benchmark():
    """dsi_qgrid and make_dsi_brain are copies of config 3's
    (benchmarks/bench_models.py:91-123)."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "benchmarks"))
    import bench_models
    for r in (3, 5):
        for a, b in zip(dsi_qgrid(r), bench_models.dsi_qgrid(r)):
            assert np.array_equal(a, b)
    assert len(dsi_qgrid(5)[0]) == 515
    dwi, mask, _ = make_dsi_brain(small=True)
    m, ax = bench_models._geometry((32, 32, 20))
    bval, bvec = bench_models.dsi_qgrid(3)
    vol = bench_models._signal(m, ax, bval, bvec, np.random.default_rng(0))
    assert np.array_equal(dwi.vol.view(np.uint32), vol.view(np.uint32))
    assert np.array_equal(mask.vol > 0, m)
    # the slab-wise noise draw of the port's _signal, on a config-3-wide
    # slab (96x96, 515 samples) and on the small config-4 table
    from fibers_tpu_torch.utils import phantom
    rdwi = phantom.make_rumba_brain(small=True)[0]
    for shape, (bv, bq) in (((3, 96, 96), dsi_qgrid(5)),
                            ((4, 40, 30), (rdwi.bval, rdwi.bvec))):
        m, ax = bench_models._geometry(shape)
        want = bench_models._signal(m, ax, bv, bq, np.random.default_rng(1))
        got = phantom._signal(m, ax, bv, bq, np.random.default_rng(1))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("kind", ["phantom", "brain"])
def test_dsi_rec_matches_jax(kind):
    if kind == "phantom":
        dwi, mask, _ = make_dsi_phantom(axis=(1, 0.3, 0.1))
    else:
        dwi, mask, _ = make_dsi_brain(small=True)
    j = ft.dsi_rec(dwi, mask, ft.sphere_642)
    t = tt.dsi_rec(dwi, mask, ft.sphere_642, device="cpu")
    _assert_dsi_close(j, t)
    assert t.pdf.vol.shape == mask.vol.shape + (len(dwi.bval),)


def test_dsi_rec_tied_peaks_match_jax(monkeypatch):
    """A fit whose radial weights hold the vertex along the fibre twice
    (its column copied over a far vertex's): both ODF values are equal,
    both are strict maxima, and both packages put the lower vertex
    first."""
    dwi, mask, _ = make_dsi_phantom(axis=(1, 0.3, 0.1))
    sphere = ft.sphere_642
    n = sphere.nvert_half
    first = np.asarray(sphere.vertices[:n], np.float64)
    first /= np.linalg.norm(first, axis=1, keepdims=True)
    plain = np.asarray(ft.dsi_rec(dwi, mask, sphere).odf.vol).reshape(-1, n)
    src = int(np.argmax(plain[0]))                   # the ODF's top vertex
    far = np.flatnonzero(np.abs(first @ first[src]) < 0.2)
    dup = int(far[far < src][-1]) if (far < src).any() else int(far[0])

    def twice(weights):
        def wrapped(nfft, odf_dirs):
            w = np.array(weights(nfft, odf_dirs))
            w[:, dup] = w[:, src]
            return w
        return wrapped

    monkeypatch.setattr(jdsi, "_radial_weight_matrix",
                        twice(jdsi._radial_weight_matrix))
    monkeypatch.setattr(tdsi, "_radial_weight_matrix",
                        twice(tdsi._radial_weight_matrix))
    j = ft.dsi_rec(dwi, mask, sphere)
    t = tt.dsi_rec(dwi, mask, sphere, device="cpu")
    lo, hi = sorted((src, dup))
    for fit in (j, t):
        odf = np.asarray(fit.odf.vol).reshape(-1, n)
        assert np.array_equal(odf[:, src], odf[:, dup])
        assert np.all(odf[:, src] == odf.max(axis=1))       # tied at the top
        for ip, v in ((0, lo), (1, hi)):
            pk = np.asarray(fit.peak[ip].vol).reshape(-1, 3)
            assert np.allclose(np.abs(pk @ first[v]), 1.0, atol=1e-3), ip
    _assert_dsi_close(j, t)
    assert np.array_equal(np.asarray(t.qa[0].vol), np.asarray(t.qa[1].vol))


def test_dsi_peak_follows_the_true_axis():
    dwi, mask, ax = make_dsi_brain(small=True)
    t = tt.dsi_rec(dwi, mask, device="cpu")
    m = mask.vol > 0
    cos = np.abs((t.peak[0].vol[m] * ax[m]).sum(-1))
    assert np.median(cos) > 0.9


def test_repeated_b0s_match_jax():
    """Three b0 volumes land in one q-space cell; the port keeps the last
    of them, as XLA's CPU scatter does."""
    bval, bvec = dsi_qspace_tables()
    rng = np.random.default_rng(4)
    nb0 = 3
    bval = np.concatenate([np.zeros(nb0, np.float32), bval])
    bvec = np.concatenate([np.zeros((nb0, 3), np.float32), bvec])
    vol = (np.abs(rng.standard_normal((3, 3, 2, len(bval)))) * 40
           + 5).astype(np.float32)
    dwi, mask = _wrap(vol, bval, bvec)
    _, iq_flat, _ = tdsi._dsi_grid(bval, bvec, 32)
    assert len(np.unique(iq_flat)) < len(iq_flat)
    j = ft.dsi_rec(dwi, mask, ft.sphere_362)
    t = tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu")
    _assert_dsi_close(j, t)
    # the first b0s are overwritten: changing them changes nothing
    vol2 = vol.copy()
    vol2[..., :nb0 - 1] *= 3.0
    dwi2, _ = _wrap(vol2, bval, bvec)
    t2 = tt.dsi_rec(dwi2, mask, ft.sphere_362, device="cpu")
    assert np.array_equal(np.asarray(t2.odf.vol), np.asarray(t.odf.vol))


def _nfft32_case():
    """tests/test_dsi.py's sparse radius-8 grid (nfft = 32)."""
    rng2 = np.random.default_rng(3)
    pts = [(8, 0, 0), (-8, 0, 0), (0, 8, 0), (0, -8, 0), (0, 0, 8),
           (0, 0, -8), (0, 0, 0)]
    while len(pts) < 40:
        p = tuple(rng2.integers(-8, 9, 3))
        if 0 < np.linalg.norm(p) <= 8 and p not in pts:
            pts.append(p)
    q = np.array(pts, np.float64)
    norm = np.linalg.norm(q, axis=1)
    bvec = np.where(norm[:, None] > 0,
                    q / np.maximum(norm, 1e-30)[:, None], 0.0)
    bval = (norm ** 2) * 125.0
    vol = (np.abs(np.random.default_rng(42).standard_normal(
        (2, 2, 1, len(q)))) * 40 + 5).astype(np.float32)
    return _wrap(vol, bval, bvec)


def test_memory_guard_matches_oracle():
    """A ~50 MB budget at nfft = 32 shrinks the chunk (<= 64 voxels);
    the results still match the per-voxel oracle."""
    from oracle import dsi_voxel_oracle

    dwi, mask = _nfft32_case()
    vol = dwi.vol
    dsi = tt.dsi_rec(dwi, mask, ft.sphere_362, mem_budget=50e6,
                     device="cpu")
    odf_vol, pdf_vol = np.asarray(dsi.odf.vol), np.asarray(dsi.pdf.vol)
    for ix in range(2):
        for iy in range(2):
            pdf_ref, odf_ref = dsi_voxel_oracle(
                vol[ix, iy, 0].astype(np.float64), dwi.bval, dwi.bvec,
                np.asarray(ft.sphere_362.vertices))
            np.testing.assert_allclose(pdf_vol[ix, iy, 0], pdf_ref,
                                       rtol=5e-4, atol=5e-6)
            np.testing.assert_allclose(odf_vol[ix, iy, 0], odf_ref,
                                       rtol=5e-4, atol=5e-6)


def test_memory_guard_keeps_the_outputs():
    """A budget that forces 256-voxel chunks (nfft = 8 here) gives the
    outputs of 4096-voxel chunks: each voxel's chain is its own row."""
    dwi, mask, _ = make_dsi_brain(small=True)
    a = tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu")
    b = tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu",
                   mem_budget=256 * 8 ** 3 * 12)
    for f in ("pdf", "odf"):
        np.testing.assert_allclose(np.asarray(getattr(b, f).vol),
                                   np.asarray(getattr(a, f).vol),
                                   atol=1e-7, rtol=0)
    np.testing.assert_allclose(b.qa[0].vol, a.qa[0].vol, atol=1e-6, rtol=0)


def test_batch_and_timings():
    dwi, mask, _ = make_dsi_phantom(shape=(4, 4, 3))
    batch = tt.prepare_batch(dwi, mask, wire="f32", device="cpu")
    tm = {}
    a = tt.dsi_rec(dwi, mask, ft.sphere_362, batch=batch, timings=tm)
    b = tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu")
    assert set(tm) == {"upload", "tables", "chunks", "finalize"}
    assert np.array_equal(np.asarray(a.odf.vol), np.asarray(b.odf.vol))


def test_handoff_into_stream_gives_jax_lines():
    """dsi_rec -> peaks_to_ovecs(device=True) -> stream in both packages
    (tests/test_stream.py:769)."""
    dwi, mask, _ = make_dsi_brain(small=True)
    kw = dict(mask=mask, nsub=1, f_thresh=0.0, wire="f32")
    tj = ft.stream(ft.peaks_to_ovecs(ft.dsi_rec(dwi, mask, ft.sphere_362),
                                     device=True), **kw)
    tr = tt.stream(tt.peaks_to_ovecs(
        tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu"), device=True),
        **kw)
    assert tr.n_count > 1000
    _compare_tracts(tj, tr)


@pytest.mark.parametrize("wire,exc", [
    ("auto8", None), ("auto", None), ("f32", None),
    ("u8", None), ("u12", None), ("u16", None), ("f16", ValueError)])
def test_wire_rules(wire, exc):
    """Every wire name of the reference is accepted.  A dsi_rec without a
    batch on the CPU slices exact host rows whatever the wire, as the
    reference does on its CPU backend: its ODF equals the "f32" run's and
    the reference's with the same wire.  An unknown name raises."""
    dwi, mask, _ = make_dsi_phantom(shape=(3, 3, 2))
    if exc is not None:
        with pytest.raises(exc, match="wire"):
            tt.dsi_rec(dwi, mask, ft.sphere_362, wire=wire, device="cpu")
        return
    got = tt.dsi_rec(dwi, mask, ft.sphere_362, wire=wire, device="cpu")
    want = tt.dsi_rec(dwi, mask, ft.sphere_362, wire="f32", device="cpu")
    assert np.array_equal(np.asarray(got.odf.vol), np.asarray(want.odf.vol))
    ref = ft.dsi_rec(dwi, mask, ft.sphere_362, wire=wire)
    np.testing.assert_allclose(np.asarray(got.odf.vol),
                               np.asarray(ref.odf.vol), atol=1e-6, rtol=0)


def test_write_and_read_back(tmp_path):
    dwi, mask, _ = make_dsi_phantom(shape=(3, 3, 3))
    dsi = tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu")
    base = str(tmp_path / "dsifit")
    tt.dsi_write(dsi, base)
    for f in ("pdf", "odf", "peak1", "qa1", "peak3", "qa3"):
        assert os.path.isfile(f"{base}_{f}.nii.gz"), f
    back = tt.mri_read(base, tt.DSI)
    np.testing.assert_allclose(back.qa[0].vol, dsi.qa[0].vol, atol=1e-7)
    assert back._peak_dev is None


def test_empty_mask_and_missing_tables():
    dwi, mask, _ = make_dsi_phantom(shape=(3, 3, 2))
    mask.vol[:] = 0
    dsi = tt.dsi_rec(dwi, mask, ft.sphere_362, device="cpu")
    assert not np.asarray(dsi.odf.vol).any()
    dwi.bval = None
    with pytest.raises(ValueError, match="b-value"):
        tt.dsi_rec(dwi, mask, device="cpu")


@pytest.mark.cuda
def test_dsi_card_matches_cpu():
    """The small config-3 phantom on the card and the CPU: ODF within
    1e-5, QA within 1e-4, peak 1 equal on >= 99.5% of valid voxels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dwi, mask, _ = make_dsi_brain(small=True)
    g = tt.dsi_rec(dwi, mask, device="cuda")
    c = tt.dsi_rec(dwi, mask, device="cpu")
    np.testing.assert_allclose(g.odf.vol, c.odf.vol, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g.qa[0].vol, c.qa[0].vol, atol=1e-4, rtol=0)
    valid = (g.qa[0].vol > 0) & (c.qa[0].vol > 0)
    same = np.all(g.peak[0].vol == c.peak[0].vol, axis=-1)[valid]
    assert same.mean() >= 0.995
