"""The plain references against the port, at a small size on the CPU,
where the port runs its plain PyTorch versions."""

import numpy as np
import pytest
import torch

import fibers_tpu_torch as tt
from portbench import harness, phantoms
from portbench.pipelines import dti_gqi
from portbench.reference import dti as ref_dti
from portbench.reference import gqi as ref_gqi
from portbench.reference import rumba as ref_rumba
from portbench.reference import structens as ref_st
from portbench.reference import tract as ref_tract


@pytest.fixture(scope="module")
def main_cell():
    from conftest import small
    bench = harness.load_benchmark()
    cfg = small(harness.load_config(bench, "hcp_mgh_dti_gqi"))
    traffic = harness.load_traffic("trk")
    cell = dti_gqi.Cell(cfg, traffic, 2 ** 35 + 11, ".", "cpu")
    return cell, cfg


def test_dti_reference_follows_the_port(main_cell):
    cell, cfg = main_cell
    dwi = cell.subjects[0][0]
    d = tt.dti_fit(dwi, cell.mask, device="cpu")
    idx = np.flatnonzero(cell.mask_np)
    bval, bvec = phantoms.btable(cfg["scan"])
    r = ref_dti.fit(cell.signals(0), bval, bvec)
    fa = d.fa.vol.reshape(-1)[idx]
    np.testing.assert_allclose(fa, r["fa"].numpy(), atol=1e-4)
    np.testing.assert_allclose(d.md.vol.reshape(-1)[idx], r["md"].numpy(),
                               rtol=1e-4)
    v = d.eigvec1.vol.reshape(-1, 3)[idx]
    cos = np.abs((v * r["evecs"][:, :, 0].numpy()).sum(1))
    assert np.median(cos) > 1 - 1e-6


def test_gqi_reference_follows_the_port(main_cell):
    cell, cfg = main_cell
    dwi = cell.subjects[0][0]
    g = tt.gqi_rec(dwi, cell.mask, tt.sphere_642, device="cpu")
    idx = np.flatnonzero(cell.mask_np)
    bval, bvec = phantoms.btable(cfg["scan"])
    r = ref_gqi.fit(cell.signals(0), bval, bvec, "sphere_642")
    odf = g.odf.vol.reshape(-1, g.odf.vol.shape[-1])[idx]
    scale = np.abs(r["odf"].numpy()).max()
    assert np.abs(odf - r["odf"].numpy()).max() / scale < 1e-5
    p = g.peak[0].vol.reshape(-1, 3)[idx]
    assert (p == r["vecs"][:, 0].float().numpy()).all(1).mean() > 0.999
    qa = g.qa[0].vol.reshape(-1)[idx]
    np.testing.assert_allclose(qa, r["qa"][:, 0].numpy(), atol=1e-5)


def test_tracking_reference_equals_the_port_line_for_line(main_cell):
    cell, cfg = main_cell
    st = cfg["stream"]
    dwi = cell.subjects[0][0]
    d = tt.dti_fit(dwi, cell.mask, device="cpu")
    g = tt.gqi_rec(dwi, cell.mask, tt.sphere_642, device="cpu")
    tract = tt.stream(tt.peaks_to_ovecs(g, device=True).first(1),
                      fa=d.fa, mask=cell.mask, seed=cell.seed,
                      nsub=st["nsub"], f_thresh=st["f_thresh"])
    idx = np.flatnonzero(cell.mask_np)
    out = dict(fa=torch.from_numpy(d.fa.vol.reshape(-1)[idx]),
               vecs=torch.from_numpy(np.stack(
                   [p.vol.reshape(-1, 3)[idx] for p in g.peak], 1)),
               qa=torch.from_numpy(np.stack(
                   [q.vol.reshape(-1)[idx] for q in g.qa], 1)))
    field = dti_gqi._field(out, idx, cell.mask_np.size, st["fa_thresh"],
                           st["f_thresh"], 1, "cpu")
    pts, npts, counts = ref_tract.track(field, tuple(cfg["scan"]["shape"]),
                                        cell.seed_vol, nsub=st["nsub"])
    assert np.array_equal(npts.numpy(), np.asarray(tract.npts))
    assert torch.equal(pts, torch.from_numpy(tract.packed_xyz))
    assert counts["streams"] == 3 * int(cell.seed_vol.sum())
    assert ref_tract.compare_lines(pts, npts, pts, npts, 0.0) == 0.0
    moved = pts.clone()
    moved[5, 1] += 0.01
    assert ref_tract.compare_lines(moved, npts, pts, npts, 1e-3) == \
        pytest.approx(1 / len(npts))


def test_trk_reader_reads_the_ports_sink(main_cell, tmp_path):
    cell, cfg = main_cell
    st = cfg["stream"]
    dwi = cell.subjects[1][0]
    g = tt.gqi_rec(dwi, cell.mask, tt.sphere_642, device="cpu")
    pk = tt.peaks_to_ovecs(g, device=True).first(1)
    kw = dict(mask=cell.mask, seed=cell.seed, nsub=st["nsub"],
              f_thresh=st["f_thresh"])
    tract = tt.stream(pk, **kw)
    tt.stream(pk, trk_sink=str(tmp_path / "a.trk"), **kw)
    pts, npts, count = ref_tract.read_trk(str(tmp_path / "a.trk"))
    assert count == tract.n_count and np.array_equal(npts, tract.npts)
    mm = ref_tract.to_mm(torch.from_numpy(tract.packed_xyz),
                         [cfg["scan"]["voxel_mm"]] * 3)
    assert np.array_equal(pts, mm.numpy())


def test_rumba_reference_follows_the_port():
    from conftest import small
    bench = harness.load_benchmark()
    cfg = small(harness.load_config(bench, "hcp_rumba_sd"))
    fit = cfg["fit"]
    vol, mask = phantoms.make_subject(cfg["scan"], 5, 0, "cpu")
    bval, bvec = phantoms.btable(cfg["scan"])
    dwi = _mri(vol.numpy(), bval, bvec, cfg)
    m = tt.MRI.like(dwi, 1, np.float32)
    m.vol = mask.astype(np.float32)
    rum = tt.rumba_rec(dwi, m, tt.sphere_724, niter=fit["niter"],
                       device="cpu")
    idx = np.flatnonzero(mask)
    rows = vol.reshape(-1, vol.shape[-1])[torch.from_numpy(idx)]
    sig = ref_rumba.signal_rows(rows, bval, "f32")   # the CPU's signal
    K = ref_rumba.kernel_matrix(bval, bvec, "sphere_724", fit["lam_par"],
                                fit["lam_perp"], fit["lam_csf"],
                                fit["lam_gm"])
    fodf = ref_rumba.fit(sig, K, mask, fit["niter"])
    full, f_iso, gfa = ref_rumba.post(fodf, K.shape[1] - 2)
    got = rum.fodf.vol.reshape(-1, full.shape[1])[idx]
    assert np.abs(got - full.numpy()).max() * full.shape[1] < 1e-4
    np.testing.assert_allclose(rum.gfa.vol.reshape(-1)[idx], gfa.numpy(),
                               atol=1e-5)
    vecs, _ = ref_rumba.peaks(full, f_iso, "sphere_724")
    p = rum.peak[0].vol.reshape(-1, 3)[idx]
    assert (np.abs(p - vecs[:, 0].numpy()).max(1) <= 1e-4).mean() > 0.99


def _mri(vol, bval, bvec, cfg):
    dwi = tt.MRI(vol=vol)
    res = cfg["scan"]["voxel_mm"]
    dwi.vox2ras0 = np.diag([res, res, res, 1.0]).astype(np.float32)
    dwi.volsize = np.asarray(vol.shape[:3])
    dwi.width, dwi.height, dwi.depth = vol.shape[:3]
    dwi.nframes = vol.shape[3]
    dwi.set_geometry()
    dwi.bval, dwi.bvec = bval, bvec
    return dwi


def test_structure_tensor_reference_follows_the_port():
    rng = np.random.default_rng(3)
    vol = rng.random((14, 11, 9)).astype(np.float32)
    ev, el = tt.st_recon(vol, sigma=1.0, rho=2.0, device="cpu")
    s = np.einsum("...ik,...k,...jk->...ij", ev.astype(np.float64),
                  el.astype(np.float64), ev.astype(np.float64))
    got = np.stack([s[..., 0, 0], s[..., 0, 1], s[..., 0, 2], s[..., 1, 1],
                    s[..., 1, 2], s[..., 2, 2]], -1)
    ref = ref_st.tensor(torch.from_numpy(vol), 1.0, 2.0).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
