"""GQI in the PyTorch port held against the JAX package.

The port's fused tile (its plain PyTorch version on the CPU) is compared
with the Pallas kernel run in interpret mode, and `gqi_rec` with the JAX
`gqi_rec`, on identical numpy inputs.

Tolerances: the ODF is a float32 sum of nvol products whose order differs
between XLA and PyTorch, so it agrees to a few ulp: atol=1e-4 where the
ODF is O(1), plus rtol=1e-6 (~8 ulp) where the phantom's ODF reaches
~10^3.  QA is normalised to O(1): atol=1e-5.  Peak masks are compared
exactly on one and the same ODF, and so are the top-3 peaks.  Rows with
a NaN sample are invalid and all zero in both packages; NaN compares
equal to NaN where the raw tile outputs are compared.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.core.odf import half_sphere
from fibers_tpu.ops.pallas.gqi_fused import gqi_fused as jax_gqi_fused
from fibers_tpu.ops.pallas.gqi_fused import neighbor_permutations
from fibers_tpu.ops.peaks import build_neighbors as jax_build_neighbors
from fibers_tpu.ops.peaks import peak_mask as jax_peak_mask
from fibers_tpu_torch.models.gqi import _gqi_kernel_fused
from fibers_tpu_torch.ops.kernels.gqi_fused import gqi_fused, gqi_fused_plain
from fibers_tpu_torch.ops.peaks import build_neighbors, peak_mask, top_peaks

from phantom import make_phantom


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tables(sphere):
    nvert = sphere.nvert_half
    _, _, faces0 = half_sphere(sphere)
    return build_neighbors(faces0, nvert)


@pytest.mark.parametrize("name", ["sphere_362", "sphere_642", "sphere_724"])
def test_build_neighbors_matches_jax(name):
    sphere = getattr(ft, name)
    _, _, faces0 = half_sphere(sphere)
    nbr, ok = build_neighbors(faces0, sphere.nvert_half)
    nbr_j, ok_j = jax_build_neighbors(faces0, sphere.nvert_half)
    assert np.array_equal(nbr, nbr_j) and np.array_equal(ok, ok_j)


@pytest.mark.parametrize("name", ["sphere_362", "sphere_642"])
def test_fused_plain_matches_pallas_interpret(name):
    sphere = getattr(ft, name)
    nvert = sphere.nvert_half
    nbr, ok = _tables(sphere)
    rng = np.random.default_rng(11)
    n, nvol = 256, 31
    signals = rng.standard_normal((n, nvol)).astype(np.float32)
    signals[::17] = -1.0                       # all-clamped rows: valid = 0
    signals[5::37, 7] = np.nan                 # a NaN sample: valid = 0
    A_t = rng.standard_normal((nvol, nvert)).astype(np.float32)

    P, okm = neighbor_permutations(nbr, ok)
    odf_j, pm_j, st_j = (np.array(x) for x in jax_gqi_fused(
        jnp.asarray(signals), jnp.asarray(A_t), jnp.asarray(P),
        jnp.asarray(okm), interpret=True))
    odf, pm, st, _, _ = gqi_fused(torch.from_numpy(signals),
                                  torch.from_numpy(A_t),
                                  torch.from_numpy(nbr), torch.from_numpy(ok))

    nan_rows = np.isnan(signals).any(axis=1)
    assert np.isnan(odf_j[nan_rows]).all() and not np.isnan(odf_j[~nan_rows]).any()
    np.testing.assert_allclose(odf.numpy(), odf_j, atol=1e-4, rtol=0,
                               equal_nan=True)
    np.testing.assert_allclose(st.numpy(), st_j, atol=1e-5, rtol=0,
                               equal_nan=True)
    assert np.array_equal(st.numpy()[:, 2], st_j[:, 2])
    assert not st_j[nan_rows, 2].any() and not pm.numpy()[nan_rows].any()
    # peak masks, each package's rule on the other's ODF
    pm_on_j = peak_mask(torch.from_numpy(odf_j), torch.from_numpy(nbr),
                        torch.from_numpy(ok)).numpy()
    assert np.array_equal(pm_on_j, pm_j > 0.5)
    pm_j_on_port = np.asarray(jax_peak_mask(jnp.asarray(odf.numpy()),
                                            jnp.asarray(nbr),
                                            jnp.asarray(ok)))
    assert np.array_equal(pm.numpy(), pm_j_on_port)


def test_fused_wrapper_checks_arguments():
    nbr, ok = _tables(ft.sphere_362)
    s = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="rows"):
        gqi_fused(s, torch.zeros((6, 181)), torch.from_numpy(nbr),
                  torch.from_numpy(ok))
    with pytest.raises(TypeError, match="float32"):
        gqi_fused(s.double(), torch.zeros((5, 181)), torch.from_numpy(nbr),
                  torch.from_numpy(ok))
    with pytest.raises(TypeError, match="int32"):
        gqi_fused(s, torch.zeros((5, 181)), torch.from_numpy(nbr).long(),
                  torch.from_numpy(ok))


def test_kernel_build_dir_needs_a_checkout(tmp_path, monkeypatch):
    from fibers_tpu_torch.ops.kernels import _build
    root = os.path.dirname(os.path.dirname(os.path.abspath(tt.__file__)))
    assert _build.build_dir() == os.path.join(root, "build", "kernels")
    monkeypatch.setattr(_build, "_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="checkout"):
        _build.build_dir()


def test_top_peaks_valid_slots_match_lax():
    import jax.lax as lax
    rng = np.random.default_rng(3)
    nbr, ok = _tables(ft.sphere_362)
    o = rng.random((64, ft.sphere_362.nvert_half)).astype(np.float32)
    is_peak = peak_mask(torch.from_numpy(o), torch.from_numpy(nbr),
                        torch.from_numpy(ok))
    vals, idx, valid = top_peaks(torch.from_numpy(o), is_peak, 3)
    vj, ij = lax.top_k(jnp.where(jnp.asarray(is_peak.numpy()), o, 0.0), 3)
    vj, ij = np.asarray(vj), np.asarray(ij)
    assert np.array_equal(valid.numpy(), vj > 0)
    m = valid.numpy()
    assert np.array_equal(vals.numpy()[m], vj[m])
    assert np.array_equal(idx.numpy()[m], ij[m])


def _tied_rows(nbr, nvert, seed):
    """Rows of a low random floor with a few far-apart vertices raised
    to shared levels: rows with two and with three tied valid peaks (at
    the top, and below a single higher peak), rows with fewer than five
    peaks, a flat row (no peak) and an all-zero row.  The floor is drawn
    from 4 levels, so that it ties too."""
    rng = np.random.default_rng(seed)
    apart = []                        # vertices that share no face
    for v in rng.permutation(nvert):
        if all(v not in nbr[u] and u not in nbr[v] for u in apart):
            apart.append(int(v))
        if len(apart) == 6:
            break
    a, b, c, d, e, f = apart
    rows = []
    for levels in ({a: 1.0, b: 1.0}, {b: 1.0, a: 1.0, c: 1.0},
                   {a: 2.0, d: 1.0, c: 1.0, b: 1.0},
                   {e: 1.5, f: 1.5, a: 1.0, b: 1.0, c: 1.0, d: 0.5},
                   {c: 0.75}, {}):
        o = rng.integers(0, 4, nvert).astype(np.float32) / 64
        for v, x in levels.items():
            o[v] = x
        rows.append(o)
    rows.append(np.full(nvert, 0.5, np.float32))
    rows.append(np.zeros(nvert, np.float32))
    return np.stack(rows)


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("name", ["sphere_362", "sphere_642"])
def test_top_peaks_ties_match_jax_every_slot(name, k):
    """Tied valid peaks, and the zero slots of rows with fewer than k
    peaks, come out in `lax.top_k`'s order (lower vertex first): values,
    indices and validity equal the JAX package's in every slot."""
    from fibers_tpu.ops.peaks import top_peaks as jax_top_peaks
    sphere = getattr(ft, name)
    nbr, ok = _tables(sphere)
    o = _tied_rows(nbr, sphere.nvert_half, 17)
    pm_j = jax_peak_mask(jnp.asarray(o), jnp.asarray(nbr), jnp.asarray(ok))
    vj, ij, okj = (np.asarray(x) for x in jax_top_peaks(jnp.asarray(o), pm_j,
                                                        k))
    pm = peak_mask(torch.from_numpy(o), torch.from_numpy(nbr),
                   torch.from_numpy(ok))
    assert np.array_equal(pm.numpy(), np.asarray(pm_j))
    vals, idx, valid = top_peaks(torch.from_numpy(o), pm, k)
    assert idx.dtype == torch.int64
    assert np.array_equal(vals.numpy(), vj)
    assert np.array_equal(idx.numpy(), ij)
    assert np.array_equal(valid.numpy(), okj)
    # the rows do hold ties among valid peaks, and rows short of k peaks
    assert (vj[:, 0] == vj[:, 1])[vj[:, 1] > 0].any()
    assert (~okj).any() and okj.any()


def test_topk_lower_first_orders_nan_and_ties_as_lax():
    import jax.lax as lax
    from fibers_tpu_torch.ops.peaks import topk_lower_first
    x = np.array([[0.0, 1.0, 0.25, 1.0, 0.0, np.nan, 0.5, 1.0, 0.0],
                  [3, 3, 3, 1, 1, 3, 0, 0, 0],
                  [0, 0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    for k in (1, 4, 9):
        vj, ij = lax.top_k(jnp.asarray(x), k)
        vt, it = topk_lower_first(torch.from_numpy(x), k)
        assert np.array_equal(vt.numpy(), np.asarray(vj), equal_nan=True)
        assert np.array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("name", ["sphere_362", "sphere_642"])
def test_fused_plain_top3_matches_lax_every_slot(name):
    """The plain top-3 against lax.top_k of the JAX package on every slot,
    ties and zero slots included.  A_t = I makes the ODF the clamped
    signals themselves, drawn from 4 levels so that many peaks tie."""
    import jax.lax as lax
    sphere = getattr(ft, name)
    nvert = sphere.nvert_half
    nbr, ok = _tables(sphere)
    rng = np.random.default_rng(5)
    s = rng.integers(-1, 3, (96, nvert)).astype(np.float32)
    s[::7] = 1.0                               # flat rows: no peak at all
    s[3::11, 2] = np.nan
    eye = np.eye(nvert, dtype=np.float32)
    odf, pm, _, vals, idx = gqi_fused_plain(
        torch.from_numpy(s), torch.from_numpy(eye), torch.from_numpy(nbr),
        torch.from_numpy(ok))
    pm_j = np.asarray(jax_peak_mask(jnp.asarray(odf.numpy()), jnp.asarray(nbr),
                                    jnp.asarray(ok)))
    assert np.array_equal(pm.numpy(), pm_j)
    vj, ij = lax.top_k(jnp.where(jnp.asarray(pm_j), jnp.asarray(odf.numpy()),
                                 0.0), 3)
    assert idx.dtype == torch.int64
    assert np.array_equal(vals.numpy(), np.asarray(vj))
    assert np.array_equal(idx.numpy(), np.asarray(ij))
    # ties among peaks and rows with fewer than 3 peaks were exercised
    v = vals.numpy()
    assert (v[:, 0] == v[:, 1]).any() and (v[:, 2] == 0).any()


def _fit_both(sphere, shape=(12, 12, 12), nan_voxels=0, device="cpu"):
    """Both packages' gqi_rec on one phantom; `nan_voxels` masked voxels
    get a NaN sample (returned as flat indices into the volume)."""
    dwi, mask, _, _ = make_phantom(shape=shape, ndir=30)
    inside = np.flatnonzero(mask.vol > 0)
    bad = inside[np.linspace(0, len(inside) - 1, nan_voxels, dtype=np.int64)]
    if nan_voxels:
        vol = dwi.vol.reshape(-1, dwi.vol.shape[-1])
        vol[bad, 7] = np.nan
    bj = ft.prepare_batch(dwi, mask, wire="f32")
    bt = tt.VoxelBatch.from_numpy(bj.idx, np.asarray(bj.signals), device)
    return (ft.gqi_rec(dwi, mask, sphere, batch=bj),
            tt.gqi_rec(dwi, mask, sphere, batch=bt), mask, bad)


def _check_nan_voxels(gj, gt, mask, bad):
    """The packages agree; the voxels with a NaN sample are zero in ODF,
    QA and peaks of both, and the other masked voxels keep a peak."""
    np.testing.assert_allclose(gt.odf.vol, gj.odf.vol, atol=1e-4, rtol=1e-6)
    n3 = mask.vol.size
    for ip in range(3):
        qj, qt = gj.qa[ip].vol, gt.qa[ip].vol
        np.testing.assert_allclose(qt, qj, atol=1e-5, rtol=0)
        valid = (qj > 0) & (qt > 0)
        assert np.array_equal(gt.peak[ip].vol[valid], gj.peak[ip].vol[valid])
        for g in (gj, gt):
            assert not g.qa[ip].vol.reshape(n3)[bad].any()
            assert not g.peak[ip].vol.reshape(n3, 3)[bad].any()
    for g in (gj, gt):
        assert not g.odf.vol.reshape(n3, -1)[bad].any()
        assert np.isfinite(g.odf.vol).all()
    good = (mask.vol > 0).reshape(n3).copy()
    good[bad] = False
    assert (gt.qa[0].vol.reshape(n3)[good] > 0).all()


def test_gqi_rec_matches_jax():
    gj, gt, mask, _ = _fit_both(ft.sphere_642)
    np.testing.assert_allclose(gt.odf.vol, gj.odf.vol, atol=1e-4, rtol=1e-6)
    for ip in range(3):
        qj, qt = gj.qa[ip].vol, gt.qa[ip].vol
        np.testing.assert_allclose(qt, qj, atol=1e-5, rtol=0)
        valid = (qj > 0) & (qt > 0)
        assert np.array_equal(gt.peak[ip].vol[valid], gj.peak[ip].vol[valid])
    # first peak exists in every masked voxel of this phantom
    assert (gt.qa[0].vol[mask.vol > 0] > 0).all()


def test_gqi_rec_nan_voxels_match_jax():
    """A NaN sample in a masked voxel: that voxel is invalid and zero in
    both packages, and the rest (QA normalisation included) agree."""
    gj, gt, mask, bad = _fit_both(ft.sphere_642, nan_voxels=5)
    _check_nan_voxels(gj, gt, mask, bad)


def test_gqi_kernel_fused_top3_equals_top_peaks():
    """`_gqi_kernel_fused` takes its peaks from the tile's top-3; the
    same finish on `top_peaks` of the tile's ODF and mask gives the same
    results."""
    from fibers_tpu_torch.models.gqi import _finish
    rng = np.random.default_rng(9)
    sphere = ft.sphere_362
    nbr, ok = (torch.from_numpy(x) for x in _tables(sphere))
    nvert = sphere.nvert_half
    s = torch.from_numpy(rng.uniform(-5, 100, (200, 40)).astype(np.float32))
    s[::13] = -1.0
    s[4::29, 3] = float("nan")
    A_t = torch.from_numpy(rng.uniform(-0.2, 1, (40, nvert)).astype(np.float32))
    _, verts_first, _ = half_sphere(sphere)
    vf = torch.from_numpy(np.ascontiguousarray(verts_first))
    got = _gqi_kernel_fused(s, A_t, vf, nbr, ok)
    odf, pm, st, _, _ = gqi_fused_plain(s, A_t, nbr, ok)
    vals, idx, pvalid = top_peaks(odf, pm, 3)
    want = _finish(odf, vals, idx, pvalid, st[:, 0], st[:, 1], st[:, 2] > 0,
                   vf)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gqi_rec_outputs_are_lazy_torch_volumes():
    from fibers_tpu_torch.core.lazy import LazyVolume
    dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=12)
    g = tt.gqi_rec(dwi, mask, ft.sphere_362, device="cpu")
    raw = g.odf.__dict__["vol"]
    assert isinstance(raw, LazyVolume)
    assert isinstance(raw._values, torch.Tensor)
    assert g.odf.vol.shape == (4, 4, 4, 181)
    assert isinstance(g._peak_dev.vecs, torch.Tensor)
    assert g._peak_dev.vecs.shape[1:] == (3, 3)


def test_gqi_rec_kernel_impl_needs_cuda_batch():
    dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=12)
    with pytest.raises(ValueError, match="CUDA"):
        tt.gqi_rec(dwi, mask, ft.sphere_362, impl="kernel", device="cpu")


@pytest.mark.parametrize("impl", ["plain", "pallas"])
def test_gqi_rec_rejects_unknown_impl(impl):
    dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=12)
    with pytest.raises(ValueError, match="impl"):
        tt.gqi_rec(dwi, mask, ft.sphere_362, impl=impl, device="cpu")


def test_find_peaks_matches_jax():
    rng = np.random.default_rng(4)
    o = rng.random((6, ft.sphere_362.nvert_half)).astype(np.float32)
    order_j, nvalid_j = ft.find_peaks(o, ft.sphere_362)
    order_t, nvalid_t = tt.find_peaks(o, ft.sphere_362)
    assert np.array_equal(nvalid_t, nvalid_j)
    for i in range(len(o)):
        k = int(nvalid_j[i])
        assert np.array_equal(order_t[i, :k], order_j[i, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,nvol", [("sphere_642", 2048, 198),
                                         ("sphere_642", 1000, 198),
                                         ("sphere_724", 1000, 198),
                                         ("sphere_362", 777, 31)])
def test_kernel_matches_plain_on_card(cuda, name, n, nvol):
    """The CUDA kernel against its plain version on the same card: ODF
    within rtol=1e-5, atol=1e-4 (3xTF32 against f32, other summation
    order), stats likewise (NaN equal to NaN), valid exactly; the peak
    mask and the top-3 exactly as the plain rules give them on the
    kernel's own ODF.  An odd nvol takes the kernel's 4-byte staging."""
    sphere = getattr(ft, name)
    nbr, ok = _tables(sphere)
    rng = np.random.default_rng(0)
    s = rng.uniform(-5.0, 100.0, (n, nvol)).astype(np.float32)
    s[::97] = -1.0
    s[5::509, 7] = np.nan
    A_t = rng.uniform(-0.2, 1.0, (nvol, sphere.nvert_half)).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (s, A_t, nbr, ok)]
    before = gqi_fused.launches
    odf, pm, st, vals, idx = gqi_fused(*args)
    torch.cuda.synchronize()
    assert gqi_fused.launches == before + 1
    odf_p, _, st_p, _, _ = gqi_fused_plain(*args)
    torch.testing.assert_close(odf, odf_p, rtol=1e-5, atol=1e-4,
                               equal_nan=True)
    torch.testing.assert_close(st, st_p, rtol=1e-5, atol=1e-4,
                               equal_nan=True)
    assert torch.equal(st[:, 2], st_p[:, 2])
    nan_rows = torch.from_numpy(np.isnan(s).any(axis=1)).to(cuda)
    assert not st[nan_rows, 2].any() and not pm[nan_rows].any()
    assert torch.equal(pm, peak_mask(odf, args[2], args[3]))
    masked = torch.where(pm, odf, torch.zeros((), device=cuda))
    top_v, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
    assert torch.equal(vals, top_v[:, :3]) and torch.equal(idx, top_i[:, :3])


@pytest.mark.cuda
def test_gqi_rec_nan_voxels_on_card(cuda):
    """The card's gqi_rec against the JAX package's on a phantom with NaN
    samples in five masked voxels: invalid and zero there, equal
    elsewhere."""
    gj, gt, mask, bad = _fit_both(ft.sphere_642, nan_voxels=5,
                                  device="cuda")
    _check_nan_voxels(gj, gt, mask, bad)


def test_probe_edits_find_their_text():
    """Each build `probe_paths.py` makes without a part of a kernel edits
    text that occurs exactly once in the current source."""
    import probe_paths
    from fibers_tpu_torch.ops.kernels import _build
    builds = [("gqi_fused.cu", e) for e in probe_paths.GQI_PARTS.values()]
    builds.append(("tv_common.cuh", probe_paths.SKELETON))
    builds.append(("tv_common.cuh", probe_paths.IEEE_DIV))
    builds.append(("tv_stencil.cu", probe_paths.ONE_DIV))
    builds.append(("tv_stencil.cu", probe_paths.ONE_SLICE))
    builds += [("rl_gemm.cu", e) for e in probe_paths.RL_PARTS.values()]
    for source, edits in builds:
        with open(os.path.join(_build._CSRC, source)) as f:
            text = f.read()
        for old, new in edits:
            assert text.count(old) == 1, (source, old[:60])
            text = text.replace(old, new)
        assert text.count("{") == text.count("}")
