"""GQI in the PyTorch port held against the JAX package.

The port's fused tile (its plain PyTorch version on the CPU) is compared
with the Pallas kernel run in interpret mode, and `gqi_rec` with the JAX
`gqi_rec`, on identical numpy inputs.

Tolerances: the ODF is a float32 sum of nvol products whose order differs
between XLA and PyTorch, so it agrees to a few ulp: atol=1e-4 where the
ODF is O(1), plus rtol=1e-6 (~8 ulp) where the phantom's ODF reaches
~10^3.  QA is normalised to O(1): atol=1e-5.  Peak masks are compared
exactly on one and the same ODF.
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
    A_t = rng.standard_normal((nvol, nvert)).astype(np.float32)

    P, okm = neighbor_permutations(nbr, ok)
    odf_j, pm_j, st_j = (np.array(x) for x in jax_gqi_fused(
        jnp.asarray(signals), jnp.asarray(A_t), jnp.asarray(P),
        jnp.asarray(okm), interpret=True))
    odf, pm, st = gqi_fused(torch.from_numpy(signals), torch.from_numpy(A_t),
                            torch.from_numpy(nbr), torch.from_numpy(ok))

    np.testing.assert_allclose(odf.numpy(), odf_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(st.numpy(), st_j, atol=1e-5, rtol=0)
    assert np.array_equal(st.numpy()[:, 2], st_j[:, 2])
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


def _fit_both(sphere, shape=(12, 12, 12)):
    dwi, mask, _, _ = make_phantom(shape=shape, ndir=30)
    bj = ft.prepare_batch(dwi, mask, wire="f32")
    bt = tt.VoxelBatch.from_numpy(bj.idx, np.asarray(bj.signals), "cpu")
    return (ft.gqi_rec(dwi, mask, sphere, batch=bj),
            tt.gqi_rec(dwi, mask, sphere, batch=bt), mask)


def test_gqi_rec_matches_jax():
    gj, gt, mask = _fit_both(ft.sphere_642)
    np.testing.assert_allclose(gt.odf.vol, gj.odf.vol, atol=1e-4, rtol=1e-6)
    for ip in range(3):
        qj, qt = gj.qa[ip].vol, gt.qa[ip].vol
        np.testing.assert_allclose(qt, qj, atol=1e-5, rtol=0)
        valid = (qj > 0) & (qt > 0)
        assert np.array_equal(gt.peak[ip].vol[valid], gj.peak[ip].vol[valid])
    # first peak exists in every masked voxel of this phantom
    assert (gt.qa[0].vol[mask.vol > 0] > 0).all()


def test_gqi_rec_outputs_are_lazy_torch_volumes():
    from fibers_tpu.core.lazy import LazyVolume as HostLazy
    dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=12)
    g = tt.gqi_rec(dwi, mask, ft.sphere_362, device="cpu")
    raw = g.odf.__dict__["vol"]
    assert isinstance(raw, HostLazy)
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
@pytest.mark.parametrize("name,n", [("sphere_642", 2048), ("sphere_642", 1000),
                                    ("sphere_724", 1000)])
def test_kernel_matches_plain_on_card(cuda, name, n):
    """The CUDA kernel against its plain version on the same card: ODF
    within rtol=1e-5, atol=1e-4 (other summation order), stats likewise,
    valid and the peak mask (on the kernel's own ODF) exactly."""
    sphere = getattr(ft, name)
    nbr, ok = _tables(sphere)
    rng = np.random.default_rng(0)
    s = rng.uniform(-5.0, 100.0, (n, 198)).astype(np.float32)
    s[::97] = -1.0
    A_t = rng.uniform(-0.2, 1.0, (198, sphere.nvert_half)).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (s, A_t, nbr, ok)]
    before = gqi_fused.launches
    odf, pm, st = gqi_fused(*args)
    torch.cuda.synchronize()
    assert gqi_fused.launches == before + 1
    odf_p, _, st_p = gqi_fused_plain(*args)
    torch.testing.assert_close(odf, odf_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(st, st_p, rtol=1e-5, atol=1e-4)
    assert torch.equal(st[:, 2], st_p[:, 2])
    assert torch.equal(pm, peak_mask(odf, args[2], args[3]))
