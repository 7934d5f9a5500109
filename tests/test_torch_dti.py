"""DTI/ADC and the 3x3 eigensolver of the PyTorch port held against the JAX
package on identical numpy inputs.

Tolerances: MD and RD are linear in the eigenvalues and agree to
atol=1e-5 (they differ by ~6e-8).  FA is a ratio of eigenvalue spreads:
the float32 normal equations carry ln(s0) ~ 4.6 beside tensor entries of
~1e-3, so a few-ulp change of summation order between XLA and PyTorch
moves the small eigenvalues by ~6e-8 and FA by up to ~4e-5; FA is held to
atol=1e-4.  Eigenvectors are compared as |dot| > 0.9999 wherever the
eigenvalue gaps exceed 1e-5 (a degenerate eigenspace has no unique
basis).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.ops.eig3 import eigh3 as jax_eigh3
from fibers_tpu_torch.models import dti as tdti
from fibers_tpu_torch.models.dti import _design_dti
from fibers_tpu_torch.ops.eig3 import eigh3, eigvalsh3
from fibers_tpu_torch.ops.masked import scatter_frames

from phantom import make_phantom


def _random_tensor_dwi(shape=(8, 8, 6), ndir=30, seed=5):
    """A DWI of random anisotropic tensors (distinct eigenvalues)."""
    from phantom import fibonacci_dirs
    rng = np.random.default_rng(seed)
    dirs = fibonacci_dirs(ndir)
    bval = np.concatenate([[0.0], np.full(ndir, 1000.0)]).astype(np.float32)
    bvec = np.concatenate([np.zeros((1, 3), np.float32), dirs])
    q, _ = np.linalg.qr(rng.standard_normal(shape + (3, 3)))
    lam = np.sort(rng.uniform(0.2e-3, 2.0e-3, shape + (3,)), axis=-1)
    D = np.einsum("...ik,...k,...jk->...ij", q, lam, q)
    quad = np.einsum("vi,...ij,vj->...v", bvec, D, bvec)
    vol = (100.0 * np.exp(-bval * quad)).astype(np.float32)
    dwi = ft.MRI(vol=vol)
    dwi.vox2ras0 = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    dwi.volsize = np.asarray(shape)
    dwi.width, dwi.height, dwi.depth = shape
    dwi.nframes = len(bval)
    dwi.set_geometry()
    dwi.bval, dwi.bvec = bval, bvec
    mask = ft.MRI.like(dwi, 1, np.float32)
    mask.vol = np.ones(shape, np.float32)
    mask.vol[0, 0] = 0
    return dwi, mask


def _inputs(kind):
    if kind == "phantom":
        dwi, mask, _, _ = make_phantom(shape=(12, 12, 12), ndir=30)
        return dwi, mask
    return _random_tensor_dwi()


@pytest.mark.parametrize("kind", ["phantom", "random_tensors"])
def test_dti_fit_matches_jax(kind):
    dwi, mask = _inputs(kind)
    bj = ft.prepare_batch(dwi, mask, wire="f32")
    bt = tt.VoxelBatch.from_numpy(bj.idx, np.asarray(bj.signals), "cpu")
    dj = ft.dti_fit(dwi, mask, batch=bj)
    dt = tt.dti_fit(dwi, mask, batch=bt)
    np.testing.assert_allclose(dt.md.vol, dj.md.vol, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dt.rd.vol, dj.rd.vol, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dt.fa.vol, dj.fa.vol, atol=1e-4, rtol=0)

    m = mask.vol > 0
    l1, l2, l3 = (getattr(dj, f"eigval{i}").vol[m] for i in (1, 2, 3))
    gaps = {1: l1 - l2, 2: np.minimum(l1 - l2, l2 - l3), 3: l2 - l3}
    for i in (1, 2, 3):
        vj = getattr(dj, f"eigvec{i}").vol[m]
        vt = getattr(dt, f"eigvec{i}").vol[m]
        sel = gaps[i] > 1e-5
        dots = np.abs((vj[sel] * vt[sel]).sum(-1))
        assert (dots > 0.9999).all(), (i, dots.min())
    if kind == "random_tensors":
        assert (gaps[2] > 1e-5).mean() > 0.9      # the test sees v2, v3


def test_dti_fit_gathers_its_own_batch():
    dwi, mask, _, _ = make_phantom(shape=(5, 5, 5), ndir=30)
    a = tt.dti_fit(dwi, mask, device="cpu")
    b = tt.dti_fit(dwi, mask, batch=tt.prepare_batch(dwi, mask,
                                                     device="cpu"))
    assert np.array_equal(a.fa.vol, b.fa.vol)
    assert a.eigvec1.vol.shape == (5, 5, 5, 3)


def test_adc_fit_matches_jax():
    dwi, mask, _, _ = make_phantom(shape=(6, 6, 6), ndir=30)
    aj, sj = ft.adc_fit(dwi, mask)
    at, st = tt.adc_fit(dwi, mask, device="cpu")
    np.testing.assert_allclose(at.vol, aj.vol, atol=1e-7, rtol=1e-4)
    np.testing.assert_allclose(st.vol, sj.vol, rtol=1e-4)


def _holed_phantom(device, shards):
    """The phantom, more holes in its mask, and its batch on `device`,
    split over a mesh of `shards` copies of it when more than one."""
    from fibers_tpu_torch.parallel.mesh import Mesh
    dwi, mask, _, _ = make_phantom(shape=(7, 6, 5), ndir=30)
    mask.vol[np.random.default_rng(3).random(mask.vol.shape) < 0.3] = 0
    dev = torch.device(device)
    mesh = (None if shards == 1 else
            Mesh(np.array([dev] * shards, dtype=object), ("data",)))
    return dwi, mask, tt.prepare_batch(dwi, mask, device=dev, mesh=mesh)


def _fit_rows_and_volumes(fit, dwi, mask, batch):
    """The fit's result rows [n, ncol] on the batch's device and its host
    volumes, in column-group order."""
    bval = np.asarray(dwi.bval, np.float32)
    if fit == "dti":
        _, A, ib0 = tdti._batch_and_tables(
            dwi, mask, batch, None, _design_dti(bval, dwi.bvec))
        rows = tdti._per_shard(tdti._dti_kernel, batch.signals, A, ib0)
        d = tt.dti_fit(dwi, mask, batch=batch)
        vols = [getattr(d, name).vol for name in tdti._DTI_COLS]
        cols = list(tdti._DTI_COLS.values())
    else:
        _, A, ib0 = tdti._batch_and_tables(
            dwi, mask, batch, None, tdti._design_adc(bval))
        rows = tdti._per_shard(
            lambda *a: torch.stack(tdti._adc_kernel(*a), dim=1),
            batch.signals, A, ib0)
        vols = [m.vol for m in tt.adc_fit(dwi, mask, batch=batch)]
        cols = list(tdti._ADC_COLS)
    return rows[:batch.n], batch.idx, mask.vol > 0, vols, cols


def _assert_scattered_volumes(rows, idx, inside, vols, cols):
    """`vols` equal `scatter_frames` of `rows` bit for bit, each a
    C-contiguous float32 volume of the old shape, zero outside the mask."""
    arr = rows.cpu().numpy()
    assert len(vols) == len(cols)
    for v, (lo, hi) in zip(vols, cols):
        want = scatter_frames(arr[:, lo] if hi - lo == 1 else arr[:, lo:hi],
                              idx, inside.shape)
        assert v.shape == want.shape == inside.shape + \
            ((hi - lo,) if hi - lo > 1 else ())
        assert v.dtype == np.float32 and v.flags["C_CONTIGUOUS"]
        assert np.array_equal(v.view(np.uint32), want.view(np.uint32))
        assert not v[~inside].any() and v[inside].any()


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("fit", ["dti", "adc"])
def test_device_scatter_equals_the_host_scatter(fit, shards):
    _assert_scattered_volumes(
        *_fit_rows_and_volumes(fit, *_holed_phantom("cpu", shards)))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("fit", ["dti", "adc"])
def test_device_scatter_on_card_is_pinned_and_reused(fit, shards):
    """On the card the volumes are views of one pinned block, and a second
    fit, the first's volumes dropped, takes the block from torch's caching
    host allocator.  Two shards of the one card: the mesh's rows gathered
    onto it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned copy from the card")
    import gc
    subject = _holed_phantom("cuda", shards)
    rows, idx, inside, vols, cols = _fit_rows_and_volumes(fit, *subject)
    _assert_scattered_volumes(rows, idx, inside, vols, cols)
    assert all(torch.from_numpy(v).is_pinned() for v in vols)
    del vols
    gc.collect()
    stats = torch.cuda.memory.host_memory_stats
    before = stats()["num_host_alloc"]
    rows, idx, inside, vols, cols = _fit_rows_and_volumes(fit, *subject)
    assert stats()["num_host_alloc"] == before
    _assert_scattered_volumes(rows, idx, inside, vols, cols)


def test_design_matches_jax():
    from fibers_tpu.models.dti import _design_dti as jax_design
    dwi, _, _, _ = make_phantom(shape=(2, 2, 2), ndir=30)
    assert np.array_equal(_design_dti(dwi.bval, dwi.bvec),
                          jax_design(dwi.bval, dwi.bvec))


def _spd(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = rng.uniform(0.1, 2.0, (n, 3))
    return np.einsum("nik,nk,njk->nij", q, lam, q)


def _unique(a):
    return np.stack([a[:, 0, 0], a[:, 0, 1], a[:, 0, 2], a[:, 1, 1],
                     a[:, 1, 2], a[:, 2, 2]], axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random_spd", "two_equal", "isotropic"])
def test_eigh3_matches_jax(kind):
    rng = np.random.default_rng(9)
    n = 500
    if kind == "random_spd":
        a = _spd(rng, n)
    else:
        q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
        lam = np.repeat(rng.uniform(0.1, 2.0, (n, 1)), 3, axis=1)
        if kind == "two_equal":
            lam[:, 0] *= 3.0
        a = np.einsum("nik,nk,njk->nij", q, lam, q)
    u = _unique(a)
    ev_t, V_t = (x.numpy() for x in eigh3(torch.from_numpy(u)))
    ev_j, V_j = (np.asarray(x) for x in jax_eigh3(jnp.asarray(u)))

    np.testing.assert_allclose(ev_t, ev_j, atol=2e-5, rtol=0)
    np.testing.assert_allclose(eigvalsh3(torch.from_numpy(u)).numpy(),
                               ev_j, atol=1e-3, rtol=0)
    assert (np.diff(ev_t, axis=1) <= 1e-6).all()          # descending
    gram = np.einsum("nik,nil->nkl", V_t, V_t)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape),
                               atol=1e-4)
    recon = np.einsum("nik,nk,njk->nij", V_t, ev_t, V_t)
    np.testing.assert_allclose(recon, a, atol=1e-4)
    if kind == "random_spd":
        gaps = np.minimum(ev_j[:, 0] - ev_j[:, 1], ev_j[:, 1] - ev_j[:, 2])
        sel = gaps > 1e-3
        dots = np.abs(np.einsum("nik,nik->nk", V_t[sel], V_j[sel]))
        assert (dots > 0.9999).all()
