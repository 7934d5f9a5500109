"""RUMBA-SD in the PyTorch port held against the JAX package.

The same numpy inputs go through fibers_tpu and fibers_tpu_torch on the
CPU (the port's TV kernels run their plain versions there; the JAX
package runs its unfused TV term, which its own tests hold against the
Pallas kernels in interpret mode).

Tolerances: the host pieces are numpy in both packages and agree exactly.
One step and the signal matrix: rtol=1e-5, atol=1e-9 (PyTorch and XLA sum
the products and the row reductions in other orders, a few ulp).  Whole
fits: fODF rtol=1e-4, atol=1e-7 (measured up to 2e-6 relative after 40
iterations), GFA and the noise variance atol 1e-5, SNR 1e-3, and peak
vectors within atol=1e-5 where both packages find a peak, with equal
validity masks; tied peaks come lower vertex first in both packages.
A bf16 TV stack: the loose bound of tests/test_rumba.py:329-339, because
the port rounds the stencil's differences to bf16 (the TPU kernel's rule)
while the reference's CPU path runs the whole stencil in bf16.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu.models import rumba as jr
from fibers_tpu.ops.masked import mask_indices
from fibers_tpu_torch.models import rumba as tr
from fibers_tpu_torch.ops.kernels.tv_fused import build_tables, embed_index

from oracle import rumba_iterate_oracle
from phantom import make_phantom
from test_torch_stream import _compare_tracts

FIT = dict(rtol=1e-4, atol=1e-7)
STEP = dict(rtol=1e-5, atol=1e-9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _masked_phantom(shape=(6, 5, 4), seed=0):
    dwi, mask, _, _ = make_phantom(shape=shape, ndir=30)
    mv = np.asarray(mask.vol).copy()
    mv[np.random.default_rng(seed).random(mv.shape) < 0.3] = 0
    mask.vol = mv
    return dwi, mask


def _assert_fits_close(p, j, bf16=False):
    fp, fj = np.asarray(p.fodf.vol), np.asarray(j.fodf.vol)
    if bf16:
        np.testing.assert_allclose(fp, fj, rtol=0.05, atol=2e-3)
        return
    np.testing.assert_allclose(fp, fj, **FIT)
    np.testing.assert_allclose(p.gfa.vol, j.gfa.vol, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.var.vol, j.var.vol, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.fcsf.vol, j.fcsf.vol, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.fgm.vol, j.fgm.vol, rtol=0, atol=1e-5)
    assert abs(p.snr_mean - j.snr_mean) < 1e-3
    assert abs(p.snr_std - j.snr_std) < 1e-3
    for ip in range(tr.NPEAK):
        vp, vj = p.peak[ip].vol, j.peak[ip].vol
        okp = np.linalg.norm(vp, axis=-1) > 0
        okj = np.linalg.norm(vj, axis=-1) > 0
        assert np.array_equal(okp, okj), ip
        np.testing.assert_allclose(vp[okp], vj[okj], rtol=0, atol=1e-5)


# ------------------------------------------------------------------ #
# Host pieces
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("name", ["sphere_362", "sphere_724"])
def test_kernel_and_neighbours_match_jax(name):
    sphere = getattr(ft, name)
    dwi, _, _, _ = make_phantom(shape=(2, 2, 2), ndir=30, two_shell=True)
    args = (dwi.bval, dwi.bvec, sphere, 1.7e-3, 0.2e-3, 3.0e-3, 0.8e-4)
    kp, ibp = tr._build_kernel(*args)
    kj, ibj = jr._build_kernel(*args)
    assert np.array_equal(kp, kj) and np.array_equal(ibp, ibj)
    for a, b in zip(tr._angular_neighbors(sphere),
                    jr._angular_neighbors(sphere)):
        assert np.array_equal(a, b)


def test_tensor_model_and_bessel_ratio_match_jax():
    b = np.array([0.0, 1000.0, 2000.0, 3000.0])
    g = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.6, 0, 0.8]])
    lam = [1.7e-3, 0.2e-3, 0.2e-3]
    assert np.array_equal(tt.tensor_model(0.3, 0.7, lam, b, g),
                          jr.tensor_model(0.3, 0.7, lam, b, g))
    with pytest.raises(ValueError, match="3"):
        tt.tensor_model(0.3, 0.7, [1e-3, 1e-3], b, g)
    z = np.random.default_rng(0).uniform(0.01, 300.0, 500).astype(
        np.float32)
    got = tt.besseli_ratio(1, torch.from_numpy(z))
    want = np.asarray(jr.besseli_ratio(1, jnp.asarray(z)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert tt.besseli_ratio(1, 2.5) == jr.besseli_ratio(1, 2.5)


def test_tv_bbox_and_gather_index_match_jax():
    shape3 = (10, 9, 8)
    m = np.zeros(shape3, bool)
    m[2:7, 3:9, 1:5] = np.random.default_rng(1).random((5, 6, 4)) < 0.7
    idx = mask_indices(m.astype(np.float32))
    for a, b in zip(tr._tv_bbox(idx, shape3), jr._tv_bbox(idx, shape3)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    tv_shape3, nxyz, idx_tv, _ = tr._tv_bbox(idx, shape3)
    got = embed_index(build_tables(idx_tv, tv_shape3), len(idx) + 3)
    want = jr._gather_index(jnp.asarray(idx_tv), len(idx) + 3, nxyz)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_signal_from_batch_matches_jax():
    dwi, mask = _masked_phantom()
    dwi.bval = np.concatenate([[0.0, 0.0], dwi.bval[2:]]).astype(np.float32)
    bj = ft.prepare_batch(dwi, mask, wire="f32")
    bt = tt.VoxelBatch.from_numpy(bj.idx, np.asarray(bj.signals), "cpu")
    ib0 = dwi.bval == dwi.bval.min()
    want = np.asarray(jr._signal_from_batch(
        bj.signals, jnp.asarray(np.flatnonzero(ib0)),
        jnp.asarray(np.flatnonzero(~ib0))))
    got = tr._signal_from_batch(
        bt.signals, torch.from_numpy(np.flatnonzero(ib0)),
        torch.from_numpy(np.flatnonzero(~ib0)))
    np.testing.assert_allclose(got.numpy(), want, **STEP)
    assert (got.numpy()[bj.n:] == 0).all()


def test_rumba_peaks_matches_jax():
    rng = np.random.default_rng(5)
    n = ft.sphere_362.nvert_half
    fodf = rng.random((7, n)).astype(np.float32)
    f_iso = rng.uniform(0.0, 0.5, 7).astype(np.float32)
    oj, nj = jr.rumba_peaks(fodf, f_iso, ft.sphere_362)
    ot, nt = tt.rumba_peaks(fodf, f_iso, ft.sphere_362)
    assert np.array_equal(nt, nj) and nj.min() > 0
    for i in range(len(fodf)):
        assert np.array_equal(ot[i, :nj[i]], oj[i, :nj[i]])


def _tied_fodf(sphere, seed):
    """fODF rows with two and three tied surviving peaks, a tie below a
    higher peak, and fewer than NPEAK peaks.  Every value is a multiple
    of 1/64, so that sums and products of the peak amplitudes are exact
    in any order."""
    nbr, nbr_ok = jr._angular_neighbors(sphere)
    n = sphere.nvert_half
    rng = np.random.default_rng(seed)
    apart = []                       # vertices outside each other's cones
    for v in rng.permutation(n):
        if all(v not in nbr[u][nbr_ok[u]] and u not in nbr[v][nbr_ok[v]]
               for u in apart):
            apart.append(int(v))
        if len(apart) == 7:
            break
    a, b, c, d, e, f, g = apart
    rows = []
    for levels in ({b: 1.0, a: 1.0}, {a: 1.0, c: 1.0, b: 1.0},
                   {d: 2.0, c: 1.0, a: 1.0},
                   {a: 1.0, b: 1.0, c: 1.0, d: 1.0, e: 1.0, f: 1.0, g: 1.0},
                   {e: 0.5}):
        o = rng.integers(0, 3, n).astype(np.float32) / 64
        for v, x in levels.items():
            o[v] = x
        rows.append(o)
    return np.stack(rows), nbr, nbr_ok


@pytest.mark.parametrize("name", ["sphere_362", "sphere_724"])
def test_rumba_peaks_kernel_ties_match_jax(name):
    """Tied surviving peaks keep `lax.top_k`'s order (lower vertex
    first): the peak vectors equal the JAX package's exactly, slot for
    slot."""
    sphere = getattr(ft, name)
    fodf, nbr, nbr_ok = _tied_fodf(sphere, 23)
    f_iso = np.array([0.25, 0.0, 0.5, 0.125, 0.25], np.float32)
    half = np.asarray(sphere.vertices[:sphere.nvert_half], np.float32)
    vj = np.asarray(jr._rumba_peaks_kernel(
        jnp.asarray(fodf), jnp.asarray(f_iso), jnp.asarray(half),
        jnp.asarray(nbr), jnp.asarray(nbr_ok), 0.1))
    vt = tr._rumba_peaks_kernel(
        torch.from_numpy(fodf), torch.from_numpy(f_iso),
        torch.from_numpy(half), torch.from_numpy(nbr).long(),
        torch.from_numpy(nbr_ok), 0.1).numpy()
    assert vj.shape == vt.shape == (len(fodf), tr.NPEAK, 3)
    assert np.array_equal(vt, vj)
    norm = np.linalg.norm(vj, axis=-1)      # the vertex table is unit to 1e-3
    assert np.isclose(norm[:3, 0], norm[:3, 1], rtol=5e-3).any()   # ties
    assert (norm[-1, 1:] == 0).all() and norm[-1, 0] > 0      # one peak


def test_rumba_rec_tied_peaks_match_jax(monkeypatch):
    """A whole fit whose dictionary holds one direction twice: the two
    components stay equal through every iteration, so wherever that
    direction is a peak, it ties with its copy.  Both packages then put
    the lower vertex first."""
    dwi, mask, axes, _ = make_phantom(shape=(6, 5, 4), ndir=30)
    sphere = ft.sphere_362
    half = np.asarray(sphere.vertices[:sphere.nvert_half], np.float64)
    m = np.asarray(mask.vol) > 0
    src = int(np.argmax(np.abs(half @ axes[m][0])))    # a voxel's own axis
    far = np.flatnonzero(np.abs(half @ half[src]) < 0.2)
    dup = int(far[far < src][-1]) if (far < src).any() else int(far[0])

    def twice(build):
        def wrapped(*args):
            kernel, ib0 = build(*args)
            kernel = np.array(kernel)
            kernel[:, dup] = kernel[:, src]
            return kernel, ib0
        return wrapped

    monkeypatch.setattr(jr, "_build_kernel", twice(jr._build_kernel))
    monkeypatch.setattr(tr, "_build_kernel", twice(tr._build_kernel))
    j = ft.rumba_rec(dwi, mask, sphere, niter=10)
    p = tt.rumba_rec(dwi, mask, sphere, niter=10, device="cpu")
    lo, hi = sorted((src, dup))
    for fit in (j, p):
        f = np.asarray(fit.fodf.vol)[m]
        assert np.array_equal(f[:, src], f[:, dup])
        tied = np.flatnonzero(f[:, src] == f.max(axis=1))
        assert len(tied) > 0, "no voxel with tied top peaks"
        for ip, v in ((0, lo), (1, hi)):      # the lower vertex first
            pk = np.asarray(fit.peak[ip].vol)[m][tied]
            cos = pk @ half[v] / (np.linalg.norm(pk, axis=-1)
                                  * np.linalg.norm(half[v]))
            assert np.all(cos > 1 - 1e-5), (ip, cos)
    _assert_fits_close(p, j)


# ------------------------------------------------------------------ #
# One iteration
# ------------------------------------------------------------------ #

def _step_inputs(shape3=(4, 4, 3), seed=3, npad=2):
    """Random iteration state on a small grid: fodf, dodf, dodf_sig,
    sig2, lam over the grid, signal, kernel, mask cells."""
    rng = np.random.default_rng(seed)
    dwi, _, _, _ = make_phantom(shape=(2, 2, 2), ndir=30)
    kernel, _ = tr._build_kernel(dwi.bval, dwi.bvec, ft.sphere_362,
                                 1.7e-3, 0.2e-3, 3.0e-3, 0.8e-4)
    ndir, ncomp = kernel.shape
    nxyz = int(np.prod(shape3))
    idx = np.sort(rng.choice(nxyz, nxyz * 2 // 3, replace=False))
    n = len(idx) + npad
    signal = rng.uniform(0.05, 1.0, (n, ndir)).astype(np.float32)
    signal[len(idx):] = 0
    fodf = rng.uniform(0.0, 0.02, (n, ncomp)).astype(np.float32)
    dodf = (fodf @ kernel.T).astype(np.float32)
    sig2 = rng.uniform(0.002, 0.01, (n, 1)).astype(np.float32)
    dodf_sig = (signal * dodf / sig2).astype(np.float32)
    lam = np.full(nxyz, 0.004, np.float32)
    return fodf, dodf, dodf_sig, sig2, lam, signal, kernel, idx


@pytest.mark.parametrize("use_tv,ipat", [(True, 1), (True, 2), (False, 1)])
def test_step_matches_jax(use_tv, ipat):
    shape3 = (4, 4, 3)
    fodf, dodf, dodf_sig, sig2, lam, signal, kernel, idx = _step_inputs(
        shape3)
    nxyz = int(np.prod(shape3))
    want = jr._rumba_step(*(jnp.asarray(a) for a in (
        fodf, dodf, dodf_sig, sig2, lam, signal, kernel, idx)),
        1, ipat, use_tv, shape3, nxyz)
    got = tr._rumba_step(*(torch.from_numpy(a) for a in (
        fodf, dodf, dodf_sig, sig2, lam, signal, kernel, idx)),
        1, ipat, use_tv, shape3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP)


@pytest.mark.parametrize("ipat", [1, 2])
def test_step_matches_oracle(ipat):
    """One iteration against the per-voxel NumPy transliteration of the
    reference (tests/oracle.py:rumba_iterate_oracle), padding rows
    dropped."""
    shape3 = (4, 4, 3)
    fodf, dodf, dodf_sig, sig2, lam, signal, kernel, idx = _step_inputs(
        shape3, npad=0)
    got = tr._rumba_step(*(torch.from_numpy(a) for a in (
        fodf, dodf, dodf_sig, sig2, lam, signal, kernel, idx)),
        1, ipat, True, shape3)
    want = rumba_iterate_oracle(fodf, dodf, dodf_sig, sig2,
                                lam.reshape(shape3), signal, kernel, idx,
                                shape3, ipat_factor=ipat)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got[4].numpy(), want[4].reshape(-1),
                               rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------------ #
# Whole fits
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("kw", [
    dict(niter=10), dict(niter=40), dict(niter=10, use_tv=False),
    dict(niter=40, use_tv=False), dict(niter=10, ipat_factor=2),
    dict(niter=10, tv_bf16=True)], ids=lambda k: "-".join(
        f"{a}={b}" for a, b in k.items()))
def test_rumba_rec_matches_jax(kw):
    dwi, mask = _masked_phantom()
    j = ft.rumba_rec(dwi, mask, ft.sphere_362, **kw)
    p = tt.rumba_rec(dwi, mask, ft.sphere_362, device="cpu", **kw)
    _assert_fits_close(p, j, bf16=kw.get("tv_bf16", False))


def test_rumba_rec_tv_crop_matches_full_volume_grid():
    """An interior mask in a larger volume: the port's cropped TV grid
    gives the full-volume iteration of the reference (the JAX package's
    _rumba_step on the whole 10^3 grid; tests/test_rumba.py:251)."""
    dwi, _, _, _ = make_phantom(shape=(4, 4, 4), ndir=30)
    shape = (10, 10, 10)
    vol = np.zeros(shape + (dwi.vol.shape[3],), np.float32)
    vol[3:7, 3:7, 3:7] = dwi.vol
    big = ft.MRI(vol=vol)
    big.vox2ras0 = np.eye(4, dtype=np.float32)
    big.volsize = np.asarray(shape)
    big.width, big.height, big.depth = shape
    big.nframes = vol.shape[3]
    big.set_geometry()
    big.bval, big.bvec = dwi.bval, dwi.bvec
    mask = ft.MRI.like(big, 1, np.float32)
    mask.vol = np.zeros(shape, np.float32)
    mask.vol[3:7, 3:7, 3:7] = 1

    niter = 6
    rec = tt.rumba_rec(big, mask, ft.sphere_362, niter=niter, device="cpu")

    idx = mask_indices(mask.vol)
    kernel, ib0 = jr._build_kernel(big.bval, big.bvec, ft.sphere_362,
                                   1.7e-3, 0.2e-3, 3.0e-3, 0.8e-4)
    ncomp = kernel.shape[1]
    signal = tr._signal_host(vol.reshape(-1, vol.shape[3]), idx, ib0)
    fodf0 = np.full(ncomp, 1.0 / ncomp, np.float32)
    lam0 = (1.0 / 15) ** 2
    n = len(idx)
    sig_j = jnp.asarray(signal)
    dodf = jnp.broadcast_to(jnp.asarray(kernel @ fodf0), (n, len(signal[0])))
    sig2 = jnp.full((n, 1), lam0, jnp.float32)
    st = (jnp.broadcast_to(jnp.asarray(fodf0), (n, ncomp)), dodf,
          (sig_j * dodf) / sig2, sig2,
          jnp.full((int(np.prod(shape)),), lam0, jnp.float32))
    for _ in range(niter):
        st = jr._rumba_step(*st, sig_j, jnp.asarray(kernel),
                            jnp.asarray(idx), 1, 1, True, shape,
                            int(np.prod(shape)))[:5]
    want = np.asarray(jr._rumba_post(st[0], ncomp - 2)[0])
    got = np.asarray(rec.fodf.vol)[3:7, 3:7, 3:7].reshape(n, ncomp - 2)
    np.testing.assert_allclose(got, want, **FIT)
    np.testing.assert_allclose(
        np.asarray(rec.var.vol)[3:7, 3:7, 3:7].reshape(-1),
        np.asarray(st[3])[:, 0], rtol=1e-5, atol=1e-9)


def test_rumba_rec_batch_reuse_matches_jax():
    dwi, mask = _masked_phantom()
    bj = ft.prepare_batch(dwi, mask, wire="f32")
    bt = tt.prepare_batch(dwi, mask, wire="f32", device="cpu")
    assert bt.n_pad > bt.n                        # padding rows present
    j = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=10, batch=bj)
    p = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, batch=bt)
    _assert_fits_close(p, j)
    host = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, device="cpu")
    np.testing.assert_allclose(p.fodf.vol, host.fodf.vol, rtol=1e-5,
                               atol=1e-7)


def test_rumba_rec_outputs_are_lazy_torch_volumes():
    from fibers_tpu_torch.core.lazy import LazyVolume
    dwi, mask = _masked_phantom((3, 3, 3))
    rec = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=2, device="cpu")
    raw = rec.fodf.__dict__["vol"]
    assert isinstance(raw, LazyVolume) and isinstance(raw._values,
                                                      torch.Tensor)
    assert rec.fodf.vol.shape == (3, 3, 3, 181)
    assert len(rec.peak) == 5 and rec.peak[4].vol.shape == (3, 3, 3, 3)
    pk = rec._peak_dev
    assert pk.nvec == 5 and pk.vecs.shape[-1] == 3
    m = pk.amp > 0
    np.testing.assert_allclose(torch.linalg.norm(pk.vecs, dim=-1)[m], 1.0,
                               atol=1e-6)


def test_rumba_rec_options():
    dwi, mask = _masked_phantom((3, 3, 3))
    for wire in ("u12", "u16", "f32"):
        stages = {}
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=1, signal_wire=wire,
                     device="cpu", timings=stages)
        assert sorted(stages) == ["iterate", "post", "signal"]
    with pytest.raises(ValueError, match="signal_wire"):
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=1, signal_wire="u8")
    with pytest.raises(TypeError, match="Mesh"):
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=1, mesh=object())
    with pytest.raises(NotImplementedError, match="pace aborts"):
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=1, abort_s_per_iter=1.0)
    with pytest.raises(ValueError, match="precision"):
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=1, precision="tf32")
    with pytest.raises(ValueError, match="coil"):
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=1, coil_combine="x")
    assert issubclass(tr.PaceAbortError, RuntimeError)


def test_precision_default_close_to_f32():
    """bf16-rounded product operands move the fit by well under a percent
    of its scale, the bound of the bf16 TV test."""
    dwi, mask = _masked_phantom()
    hi = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, device="cpu")
    lo = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, device="cpu",
                      precision="default")
    np.testing.assert_allclose(lo.fodf.vol, hi.fodf.vol, rtol=0.05,
                               atol=2e-3)
    assert not np.array_equal(lo.fodf.vol, hi.fodf.vol)


# ------------------------------------------------------------------ #
# Checkpoints and results on disk
# ------------------------------------------------------------------ #

def test_jax_checkpoint_resumes_in_port(tmp_path):
    dwi, mask = _masked_phantom((4, 4, 4))
    full = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=16, device="cpu")
    ck = str(tmp_path / "rumba.ckpt.npz")
    ft.rumba_rec(dwi, mask, ft.sphere_362, niter=8, checkpoint_path=ck,
                 checkpoint_every=4)
    with np.load(ck) as z:
        state = dict(z)
    assert int(state["iteration"]) == 4 and int(state["version"]) == 2
    state["niter"] = 16
    ck2 = str(tmp_path / "rumba16.ckpt.npz")
    np.savez(ck2, **state)
    resumed = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=16,
                           checkpoint_path=ck2, device="cpu")
    np.testing.assert_allclose(resumed.fodf.vol, full.fodf.vol, **FIT)

    # a pre-v2 checkpoint with lambda on the full volume is remapped
    legacy = {k: state[k] for k in ("fodf", "sig2", "iteration", "nmask",
                                    "ncomp", "niter")}
    grid = np.zeros(mask.vol.shape, np.float32)
    lo, sh = state["tv_lo"], state["tv_shape3"]
    grid[tuple(slice(a, a + s) for a, s in zip(lo, sh))] = \
        state["lam_flat"].reshape(sh)
    legacy["lam_flat"] = grid.reshape(-1)
    ck3 = str(tmp_path / "legacy.ckpt.npz")
    np.savez(ck3, **legacy)
    again = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=16,
                         checkpoint_path=ck3, device="cpu")
    np.testing.assert_allclose(again.fodf.vol, resumed.fodf.vol, rtol=0,
                               atol=1e-7)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    dwi, mask = _masked_phantom((4, 4, 4))
    ck = str(tmp_path / "port.ckpt.npz")
    tt.rumba_rec(dwi, mask, ft.sphere_362, niter=12, checkpoint_path=ck,
                 checkpoint_every=6, device="cpu")
    with np.load(ck) as z:
        assert int(z["iteration"]) == 6
        assert z["fodf"].shape[1] == int(z["ncomp"])
    resumed = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=12,
                           checkpoint_path=ck)
    full = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=12)
    np.testing.assert_allclose(resumed.fodf.vol, full.fodf.vol, **FIT)


def test_checkpoint_on_mismatch(tmp_path):
    dwi, mask = _masked_phantom((3, 3, 3))
    ck = str(tmp_path / "bad.npz")
    np.savez(ck, fodf=np.zeros((5, 5)), sig2=np.zeros((5, 1)),
             lam_flat=np.zeros(27), iteration=3, nmask=5, ncomp=5, niter=4)
    with pytest.raises(ValueError, match="does not match"):
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=4, checkpoint_path=ck,
                     device="cpu")
    fresh = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=4, device="cpu")
    with pytest.warns(UserWarning, match="starting fresh"):
        rec = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=4,
                           checkpoint_path=ck, on_mismatch="fresh",
                           device="cpu")
    assert np.array_equal(rec.fodf.vol, fresh.fodf.vol)
    with pytest.raises(ValueError, match="on_mismatch"):
        tt.rumba_rec(dwi, mask, ft.sphere_362, niter=4, checkpoint_path=ck,
                     on_mismatch="retry", device="cpu")


def test_rumba_write_roundtrip(tmp_path):
    dwi, mask = _masked_phantom((3, 3, 3))
    rec = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=5, device="cpu")
    base = str(tmp_path / "rumba")
    tt.rumba_write(rec, base)
    for f in ("fodf", "fgm", "fcsf", "peak1", "peak5", "gfa", "var"):
        assert os.path.isfile(f"{base}_{f}.nii.gz"), f
    back = tt.mri_read_struct(base, tt.RUMBASD)
    np.testing.assert_allclose(back.fodf.vol, rec.fodf.vol, atol=1e-6)
    np.testing.assert_allclose(back.peak[0].vol, rec.peak[0].vol, atol=1e-6)
    assert abs(back.snr_mean - rec.snr_mean) < 1e-4
    assert len(back.peak) == 5


# ------------------------------------------------------------------ #
# The chain into tractography
# ------------------------------------------------------------------ #

def test_rumba_stream_chain_matches_jax(tmp_path):
    """RUMBA peaks -> device handoff -> stream (tests/test_stream.py:
    744-758 setup), each package its own whole chain."""
    dwi, mask, _, _ = make_phantom(shape=(8, 8, 8), ndir=30)
    out = {}
    for name, pkg, kw in (("jax", ft, {}), ("torch", tt, {"device": "cpu"})):
        rum = pkg.rumba_rec(dwi, mask, ft.sphere_362, niter=10, **kw)
        pk = pkg.peaks_to_ovecs(rum, device=True)
        assert pk.nvec == 5
        trk = str(tmp_path / f"{name}.trk")
        tract = pkg.stream(pk, mask=mask, nsub=1, f_thresh=0.01, wire="f32",
                           trk_sink=trk)
        out[name] = (tract, pkg.trk_read(trk))
    (tj, bj), (tp, bp) = out["jax"], out["torch"]
    assert tj.n_count > 0
    assert bp.n_count == tp.n_count and np.array_equal(bp.npts, tp.npts)
    _compare_tracts(bj, bp)


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #

@pytest.mark.cuda
@pytest.mark.parametrize("tv_bf16", [False, True])
def test_rumba_card_matches_cpu(cuda, tv_bf16):
    from fibers_tpu_torch.ops.kernels.tv_fused import tv_fused
    from fibers_tpu_torch.ops.kernels.tv_stencil import tv_multiplier
    dwi, mask = _masked_phantom((8, 7, 6))
    counter = tv_multiplier if tv_bf16 else tv_fused
    before = counter.launches
    # the exact signal on both devices: the card's default u12 wire is
    # held to the exact signal in tests/test_torch_wire.py
    g = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, tv_bf16=tv_bf16,
                     device="cuda", signal_wire="f32")
    assert counter.launches == before + 10
    c = tt.rumba_rec(dwi, mask, ft.sphere_362, niter=10, tv_bf16=tv_bf16,
                     device="cpu", signal_wire="f32")
    # bf16: an ulp of f32 difference between the card's and the CPU's
    # products can flip the bf16 rounding of a stack value, which moves
    # the multiplier by ~2^-9 of a difference (6.4e-6 on the fODF
    # measured on the card at 20 iterations, 32x32x20 phantom)
    tol = dict(rtol=1e-3, atol=1e-4) if tv_bf16 else FIT
    np.testing.assert_allclose(g.fodf.vol, c.fodf.vol, **tol)
    np.testing.assert_allclose(g.gfa.vol, c.gfa.vol, rtol=0,
                               atol=1e-3 if tv_bf16 else 1e-5)
