"""The structure tensor of the PyTorch port against the JAX package and
the float64 per-voxel oracle (tests/oracle.py:st_recon_oracle).

Tolerances: eigenvalues within 1e-5 of the largest eigenvalue's
magnitude (both packages filter in float32 GEMMs, summed in different
orders; seen: 2.5e-7 against the JAX package, 1.1e-6 against the
oracle); eigenvectors up to sign, |dot| >= 1 - 1e-4, wherever the
eigenvalue is separated from its neighbours by more than 1e-3 of the
largest (inside a degenerate eigenspace the basis is arbitrary).
"""

import numpy as np
import pytest
import torch

import fibers_tpu as ft
import fibers_tpu_torch as tt
from fibers_tpu_torch.core.lazy import LazyArray

from oracle import st_recon_oracle

CASES = [(1.0, 2.0), (0.0, 1.5), (1.5, 0.0)]


def _volume(shape=(12, 10, 9), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 50 + 100).astype(np.float32)


def _assert_eig_close(evec, evals, evec_ref, evals_ref):
    scale = float(np.abs(evals_ref).max())
    np.testing.assert_allclose(evals, evals_ref, atol=1e-5 * scale, rtol=0)
    gaps = np.diff(evals_ref, axis=-1)                     # [..., 2]
    sep = np.ones(evals_ref.shape, bool)
    sep[..., :2] &= gaps > 1e-3 * scale
    sep[..., 1:] &= gaps > 1e-3 * scale
    dots = np.abs((evec * evec_ref).sum(axis=-2))          # [..., 3]
    assert sep.any()
    assert dots[sep].min() >= 1 - 1e-4


@pytest.mark.parametrize("sigma,rho", CASES)
def test_st_recon_matches_jax(sigma, rho):
    vol = _volume()
    ej, lj = ft.st_recon(vol, sigma, rho)
    et, lt = tt.st_recon(vol, sigma, rho, device="cpu")
    assert et.shape == vol.shape + (3, 3) and lt.shape == vol.shape + (3,)
    assert et.dtype == lt.dtype == np.float32
    _assert_eig_close(et, lt, np.asarray(ej), np.asarray(lj))


@pytest.mark.parametrize("sigma,rho", CASES)
def test_st_recon_matches_oracle(sigma, rho):
    vol = _volume(seed=1)
    eo, lo = st_recon_oracle(vol, sigma, rho)
    et, lt = tt.st_recon(vol, sigma, rho, device="cpu")
    _assert_eig_close(et, lt, eo, lo)


def test_st_recon_takes_a_4d_volume():
    vol = _volume((8, 7, 6))
    a = tt.st_recon(vol[..., None], 1.0, 1.0, device="cpu")
    b = tt.st_recon(vol, 1.0, 1.0, device="cpu")
    assert np.array_equal(a[1], b[1])


def test_planar_texture_orientation():
    """tests/test_structens.py: a grating along x has its dominant
    gradient (last, largest eigenvalue) along x."""
    shape = (24, 24, 24)
    x = np.arange(shape[0])[:, None, None]
    vol = (np.sin(2 * np.pi * x / 6.0) * np.ones(shape)).astype(np.float32)
    eigvec, eigval = tt.st_recon(vol, 1.0, 1.5, device="cpu")
    assert (np.diff(eigval, axis=-1) >= -1e-4).all()
    inner = (slice(6, -6),) * 3
    assert np.abs(eigvec[inner + (slice(None), 2)][..., 0]).min() > 0.95


def test_isotropic_noise_no_dominant():
    vol = np.random.default_rng(0).standard_normal((20, 20, 20)).astype(
        np.float32)
    _, eigval = tt.st_recon(vol, 1.0, 2.0, device="cpu")
    ev = eigval[(slice(5, -5),) * 3]
    assert np.median(ev[..., 2] / np.maximum(ev[..., 0], 1e-12)) < 10.0


def test_st_eigen_matches_jax_and_numpy():
    u = np.random.default_rng(42).standard_normal((50, 6)).astype(
        np.float32)
    cols = [u[:, i] for i in range(6)]
    et, lt = tt.st_eigen(*cols, device="cpu")
    ej, lj = ft.st_eigen(*cols)
    _assert_eig_close(et, lt, np.asarray(ej), np.asarray(lj))
    for i in range(len(u)):
        m = np.array([[u[i, 0], u[i, 1], u[i, 2]],
                      [u[i, 1], u[i, 3], u[i, 4]],
                      [u[i, 2], u[i, 4], u[i, 5]]])
        np.testing.assert_allclose(lt[i], np.linalg.eigvalsh(m), atol=2e-4)


def test_lazy_materializes_to_the_eager_arrays():
    vol = _volume()
    ev, el = tt.st_recon(vol, 1.0, 2.0, device="cpu")
    lv, ll = tt.st_recon(vol, 1.0, 2.0, lazy=True, device="cpu")
    assert isinstance(lv, LazyArray) and isinstance(ll, LazyArray)
    assert isinstance(ll.device, torch.Tensor)       # still on the device
    assert ll.shape == el.shape and ll.dtype == np.float32
    assert bool(torch.isfinite(ll.device).all())
    assert np.array_equal(np.asarray(ll), el)
    assert np.array_equal(lv.materialize(), ev)
    assert ll.device is None                         # fetched, released
    assert np.array_equal(lv[1, 2], ev[1, 2])


@pytest.mark.cuda
def test_st_recon_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    vol = _volume((32, 32, 20))
    eg, lg = tt.st_recon(vol, 1.0, 2.0, device="cuda")
    ec, lc = tt.st_recon(vol, 1.0, 2.0, device="cpu")
    _assert_eig_close(eg, lg, ec, lc)
