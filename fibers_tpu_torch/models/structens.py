"""Structure-tensor reconstruction, in PyTorch.

Counterpart of fibers_tpu/models/structens.py: a Gaussian pre-smooth,
Scharr gradients, their outer products, a Gaussian post-smooth and the
batched closed-form 3x3 eigensolver (reference: src/structens.jl:13-88).
Each separable 1-D filter is one banded [n, n] matrix contracted over
the filtered axis with `torch.tensordot`, in float32 with TF32 off (the
reference runs it at Precision.HIGHEST).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lazy import LazyArray
from ..device import resolve
from ..ops.eig3 import eigh3

__all__ = ["st_recon", "st_eigen"]


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    """Odd-length Gaussian kernel matching ImageFiltering's
    KernelFactors.gaussian default length 4*ceil(sigma)+1.

    A copy of fibers_tpu/models/structens.py:_gaussian_kernel1d (that
    module imports jax at its top)."""
    r = int(4 * np.ceil(sigma)) // 2 * 2 // 2
    r = max(r, int(np.ceil(2 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


# Scharr 3-tap factors: derivative [-1/2, 0, 1/2] smoothed by
# [3/16, 10/16, 3/16] along the other axes (ImageFiltering's
# KernelFactors.scharr convention)
_SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], np.float32) / 16.0
_SCHARR_DERIV = np.array([-0.5, 0.0, 0.5], np.float32)


def _band_matrix(n: int, kernel: np.ndarray) -> np.ndarray:
    """[n, n] banded correlation matrix with the "symmetric" (edge-
    inclusive reflect) boundary folded into the edge rows.

    A copy of fibers_tpu/models/structens.py:_band_matrix."""
    r = (len(kernel) - 1) // 2
    b = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, w in enumerate(np.asarray(kernel, np.float64)):
            j = i + t - r
            while j < 0 or j >= n:      # multiple reflections for k > n
                j = -1 - j if j < 0 else 2 * n - 1 - j
            b[i, j] += w
    return b


def _conv1d_reflect(vol, kernel, axis):
    """Separable 1-D correlation along `axis` with reflect ("symmetric")
    boundary, matching imfilter(..., "reflect"): the banded [n, n] matrix
    contracted over the filtered axis."""
    b = torch.from_numpy(_band_matrix(vol.shape[axis], kernel)).to(
        vol.device)
    out = torch.tensordot(b, torch.movedim(vol, axis, 0), dims=1)
    return torch.movedim(out, 0, axis)


def _smooth(vol, sigma):
    k = _gaussian_kernel1d(sigma)
    for ax in range(3):
        vol = _conv1d_reflect(vol, k, ax)
    return vol


def _scharr_grad(vol, axis):
    for ax in range(3):
        k = _SCHARR_DERIV if ax == axis else _SCHARR_SMOOTH
        vol = _conv1d_reflect(vol, k, ax)
    return vol


def _st_kernel(vol, sigma, rho):
    image = _smooth(vol, sigma) if sigma > 0 else vol

    gx = _scharr_grad(image, 0)
    gy = _scharr_grad(image, 1)
    gz = _scharr_grad(image, 2)

    comps = [gx * gx, gx * gy, gx * gz, gy * gy, gy * gz, gz * gz]
    if rho > 0:
        comps = [_smooth(c, rho) for c in comps]

    evals, evecs = eigh3(torch.stack(comps, dim=-1))
    # The reference returns Julia `eigen` ordering: ascending eigenvalues
    # (reference: src/structens.jl:26-28); flip eigh3's descending output.
    return evecs.flip(-1), evals.flip(-1)


def st_eigen(sxx, sxy, sxz, syy, syz, szz, device=None):
    """Voxel-wise eigendecomposition of a symmetric tensor field.

    Returns (eigvec [..., 3, 3], eigval [..., 3]) as numpy, eigenvalues
    ascending, as in the reference (src/structens.jl:13-34)."""
    dev = resolve(device)
    u = torch.stack([torch.from_numpy(np.array(c, np.float32)).to(dev)
                     for c in (sxx, sxy, sxz, syy, syz, szz)], dim=-1)
    evals, evecs = eigh3(u)
    return evecs.flip(-1).cpu().numpy(), evals.flip(-1).cpu().numpy()


def st_recon(vol: np.ndarray, sigma: float, rho: float, lazy: bool = False,
             mesh=None, device=None):
    """Structure-tensor reconstruction: Gaussian pre-smooth (sigma), Scharr
    gradients, outer products, Gaussian post-smooth (rho), eigen-
    decomposition.  (reference: src/structens.jl:40-88)

    Returns (eigvec [X,Y,Z,3,3], eigval [X,Y,Z,3]), eigenvalues ascending,
    as numpy; with `lazy=True` as `LazyArray`s that stay on `device`
    (None: cuda when available) until host code reads them.  `mesh=` is
    not ported yet (ROADMAP A13) and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "st_recon(mesh=): multi-device structure tensors are not ported "
            "yet (ROADMAP A13)")
    v = np.array(vol, np.float32)
    if v.ndim == 4:
        v = v[..., 0]
    evecs, evals = _st_kernel(torch.from_numpy(v).to(resolve(device)),
                              float(sigma), float(rho))
    if lazy:
        return LazyArray(evecs), LazyArray(evals)
    return evecs.cpu().numpy(), evals.cpu().numpy()
