"""Structure-tensor reconstruction, in PyTorch.

Counterpart of fibers_tpu/models/structens.py: a Gaussian pre-smooth,
Scharr gradients, their outer products, a Gaussian post-smooth and the
batched closed-form 3x3 eigensolver (reference: src/structens.jl:13-88).
Each separable 1-D filter is one banded [n, n] matrix contracted over
the filtered axis with `torch.tensordot`, in float32 with TF32 off (the
reference runs it at Precision.HIGHEST).

A volume is filtered in slabs: each slab plus a halo as wide as the
filters reach (pre-smooth radius + 1 for Scharr + post-smooth radius)
goes through the whole chain and keeps the slab.  Along the cut axis the
band is built for the extended slab with the reflect boundary of the
whole volume, so only the volume's own faces reflect.  On a mesh the
slabs are equal cuts of an axis that the data-axis size divides, one
per data device; on one device a volume larger than `_SLAB_VOXELS`
(halo included) is cut along its first axis and its slabs run in order,
each written into the full outputs, so the working set is one slab's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.lazy import LazyArray
from ..device import resolve
from ..ops.eig3 import eigh3
from ..parallel.mesh import _move, as_mesh
from ..utils.profiling import count, span

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


def _band_slab(n: int, lo: int, hi: int, kernel: np.ndarray) -> np.ndarray:
    """The rows and columns lo:hi of `_band_matrix(n, kernel)`: the band
    of the slab [lo, hi) of an axis of length n, reflecting at the axis's
    own ends.  Taps that fall outside the slab are dropped; they reach
    only halo rows, which the caller crops."""
    r = (len(kernel) - 1) // 2
    b = np.zeros((hi - lo, hi - lo), np.float32)
    for i in range(lo, hi):
        for t, w in enumerate(np.asarray(kernel, np.float64)):
            j = i + t - r
            while j < 0 or j >= n:
                j = -1 - j if j < 0 else 2 * n - 1 - j
            if lo <= j < hi:
                b[i - lo, j - lo] += w
    return b


@functools.lru_cache(maxsize=64)
def _band(n: int, lo: int, hi: int, taps: tuple) -> np.ndarray:
    """`_band_slab(n, lo, hi, taps)`, or `_band_matrix(n, taps)` for the
    whole axis, built once per shape and kernel (a volume's slabs and
    filters ask for the same few); callers only read it."""
    k = np.asarray(taps, np.float32)
    return _band_matrix(n, k) if (lo, hi) == (0, n) else _band_slab(n, lo,
                                                                     hi, k)


def _conv1d_reflect(vol, kernel, axis, slab=None):
    """Separable 1-D correlation along `axis` with reflect ("symmetric")
    boundary, matching imfilter(..., "reflect"): the banded [n, n] matrix
    contracted over the filtered axis.  `slab` (axis, lo, hi, n): `vol`
    holds rows lo:hi of an axis of length n, filtered with `_band_slab`."""
    taps = tuple(np.asarray(kernel, np.float32).tolist())
    if slab is not None and slab[0] == axis:
        b = _band(slab[3], slab[1], slab[2], taps)
    else:
        b = _band(vol.shape[axis], 0, vol.shape[axis], taps)
    b = torch.from_numpy(b).to(vol.device)
    out = torch.tensordot(b, torch.movedim(vol, axis, 0), dims=1)
    return torch.movedim(out, 0, axis)


def _smooth(vol, sigma, slab=None):
    k = _gaussian_kernel1d(sigma)
    for ax in range(3):
        vol = _conv1d_reflect(vol, k, ax, slab)
    return vol


def _scharr_grad(vol, axis, slab=None):
    for ax in range(3):
        k = _SCHARR_DERIV if ax == axis else _SCHARR_SMOOTH
        vol = _conv1d_reflect(vol, k, ax, slab)
    return vol


def _st_kernel(vol, sigma, rho, slab=None):
    image = _smooth(vol, sigma, slab) if sigma > 0 else vol

    gx = _scharr_grad(image, 0, slab)
    gy = _scharr_grad(image, 1, slab)
    gz = _scharr_grad(image, 2, slab)

    comps = [gx * gx, gx * gy, gx * gz, gy * gy, gy * gz, gz * gz]
    if rho > 0:
        comps = [_smooth(c, rho, slab) for c in comps]

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


def _halo(sigma: float, rho: float) -> int:
    """How far the filters reach along an axis: the pre-smooth radius,
    Scharr's 1 and the post-smooth radius."""
    def radius(s):
        return (len(_gaussian_kernel1d(s)) - 1) // 2 if s > 0 else 0
    return radius(sigma) + 1 + radius(rho)


# the most voxels (halo included) one device filters at once: the chain
# holds ~22 float32 volumes of a slab, and eigh3 its temporaries
_SLAB_VOXELS = 1 << 25


def _st_slab(v, a, b, axis, sigma, rho, device):
    """`_st_kernel` on the planes [a, b) of host volume `v` along `axis`:
    the planes and their halo go to `device` and through the chain, and
    the halo is cropped from the outputs."""
    n, h = v.shape[axis], _halo(sigma, rho)
    lo, hi = max(a - h, 0), min(b + h, n)
    with span("structens.slab"):
        slab = torch.from_numpy(np.ascontiguousarray(
            v[(slice(None),) * axis + (slice(lo, hi),)])).to(device)
        count("structens.slabs", 1)
        count("structens.voxels", slab.numel())
        ev, el = _st_kernel(slab, sigma, rho, (axis, lo, hi, n))
        return ev.narrow(axis, a - lo, b - a), el.narrow(axis, a - lo, b - a)


def _st_one_device(v, sigma, rho, device):
    """`_st_kernel` on one device: the whole volume as one slab when it
    fits in `_SLAB_VOXELS`, else slabs along the first axis in order,
    each written into the full outputs."""
    n, plane = v.shape[0], int(np.prod(v.shape[1:]))
    if n * plane <= _SLAB_VOXELS:
        return _st_slab(v, 0, n, 0, sigma, rho, device)
    per = max(1, _SLAB_VOXELS // plane - 2 * _halo(sigma, rho))
    evecs = torch.empty(v.shape + (3, 3), dtype=torch.float32, device=device)
    evals = torch.empty(v.shape + (3,), dtype=torch.float32, device=device)
    for a in range(0, n, per):
        b = min(a + per, n)
        ev, el = _st_slab(v, a, b, 0, sigma, rho, device)
        evecs[a:b] = ev
        evals[a:b] = el
        del ev, el
    return evecs, evals


def _st_sharded(v, sigma, rho, mesh):
    """`_st_kernel` over slabs of `v` on the mesh's data devices, joined on
    the first one (fibers_tpu/models/structens.py:145-155)."""
    nd = mesh.ndata
    axis = next((i for i in range(3) if v.shape[i] % nd == 0), None)
    d0 = mesh.data_devices[0]
    if axis is None:
        return _st_one_device(v, sigma, rho, d0)
    per = v.shape[axis] // nd
    parts = [_st_slab(v, i * per, (i + 1) * per, axis, sigma, rho, d)
             for i, d in enumerate(mesh.data_devices)]
    return tuple(torch.cat([_move(p[k], d0) for p in parts], dim=axis)
                 for k in range(2))


def st_recon(vol: np.ndarray, sigma: float, rho: float, lazy: bool = False,
             mesh=None, device=None):
    """Structure-tensor reconstruction: Gaussian pre-smooth (sigma), Scharr
    gradients, outer products, Gaussian post-smooth (rho), eigen-
    decomposition.  (reference: src/structens.jl:40-88)

    Returns (eigvec [X,Y,Z,3,3], eigval [X,Y,Z,3]), eigenvalues ascending,
    as numpy; with `lazy=True` as `LazyArray`s that stay on `device`
    (None: the card) until host code reads them.

    On one device a volume of more than `_SLAB_VOXELS` voxels is
    filtered in slabs along its first axis, in order (module docstring),
    so a microscopy block needs one slab's working set beside its
    outputs.  `mesh` (parallel/mesh.py): the volume is cut into equal
    slabs along its first axis that the data-axis size divides, one per
    data device, each filtered with its halo; with no such axis it runs
    on the mesh's first device alone, as the reference does.  The lazy
    outputs are joined on the first device.  A float32 input is read in
    place, with no host copy.
    """
    with span("structens.recon"):
        mesh = as_mesh(mesh)
        v = np.asarray(vol)
        if v.ndim == 4:
            v = v[..., 0]
        if v.dtype != np.float32:
            v = v.astype(np.float32)
        sigma, rho = float(sigma), float(rho)
        if mesh is not None:
            evecs, evals = _st_sharded(v, sigma, rho, mesh)
        else:
            evecs, evals = _st_one_device(v, sigma, rho, resolve(device))
        if lazy:
            return LazyArray(evecs), LazyArray(evals)
        return evecs.cpu().numpy(), evals.cpu().numpy()
