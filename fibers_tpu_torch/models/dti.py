"""ADC and DTI tensor fitting over a device voxel batch, in PyTorch.

Counterpart of fibers_tpu/models/dti.py: one masked weighted-least-squares
solve plus the closed-form 3x3 eigendecomposition over the whole [N, nvol]
batch, scattered back into host volumes (reference: src/dti.jl:164-316).
The normal-equation products are plain large matrix products, left to
`torch.matmul` in float32 (TF32 stays off; see fibers_tpu_torch.device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.mri import MRI
from ..io.dispatch import mri_write_struct
from ..ops.eig3 import eigh3
from ..ops.masked import scatter_frames

__all__ = ["DTI", "adc_fit", "dti_fit", "dti_fit_ls", "dti_maps", "dti_write"]


@dataclass
class DTI:
    """Outputs of a DTI fit.  (reference: src/dti.jl:11-22)"""

    s0: MRI
    eigval1: MRI
    eigval2: MRI
    eigval3: MRI
    eigvec1: MRI
    eigvec2: MRI
    eigvec3: MRI
    rd: MRI
    md: MRI
    fa: MRI


def _design_adc(bval: np.ndarray) -> np.ndarray:
    """[nvol, 2] design for the log-linear ADC fit."""
    return np.stack([-bval, np.ones_like(bval)], axis=1).astype(np.float32)


def _design_dti(bval: np.ndarray, bvec: np.ndarray) -> np.ndarray:
    """[nvol, 7] design for the log-linear tensor fit.
    A copy of fibers_tpu/models/dti.py:_design_dti (that module imports
    jax at its top).  (reference: src/dti.jl:129-140)"""
    gx, gy, gz = bvec[:, 0], bvec[:, 1], bvec[:, 2]
    a = np.stack([
        gx * gx, 2 * gx * gy, 2 * gx * gz, gy * gy, 2 * gy * gz, gz * gz,
    ], axis=1)
    a = -bval[:, None] * a
    a = np.concatenate([a, np.ones((len(bval), 1))], axis=1)
    return a.astype(np.float32)


def _masked_wls(signals, A, ib0):
    """Masked log-linear least squares over a [N, nvol] batch, using only
    strictly positive signals per voxel (reference: src/dti.jl:290-298).
    Column-equilibrated normal equations keep the f32 solve well
    conditioned.  Returns (d [N, nparam], valid [N])."""
    nparam = A.shape[1]
    ipos = signals > 0
    w = ipos.to(signals.dtype)
    npos = w.sum(dim=1)

    # valid: all-positive, or >6 positives including a positive b=0
    has_b0 = (w * ib0[None, :]).sum(dim=1) > 0
    valid = (npos == signals.shape[1]) | ((npos > 6) & has_b0)

    logs = torch.log(torch.where(ipos, signals, torch.ones_like(signals)))

    colnorm = torch.sqrt((A * A).sum(dim=0))
    As = A / colnorm[None, :]

    # G = As^T diag(w) As as ONE [N, nvol] x [nvol, p^2] product against
    # the per-volume outer products; rhs = (w * logs) @ As
    b_outer = (As[:, :, None] * As[:, None, :]).reshape(A.shape[0],
                                                         nparam * nparam)
    g = torch.matmul(w, b_outer).reshape(-1, nparam, nparam)
    rhs = torch.matmul(w * logs, As)

    eye = torch.eye(nparam, dtype=signals.dtype, device=signals.device)
    g = torch.where(valid[:, None, None], g, eye)
    d = _chol_solve_small(g + 1e-8 * eye, rhs)
    return d / colnorm[None, :], valid


def _chol_solve_small(g, rhs):
    """Batched SPD solve for a small static p (the 7-parameter tensor fit),
    unrolled into [N]-vector operations: Cholesky, then forward and back
    substitution."""
    p = g.shape[-1]
    L = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = g[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * p
    for i in range(p):
        s = rhs[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=1)


def dti_maps(eigval1, eigval2, eigval3):
    """RD, MD, FA from tensor eigenvalues.  (reference: src/dti.jl:325-335)"""
    rd = eigval2 + eigval3
    md = (eigval1 + rd) / 3
    rd = rd / 2
    denom = eigval1 ** 2 + eigval2 ** 2 + eigval3 ** 2
    fa = torch.sqrt(
        ((eigval1 - md) ** 2 + (eigval2 - md) ** 2 + (eigval3 - md) ** 2)
        / torch.clamp_min(denom, 1e-30) * 1.5)
    return rd, md, fa


def _adc_kernel(signals, A, ib0):
    d, valid = _masked_wls(signals, A, ib0)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    adc = torch.where(valid, d[:, 0], zero)
    s0 = torch.where(valid, torch.exp(d[:, 1]), zero)
    return adc, s0


# Column layout of the packed DTI result [N, 16]: one device->host copy
_DTI_COLS = dict(s0=(0, 1), eigval1=(1, 2), eigval2=(2, 3), eigval3=(3, 4),
                 eigvec1=(4, 7), eigvec2=(7, 10), eigvec3=(10, 13),
                 rd=(13, 14), md=(14, 15), fa=(15, 16))


def _dti_kernel(signals, A, ib0):
    d, valid = _masked_wls(signals, A, ib0)

    s0 = torch.exp(d[:, 6])
    evals, evecs = eigh3(d[:, 0:6])

    l1, l2, l3 = evals[:, 0], evals[:, 1], evals[:, 2]
    rd, md, fa = dti_maps(l1, l2, l3)

    packed = torch.cat([
        s0[:, None], l1[:, None], l2[:, None], l3[:, None],
        evecs[:, :, 0], evecs[:, :, 1], evecs[:, :, 2],
        rd[:, None], md[:, None], fa[:, None]], dim=1)
    return torch.where(valid[:, None], packed,
                       torch.zeros((), dtype=packed.dtype,
                                   device=packed.device))


def _batch_and_tables(dwi, mask, batch, device, design):
    if batch is None:
        from ..core.batch import prepare_batch
        batch = prepare_batch(dwi, mask, device=device)
    dev = batch.signals.device
    A = torch.from_numpy(design).to(dev)
    bval = np.asarray(dwi.bval)
    ib0 = torch.from_numpy((bval == bval.min()).astype(np.float32)).to(dev)
    return batch, A, ib0


def adc_fit(dwi: MRI, mask: MRI, batch=None, device=None):
    """Fit the apparent diffusion coefficient.  Returns (adc, s0) MRIs.
    (reference: src/dti.jl:164-213)

    `batch`: an optional prepared `VoxelBatch`; without one the batch is
    gathered onto `device` (None: the card)."""
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    batch, A, ib0 = _batch_and_tables(
        dwi, mask, batch, device,
        _design_adc(np.asarray(dwi.bval, np.float32)))
    adc_d, s0_d = _adc_kernel(batch.signals, A, ib0)
    both = torch.stack([adc_d, s0_d])[:, :batch.n].cpu().numpy()

    shape3 = mask.vol.shape[:3]
    adc = MRI.like(mask, 1, np.float32)
    s0 = MRI.like(mask, 1, np.float32)
    adc.vol = scatter_frames(both[0], batch.idx, shape3)
    s0.vol = scatter_frames(both[1], batch.idx, shape3)
    return adc, s0


def dti_fit(dwi: MRI, mask: MRI, batch=None, device=None) -> DTI:
    """Fit tensors to DWIs; returns a `DTI` structure.
    (reference: src/dti.jl:221-232)"""
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    if dwi.bvec is None or np.asarray(dwi.bvec).size == 0:
        raise ValueError("Missing gradient table from input DWI structure")
    return dti_fit_ls(dwi, mask, batch=batch, device=device)


def dti_fit_ls(dwi: MRI, mask: MRI, batch=None, device=None) -> DTI:
    """Least-squares tensor fit.
    Basser et al. (1994), J Magn Reson B 103(3):247-254.
    (reference: src/dti.jl:243-316)"""
    batch, A, ib0 = _batch_and_tables(
        dwi, mask, batch, device,
        _design_dti(np.asarray(dwi.bval, np.float32),
                    np.asarray(dwi.bvec, np.float32)))
    arr = _dti_kernel(batch.signals, A, ib0)[:batch.n].cpu().numpy()

    shape3 = mask.vol.shape[:3]

    def vol(name):
        lo, hi = _DTI_COLS[name]
        m = MRI.like(mask, hi - lo, np.float32)
        m.vol = scatter_frames(arr[:, lo] if hi - lo == 1 else arr[:, lo:hi],
                               batch.idx, shape3)
        return m

    return DTI(**{name: vol(name) for name in _DTI_COLS})


def dti_write(dti: DTI, basename: str) -> None:
    """Write DTI volumes as <basename>_<field>.nii.gz.
    (reference: src/dti.jl:344-349)"""
    mri_write_struct(dti, basename)
