"""ADC and DTI tensor fitting over a device voxel batch, in PyTorch.

Counterpart of fibers_tpu/models/dti.py: one masked weighted-least-squares
solve plus the closed-form 3x3 eigendecomposition over the whole [N, nvol]
batch, scattered back into host volumes (reference: src/dti.jl:164-316).
The normal-equation products are plain large matrix products, left to
`torch.matmul` in float32 (TF32 stays off; see fibers_tpu_torch.device).

The result reaches the host as whole volumes through the route the lazy
volumes take (`core.lazy.host_volumes`, spans `dti.scatter` and
`dti.fetch`): the rows are scattered on their device into one zeroed
buffer that holds the volumes back to back, the buffer comes to the host
in one copy, and each volume is a numpy view of that copy.  From a CUDA
device the copy lands in one pinned block of torch's caching host
allocator (128 MB at the HCP scale: 140x140x92 voxels, 16 frames).
Every volume of a fit keeps the whole block alive through its `base`, so
a caller who keeps any one volume (only `fa`, say) holds all 128 MB of
pinned memory; `np.array(vol)` copies a volume out to keep it alone.
When the last view is dropped the block goes back to the pool, still
page-locked, and the next fit takes it again without a new page-locked
allocation.  A batch sharded over a mesh runs the same kernel once per
shard; its rows are gathered onto one of its devices and take the same
route from there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.lazy import host_volumes
from ..core.mri import MRI
from ..io.dispatch import mri_write_struct
from ..ops.eig3 import eigh3
from ..parallel.mesh import ShardedRows

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


# Column layout of the packed DTI result [N, 16], one group a volume
_DTI_COLS = dict(s0=(0, 1), eigval1=(1, 2), eigval2=(2, 3), eigval3=(3, 4),
                 eigvec1=(4, 7), eigvec2=(7, 10), eigvec3=(10, 13),
                 rd=(13, 14), md=(14, 15), fa=(15, 16))
_ADC_COLS = ((0, 1), (1, 2))            # [N, 2]: adc, s0


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


def _per_shard(kernel, signals, *tables):
    """kernel(signals, *tables) with the numpy `tables` on the signals'
    device; once per shard of a sharded batch."""
    def run(s):
        return kernel(s, *(torch.from_numpy(t).to(s.device) for t in tables))
    if isinstance(signals, ShardedRows):
        return signals.map(run)
    return run(signals)


def _batch_and_tables(dwi, mask, batch, device, design):
    if batch is None:
        from ..core.batch import prepare_batch
        batch = prepare_batch(dwi, mask, device=device)
    bval = np.asarray(dwi.bval)
    return batch, design, (bval == bval.min()).astype(np.float32)


def adc_fit(dwi: MRI, mask: MRI, batch=None, device=None):
    """Fit the apparent diffusion coefficient.  Returns (adc, s0) MRIs.
    (reference: src/dti.jl:164-213)

    `batch`: an optional prepared `VoxelBatch` (sharded over a mesh or
    not); without one the batch is gathered onto `device` (None: the
    card)."""
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    batch, A, ib0 = _batch_and_tables(
        dwi, mask, batch, device,
        _design_adc(np.asarray(dwi.bval, np.float32)))
    both = _per_shard(lambda *a: torch.stack(_adc_kernel(*a), dim=1),
                      batch.signals, A, ib0)[:batch.n]
    adc = MRI.like(mask, 1, np.float32)
    s0 = MRI.like(mask, 1, np.float32)
    adc.vol, s0.vol = host_volumes(both, batch.idx, mask.vol.shape[:3],
                                   _ADC_COLS, "dti")
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
    arr = _per_shard(_dti_kernel, batch.signals, A, ib0)[:batch.n]
    vols = host_volumes(arr, batch.idx, mask.vol.shape[:3],
                        _DTI_COLS.values(), "dti")
    out = {}
    for (name, (lo, hi)), v in zip(_DTI_COLS.items(), vols):
        out[name] = MRI.like(mask, hi - lo, np.float32)
        out[name].vol = v
    return DTI(**out)


def dti_write(dti: DTI, basename: str) -> None:
    """Write DTI volumes as <basename>_<field>.nii.gz.
    (reference: src/dti.jl:344-349)"""
    mri_write_struct(dti, basename)
