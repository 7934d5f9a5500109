"""Generalized Q-space Imaging (GQI) reconstruction, in PyTorch.

Counterpart of fibers_tpu/models/gqi.py: one [N, nvol] x [nvol, nvert]
product over the masked voxel batch, the face-neighbour peak mask, and a
top-k in place of the reference's per-voxel sortperm (reference:
src/gqi.jl:109-171).  On a CUDA batch the product, the peak mask and the
per-voxel stats run in one hand-written kernel
(ops/kernels/gqi_fused.py); on a CPU batch in plain PyTorch.

Yeh et al. (2010), IEEE TMI 29(9):1626-1635.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.handoff import DevicePeaks
from ..core.lazy import LazyVolume
from ..core.mri import MRI
from ..core.odf import ODF, half_sphere
from ..io.dispatch import mri_write_struct
from ..ops.kernels.gqi_fused import gqi_fused
from ..ops.peaks import build_neighbors, peak_mask, top_peaks

__all__ = ["GQI", "gqi_rec", "gqi_write", "find_peaks", "gqi_design"]

NPEAK = 3


@dataclass
class GQI:
    """Outputs of a GQI fit.  (reference: src/gqi.jl:10-14)

    `_peak_dev` keeps the peak batch on the device for the tractography
    handoff (core.handoff.DevicePeaks); never written by `gqi_write`."""

    odf: MRI
    peak: List[MRI]
    qa: List[MRI]
    _peak_dev: object = None


def gqi_design(bval: np.ndarray, bvec: np.ndarray, odf_dirs: ODF,
               sigma: float = 1.25) -> np.ndarray:
    """System matrix A [nvert, nvol] = sinc(V_half (bvec sqrt(b*0.01506)
    sigma/pi)^T), normalized sinc.  (reference: src/gqi.jl:66-69)

    A copy of fibers_tpu/models/gqi.py:gqi_design (that module imports
    jax at its top)."""
    nvert = odf_dirs.nvert_half
    verts = odf_dirs.vertices[nvert:].astype(np.float64)
    bq = bvec.astype(np.float64) * (
        np.sqrt(bval.astype(np.float64) * 0.01506)[:, None] * (sigma / np.pi))
    return np.sinc(verts @ bq.T).astype(np.float32)


def _finish(odf, vals, idx, pvalid, odfmin, odfmean, valid, verts_first):
    """Peak vectors, QA normalised by the global max mean ODF, and the ODF
    zeroed outside valid voxels (reference: src/gqi.jl:154-168)."""
    zero = torch.zeros((), dtype=odf.dtype, device=odf.device)
    pvalid = pvalid & valid[:, None]
    # peak directions come from the FIRST half of the vertex table, the
    # antipodes of the directions in A (reference: src/gqi.jl:154-155)
    vecs = torch.where(pvalid[..., None], verts_first[idx], zero)
    qa = torch.where(pvalid, vals - odfmin[:, None], zero)
    odfmax = torch.where(valid, odfmean, zero).max()
    qa = qa / torch.clamp_min(odfmax, 1e-30)
    odf = torch.where(valid[:, None], odf, zero)
    return odf, vecs, qa, valid


def _gqi_kernel_fused(signals, A_t, verts_first, nbr, nbr_valid,
                      npeak=NPEAK):
    """signals [N, nvol] -> odf [N, nvert], peak vecs [N, npeak, 3], qa
    [N, npeak] (globally normalised), valid [N].  Product, peak mask and
    stats come from the fused tile (the CUDA kernel on a CUDA batch, its
    plain version on a CPU batch), then top-k, peak vectors, QA and the
    odfmax normalisation."""
    odf, is_peak, stats = gqi_fused(signals, A_t, nbr, nbr_valid)
    valid = stats[:, 2] > 0
    vals, idx, pvalid = top_peaks(odf, is_peak, npeak)
    return _finish(odf, vals, idx, pvalid, stats[:, 0], stats[:, 1], valid,
                   verts_first)


def find_peaks(o, odf_dirs: ODF):
    """Local-maximum vertices of ODF amplitudes `o` [..., nvert_half],
    sorted descending.  Returns (sorted indices, count of valid peaks),
    as numpy.  (reference: src/gqi.jl:180-201)"""
    _, _, faces0 = half_sphere(odf_dirs)
    nbr, ok = build_neighbors(faces0, odf_dirs.nvert_half)
    o = torch.as_tensor(np.asarray(o))
    mask = peak_mask(o, torch.from_numpy(nbr), torch.from_numpy(ok))
    masked = torch.where(mask, o, torch.zeros((), dtype=o.dtype))
    order = torch.argsort(-masked, dim=-1, stable=True)
    nvalid = (masked > 0).sum(dim=-1)
    return order.numpy(), nvalid.numpy()


def gqi_rec(dwi: MRI, mask: MRI, odf_dirs: ODF = None,
            sigma: float = 1.25, impl: str = "auto", batch=None,
            device=None) -> GQI:
    """GQI reconstruction of DWIs.  (reference: src/gqi.jl:109-171)

    Returns a `GQI` with half-sphere ODF amplitudes, the top-3 peak
    orientation vectors and the quantitative anisotropy of each peak.

    `impl`: "auto" runs the hand-written kernel on a CUDA batch and its
    plain PyTorch version on a CPU batch; "kernel" demands the kernel (and
    raises on a CPU batch).  `batch`: an
    optional prepared `VoxelBatch`; without one the batch is gathered
    onto `device` (None: the card).
    """
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    if dwi.bvec is None or np.asarray(dwi.bvec).size == 0:
        raise ValueError("Missing gradient table from input DWI structure")
    if impl not in ("auto", "kernel"):
        raise ValueError(f"Unknown impl {impl!r} (expected auto/kernel)")
    if odf_dirs is None:
        from ..core import odf as _odf
        odf_dirs = _odf.sphere_642

    nvert = odf_dirs.nvert_half
    A = gqi_design(np.asarray(dwi.bval, np.float32),
                   np.asarray(dwi.bvec, np.float32), odf_dirs, sigma)
    _, verts_first, faces0 = half_sphere(odf_dirs)
    nbr, nbr_ok = build_neighbors(faces0, nvert)

    if batch is None:
        from ..core.batch import prepare_batch
        batch = prepare_batch(dwi, mask, device=device)
    idx, signals = batch.idx, batch.signals
    dev = signals.device

    if impl == "kernel" and dev.type != "cuda":
        raise ValueError(f"gqi_rec(impl='kernel') needs a CUDA batch, got "
                         f"one on {dev}")
    vf = torch.from_numpy(np.ascontiguousarray(verts_first)).to(dev)
    nb = torch.from_numpy(nbr).to(dev)
    ok = torch.from_numpy(nbr_ok).to(dev)
    A_t = torch.from_numpy(np.ascontiguousarray(A.T)).to(dev)
    odf_b, vecs_b, qa_b, _ = _gqi_kernel_fused(signals, A_t, vf, nb, ok)

    # every large output stays on the device: the volumes materialize on
    # the host on first access, and DevicePeaks feeds tractography
    shape3 = mask.vol.shape[:3]
    odf = MRI.like(mask, nvert, np.float32)
    odf.vol = LazyVolume(odf_b, idx, shape3, nvert)
    peak, qa = [], []
    for ip in range(NPEAK):
        pm = MRI.like(mask, 3, np.float32)
        pm.vol = LazyVolume(vecs_b[:, ip, :], idx, shape3, 3)
        peak.append(pm)
        qm = MRI.like(mask, 1, np.float32)
        qm.vol = LazyVolume(qa_b[:, ip], idx, shape3, 1)
        qa.append(qm)
    return GQI(odf=odf, peak=peak, qa=qa,
               _peak_dev=DevicePeaks(vecs=vecs_b, amp=qa_b, idx=idx,
                                     ref=mask))


def gqi_write(gqi: GQI, basename: str) -> None:
    """Write GQI volumes as <basename>_<field>[i].nii.gz.
    (reference: src/gqi.jl:210-225)"""
    mri_write_struct(gqi, basename)
