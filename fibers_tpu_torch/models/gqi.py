"""Generalized Q-space Imaging (GQI) reconstruction, in PyTorch.

Counterpart of fibers_tpu/models/gqi.py: one [N, nvol] x [nvol, nvert]
product over the masked voxel batch, the face-neighbour peak mask, and a
top-3 in place of the reference's per-voxel sortperm (reference:
src/gqi.jl:109-171).  On a CUDA batch the product, the peak mask, the
per-voxel stats and the top-3 run in one hand-written kernel
(ops/kernels/gqi_fused.py); on a CPU batch in plain PyTorch.  A batch
sharded over a mesh runs the same calls once per shard; the QA normaliser
is then a maximum over the shards.

Yeh et al. (2010), IEEE TMI 29(9):1626-1635.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.handoff import DevicePeaks
from ..core.lazy import LazyVolume, lazy_peak_volumes
from ..core.mri import MRI
from ..core.odf import ODF, half_sphere
from ..io.dispatch import mri_write_struct
from ..ops.kernels.gqi_fused import gqi_fused
from ..ops.peaks import build_neighbors, peak_mask
from ..parallel.mesh import map_shards, per_shard, replicate, shard_max
from ..utils.profiling import span

__all__ = ["GQI", "gqi_rec", "gqi_write", "find_peaks", "gqi_design"]


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


def _odfmax(odfmean, valid):
    """The batch's max mean ODF over valid voxels (a device scalar)."""
    return torch.where(valid, odfmean, odfmean.new_zeros(())).max()


def _finish(odf, vals, idx, pvalid, odfmin, odfmean, valid, verts_first,
            odfmax=None):
    """Peak vectors, QA normalised by the global max mean ODF (this
    batch's unless `odfmax` gives it), and the ODF zeroed outside valid
    voxels (reference: src/gqi.jl:154-168)."""
    zero = torch.zeros((), dtype=odf.dtype, device=odf.device)
    pvalid = pvalid & valid[:, None]
    # peak directions come from the FIRST half of the vertex table, the
    # antipodes of the directions in A (reference: src/gqi.jl:154-155)
    vecs = torch.where(pvalid[..., None], verts_first[idx], zero)
    qa = torch.where(pvalid, vals - odfmin[:, None], zero)
    if odfmax is None:
        odfmax = _odfmax(odfmean, valid)
    qa = qa / torch.clamp_min(odfmax, 1e-30)
    odf = torch.where(valid[:, None], odf, zero)
    return odf, vecs, qa, valid


def _gqi_kernel_fused(signals, A_t, verts_first, nbr, nbr_valid):
    """signals [N, nvol] -> odf [N, nvert], peak vecs [N, 3, 3], qa
    [N, 3] (globally normalised), valid [N].  Product, peak mask, stats
    and the top-3 peaks come from the fused tile (the CUDA kernel on a
    CUDA batch, its plain version on a CPU batch), then peak vectors, QA
    and the odfmax normalisation.  On a `ShardedRows` batch, with the
    tables {device: tensor} (`replicate`), the kernel runs once per shard
    and the QA normaliser is the maximum over every shard."""
    odf, _, stats, vals, idx = map_shards(gqi_fused, signals, A_t, nbr,
                                          nbr_valid)
    valid = map_shards(lambda st: st[:, 2] > 0, stats)
    odfmax = shard_max(per_shard(lambda st, v: _odfmax(st[:, 1], v), stats,
                                 valid), getattr(signals, "mesh", None))
    return map_shards(
        lambda o, va, ix, st, v, vf, m: _finish(o, va, ix, va > 0, st[:, 0],
                                                st[:, 1], v, vf, m),
        odf, vals, idx, stats, valid, verts_first, odfmax)


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
    raises on a CPU batch).  `batch`: an optional prepared `VoxelBatch`,
    sharded over a mesh or not; without one the batch is gathered onto
    `device` (None: the card).
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

    if batch is None:
        from ..core.batch import prepare_batch
        batch = prepare_batch(dwi, mask, device=device)
    idx, signals = batch.idx, batch.signals
    dev = signals.device

    if impl == "kernel" and dev.type != "cuda":
        raise ValueError(f"gqi_rec(impl='kernel') needs a CUDA batch, got "
                         f"one on {dev}")
    nvert = odf_dirs.nvert_half
    with span("gqi.tables"):
        A = gqi_design(np.asarray(dwi.bval, np.float32),
                       np.asarray(dwi.bvec, np.float32), odf_dirs, sigma)
        _, verts_first, faces0 = half_sphere(odf_dirs)
        nbr, nbr_ok = build_neighbors(faces0, nvert)
        vf, nb, ok, A_t = (replicate(t, batch.mesh, dev)
                           for t in (verts_first, nbr, nbr_ok, A.T))
    odf_b, vecs_b, qa_b, _ = _gqi_kernel_fused(signals, A_t, vf, nb, ok)

    # every large output stays on the device: the volumes materialize on
    # the host on first access, and DevicePeaks feeds tractography
    shape3 = mask.vol.shape[:3]

    def lazy(vol, nframes):
        out = MRI.like(mask, nframes, np.float32)
        out.vol = vol
        return out

    # the three peak and three QA volumes reach the host in one copy
    peak_v, qa_v = lazy_peak_volumes(vecs_b, qa_b, idx, shape3)
    return GQI(odf=lazy(LazyVolume(odf_b, idx, shape3, nvert), nvert),
               peak=[lazy(v, 3) for v in peak_v],
               qa=[lazy(v, 1) for v in qa_v],
               _peak_dev=DevicePeaks(vecs=vecs_b, amp=qa_b, idx=idx,
                                     ref=mask))


def gqi_write(gqi: GQI, basename: str) -> None:
    """Write GQI volumes as <basename>_<field>[i].nii.gz.
    (reference: src/gqi.jl:210-225)"""
    mri_write_struct(gqi, basename)
