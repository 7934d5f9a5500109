"""RUMBA-SD: robust and unbiased model-based spherical deconvolution, in
PyTorch.

Counterpart of fibers_tpu/models/rumba.py: the whole-brain matrix
iteration of the reference (src/rusd.jl:241-339) as one update step over
the [N, ndir] / [N, ncomp] voxel batch, run in a Python loop: the
Richardson-Lucy ratio from two products with the multi-tensor kernel, the
Rician likelihood through Perron's continued fraction for the Bessel
ratio, the total-variation multiplier, and the noise-variance and lambda
updates.

The TV term runs on the mask's bounding box plus a one-voxel halo.  With
`tv_bf16=False` (the default) it is one hand-written kernel over the fODF
row table (ops/kernels/tv_fused.py); with `tv_bf16=True` the rows are
embedded into a dense bf16 stack, the dense stencil kernel runs on it
(ops/kernels/tv_stencil.py), and the multiplier is gathered back.  On a
CPU batch both run their plain PyTorch versions.

Canales-Rodriguez et al. (2015), PLoS ONE 10(10):e0138910.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.handoff import DevicePeaks, split_unit_amp
from ..core.lazy import LazyVolume
from ..core.mri import MRI
from ..core.odf import ODF
from ..device import resolve
from ..io.dispatch import mri_write_struct
from ..ops.kernels.tv_fused import build_tables, embed_index, tv_fused
from ..ops.kernels.tv_stencil import tv_multiplier
from ..ops.masked import mask_indices
from ..utils.coords import ang2rot, cart2sph

__all__ = ["RUMBASD", "rumba_rec", "rumba_write", "rumba_peaks",
           "tensor_model", "besseli_ratio", "PaceAbortError"]


class PaceAbortError(RuntimeError):
    """The reference raises this from rumba_rec(abort_s_per_iter=...).
    Pace aborts are not carried over to the port (a workaround for a
    TPU runtime); the class stays importable for API parity."""


NPEAK = 5
FTHRESH = 0.1
_PRECISIONS = ("default", "high", "highest")


@dataclass
class RUMBASD:
    """Outputs of a RUMBA-SD fit.  (reference: src/rusd.jl:11-20)

    `_peak_dev` keeps the peak batch on the device (unit directions and
    volume-fraction amplitudes) for `peaks_to_ovecs(rec, device=True)`;
    it is never written by `rumba_write`."""

    fodf: MRI
    fgm: MRI
    fcsf: MRI
    peak: List[MRI]
    gfa: MRI
    var: MRI
    snr_mean: float
    snr_std: float
    _peak_dev: object = None


def tensor_model(phi, theta, lam, b, g, s0=1.0):
    """Expected DWI signal of an axially-oriented tensor.
    (reference: src/rusd.jl:141-153)"""
    lam = np.asarray(lam, np.float64)
    if lam.shape[-1] != 3:
        raise ValueError(f"Length of diffusivity vector {lam} must be 3")
    r = ang2rot(phi, theta)
    d = r @ np.diag(lam) @ r.T
    quad = np.einsum("vi,ij,vj->v", g, d, g)
    return s0 * np.exp(-np.asarray(b, np.float64) * quad)


def besseli_ratio(nu, z):
    """I_nu(z) / I_{nu-1}(z) by Perron's continued fraction; z a number,
    numpy array or tensor.  (reference: src/rusd.jl:170-177)"""
    return z / ((2 * nu + z)
                - ((2 * nu + 1) * z
                   / (2 * z + (2 * nu + 1)
                      - ((2 * nu + 3) * z
                         / ((2 * nu + 2) + 2 * z
                            - ((2 * nu + 5) * z
                               / ((2 * nu + 3) + 2 * z)))))))


def _build_kernel(bval, bvec, odf_dirs, lam_para, lam_perp, lam_csf, lam_gm):
    """Multi-tensor reconstruction kernel [ndir, nvert + 2] and the b0
    flags.  (reference: src/rusd.jl:447-517)"""
    ib0 = bval == bval.min()
    gsub = bvec[~ib0]
    gnorm = np.sqrt((gsub ** 2).sum(axis=1, keepdims=True))
    with np.errstate(invalid="ignore"):
        gsub = np.where(gnorm > 0, gsub / gnorm, 0.0)
    g = np.vstack([np.zeros((1, 3)), gsub])
    b = np.concatenate([[0.0], bval[~ib0]])

    nvert = odf_dirs.nvert_half
    verts2 = odf_dirs.vertices[nvert:]           # second half, like the ref
    phi, theta, _ = cart2sph(verts2[:, 0], verts2[:, 1], verts2[:, 2])
    theta = -theta

    kernel = np.zeros((len(b), nvert + 2), np.float64)
    for iv in range(nvert):
        kernel[:, iv] = tensor_model(phi[iv], theta[iv],
                                     [lam_para, lam_perp, lam_perp], b, g)
    kernel[:, nvert] = tensor_model(0.0, 0.0, [lam_csf] * 3, b, g)
    kernel[:, nvert + 1] = tensor_model(0.0, 0.0, [lam_gm] * 3, b, g)
    return kernel.astype(np.float32), ib0


def _angular_neighbors(odf_dirs: ODF):
    """Padded neighbour table within the angular neighbourhood used for
    peak NMS.  (reference: src/rusd.jl:477-493)"""
    nvert = odf_dirs.nvert_half
    half = odf_dirs.vertices[:nvert].astype(np.float64)
    ang_neig = 16.0 if nvert * 2 == 362 else 12.5

    cosang = np.clip(half @ half.T, -1.0, 1.0)
    ang = np.degrees(np.arccos(cosang))
    ang = np.minimum(ang, 180.0 - ang)
    isneig = ang < ang_neig
    np.fill_diagonal(isneig, False)

    maxdeg = int(isneig.sum(axis=1).max())
    nbr = np.zeros((nvert, maxdeg), np.int32)
    ok = np.zeros((nvert, maxdeg), bool)
    for v in range(nvert):
        idxs = np.nonzero(isneig[v])[0]
        nbr[v, :len(idxs)] = idxs
        ok[v, :len(idxs)] = True
    return nbr, ok


def _tv_bbox(idx, shape3):
    """Crop the TV grid to the mask bounding box + 1-voxel halo (clamped
    to the volume).  Exact: every gradient/divergence cell a mask voxel
    reads lies within the halo.  Returns (tv_shape3, tv_nxyz, idx_tv, lo)
    with idx_tv the mask voxels' flat indices within the crop and lo the
    crop origin.  (fibers_tpu/models/rumba.py:_tv_bbox)"""
    xyz = np.unravel_index(idx, shape3)
    lo = [max(int(c.min()) - 1, 0) if len(c) else 0 for c in xyz]
    hi = [min(int(c.max()) + 2, s) if len(c) else s
          for c, s in zip(xyz, shape3)]
    tv_shape3 = tuple(h - l for l, h in zip(lo, hi))
    tv_nxyz = int(np.prod(tv_shape3))
    idx_tv = (((xyz[0] - lo[0]) * tv_shape3[1] + (xyz[1] - lo[1]))
              * tv_shape3[2] + (xyz[2] - lo[2])).astype(np.int64)
    return tv_shape3, tv_nxyz, idx_tv, tuple(lo)


def _tv_term(fodf, lam3, tabs, tv_bf16, out):
    """TV multiplier rows of the fODF batch, written into `out` (single
    device; `tabs` from tv_fused.build_tables over the crop).
    (reference: src/rusd.jl:183-235, 282-296)

    f32: the fused row-table kernel.  bf16: embed the bf16 rows into the
    dense crop grid with one gather (the padding row n for cells outside
    the mask, the reference's `_gather_index`), run the dense stencil,
    gather the mask rows back."""
    if not tv_bf16:
        return tv_fused(fodf, lam3, tabs, out)
    n, C = fodf.shape
    rows = torch.cat([fodf.to(torch.bfloat16),
                      fodf.new_zeros((1, C), dtype=torch.bfloat16)])
    v = rows[embed_index(tabs, n)].reshape(tuple(lam3.shape) + (C,))
    tv = tv_multiplier(v, lam3).reshape(-1, C)
    out[:tabs.nmask] = tv[tabs.rowcell.long()]
    return out


def _mm(a, b, precision):
    """The R-L products.  "high"/"highest": f32 (TF32 stays off);
    "default": bf16-rounded operands, f32 accumulation."""
    if precision == "default":
        return torch.matmul(a.bfloat16().float(), b.bfloat16().float())
    return torch.matmul(a, b)


def _rumba_step(fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel,
                idx_mask, n_order, ipat_factor, use_tv, shape3,
                precision="high", tv_bf16=False, tabs=None, tv_buf=None):
    """One RUMBA-SD iteration over the voxel batch.
    (reference: src/rusd.jl:266-339)

    fodf [N, ncomp], dodf and dodf_sig [N, ndir], sig2 [N, 1], lam_flat
    [prod(shape3)] on the TV crop `shape3`, signal [N, ndir], kernel
    [ndir, ncomp], idx_mask the crop cells of the first len(idx_mask)
    rows (later rows are padding).  The TV tables `tabs`
    (tv_fused.build_tables) and the multiplier buffer `tv_buf` are built
    here when not given.
    Returns (fodf, dodf, dodf_sig, sig2, lam_flat, snr)."""
    eps = 1e-7
    nmask = idx_mask.shape[0]

    iratio = besseli_ratio(n_order, dodf_sig)

    rl_num = _mm(signal * iratio, kernel, precision)
    rl_den = _mm(dodf, kernel, precision) + eps
    rl = rl_num / rl_den

    if use_tv:
        if tv_buf is None:
            tv_buf = torch.ones_like(fodf)
        if tabs is None:
            tabs = build_tables(idx_mask.cpu().numpy(), shape3, fodf.device)
        tv = _tv_term(fodf, lam_flat.reshape(shape3), tabs, tv_bf16, tv_buf)
        fodf = torch.clamp_min(fodf * rl * tv, 0.0)
    else:
        fodf = torch.clamp_min(fodf * rl, 0.0)

    dodf = _mm(fodf, kernel.T, precision)
    dodf_sig = (signal * dodf) / sig2

    # Noise-variance update (reference: src/rusd.jl:314-323)
    resid = ((signal ** 2 + dodf ** 2) / 2
             - (sig2 * dodf_sig) * iratio)
    ndir = signal.shape[1]
    sig2 = resid.sum(dim=1, keepdim=True) / (n_order * ndir)
    sig2 = torch.clamp(sig2, (1.0 / 80) ** 2, (1.0 / 8) ** 2)

    # Lambda update (reference: src/rusd.jl:326-339), over the real rows
    if use_tv:
        if ipat_factor == 1:
            m = torch.clamp_min(sig2[:nmask].mean(), (1.0 / 30) ** 2)
            lam_flat = m.expand(lam_flat.shape).contiguous()
        else:
            lam_flat = torch.zeros_like(lam_flat).index_put_(
                (idx_mask,), sig2[:nmask, 0])

    snr = 1.0 / torch.sqrt(sig2)
    return fodf, dodf, dodf_sig, sig2, lam_flat, snr


def _snr_stats(sig2, nmask):
    """Mean and std (ddof=1) of SNR = 1/sigma over the real rows, as two
    device scalars."""
    snr = 1.0 / torch.sqrt(sig2[:nmask, 0])
    m = snr.mean()
    var = ((snr - m) ** 2).sum() / max(nmask - 1, 1)
    return m, torch.sqrt(torch.clamp_min(var, 0.0))


def _rumba_post(fodf, nvert):
    """Energy normalisation, isotropic-fraction embedding and GFA, on the
    device.  (reference: src/rusd.jl:560-596)"""
    fodf = fodf / (fodf.sum(dim=1, keepdim=True) + 1e-7)
    fodf_wm = fodf[:, :nvert]
    fcsf = fodf[:, nvert]
    fgm = fodf[:, nvert + 1]
    f_iso = fcsf + fgm

    fodf_full = fodf_wm + f_iso[:, None]
    s = fodf_full.sum(dim=1, keepdim=True)
    zero = fodf.new_zeros(())
    fodf_full = torch.where(s > 0, fodf_full / torch.clamp_min(s, 1e-30),
                            zero)

    std = fodf_full.std(dim=1, correction=1)
    rms = torch.sqrt((fodf_full ** 2).mean(dim=1))
    gfa = torch.where(rms > 0, std / torch.clamp_min(rms, 1e-30), zero)
    return fodf_full, fgm, fcsf, f_iso, gfa


def _neighbour_max(f, nbr, nbr_ok):
    """max over each vertex's valid angular neighbours (-inf if none),
    one neighbour column at a time so no [..., nvert, maxdeg] gather is
    formed."""
    out = torch.full_like(f, -torch.inf)
    ninf = f.new_full((), -torch.inf)
    for k in range(nbr.shape[1]):
        g = f.index_select(-1, nbr[:, k])
        out = torch.maximum(out, torch.where(nbr_ok[:, k], g, ninf))
    return out


def _rumba_peaks_kernel(fodf_full, f_iso, half_verts, nbr, nbr_ok,
                        fthresh, npeak=NPEAK):
    """Batched peak extraction with angular-neighbourhood NMS and the
    f_iso-scaled threshold; [N, npeak, 3] vectors whose magnitude is the
    peak's volume fraction.  (reference: src/rusd.jl:348-373, 602-633)"""
    thr_xyz = fthresh / torch.clamp_min(1.0 - f_iso, 1e-7)
    thr_abs = thr_xyz * fodf_full.amax(dim=1)

    nbr_max = _neighbour_max(fodf_full, nbr, nbr_ok)
    surv = (fodf_full > nbr_max) & (fodf_full >= thr_abs[:, None])
    zero = fodf_full.new_zeros(())
    masked = torch.where(surv, fodf_full, zero)
    vals, idx = torch.topk(masked, npeak, dim=1)
    pvalid = vals > 0

    amp_sum = (vals * pvalid).sum(dim=1)
    fnorm = (1.0 - f_iso) / torch.clamp_min(amp_sum, 1e-30)

    vecs = half_verts[idx] * (vals * fnorm[:, None])[..., None]
    return torch.where(pvalid[..., None], vecs, zero)


def rumba_peaks(fodf, f_iso, odf_dirs: ODF = None, thr: float = FTHRESH):
    """fODF peak finding with angular-neighbourhood NMS and the f_iso-
    scaled amplitude threshold; batched over leading axes.

    Returns (vertex indices sorted descending by surviving amplitude,
    number of valid peaks) as numpy, the API of the reference's
    `rumba_peaks!` (reference: src/rusd.jl:348-373), vectorised."""
    if odf_dirs is None:
        from ..core import odf as _odf
        odf_dirs = _odf.sphere_724

    nbr, nbr_ok = _angular_neighbors(odf_dirs)
    fodf = torch.as_tensor(np.asarray(fodf))
    f_iso = torch.as_tensor(np.asarray(f_iso))

    thr_xyz = thr / torch.clamp_min(1.0 - f_iso, 1e-7)
    thr_abs = thr_xyz * fodf.amax(dim=-1)
    nbr_max = _neighbour_max(fodf, torch.from_numpy(nbr).long(),
                             torch.from_numpy(nbr_ok))
    surv = (fodf > nbr_max) & (fodf >= thr_abs[..., None])
    masked = torch.where(surv, fodf, fodf.new_zeros(()))
    isort = torch.argsort(-masked, dim=-1, stable=True)
    nvalid = (masked > 0).sum(dim=-1)
    return isort.numpy(), nvalid.numpy()


def _signal_from_batch(signals, ib0_idx, idwi_idx):
    """b0-normalised RUMBA signal matrix from a prepared [N, nvol] voxel
    batch, on its device (reference: src/rusd.jl:450-465).  Zero padding
    rows give all-zero signal rows."""
    b0 = signals.index_select(1, ib0_idx).clamp_min(0).mean(dim=1)
    dwis = signals.index_select(1, idwi_idx).clamp_min(0)
    dwis = torch.where(b0[:, None] > 0,
                       dwis / torch.clamp_min(b0[:, None], 1e-30),
                       signals.new_zeros(()))
    sig = torch.cat([(b0 > 0).to(torch.float32)[:, None], dwis], dim=1)
    return torch.clamp_max(sig, 1.0)


def _signal_host(flat, idx, ib0):
    """The same matrix built on the host from the masked voxels: gather,
    b0 normalisation, clip.  (fibers_tpu/models/rumba.py:746-755)"""
    rows = flat[idx]
    b0_mean = np.maximum(rows[:, ib0], 0).mean(axis=1)
    dwis = np.maximum(rows[:, ~ib0], 0).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        dwis /= b0_mean[:, None].astype(np.float32)
    dwis[~np.isfinite(dwis)] = 0
    np.clip(dwis, 0.0, 1.0, out=dwis)
    return np.concatenate(
        [(b0_mean > 0).astype(np.float32)[:, None], dwis], axis=1)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor, through one pinned buffer for CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _lap(timings, name, t0, dev):
    """Store the wall seconds since `t0` under `name` in `timings` (after
    a device synchronize) when `timings` is a dict; return a new t0."""
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = time.perf_counter() - t0
    return time.perf_counter()


def _load_checkpoint(path, nmask, ncomp, niter, n_rows, lam0, shape3,
                     tv_shape3, tv_lo, tv_nxyz):
    """Host arrays (fodf [n_rows, ncomp], sig2 [n_rows, 1], lam on the TV
    crop) and the iteration of a checkpoint in the reference's npz format
    (version 2, unpadded components; a pre-v2 full-volume lambda is
    remapped onto the crop).  Raises ValueError on a mismatch."""
    with np.load(path) as ck:
        if (int(ck["nmask"]) != nmask or int(ck["ncomp"]) != ncomp
                or int(ck["iteration"]) > niter):
            raise ValueError(
                f"checkpoint {path} does not match this problem "
                f"(checkpoint nmask={int(ck['nmask'])} "
                f"ncomp={int(ck['ncomp'])} "
                f"iteration={int(ck['iteration'])}; expected nmask={nmask} "
                f"ncomp={ncomp} niter>={int(ck['iteration'])}).  Delete "
                "the file to start fresh.")
        fodf_ck = np.asarray(ck["fodf"])
        if fodf_ck.ndim != 2 or fodf_ck.shape[1] < ncomp:
            raise ValueError(
                f"checkpoint {path} fodf shape {fodf_ck.shape} has fewer "
                f"than ncomp={ncomp} columns")
        fodf_h = fodf_ck[:nmask, :ncomp]
        sig2_h = np.asarray(ck["sig2"], np.float32)
        if sig2_h.ndim == 1:
            sig2_h = sig2_h[:, None]
        if sig2_h.ndim != 2 or sig2_h.shape[1] != 1:
            raise ValueError(f"checkpoint {path} sig2 shape "
                             f"{sig2_h.shape} is not a column")
        sig2_h = sig2_h[:nmask]
        if fodf_h.shape[0] < nmask:
            raise ValueError(
                f"checkpoint {path} has fewer rows ({fodf_h.shape[0]}) "
                f"than masked voxels ({nmask})")
        pad = n_rows - nmask
        if pad:
            fodf_h = np.pad(fodf_h, ((0, pad), (0, 0)))
            sig2_h = np.concatenate(
                [sig2_h, np.full((pad, 1), lam0, np.float32)])
        lam_h = np.asarray(ck["lam_flat"]).reshape(-1)
        if lam_h.size != tv_nxyz:
            if lam_h.size == int(np.prod(shape3)):
                # legacy full-volume grid: slice the crop bbox
                sl = tuple(slice(l, l + s) for l, s in zip(tv_lo, tv_shape3))
                lam_h = lam_h.reshape(shape3)[sl].reshape(-1)
            elif np.ptp(lam_h) == 0:
                # spatially constant (the ipat_factor == 1 update)
                lam_h = np.full(tv_nxyz, lam_h.flat[0], np.float32)
            else:
                raise ValueError(
                    f"checkpoint {path} lam_flat size {lam_h.size} matches "
                    f"neither the TV crop ({tv_nxyz}) nor the full volume "
                    f"({int(np.prod(shape3))})")
        return (np.ascontiguousarray(fodf_h, np.float32),
                np.ascontiguousarray(sig2_h), lam_h.astype(np.float32),
                int(ck["iteration"]))


def rumba_rec(dwi: MRI, mask: MRI, odf_dirs: ODF = None,
              niter: int = 600, lam_para: float = 1.7e-3,
              lam_perp: float = 0.2e-3, lam_csf: float = 3.0e-3,
              lam_gm: float = 0.8e-4, ncoils: int = 1,
              coil_combine: str = "SMF-SENSE", ipat_factor: int = 1,
              use_tv: bool = True, verbose: bool = False,
              checkpoint_path: str = None,
              checkpoint_every: int = 0,
              on_mismatch: str = "raise",
              precision: str = "high", batch=None, mesh=None,
              tv_bf16: bool = False, signal_wire: str = "u12",
              abort_s_per_iter: float = None, device=None,
              timings: dict = None) -> RUMBASD:
    """RUMBA-SD reconstruction of DWIs.  (reference: src/rusd.jl:419-636)

    Keywords and defaults are those of fibers_tpu.rumba_rec.  With
    `checkpoint_path` set, the state (fodf, sigma^2, lambda) is saved
    every `checkpoint_every` iterations in the reference's npz format, and
    the fit resumes from an existing checkpoint, written by this package
    or by fibers_tpu.  A checkpoint of another problem raises
    `ValueError`; `on_mismatch="fresh"` warns and starts from scratch.

    `precision` of the R-L products: "high" (default) and "highest" run
    in f32 with TF32 off; "default" rounds the operands to bf16 and
    accumulates in f32.  `tv_bf16` runs the TV stencil on a bf16 stack
    (differences in bf16, the rest in f32); the estimate stays f32.

    `batch`: a prepared `VoxelBatch` to reuse one gather and upload; the
    b0 normalisation then runs on its device.  Without one the signal
    matrix is built on the host and uploaded to `device` (None: the card)
    once, in exact f32.  `signal_wire` is accepted for API
    parity: the reference's u12/u16 upload codecs are not ported (ROADMAP
    A14), so every value uploads exact f32.

    Not carried over: `mesh=` (ROADMAP A13) and the pace aborts of
    `abort_s_per_iter` (a workaround for a TPU runtime), which raise
    `NotImplementedError` unless left None.

    `timings`: a dict that receives the wall seconds of the stages
    "signal" (kernel, signal matrix, upload), "iterate" and "post" (SNR,
    normalisation, GFA, peaks), each ended by a device synchronize.
    """
    if signal_wire not in ("u12", "u16", "f32"):
        raise ValueError(f"signal_wire must be u12/u16/f32, "
                         f"got {signal_wire!r}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got "
                         f"{precision!r}")
    if mesh is not None:
        raise NotImplementedError(
            "rumba_rec(mesh=): multi-device RUMBA-SD is not ported yet "
            "(ROADMAP A13)")
    if abort_s_per_iter is not None:
        raise NotImplementedError(
            "rumba_rec(abort_s_per_iter=): pace aborts are not carried over "
            "to the PyTorch port; leave it None")
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    if dwi.bvec is None or np.asarray(dwi.bvec).size == 0:
        raise ValueError("Missing gradient table from input DWI structure")

    n_order = 1
    if coil_combine == "SoS-GRAPPA":
        n_order = ncoils
    elif coil_combine != "SMF-SENSE":
        raise ValueError(f"Unknown coil combine mode {coil_combine}")
    if ipat_factor < 1:
        raise ValueError("iPAT factor must be a positive integer")
    if on_mismatch not in ("raise", "fresh"):
        raise ValueError(f"on_mismatch must be 'raise' or 'fresh', "
                         f"got {on_mismatch!r}")

    if odf_dirs is None:
        from ..core import odf as _odf
        odf_dirs = _odf.sphere_724

    t0 = time.perf_counter()
    shape3 = tuple(int(s) for s in mask.vol.shape[:3])
    idx = batch.idx if batch is not None else mask_indices(mask.vol)
    nmask = len(idx)

    bval = np.asarray(dwi.bval, np.float32)
    bvec = np.asarray(dwi.bvec, np.float32)
    kernel, ib0 = _build_kernel(bval, bvec, odf_dirs, lam_para, lam_perp,
                                lam_csf, lam_gm)
    ndir, ncomp = kernel.shape
    nvert = ncomp - 2

    # TV runs on the mask bounding box + halo, not the full volume
    tv_shape3, tv_nxyz, idx_tv, tv_lo = _tv_bbox(idx, shape3)

    # Signal matrix: average b0 first, then DWIs, normalised by b0
    # (reference: src/rusd.jl:450-465)
    if batch is not None:
        dev = batch.signals.device
        signal = _signal_from_batch(
            batch.signals,
            torch.from_numpy(np.flatnonzero(ib0)).to(dev),
            torch.from_numpy(np.flatnonzero(~ib0)).to(dev))
        n_rows = batch.n_pad
    else:
        dev = resolve(device)
        vol = np.asarray(dwi.vol)
        signal = _upload(_signal_host(vol.reshape(-1, vol.shape[3]), idx,
                                      ib0), dev)
        n_rows = nmask

    t0 = _lap(timings, "signal", t0, dev)
    nbr, nbr_ok = _angular_neighbors(odf_dirs)
    half_verts = odf_dirs.vertices[:nvert].astype(np.float32)

    # Initialisation (reference: src/rusd.jl:522-537)
    fodf0 = np.full(ncomp, 1.0 / ncomp, np.float32)
    lam0 = (1.0 / 15) ** 2
    kernel_d = torch.from_numpy(kernel).to(dev)
    fodf = torch.from_numpy(fodf0).to(dev).expand(n_rows, ncomp).clone()
    dodf = torch.from_numpy(kernel @ fodf0).to(dev).expand(
        n_rows, ndir).clone()
    sig2 = torch.full((n_rows, 1), lam0, dtype=torch.float32, device=dev)
    lam_flat = torch.full((tv_nxyz,), lam0, dtype=torch.float32, device=dev)
    idx_d = torch.from_numpy(idx_tv).to(dev)

    it_start = 0
    if checkpoint_path is not None and os.path.isfile(checkpoint_path):
        try:
            fodf_h, sig2_h, lam_h, it_ck = _load_checkpoint(
                checkpoint_path, nmask, ncomp, niter, n_rows, lam0, shape3,
                tv_shape3, tv_lo, tv_nxyz)
        except Exception:
            # a truncated or corrupt npz raises BadZipFile/OSError and a
            # missing key KeyError: all mean "unusable", which is what
            # on_mismatch='fresh' exists to survive
            if on_mismatch == "raise":
                raise
            warnings.warn(
                f"checkpoint {checkpoint_path} does not match this problem "
                "or is unreadable; starting fresh (on_mismatch='fresh')",
                stacklevel=2)
        else:
            fodf = torch.from_numpy(fodf_h).to(dev)
            sig2 = torch.from_numpy(sig2_h).to(dev)
            lam_flat = torch.from_numpy(lam_h).to(dev)
            dodf = torch.matmul(fodf, kernel_d.T)
            it_start = it_ck
            print(f"Resuming RUMBA-SD from iteration {it_start} "
                  f"({checkpoint_path})")
    dodf_sig = (signal * dodf) / sig2

    tabs = tv_buf = None
    if use_tv:
        tv_buf = torch.ones((n_rows, ncomp), dtype=torch.float32,
                            device=dev)
        tabs = build_tables(idx_tv, tv_shape3, dev)

    # Iterate (verbose prints the per-iteration SNR like the reference,
    # reference: src/rusd.jl:543-556)
    snr = 1.0 / torch.sqrt(sig2)
    for it in range(it_start + 1, niter + 1):
        fodf, dodf, dodf_sig, sig2, lam_flat, snr = _rumba_step(
            fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel_d, idx_d,
            n_order, ipat_factor, use_tv, tv_shape3, precision, tv_bf16,
            tabs=tabs, tv_buf=tv_buf)
        if verbose:
            s = snr[:nmask]
            sm = float(s.mean())
            ss = float(s.std(correction=1)) if nmask > 1 else 0.0
            print(f"Iteration {it} of {niter}")
            print(f"Estimated mean SNR (s0/sigma) = {sm} (+-) {ss}")
        if (checkpoint_path is not None and checkpoint_every > 0
                and it % checkpoint_every == 0 and it < niter):
            tmp = checkpoint_path + ".tmp.npz"
            np.savez(tmp, fodf=fodf.cpu().numpy(), sig2=sig2.cpu().numpy(),
                     lam_flat=lam_flat.cpu().numpy(), iteration=it,
                     nmask=nmask, ncomp=ncomp, niter=niter, version=2,
                     n_rows=n_rows, tv_lo=np.asarray(tv_lo),
                     tv_shape3=np.asarray(tv_shape3))
            os.replace(tmp, checkpoint_path)

    t0 = _lap(timings, "iterate", t0, dev)
    sm_d, ss_d = _snr_stats(sig2, nmask)
    snr_mean = float(sm_d)
    snr_std = float(ss_d) if nmask > 1 else 0.0

    # Energy normalisation + iso embedding + GFA + peaks, on the device
    # (reference: src/rusd.jl:560-633)
    fodf_full, fgm_d, fcsf_d, f_iso_d, gfa_d = _rumba_post(fodf, nvert)
    vecs_d = _rumba_peaks_kernel(
        fodf_full, f_iso_d, torch.from_numpy(half_verts).to(dev),
        torch.from_numpy(nbr).long().to(dev),
        torch.from_numpy(nbr_ok).to(dev), FTHRESH)

    # every large output stays on the device until host code reads it
    def vol_of(values, nframes):
        m = MRI.like(mask, nframes, np.float32)
        m.vol = LazyVolume(values, idx, shape3, nframes)
        return m

    unit_d, amp_d = split_unit_amp(vecs_d)
    _lap(timings, "post", t0, dev)
    return RUMBASD(
        fodf=vol_of(fodf_full, nvert),
        fgm=vol_of(fgm_d, 1),
        fcsf=vol_of(fcsf_d, 1),
        peak=[vol_of(vecs_d[:, ip, :], 3) for ip in range(NPEAK)],
        gfa=vol_of(gfa_d, 1),
        var=vol_of(sig2[:, 0], 1),
        snr_mean=snr_mean,
        snr_std=snr_std,
        _peak_dev=DevicePeaks(vecs=unit_d, amp=amp_d, idx=idx, ref=mask),
    )


def rumba_write(rumba: RUMBASD, basename: str) -> None:
    """Write RUMBA-SD volumes as <basename>_<field>[i].nii.gz (scalars as
    .txt).  (reference: src/rusd.jl:645-663)"""
    mri_write_struct(rumba, basename)
