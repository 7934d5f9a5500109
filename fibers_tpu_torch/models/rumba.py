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
(ops/kernels/tv_stencil.py), and the multiplier is gathered back.  The
row passes around the products are two hand-written kernels
(ops/kernels/rumba_step.py): `rumba_update`, the fODF update, and
`rumba_refit`, the noise-variance refit with the next iteration's Bessel
ratio and numerator operand.  On the card the three products run the
reference's matrix-unit routes in a hand-written tensor-core kernel
(ops/kernels/rl_gemm.py: "high" 3-pass bf16, "default" 1-pass), num and
den in one launch, so an iteration is two product launches, the TV
kernel and two row passes (the reference's `_rumba_block` program).  On
a CPU batch all of them run their plain PyTorch versions, and the
products are the f32 ones JAX's CPU computes ("default": bf16-rounded
operands).

Canales-Rodriguez et al. (2015), PLoS ONE 10(10):e0138910.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import native
from ..core.batch import (_gather_rows, _quantize_pack_u12, decoder,
                          place_rows, u12_row_bytes, wire_dtypes)
from ..core.handoff import DevicePeaks, split_unit_amp
from ..core.lazy import LazyVolume
from ..core.mri import MRI
from ..core.odf import ODF
from ..device import resolve, upload
from ..io.dispatch import mri_write_struct
from ..ops.kernels.rl_gemm import pack_rl, rl_gemm
from ..ops.kernels.rumba_step import besseli_ratio, rumba_refit, rumba_update
from ..ops.kernels.tv_fused import build_tables, embed_index, tv_fused
from ..ops.kernels.tv_stencil import tv_multiplier
from ..ops.masked import mask_indices
from ..ops.peaks import topk_lower_first
from ..parallel.mesh import (ShardedRows, as_mesh, as_tensor,
                             components_to_rows, map_shards, pad_to_multiple,
                             per_device, put_batch, put_rows, replicate,
                             resolve_mesh, row_mean, rows_to_components,
                             spread)
from ..utils.coords import ang2rot, cart2sph
from ..utils.profiling import lap, span

__all__ = ["RUMBASD", "rumba_rec", "rumba_write", "rumba_peaks",
           "tensor_model", "besseli_ratio", "PaceAbortError"]


class PaceAbortError(RuntimeError):
    """The reference raises this from rumba_rec(abort_s_per_iter=...).
    Pace aborts are not carried over to the port (a workaround for a
    TPU runtime); the class stays importable for API parity."""


NPEAK = 5
FTHRESH = 0.1
_PRECISIONS = ("default", "high", "highest")
# the passes of the card's tensor-core routes (ops/kernels/rl_gemm.py)
_PASSES = {"high": 3, "default": 1}


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


def _tensor_cores(a, precision):
    """Whether a product of `a` runs `rl_gemm`: "high" and "default" on
    the card."""
    return a.device.type == "cuda" and precision in _PASSES


def _pack_products(kernel, precision):
    """`rl_gemm`'s planes of the kernel matrix and of its transpose, for
    the products of a fit at `precision` on `kernel`'s device; (None,
    None) where they take no `rl_gemm` (the CPU, "highest")."""
    if not _tensor_cores(kernel, precision):
        return None, None
    return pack_rl(kernel), pack_rl(kernel.T.contiguous())


def _mm(a, b, precision, packed=None):
    """One R-L product a @ b (reference: fibers_tpu/models/rumba.py:46-55).
    On the card "high" is `rl_gemm`'s 3-pass bf16 tensor-core product and
    "default" its 1-pass one, with `b`'s planes `packed` (`pack_rl`;
    packed here when None); "highest" is the f32 product (TF32 stays
    off).  On the CPU "high" and "highest" are the f32 product, which
    JAX's CPU computes at every precision, and "default" the product of
    the bf16-rounded operands with f32 accumulation."""
    if _tensor_cores(a, precision):
        if packed is None:
            packed = pack_rl(b.contiguous())
        return rl_gemm(a, packed, _PASSES[precision])
    if precision == "default":
        return torch.matmul(a.bfloat16().float(), b.bfloat16().float())
    return torch.matmul(a, b)


def _update_rows(fodf, x, dodf, tv, kernel, precision, packed):
    """The Richardson-Lucy update of the fODF rows: the two products (one
    `rl_gemm` launch on the card, `packed` the kernel's planes), then
    `rumba_update` written over the numerator's buffer.  `x` is
    signal * besseli_ratio(n_order, dodf_sig) (`rumba_refit`), `tv` the
    multiplier rows or None."""
    if _tensor_cores(x, precision):
        num, den = rl_gemm(x, packed, _PASSES[precision], a2=dodf)
    else:
        num = _mm(x, kernel, precision)
        den = _mm(dodf, kernel, precision)
    return rumba_update(fodf, num, den, tv, out=num)


def _refit_rows(fodf, signal, dodf_sig, sig2, kernel, n_order, precision,
                x, packed_t):
    """dODF of the new fODF (`packed_t` the transpose's planes on the
    card), then `rumba_refit`: its signal ratio, the noise variance
    (reference: src/rusd.jl:305-323) and the next iteration's x, written
    over this iteration's `x`.  Returns (dodf, dodf_sig, sig2, x)."""
    dodf = _mm(fodf, kernel.T, precision, packed_t)
    return (dodf,) + rumba_refit(signal, dodf_sig, n_order, dodf, sig2,
                                 out=x)


def _first_x(signal, dodf_sig, n_order):
    """x of a first iteration (a fresh start or a resumed checkpoint):
    `rumba_refit`'s first-iteration mode."""
    return rumba_refit(signal, dodf_sig, n_order)[2]


def _rumba_step(fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel,
                idx_mask, n_order, ipat_factor, use_tv, shape3,
                precision="high", tv_bf16=False, x=None, packs=None,
                tv=None):
    """One RUMBA-SD iteration over the voxel batch, on one device or, on
    `ShardedRows` state, once per shard of a mesh.
    (reference: src/rusd.jl:266-339)

    fodf [N, ncomp], dodf and dodf_sig [N, ndir], sig2 [N, 1] and signal
    [N, ndir] are tensors or `ShardedRows`; lam_flat [prod(shape3)] on the
    TV crop `shape3`, kernel [ndir, ncomp] and idx_mask (the crop cells of
    the first len(idx_mask) rows; later rows are padding) are tensors, or
    on a mesh {device: tensor} (`replicate`).  `tv` is the TV term
    (`_tv_fn`) and `packs` the products' planes (`_pack_products`, per
    device on a mesh); on one device both are built here when not given.
    `x` [N, ndir] is the numerator operand the previous iteration
    returned, which this one overwrites with the next (None: computed from
    dodf_sig).  The other arguments are left as they are.  Lambda and the noise variance's mean
    take the real rows of every shard.
    Returns (fodf, dodf, dodf_sig, sig2, lam_flat, snr, x), the last the
    next iteration's x."""
    nmask = as_tensor(idx_mask).shape[0]
    if x is None:
        x = map_shards(lambda s, ds: _first_x(s, ds, n_order), signal,
                       dodf_sig)
    if packs is None:
        packs = per_device(lambda k: _pack_products(k, precision), kernel)

    t = None
    if use_tv:
        if tv is None:
            tv = _tv_fn(None, idx_mask.cpu().numpy(), shape3, *fodf.shape,
                        tv_bf16, fodf.device)
        t = tv(fodf, lam_flat)
    fodf = map_shards(
        lambda f, x_, d, t_, k, p: _update_rows(f, x_, d, t_, k, precision,
                                                p[0]),
        fodf, x, dodf, t, kernel, packs)
    del t
    dodf, dodf_sig, sig2, x = map_shards(
        lambda f, s, ds, s2, k, x_, p: _refit_rows(f, s, ds, s2, k, n_order,
                                                   precision, x_, p[1]),
        fodf, signal, dodf_sig, sig2, kernel, x, packs)

    # Lambda update (reference: src/rusd.jl:326-339), over the real rows
    if use_tv:
        lam0 = as_tensor(lam_flat)
        if ipat_factor == 1:
            m = torch.clamp_min(row_mean(sig2, nmask), (1.0 / 30) ** 2)
            lam_flat = per_device(lambda t: t.expand(lam0.shape).contiguous(),
                                  spread(m, lam_flat))
        else:
            lam_flat = spread(torch.zeros_like(lam0).index_put_(
                (as_tensor(idx_mask),),
                as_tensor(sig2[:nmask], lam0.device)[:, 0]), lam_flat)

    snr = map_shards(lambda s: 1.0 / torch.sqrt(s), sig2)
    return fodf, dodf, dodf_sig, sig2, lam_flat, snr, x


def _row_tv(tabs, shape3, tv_bf16, buf):
    """RUMBA's TV term on one device: `_tv_term` over the crop's row
    tables, written into `buf`; called as `_MeshTV` is."""
    return lambda fodf, lam_flat: _tv_term(fodf, lam_flat.reshape(shape3),
                                           tabs, tv_bf16, buf)


def _tv_fn(mesh, idx_tv, tv_shape3, n_rows, ncomp, tv_bf16, device):
    """The TV term of a fit, `(fodf, lam_flat) -> multiplier rows`, built
    once: `_row_tv` with its buffer and tables on `device`, or `_MeshTV`
    over `mesh`."""
    if mesh is not None:
        return _MeshTV.build(mesh, idx_tv, tv_shape3, n_rows, ncomp, tv_bf16)
    buf = torch.ones((n_rows, ncomp), dtype=torch.float32, device=device)
    return _row_tv(build_tables(idx_tv, tv_shape3, device), tv_shape3,
                   tv_bf16, buf)


def mesh_tv_width(ncomp: int, ndev: int) -> int:
    """Components per device in the TV reshard: C split over `ndev`
    devices, rounded up to a multiple of 4 so that each cell's row is a
    multiple of 16 bytes (f32) or 8 (bf16), which the stencil kernel
    stages with its wide copies (csrc/tv_common.cuh:sweep_copy_bytes).
    The padding components are zero and are cut after the kernel."""
    return pad_to_multiple(-(-ncomp // ndev), 4)


@dataclass
class _MeshTV:
    """RUMBA's TV term on a mesh (fibers_tpu/models/rumba.py:220-281): the
    row-sharded fODF, its components padded with zeros to `width` per
    mesh device (`mesh_tv_width`), resharded so each device holds every
    row of its components; each device embeds its [X, Y, Z, width] stack
    into the crop (`embed`: cell -> row, the zero row n for cells outside
    the mask), runs `tv_multiplier` on it, gathers the rows back (`back`:
    row -> cell, cell 0 for padding rows, whose fODF is zero) and the
    multiplier reshards to rows.  `embed`/`back` are per device, as is
    the flat lambda it is called with."""

    shape3: tuple
    ncomp: int
    width: int
    embed: dict
    back: dict
    dtype: torch.dtype

    @classmethod
    def build(cls, mesh, idx_tv, tv_shape3, n_rows, ncomp, tv_bf16):
        nxyz = int(np.prod(tv_shape3))
        nmask = len(idx_tv)
        if nmask and (int(idx_tv.min()) < 0 or int(idx_tv.max()) >= nxyz):
            raise ValueError("rumba: TV cells outside the crop")
        if nmask > n_rows:
            raise ValueError("rumba: more mask voxels than batch rows")
        cellrow = np.full(nxyz, n_rows, np.int64)
        cellrow[idx_tv] = np.arange(nmask)
        rowcell = np.zeros(n_rows, np.int64)
        rowcell[:nmask] = idx_tv
        return cls(tuple(tv_shape3), ncomp, mesh_tv_width(ncomp, mesh.size),
                   replicate(cellrow, mesh), replicate(rowcell, mesh),
                   torch.bfloat16 if tv_bf16 else torch.float32)

    def __call__(self, fodf: ShardedRows, lam_flat: dict) -> ShardedRows:
        pad = self.width * fodf.mesh.size - self.ncomp
        x = fodf.map(lambda f: torch.nn.functional.pad(
            f.to(self.dtype), (0, pad)))
        out = {}
        for k, blk in rows_to_components(x, self.width).items():
            d = blk.device
            rows = torch.cat([blk, blk.new_zeros((1, self.width))])
            v = rows[self.embed[d]].reshape(self.shape3 + (self.width,))
            tv = tv_multiplier(v, lam_flat[d].reshape(self.shape3)).reshape(
                -1, self.width)
            out[k] = tv[self.back[d]]
        return components_to_rows(out, x).map(lambda t: t[:, :self.ncomp])


def _snr_stats(sig2, nmask):
    """Mean and std (ddof=1) of SNR = 1/sigma over the real rows, as two
    device scalars (over every shard of a ShardedRows)."""
    snr = map_shards(lambda s: 1.0 / torch.sqrt(s[:, 0]), sig2[:nmask])
    m, var = row_mean(snr, nmask, var=True)
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
    vals, idx = topk_lower_first(masked, npeak)
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


def _signal_rows(rows, ib0_idx, idwi_idx):
    """`_signal_host`'s normalisation of raw [N, nvol] rows, on their
    device: b0 mean of the clamped b0 columns, the clamped DWI columns
    over it with every non-finite quotient set to 0 (a NaN or inf sample,
    a zero or NaN b0), clipped to [0, 1], the b0 flag first.  Zero rows
    give zero rows."""
    b0 = rows.index_select(1, ib0_idx).clamp_min(0).mean(dim=1)
    dwis = rows.index_select(1, idwi_idx).clamp_min(0) / b0[:, None]
    dwis = torch.where(torch.isfinite(dwis), dwis,
                       rows.new_zeros(())).clamp_(0.0, 1.0)
    return torch.cat([(b0 > 0).to(torch.float32)[:, None], dwis], dim=1)


def _signal_f32(flat, idx, ib0, device, mesh=None):
    """`_signal_host`'s matrix built on the card: the raw masked rows
    gathered into a pinned buffer (the native OpenMP gather when the
    volume is C-contiguous float32), copied to `device` once, or over
    `mesh` once per shard with zero pad rows, and normalised there by
    `_signal_rows`.  The b0 mean is summed in another order than numpy's,
    so rows agree with `_signal_host`'s to float rounding."""
    nmask, nvol = len(idx), flat.shape[1]
    n = nmask if mesh is None else pad_to_multiple(nmask, mesh.ndata)
    devs = mesh.data_devices if mesh is not None else [torch.device(device)]
    host = torch.empty((n, nvol), dtype=torch.float32,
                       pin_memory=any(d.type == "cuda" for d in devs))
    h = host.numpy()
    _gather_rows(flat, idx, None, 0.0, out=h[:nmask])
    h[nmask:] = 0
    ib0_i, idwi_i = np.flatnonzero(ib0), np.flatnonzero(~ib0)

    def normalise(rows):
        return _signal_rows(rows, torch.from_numpy(ib0_i).to(rows.device),
                            torch.from_numpy(idwi_i).to(rows.device))
    return place_rows(host, normalise, device, mesh)


def _signal_wire(flat, idx, ib0, quantize, device, mesh=None):
    """`_signal_host`'s matrix through the u12 or u16 upload wire (scale
    1/4095 or 1/65535 of the [0, 1] signal): one fused OpenMP pass of
    gather, b0 normalisation, clip and quantization fills a pinned
    buffer (numpy when the native library is missing or the volume is
    not C-contiguous float32), copied to `device` once, or over `mesh`
    once per shard with zero pad rows, and decoded there.
    (fibers_tpu/models/rumba.py:697-775)"""
    nmask, ncol = len(idx), 1 + int((~ib0).sum())
    n = nmask if mesh is None else pad_to_multiple(nmask, mesh.ndata)
    u12 = quantize == "u12"
    np_dt, torch_dt = wire_dtypes(quantize)
    devs = mesh.data_devices if mesh is not None else [torch.device(device)]
    host = torch.empty((n, u12_row_bytes(ncol) if u12 else ncol),
                       dtype=torch_dt,
                       pin_memory=any(d.type == "cuda" for d in devs))
    h = host.numpy().view(np_dt)
    h[nmask:] = 0
    nlib = native.lib()
    if (nlib is not None and flat.dtype == np.float32
            and flat.flags["C_CONTIGUOUS"]):
        take = np.ascontiguousarray(idx, np.int64)
        ib0_i = np.ascontiguousarray(np.flatnonzero(ib0), np.int32)
        idwi_i = np.ascontiguousarray(np.flatnonzero(~ib0), np.int32)
        fill = nlib.rumba_signal_u12 if u12 else nlib.rumba_signal_u16
        out = native.as_u8_ptr(h) if u12 else native.as_u16_ptr(h)
        fill(native.as_f32_ptr(flat), native.as_i64_ptr(take), nmask,
             flat.shape[1], native.as_i32_ptr(ib0_i), len(ib0_i),
             native.as_i32_ptr(idwi_i), len(idwi_i), out)
    else:
        sig = _signal_host(flat, idx, ib0)
        h[:nmask] = _quantize_pack_u12(sig, 1.0 / 4095.0) if u12 else \
            (sig * np.float32(65535.0) + np.float32(0.5)).astype(np.uint16)
    scale = 1.0 / 4095.0 if u12 else 1.0 / 65535.0
    return place_rows(host, decoder(quantize, scale, ncol), device, mesh)


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

    `precision` of the R-L products, the reference's matrix-unit routes:
    on the card "high" (default) is the 3-pass bf16 product (x = hi + lo
    in bf16, lo*hi + hi*lo + hi*hi on the tensor cores, f32
    accumulation) and "default" the 1-pass one (bf16-rounded operands,
    f32 accumulation), both in the hand-written `rl_gemm` kernel;
    "highest" is the f32 product (TF32 off).  On the CPU "high" and
    "highest" are the f32 product, as JAX's CPU computes every
    precision, and "default" the product of bf16-rounded operands with
    f32 accumulation.  `tv_bf16` runs the TV stencil on a bf16 stack
    (differences in bf16, the rest in f32); the estimate stays f32.

    `batch`: a prepared `VoxelBatch` to reuse one gather and upload; the
    b0 normalisation then runs on its device.  Without one the signal
    matrix goes to `device` (None: the card) in one upload, through
    `signal_wire`: "u12" (the default; packed 12-bit, error <= 0.5/4095
    on the [0, 1] signal) and "u16" (<= 0.5/65535) are built on the host
    and decoded on the card; "f32" uploads the raw masked rows and
    normalises them on the card (the host matrix's rows to float
    rounding).  On the CPU the matrix is built on the host; there, and
    with `batch`, `signal_wire` is ignored, as in the reference.

    `mesh` (parallel/mesh.py), or a `batch` sharded over one: the state
    is row-sharded over the mesh's data axis and the TV term reshards its
    components over every device of the mesh, where the dense stencil
    kernel (`tv_multiplier`, f32, or bf16 with `tv_bf16`) runs on each
    device's [X, Y, Z, C/ndev] stack; sigma^2's mean and lambda take the
    real rows of every shard.  `tv_fused` stays the one-device path, as
    in the reference.  A batch that is not sharded is resharded over
    `mesh`.

    Not carried over: the pace aborts of `abort_s_per_iter` (a
    workaround for a TPU runtime), which raise `NotImplementedError`
    unless left None.

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
    mesh = as_mesh(mesh)
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

    with lap(timings, "rumba.signal") as stage:
        shape3 = tuple(int(s) for s in mask.vol.shape[:3])
        idx = batch.idx if batch is not None else mask_indices(mask.vol)
        nmask = len(idx)

        bval = np.asarray(dwi.bval, np.float32)
        bvec = np.asarray(dwi.bvec, np.float32)
        kernel, ib0 = _build_kernel(bval, bvec, odf_dirs, lam_para,
                                    lam_perp, lam_csf, lam_gm)
        ndir, ncomp = kernel.shape
        nvert = ncomp - 2

        # TV runs on the mask bounding box + halo, not the full volume
        tv_shape3, tv_nxyz, idx_tv, tv_lo = _tv_bbox(idx, shape3)

        # the mesh of a sharded batch; a one-device mesh runs unsharded
        # there
        mesh, device = resolve_mesh(mesh, device, getattr(batch, "mesh",
                                                          None))

        # Signal matrix: average b0 first, then DWIs, normalised by b0
        # (reference: src/rusd.jl:450-465); sharded over the mesh's data
        # axis
        if batch is not None:
            sig_b = batch.signals
            signal = map_shards(_signal_from_batch, sig_b,
                                replicate(np.flatnonzero(ib0), batch.mesh,
                                          sig_b.device),
                                replicate(np.flatnonzero(~ib0), batch.mesh,
                                          sig_b.device))
            if mesh is not None and not isinstance(signal, ShardedRows):
                signal = put_batch(signal.cpu().numpy(), mesh)
        else:
            vol = np.asarray(dwi.vol)
            flat = vol.reshape(-1, vol.shape[3])
            dev0 = resolve(device) if mesh is None else \
                mesh.data_devices[0]
            if dev0.type == "cuda" and signal_wire == "f32":
                signal = _signal_f32(flat, idx, ib0, dev0, mesh)
            elif dev0.type == "cuda":
                signal = _signal_wire(flat, idx, ib0, signal_wire, dev0,
                                      mesh)
            else:
                host = _signal_host(flat, idx, ib0)
                signal = upload(host, dev0) if mesh is None else \
                    put_batch(host, mesh)
        n_rows = signal.shape[0]
        dev = signal.device
        devs = [dev] if mesh is None else mesh.distinct_devices()
        stage.devs = devs

    with lap(timings, "rumba.iterate", devs):
        with span("rumba.init"):
            nbr, nbr_ok = _angular_neighbors(odf_dirs)
            half_verts = odf_dirs.vertices[:nvert].astype(np.float32)

            # Initialisation (reference: src/rusd.jl:522-537)
            fodf0 = np.full(ncomp, 1.0 / ncomp, np.float32)
            lam0 = (1.0 / 15) ** 2

            def rows_of(row):
                return map_shards(
                    lambda s: torch.from_numpy(row).to(s.device).expand(
                        s.shape[0], len(row)).clone(), signal)

            kernel_d = replicate(kernel, mesh, dev)
            # rl_gemm's planes of the kernel and its transpose, once per
            # device
            packs = per_device(lambda k: _pack_products(k, precision),
                               kernel_d)
            fodf = rows_of(fodf0)
            dodf = rows_of(kernel @ fodf0)
            sig2 = rows_of(np.full(1, lam0, np.float32))
            lam_flat = replicate(np.full(tv_nxyz, lam0, np.float32), mesh,
                                 dev)
            idx_d = replicate(idx_tv, mesh, dev)

            it_start = 0
            if checkpoint_path is not None and \
                    os.path.isfile(checkpoint_path):
                try:
                    fodf_h, sig2_h, lam_h, it_ck = _load_checkpoint(
                        checkpoint_path, nmask, ncomp, niter, n_rows, lam0,
                        shape3, tv_shape3, tv_lo, tv_nxyz)
                except Exception:
                    # a truncated or corrupt npz raises BadZipFile/OSError
                    # and a missing key KeyError: all mean "unusable",
                    # which is what on_mismatch='fresh' exists to survive
                    if on_mismatch == "raise":
                        raise
                    warnings.warn(
                        f"checkpoint {checkpoint_path} does not match this "
                        "problem or is unreadable; starting fresh "
                        "(on_mismatch='fresh')", stacklevel=2)
                else:
                    fodf = put_rows(fodf_h, mesh, dev)
                    sig2 = put_rows(sig2_h, mesh, dev)
                    lam_flat = replicate(lam_h, mesh, dev)
                    dodf = map_shards(lambda f, k: torch.matmul(f, k.T), fodf,
                                      kernel_d)
                    it_start = it_ck
                    print(f"Resuming RUMBA-SD from iteration {it_start} "
                          f"({checkpoint_path})")
            dodf_sig = map_shards(lambda s, d, s2: (s * d) / s2, signal,
                                  dodf, sig2)

            x = None
            tv = _tv_fn(mesh, idx_tv, tv_shape3, n_rows, ncomp, tv_bf16,
                        dev) if use_tv else None

        # Iterate (verbose prints the per-iteration SNR like the reference,
        # reference: src/rusd.jl:543-556); each iteration hands the next its
        # x, the first computes it from dodf_sig
        for it in range(it_start + 1, niter + 1):
            fodf, dodf, dodf_sig, sig2, lam_flat, _, x = _rumba_step(
                fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel_d,
                idx_d, n_order, ipat_factor, use_tv, tv_shape3, precision,
                tv_bf16, x=x, packs=packs, tv=tv)
            if verbose:
                sm_d, ss_d = _snr_stats(sig2, nmask)
                ss = float(ss_d) if nmask > 1 else 0.0
                print(f"Iteration {it} of {niter}")
                print(f"Estimated mean SNR (s0/sigma) = {float(sm_d)} "
                      f"(+-) {ss}")
            if (checkpoint_path is not None and checkpoint_every > 0
                    and it % checkpoint_every == 0 and it < niter):
                tmp = checkpoint_path + ".tmp.npz"
                np.savez(tmp, fodf=fodf.cpu().numpy(),
                         sig2=sig2.cpu().numpy(),
                         lam_flat=as_tensor(lam_flat).cpu().numpy(),
                         iteration=it,
                         nmask=nmask, ncomp=ncomp, niter=niter, version=2,
                         n_rows=n_rows, tv_lo=np.asarray(tv_lo),
                         tv_shape3=np.asarray(tv_shape3))
                os.replace(tmp, checkpoint_path)

    with lap(timings, "rumba.post", devs):
        # the iteration's row state is not needed past here: free it before
        # the post stage's temporaries
        del signal, dodf, dodf_sig, x, tv
        sm_d, ss_d = _snr_stats(sig2, nmask)
        snr_mean = float(sm_d)
        snr_std = float(ss_d) if nmask > 1 else 0.0

        # Energy normalisation + iso embedding + GFA + peaks, on the
        # device(s)
        # (reference: src/rusd.jl:560-633)
        fodf_full, fgm_d, fcsf_d, f_iso_d, gfa_d = map_shards(
            lambda f: _rumba_post(f, nvert), fodf)
        vecs_d = map_shards(
            lambda ff, fi, hv, nb, ok: _rumba_peaks_kernel(
                ff, fi, hv, nb, ok, FTHRESH),
            fodf_full, f_iso_d, replicate(half_verts, mesh, dev),
            replicate(nbr.astype(np.int64), mesh, dev),
            replicate(nbr_ok, mesh, dev))

        # every large output stays on the device until host code reads it
        def vol_of(values, nframes):
            m = MRI.like(mask, nframes, np.float32)
            m.vol = LazyVolume(values, idx, shape3, nframes)
            return m

        unit_d, amp_d = map_shards(split_unit_amp, vecs_d)
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
