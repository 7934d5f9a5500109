"""Diffusion Spectrum Imaging (DSI) reconstruction, in PyTorch.

Counterpart of fibers_tpu/models/dsi.py (reference: src/dsi.jl:59-261):
per chunk of masked voxels, the signals are scattered onto a
[B, nfft^3] q-space grid, fftshift-rolled and transformed with one
batched real 3-D FFT, and the radial ODF integral is one GEMM against a
host-built weight matrix that carries the trilinear stencils and the
r^2 dr quadrature of all 21 radii, with the PDF sum as its last column.

Two things differ from the reference's XLA program:
- A b-table that repeats a q-point (several b0 volumes, as real DSI scans
  have) puts several samples into one grid cell.  XLA's CPU scatter keeps
  the last of them; `index_put_` with repeated indices is
  nondeterministic on CUDA.  The repeats are resolved on the host once
  per call, keeping the last sample of each cell, so the scatter's
  indices are unique.
- The FFT is pocketfft on the CPU and cuFFT on the card, not XLA's; the
  outputs agree to float tolerance, not bit for bit.

Wedeen et al. (2005), Magn Reson Med 54(6):1377-1386.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.handoff import DevicePeaks
from ..core.lazy import LazyVolume
from ..core.mri import MRI
from ..core.odf import ODF, half_sphere
from ..device import resolve
from ..io.dispatch import mri_write_struct
from ..ops.masked import gather_frames, mask_indices
from ..ops.peaks import build_neighbors, peak_mask, top_peaks

__all__ = ["DSI", "dsi_rec", "dsi_write"]

NPEAK = 3


@dataclass
class DSI:
    """Outputs of a DSI reconstruction.  (reference: src/dsi.jl:10-15)

    `_peak_dev` keeps the peak batch on the device for the tractography
    handoff (core.handoff.DevicePeaks); never written by `dsi_write`."""

    pdf: MRI
    odf: MRI
    peak: List[MRI]
    qa: List[MRI]
    _peak_dev: object = None


# The three host tables below are copies of fibers_tpu/models/dsi.py
# (that module imports jax at its top).

def _dsi_grid(bval: np.ndarray, bvec: np.ndarray, hann_width: int):
    """Map q-space samples onto the zero-padded FFT grid.

    Returns (nfft, iq_flat [nvol] C-order flat indices, hann [nvol]).
    (reference: src/dsi.jl:61-85)
    """
    bval = bval.astype(np.float64)
    q = bvec.astype(np.float64) * np.sqrt(bval)[:, None]
    bmin = bval.min()
    above = bval[bval > bmin]
    if above.size == 0:
        raise ValueError("DSI requires multiple b-values on a q-space grid")
    dq = np.sqrt(above.min())
    iq = np.round(q / dq).astype(np.int64)

    nfft = int(iq.max() - iq.min() + 1)
    nfft = 1 << int(np.ceil(np.log2(nfft)))
    shift = nfft // 2                       # 0-based center index
    iq0 = iq + shift
    iq_flat = (iq0[:, 0] * nfft + iq0[:, 1]) * nfft + iq0[:, 2]

    if hann_width == 0:
        hann = np.ones(len(bval), np.float32)
    else:
        hann = ((1.0 + np.cos(np.sqrt((iq ** 2).sum(axis=1))
                              * (2 * np.pi / hann_width))) * 0.5)
    return nfft, iq_flat.astype(np.int32), hann.astype(np.float32)


def _radial_weight_matrix(nfft: int, odf_dirs: ODF) -> np.ndarray:
    """[nfft^3, nvert] matrix turning a flat PDF into ODF amplitudes: the
    21-point radial quadrature (radii 0.3..0.9 of Nyquist, reference:
    src/dsi.jl:104-109) and trilinear stencils (src/dsi.jl:229-242)."""
    nvert = odf_dirs.nvert_half
    verts = odf_dirs.vertices[nvert:].astype(np.float64)   # lower half

    qr = (nfft / 2 - 1) * np.arange(0.3, 0.9 + 1e-9, 0.03)
    dqr = qr[1] - qr[0]
    shift = nfft // 2

    w = np.zeros((nfft ** 3, nvert), np.float64)
    for irad, r in enumerate(qr):
        coords = verts * r + shift                          # [nvert, 3]
        base = np.floor(coords).astype(np.int64)
        frac = coords - base
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    cw = (np.where(dx, frac[:, 0], 1 - frac[:, 0])
                          * np.where(dy, frac[:, 1], 1 - frac[:, 1])
                          * np.where(dz, frac[:, 2], 1 - frac[:, 2]))
                    ix = np.clip(base[:, 0] + dx, 0, nfft - 1)
                    iy = np.clip(base[:, 1] + dy, 0, nfft - 1)
                    iz = np.clip(base[:, 2] + dz, 0, nfft - 1)
                    flat = (ix * nfft + iy) * nfft + iz
                    np.add.at(w, (flat, np.arange(nvert)),
                              cw * r * r * dqr)
    return w.astype(np.float32)


def _half_spectrum_map(nfft: int) -> np.ndarray:
    """[nfft^3] map from fftshift-ed full-spectrum flat indices to
    rfftn half-spectrum flat indices ([nfft, nfft, nfft//2+1] C-order):
    the grid is real, so the real part of the full spectrum at a cell is
    that of the half spectrum at its Hermitian mirror."""
    n = nfft
    nh = n // 2 + 1
    s = n // 2
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    i2, j2, k2 = (i - s) % n, (j - s) % n, (k - s) % n
    flip = k2 >= nh
    i2 = np.where(flip, (-i2) % n, i2)
    j2 = np.where(flip, (-j2) % n, j2)
    k2 = np.where(flip, n - k2, k2)
    return ((i2 * n + j2) * nh + k2).reshape(-1).astype(np.int32)


def _unique_cells(iq_flat: np.ndarray):
    """(cells, cols): each grid cell that a sample hits once, and the
    column of the LAST sample that hits it (XLA's CPU scatter order)."""
    rev = iq_flat[::-1]
    cells, first_in_rev = np.unique(rev, return_index=True)
    return cells.astype(np.int64), (len(iq_flat) - 1 - first_in_rev)


def _dsi_kernel(signals, cells, cols, hann, iq_half, wmat_aug, verts_first,
                nbr, nbr_valid, nfft, npeak=NPEAK):
    """signals [B, nvol] -> pdf [B, nq], odf [B, nvert], peak vecs
    [B, npeak, 3], qa before the global normalisation [B, npeak] and the
    mean ODF of each valid voxel [B]."""
    s = torch.clamp_min(signals, 0.0)
    valid = s.amax(dim=1) > 0
    zero = torch.zeros((), dtype=s.dtype, device=s.device)

    b = s.shape[0]
    grid = torch.zeros((b, nfft ** 3), dtype=s.dtype, device=s.device)
    grid[:, cells] = (s * hann)[:, cols]
    grid = grid.reshape(b, nfft, nfft, nfft)

    shift = nfft // 2
    grid = torch.roll(grid, (shift, shift, shift), dims=(1, 2, 3))
    pr = torch.fft.rfftn(grid, dim=(1, 2, 3)).real.reshape(b, -1)

    aug = pr @ wmat_aug
    psum = aug[:, -1:]
    odf = aug[:, :-1] / psum
    pdf = pr[:, iq_half] / psum
    odfmin = odf.amin(dim=1)

    is_peak = peak_mask(odf, nbr, nbr_valid)
    vals, idx, pvalid = top_peaks(odf, is_peak, npeak)
    pvalid = pvalid & valid[:, None]

    vecs = torch.where(pvalid[..., None], verts_first[idx], zero)
    qa = torch.where(pvalid, vals - odfmin[:, None], zero)

    vz = valid[:, None]
    pdf = torch.where(vz, pdf, zero)
    odf = torch.where(vz, odf, zero)
    odfmean = torch.where(valid, odf.mean(dim=1), zero)
    return pdf, odf, vecs, qa, odfmean


def _check_wire(wire: str) -> None:
    """DSI's `wire` rule (ROADMAP A14): "auto8" (the reference's
    default), "auto" and "f32" upload exact float32; the quantized wires
    are not ported yet."""
    if wire in ("u8", "u12", "u16"):
        raise NotImplementedError(
            f"dsi_rec(wire={wire!r}): the quantized upload wires are not "
            "ported yet (ROADMAP A14); use wire='f32'")
    if wire not in ("auto8", "auto", "f32"):
        raise ValueError(f"Unknown DSI wire {wire!r} "
                         "(expected auto8/auto/u16/u12/u8/f32)")


def dsi_rec(dwi: MRI, mask: MRI, odf_dirs: ODF = None,
            hann_width: int = 32, chunk: int = 4096,
            mem_budget: float = 4e9, batch=None, mesh=None,
            wire: str = "auto8", device=None, timings=None) -> DSI:
    """DSI reconstruction of DWIs.  (reference: src/dsi.jl:171-270)

    The per-chunk working set is dominated by the [chunk, nfft^3] q-space
    grid and its spectrum; `chunk` shrinks so that stays under
    `mem_budget` bytes of device memory (a device-resident batch's bytes
    come out of the budget).

    `batch`: an optional prepared `VoxelBatch`; chunks then slice its
    rows.  Without one, a CUDA `device` (None: the card) gets
    the masked signals in one upload through `prepare_batch`, and on the
    CPU the chunks slice the gathered host rows, as in the reference.
    `wire`: "auto8" (the default), "auto" and "f32" all upload exact
    float32; the quantized wires raise (ROADMAP A14).  `mesh=` is not
    ported yet (ROADMAP A13).  `timings`: a dict that receives the stage
    wall times, each ending in a device synchronize: upload (the host
    tables and the uploads), chunks and finalize.

    Returns a `DSI` whose volumes stay on the device until host code
    reads them, with the peaks as `DevicePeaks` for `stream`.
    """
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    if dwi.bvec is None or np.asarray(dwi.bvec).size == 0:
        raise ValueError("Missing gradient table from input DWI structure")
    _check_wire(wire)
    if mesh is not None:
        raise NotImplementedError(
            "dsi_rec(mesh=): multi-device DSI is not ported yet "
            "(ROADMAP A13)")
    if odf_dirs is None:
        from ..core import odf as _odf
        odf_dirs = _odf.sphere_642

    def stage(name, t0, dev):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[name] = time.time() - t0
        return time.time()

    t0 = time.time()
    nvert = odf_dirs.nvert_half
    nfft, iq_flat, hann = _dsi_grid(np.asarray(dwi.bval, np.float32),
                                    np.asarray(dwi.bvec, np.float32),
                                    hann_width)
    wmat = _radial_weight_matrix(nfft, odf_dirs)
    _, verts_first, faces0 = half_sphere(odf_dirs)
    nbr, nbr_ok = build_neighbors(faces0, nvert)

    # the Hermitian full -> half spectrum mirror folded into the GEMM
    # operand and the PDF sample indices; the PDF sum as one extra column
    # (the count of full cells per half cell)
    half_map = _half_spectrum_map(nfft)
    nhalf = nfft * nfft * (nfft // 2 + 1)
    wmat_aug = np.zeros((nhalf, nvert + 1), np.float32)
    np.add.at(wmat_aug[:, :nvert], half_map, wmat)
    wmat_aug[:, nvert] = np.bincount(half_map, minlength=nhalf)
    iq_half = half_map[iq_flat]
    cells, cols = _unique_cells(iq_flat)

    dev = batch.signals.device if batch is not None else resolve(device)
    if batch is None and dev.type != "cpu":
        from ..core.batch import prepare_batch
        batch = prepare_batch(dwi, mask, wire="f32", device=dev)

    # chunk guard: grid f32 + half spectrum (c64 over nfft^3/2) + FFT
    # scratch ~= 12 bytes per grid cell per voxel
    budget = mem_budget
    if batch is not None:
        budget = max(1e9, mem_budget - batch.signals.numel() * 4)
    max_chunk = max(8, int(budget / (nfft ** 3 * 12)))
    if chunk > max_chunk:
        chunk = 1 << int(np.floor(np.log2(max_chunk)))

    if batch is not None:
        idx = batch.idx
        signals = batch.signals
    else:
        idx = mask_indices(mask.vol)
        signals = torch.from_numpy(
            gather_frames(dwi.vol, idx).astype(np.float32))
    n = len(idx)
    nq = len(iq_flat)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (put(cells), put(cols), put(hann), put(iq_half.astype(np.int64)),
            put(wmat_aug), put(verts_first), put(nbr), put(nbr_ok))
    t0 = stage("upload", t0, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    pdf_b = torch.empty((n, nq), **f32)
    odf_b = torch.empty((n, nvert), **f32)
    vecs_b = torch.empty((n, NPEAK, 3), **f32)
    qa_b = torch.empty((n, NPEAK), **f32)
    # the global QA normaliser stays on the device: no host sync per chunk
    odfmax = torch.zeros((), **f32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pdf_c, odf_c, vecs_c, qa_c, odfmean = _dsi_kernel(
            signals[lo:hi].to(dev), *args, nfft=nfft)
        pdf_b[lo:hi] = pdf_c
        odf_b[lo:hi] = odf_c
        vecs_b[lo:hi] = vecs_c
        qa_b[lo:hi] = qa_c
        odfmax = torch.maximum(odfmax, odfmean.max())
    t0 = stage("chunks", t0, dev)

    # global QA normalisation (reference: src/dsi.jl:263-267)
    qa_b = torch.where(odfmax > 0, qa_b / torch.clamp_min(odfmax, 1e-30),
                       qa_b)
    shape3 = mask.vol.shape[:3]

    def lazy(values, nframes):
        out = MRI.like(mask, nframes, np.float32)
        out.vol = LazyVolume(values, idx, shape3, nframes)
        return out

    peak = [lazy(vecs_b[:, ip, :], 3) for ip in range(NPEAK)]
    qa = [lazy(qa_b[:, ip], 1) for ip in range(NPEAK)]
    out = DSI(pdf=lazy(pdf_b, nq), odf=lazy(odf_b, nvert), peak=peak, qa=qa,
              _peak_dev=DevicePeaks(vecs=vecs_b, amp=qa_b, idx=idx,
                                    ref=mask))
    stage("finalize", t0, dev)
    return out


def dsi_write(dsi: DSI, basename: str) -> None:
    """Write DSI volumes as <basename>_<field>[i].nii.gz.
    (reference: src/dsi.jl:279-294)"""
    mri_write_struct(dsi, basename)
