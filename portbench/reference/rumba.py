"""Plain RUMBA-SD reference: robust and unbiased model-based spherical
deconvolution with total-variation regularisation, and its peaks.

Canales-Rodriguez et al. (2015), PLoS ONE 10(10):e0138910, as Fibers.jl
runs it (src/rusd.jl:141-177, 241-373, 447-636), in float32 torch with
float32 matrix products (TF32 off):

- the signal: per voxel the b0 flag, then each diffusion-weighted sample
  over the mean of the (non-negative) b = 0 samples, clipped to [0, 1],
  carried on the configuration's upload wire ("u12": 4095 steps, as the
  wire rounds, q = trunc(s * 4095 + 0.5), decoded as q * f32(1/4095));
- the kernel: per vertex of the sphere's second half an axially
  symmetric tensor (lambda_par, lambda_perp) along it, then two
  isotropic columns (CSF, GM), against g = 0 for the b0 row and the unit
  gradients of the diffusion-weighted rows;
- each iteration: the Richardson-Lucy update of the fODF with the Rician
  likelihood (the Bessel ratio I1/I0 by Perron's continued fraction),
  the TV multiplier on the mask (zero outside; forward differences, the
  gradient normalised by sqrt(|g|^2 + 1e-7), backward divergence), the
  noise variance refit clamped to [(1/80)^2, (1/8)^2] and the TV weight
  the mean variance, at least (1/30)^2;
- after the iterations: the energy normalisation, the isotropic
  fraction spread over the vertices, GFA, and up to five peaks: vertices
  above every neighbour within 12.5 degrees (16 on the 362-vertex
  sphere) and above 0.1 / (1 - f_iso) of the maximum, scaled to their
  volume fractions.

The TV runs on the mask's bounding box with a one-voxel halo, which
reproduces the whole volume's stencil on every mask voxel.
"""

from __future__ import annotations

import numpy as np
import torch

from .gqi import sphere

__all__ = ["signal_rows", "kernel_matrix", "fit", "post", "peaks",
           "angular_neighbours", "NPEAK"]

NPEAK = 5
SIG2_MIN = (1.0 / 80) ** 2
SIG2_MAX = (1.0 / 8) ** 2


def signal_rows(rows, bval, wire):
    """[N, 1 + ndwi] float32 RUMBA signal of raw rows [N, nvol]."""
    b = np.asarray(bval)
    ib0 = torch.from_numpy(np.flatnonzero(b == b.min())).to(rows.device)
    idw = torch.from_numpy(np.flatnonzero(b != b.min())).to(rows.device)
    b0 = (rows[:, ib0].clamp_min(0).double().sum(1) / len(ib0)).float()
    q = rows[:, idw].clamp_min(0) / b0[:, None]
    q = torch.where(torch.isfinite(q) & (b0[:, None] > 0), q, 0.0)
    q = q.clamp(0.0, 1.0)
    sig = torch.cat([(b0 > 0).float()[:, None], q], 1)
    if wire == "u12":
        step = float(np.float32(1.0 / 4095.0))
        sig = torch.trunc(sig * 4095.0 + 0.5) * step
    elif wire != "f32":
        raise ValueError(f"unknown signal wire {wire!r}")
    return sig


def kernel_matrix(bval, bvec, sphere_name, lam_par, lam_perp, lam_csf,
                  lam_gm):
    """[1 + ndwi, nvert + 2] float32 kernel on the sphere's second half."""
    b = np.asarray(bval, np.float64)
    dw = b != b.min()
    g = np.asarray(bvec, np.float64)[dw]
    g = g / np.linalg.norm(g, axis=1, keepdims=True)
    g = np.vstack([np.zeros((1, 3)), g])
    bb = np.concatenate([[0.0], b[dw]])
    verts, _ = sphere(sphere_name)
    n = len(verts) // 2
    c = g @ verts[n:].astype(np.float64).T
    k = np.exp(-bb[:, None] * (lam_perp + (lam_par - lam_perp) * c * c))
    iso = [np.exp(-bb * lam)[:, None] for lam in (lam_csf, lam_gm)]
    return np.concatenate([k] + iso, 1).astype(np.float32)


def _bessel_ratio(z):
    """I1(z) / I0(z) by Perron's continued fraction (nu = 1)."""
    nu = 1
    return z / ((2 * nu + z) - ((2 * nu + 1) * z / (
        2 * z + (2 * nu + 1) - ((2 * nu + 3) * z / (
            (2 * nu + 2) + 2 * z - ((2 * nu + 5) * z / (
                (2 * nu + 3) + 2 * z)))))))


def _crop(mask):
    """(cell index of each mask voxel in the bounding box + 1-voxel halo,
    the crop's shape)."""
    xyz = np.nonzero(mask)
    lo = [max(int(c.min()) - 1, 0) for c in xyz]
    hi = [min(int(c.max()) + 2, s) for c, s in zip(xyz, mask.shape)]
    shape = tuple(h - l for l, h in zip(lo, hi))
    cell = ((xyz[0] - lo[0]) * shape[1] + (xyz[1] - lo[1])) * shape[2] \
        + (xyz[2] - lo[2])
    return cell.astype(np.int64), shape


def _tv(fodf, cell, shape, lam):
    """The TV multiplier rows [N, C] of the fODF rows."""
    n, c = fodf.shape
    X, Y, Z = shape
    v = torch.zeros((X * Y * Z, c), dtype=fodf.dtype, device=fodf.device)
    v[cell] = fodf
    v = v.reshape(X, Y, Z, c)
    grads = []
    for d in range(3):
        g = torch.zeros_like(v)
        m = v.shape[d] - 1
        torch.sub(v.narrow(d, 1, m), v.narrow(d, 0, m), out=g.narrow(d, 0, m))
        grads.append(g)
    del v
    norm = grads[0] * grads[0]
    norm.addcmul_(grads[1], grads[1]).addcmul_(grads[2], grads[2])
    norm.add_(1e-7).sqrt_()
    div = torch.zeros_like(norm)
    for d, g in enumerate(grads):
        g.div_(norm)
        m = g.shape[d] - 1
        div.add_(g)
        div.narrow(d, 1, m).sub_(g.narrow(d, 0, m))
    del grads, norm
    div.mul_(-lam).add_(1.0).abs_().add_(1e-7).reciprocal_()
    return div.reshape(-1, c)[cell]


def fit(signal, kernel, mask, niter, lam0=(1.0 / 15) ** 2, use_tv=True):
    """RUMBA-SD iterations over the mask rows of `signal` [N, ndir]
    (float32, on its device, in the C order of `mask`'s voxels) with
    `kernel` [ndir, ncomp].  Returns the final fODF rows [N, ncomp]."""
    dev = signal.device
    K = torch.from_numpy(kernel).to(dev)
    Kt = K.T.contiguous()
    n, ndir = signal.shape
    ncomp = K.shape[1]
    cell, shape = _crop(mask)
    cell = torch.from_numpy(cell).to(dev)
    f0 = torch.full((ncomp,), 1.0 / ncomp, dtype=torch.float32, device=dev)
    fodf = f0.expand(n, ncomp).contiguous()
    dodf = (K @ f0).expand(n, ndir).contiguous()
    sig2 = torch.full((n, 1), lam0, dtype=torch.float32, device=dev)
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    ratio = _bessel_ratio(signal * dodf / sig2)
    for _ in range(niter):
        tv = _tv(fodf, cell, shape, lam) if use_tv else None
        f = fodf * ((signal * ratio) @ K / (dodf @ K + 1e-7))
        if tv is not None:
            f.mul_(tv)
        del tv
        fodf = f.clamp_min_(0.0)
        dodf = fodf @ Kt
        dodf_sig = signal * dodf / sig2
        resid = (signal * signal + dodf * dodf) / 2 - sig2 * dodf_sig * ratio
        sig2 = (resid.double().sum(1, keepdim=True) / ndir).float().clamp(
            SIG2_MIN, SIG2_MAX)
        del resid
        ratio = _bessel_ratio(dodf_sig)
        del dodf_sig
        if use_tv:
            lam = sig2.mean().clamp_min((1.0 / 30) ** 2)
    return fodf


def post(fodf, nvert):
    """(fODF over the vertices with the isotropic fraction spread over
    them, normalised to sum 1 [N, nvert]; f_iso [N]; GFA [N])."""
    f = fodf / (fodf.sum(1, keepdim=True) + 1e-7)
    f_iso = f[:, nvert] + f[:, nvert + 1]
    full = f[:, :nvert] + f_iso[:, None]
    s = full.sum(1, keepdim=True)
    full = torch.where(s > 0, full / s.clamp_min(1e-30), 0.0)
    std = full.std(1, correction=1)
    rms = torch.sqrt((full * full).mean(1))
    gfa = torch.where(rms > 0, std / rms.clamp_min(1e-30), 0.0)
    return full, f_iso, gfa


def angular_neighbours(sphere_name):
    """[n, maxdeg] neighbours of each vertex of the first half within the
    peak neighbourhood (12.5 degrees; 16 on the 362-vertex sphere),
    padded with -1."""
    verts, _ = sphere(sphere_name)
    n = len(verts) // 2
    half = verts[:n].astype(np.float64)
    ang = np.degrees(np.arccos(np.clip(half @ half.T, -1.0, 1.0)))
    ang = np.minimum(ang, 180.0 - ang)
    near = ang < (16.0 if 2 * n == 362 else 12.5)
    np.fill_diagonal(near, False)
    deg = int(near.sum(1).max())
    out = np.full((n, deg), -1, np.int64)
    for v in range(n):
        k = np.flatnonzero(near[v])
        out[v, :len(k)] = k
    return out


def peaks(full, f_iso, sphere_name, thr=0.1, rows=65_536):
    """[N, 5, 3] peak vectors (first-half vertex directions scaled to the
    peak's volume fraction; zero where none) and [N, 5] vertex indices
    (-1 where none)."""
    verts, _ = sphere(sphere_name)
    n = len(verts) // 2
    dev = full.device
    half = torch.from_numpy(verts[:n].astype(np.float32)).to(dev)
    nb = torch.from_numpy(angular_neighbours(sphere_name)).to(dev)
    vecs, verts_out = [], []
    for lo in range(0, full.shape[0], rows):
        f, fi = full[lo:lo + rows], f_iso[lo:lo + rows]
        thr_abs = thr / torch.clamp_min(1.0 - fi, 1e-7) * f.amax(1)
        around = torch.where(nb >= 0, f[:, nb.clamp_min(0)], -torch.inf)
        keep = (f > around.amax(-1)) & (f >= thr_abs[:, None])
        vals, idx = torch.sort(torch.where(keep, f, 0.0), dim=1,
                               descending=True, stable=True)
        vals, idx = vals[:, :NPEAK], idx[:, :NPEAK]
        ok = vals > 0
        norm = (1.0 - fi) / torch.clamp_min((vals * ok).sum(1), 1e-30)
        v = half[idx] * (vals * norm[:, None])[..., None]
        vecs.append(torch.where(ok[..., None], v, 0.0))
        verts_out.append(torch.where(ok, idx, -1))
    return torch.cat(vecs), torch.cat(verts_out)
