"""Plain DSI reference: diffusion spectrum imaging with its peaks.

Wedeen et al. (2005), Magn Reson Med 54(6):1377-1386, as Fibers.jl
computes it (src/dsi.jl:59-261), voxel by voxel in spirit and in blocks
of rows here:

- the lattice: each sample's q-vector bvec sqrt(b / b1), b1 the least
  b above the smallest, rounded to integers, placed on a zero-padded
  cube of the next power of two above the lattice's span, its origin at
  cell nfft // 2 of each axis.  Where several samples hit one cell (the
  b0s of a real scan), the last of them stays, as the program documents
  (fibers_tpu_torch/models/dsi.py);
- each sample weighted by the Hanning window (1 + cos(2 pi |q| / w)) / 2
  (w = 0: no window);
- the PDF: fftshift, the full complex 3-D FFT, fftshift, the real part,
  divided by its sum over the cube; the PDF output is its value at each
  sample's own cell;
- the ODF at vertex u of the half sphere (the second half of the vertex
  table, as src/gqi.jl:69 takes it): sum over the 21 radii
  r = (0.3, 0.33, ..., 0.9) (nfft / 2 - 1) of pdf(r u) r^2 dr, pdf(x) by
  trilinear interpolation of the eight cells around x, gathered;
- peaks and QA as the GQI reference finds them (`reference/gqi.py`): a
  vertex strictly above every vertex it shares a face with, the three
  largest (ties to the lower vertex), their directions from the first
  half of the table, QA = (peak - min ODF) / the largest mean ODF of any
  fitted voxel.  A voxel is fitted when a sample is positive; the PDF
  and ODF of any other are zero.

`prec="ref"`: float64 and complex128.  `prec="tf32"`, the control: what
a TF32 route would compute, the FFT's input and the PDF operand of the
radial integral rounded to TF32's 10-bit mantissa, the rest in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .gqi import NPEAK, neighbours, sphere
from .precision import round_tf32

__all__ = ["grid", "radii", "fit"]


def grid(bval, bvec, hann_width):
    """(nfft, cell [nvol] flat C-order index of each sample's cell,
    hann [nvol] float64) of a Cartesian b-table."""
    bval = np.asarray(bval, np.float64)
    bvec = np.asarray(bvec, np.float64)
    above = bval[bval > bval.min()]
    if above.size == 0:
        raise ValueError("a DSI b-table needs more than one b-value")
    iq = np.rint(bvec * np.sqrt(bval / above.min())[:, None]).astype(
        np.int64)
    span = int(iq.max() - iq.min() + 1)
    nfft = 1
    while nfft < span:
        nfft *= 2
    c = iq + nfft // 2
    cell = (c[:, 0] * nfft + c[:, 1]) * nfft + c[:, 2]
    if hann_width:
        hann = 0.5 * (1.0 + np.cos(2 * np.pi * np.sqrt((iq * iq).sum(1))
                                   / hann_width))
    else:
        hann = np.ones(len(bval))
    return nfft, cell, hann


def radii(nfft, n=21):
    """The radial quadrature: radii [n] and their step, in cells."""
    scale = nfft / 2 - 1
    r = scale * (0.3 + 0.03 * np.arange(n))
    return r, 0.03 * scale


def _stencils(nfft, dirs):
    """Trilinear stencils of the points r u: (flat cell indices [8, n_r,
    n_u], weights [8, n_r, n_u] times r^2 dr), float64."""
    r, dr = radii(nfft)
    x = r[:, None, None] * dirs[None] + nfft // 2           # [n_r, n_u, 3]
    base = np.floor(x).astype(np.int64)
    f = x - base
    if base.min() < 0 or base.max() + 1 >= nfft:
        raise ValueError("a radius reaches past the cube")
    idx, w = [], []
    for d in np.ndindex(2, 2, 2):
        c = base + np.asarray(d)
        idx.append((c[..., 0] * nfft + c[..., 1]) * nfft + c[..., 2])
        w.append(np.prod(np.where(np.asarray(d, bool), f, 1 - f), -1)
                 * (r * r * dr)[:, None])
    return np.stack(idx), np.stack(w)


def fit(signals, bval, bvec, sphere_name, hann_width=32, prec="ref",
        rows=8192):
    """DSI of the rows of `signals` [N, nvol] (float32).  Returns a dict:
    `pdf` [N, nvol], `odf` [N, n], `vecs` [N, 3, 3] (zero rows where no
    peak), `qa` [N, 3], `vertex` [N, 3] (-1 where no peak), `valid` [N]."""
    dev = signals.device
    ref = prec == "ref"
    dt = torch.float64 if ref else torch.float32
    nfft, cell, hann = grid(bval, bvec, hann_width)
    # the last sample of each cell stays
    last = {int(c): k for k, c in enumerate(cell)}
    keep = torch.tensor(sorted(last.values()), device=dev)
    at = torch.from_numpy(cell).to(dev)
    hann = torch.from_numpy(hann).to(dev, dt)
    verts, faces = sphere(sphere_name)
    n = len(verts) // 2
    sidx, sw = _stencils(nfft, verts[n:].astype(np.float64))
    sidx = torch.from_numpy(sidx.reshape(8, -1)).to(dev)
    sw = torch.from_numpy(sw).to(dev, dt)                   # [8, n_r, n]
    nbr = torch.from_numpy(neighbours(faces, n)).to(dev)
    first = torch.from_numpy(verts[:n].astype(np.float64)).to(dev, dt)
    dims = (1, 2, 3)
    parts = []
    for lo in range(0, signals.shape[0], rows):
        s = signals[lo:lo + rows].to(dt).clamp_min(0)
        b = s.shape[0]
        q = torch.zeros((b, nfft ** 3), dtype=dt, device=dev)
        q[:, at[keep]] = (s * hann)[:, keep]
        if not ref:
            q = round_tf32(q)
        q = q.reshape(b, nfft, nfft, nfft)
        p = torch.fft.fftshift(torch.fft.fftn(
            torch.fft.fftshift(q, dims), dim=dims), dims).real.reshape(b, -1)
        p = p / p.sum(1, keepdim=True)
        pg = round_tf32(p) if not ref else p
        odf = torch.zeros((b, n), dtype=dt, device=dev)
        for k in range(8):
            odf += (pg[:, sidx[k]].reshape(b, -1, n) * sw[k]).sum(1)
        around = torch.where(nbr >= 0, odf[:, nbr.clamp_min(0)], -torch.inf)
        peak = odf > around.amax(-1)
        vals, idx = torch.sort(torch.where(peak, odf, 0.0), dim=1,
                               descending=True, stable=True)
        vals, idx = vals[:, :NPEAK], idx[:, :NPEAK]
        valid = s.amax(1) > 0
        ok = (vals > 0) & valid[:, None]
        v = valid[:, None]
        parts.append(dict(pdf=torch.where(v, p[:, at], 0.0),
                          odf=torch.where(v, odf, 0.0), vals=vals, idx=idx,
                          ok=ok, valid=valid, odfmin=odf.amin(1),
                          odfmean=odf.mean(1)))
    r = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    odfmax = torch.where(r["valid"], r["odfmean"], 0.0).max()
    ok = r["ok"]
    qa = torch.where(ok, (r["vals"] - r["odfmin"][:, None])
                     / torch.clamp_min(odfmax, 1e-30), 0.0)
    vecs = torch.where(ok[..., None], first[r["idx"]], 0.0)
    return dict(pdf=r["pdf"], odf=r["odf"], vecs=vecs, qa=qa,
                vertex=torch.where(ok, r["idx"], -1), valid=r["valid"])
