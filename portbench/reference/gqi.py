"""Plain GQI reference: generalized q-sampling imaging with its peaks.

Yeh et al. (2010), IEEE TMI 29(9):1626-1635, as Fibers.jl computes it
(src/gqi.jl:63-171): the ODF on the half sphere is max(s, 0) times the
normalised sinc of the sphere's vertices against the q-vectors
bvec sqrt(0.01506 b) sigma / pi (sigma = 1.25); a vertex is a peak when
its ODF is strictly above every vertex it shares a face with; the three
largest peaks, ties to the lower vertex, give the peak directions (from
the first half of the vertex table, the antipodes of the design's) and
QA = (peak - min ODF) / the largest mean ODF of any fitted voxel.  A
voxel is fitted when a sample is positive.

The sphere is read from this benchmark's copy of the tessellation
(`portbench/data/<name>.npz`: 2n vertices, antipodal pairs i and i + n,
and 1-based faces).  `prec="ref"`: float64.  `prec="tf32"`, the control:
the ODF product in float32 on TF32-rounded operands.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .precision import round_tf32

__all__ = ["sphere", "fit", "NPEAK"]

NPEAK = 3
DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def sphere(name):
    """(vertices [2n, 3] float32, faces [m, 3] 1-based) of a tessellation."""
    with np.load(os.path.join(DATA, f"{name}.npz")) as z:
        return z["vertices"], z["faces"]


def neighbours(faces, n):
    """[n, maxdeg] vertex neighbours over faces folded onto the half
    sphere (0-based), padded with -1."""
    f = faces.astype(np.int64).copy()
    f[f > n] -= n
    f -= 1
    nb = [set() for _ in range(n)]
    for a, b, c in f:
        nb[a] |= {b, c}
        nb[b] |= {a, c}
        nb[c] |= {a, b}
    deg = max(len(s) for s in nb)
    out = np.full((n, deg), -1, np.int64)
    for v, s in enumerate(nb):
        out[v, :len(s)] = sorted(s)
    return out


def fit(signals, bval, bvec, sphere_name, prec="ref", rows=65_536,
        sigma=1.25):
    """Fit the rows of `signals` [N, nvol] (float32).  Returns a dict:
    `odf` [N, n], `vecs` [N, 3, 3] (zero rows where no peak), `qa` [N, 3],
    `vertex` [N, 3] (-1 where no peak) and `valid` [N]."""
    dev = signals.device
    dt = torch.float64 if prec == "ref" else torch.float32
    verts, faces = sphere(sphere_name)
    n = len(verts) // 2
    q = np.asarray(bvec, np.float64) * (
        np.sqrt(np.asarray(bval, np.float64) * 0.01506)[:, None]
        * (sigma / np.pi))
    A_t = torch.from_numpy(np.sinc(q @ verts[n:].astype(np.float64).T)
                           ).to(dev, dt)                     # [nvol, n]
    if prec == "tf32":
        A_t = round_tf32(A_t)
    nbr = torch.from_numpy(neighbours(faces, n)).to(dev)
    first = torch.from_numpy(verts[:n].astype(np.float64)).to(dev, dt)
    parts = []
    for lo in range(0, signals.shape[0], rows):
        s = signals[lo:lo + rows].to(dt).clamp_min(0)
        odf = (round_tf32(s) if prec == "tf32" else s) @ A_t
        around = torch.where(nbr >= 0, odf[:, nbr.clamp_min(0)], -torch.inf)
        peak = odf > around.amax(-1)
        masked = torch.where(peak, odf, 0.0)
        vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :NPEAK], idx[:, :NPEAK]
        valid = s.amax(1) > 0
        ok = (vals > 0) & valid[:, None]
        parts.append(dict(odf=torch.where(valid[:, None], odf, 0.0),
                          vals=vals, idx=idx, ok=ok, valid=valid,
                          odfmin=odf.amin(1), odfmean=odf.mean(1)))
    r = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    odfmax = torch.where(r["valid"], r["odfmean"], 0.0).max()
    ok = r["ok"]
    qa = torch.where(ok, (r["vals"] - r["odfmin"][:, None])
                     / torch.clamp_min(odfmax, 1e-30), 0.0)
    vecs = torch.where(ok[..., None], first[r["idx"]], 0.0)
    return dict(odf=r["odf"], vecs=vecs, qa=qa,
                vertex=torch.where(ok, r["idx"], -1), valid=r["valid"])
