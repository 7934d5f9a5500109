"""Synthetic DSI scans on a Cartesian q-space lattice, made on the card
from the run's seed.

A configuration's `scan` gives `lattice` {"radius": R, "bmax": B}: the
integer points q with |q|^2 <= R^2, the origin first (the one b0), then
by |q|^2 and in C order within a shell; b = B |q|^2 / R^2 and the unit
direction q / |q| (zero at the origin).  Radius 4 gives the 257 samples
of the CMU DSI scheme.  The grid, the brain mask, the fibre field, the
signal model and the noise are those of `phantoms` (its geometry, its
tensor signal and its seeds): only the b-table differs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import phantoms

__all__ = ["btable", "make_subject"]


def btable(scan):
    """(bval [nvol] f32, bvec [nvol, 3] f32) of the scan's lattice."""
    lat = scan["lattice"]
    r = int(lat["radius"])
    ax = np.arange(-r, r + 1)
    q = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    n2 = (q * q).sum(1)
    keep = np.flatnonzero(n2 <= r * r)
    keep = keep[np.argsort(n2[keep], kind="stable")]
    q, n2 = q[keep].astype(np.float64), n2[keep].astype(np.float64)
    norm = np.sqrt(n2)
    bvec = np.where(norm[:, None] > 0, q / np.maximum(norm, 1.0)[:, None],
                    0.0)
    bval = float(lat["bmax"]) * n2 / (r * r)
    return bval.astype(np.float32), bvec.astype(np.float32)


def make_subject(scan, seed: int, subject: int, device):
    """One subject of `scan` on `device`, as `phantoms.make_subject` makes
    one on shells: the float32 DWI volume [X, Y, Z, nvol] in pinned host
    memory (on a card) and the brain mask [X, Y, Z] (bool, host).  The
    "graded" signal model only: DSI is for crossings."""
    shape = tuple(int(n) for n in scan["shape"])
    sig = scan["signal"]
    if sig["model"] != "graded":
        raise ValueError(f"a lattice scan takes the graded signal model, "
                         f"not {sig['model']!r}")
    bval_h, bvec_h = btable(scan)
    bval = torch.from_numpy(bval_h).to(device)
    bvec = torch.from_numpy(bvec_h).to(device)
    x, y, z, mask, ax = phantoms.geometry(shape, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(phantoms.noise_seed(seed, subject))
    out = torch.empty(shape + (len(bval_h),), dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")
    s0, sigma, md = (float(sig[k]) for k in ("s0", "noise_sigma", "md"))
    cross = sig["crossing"]
    step = max(1, shape[0] // 8)
    for lo in range(0, shape[0], step):
        sl = slice(lo, min(lo + step, shape[0]))
        a = ax[sl]
        r2 = x[sl] ** 2 + y[sl] ** 2 + z[sl] ** 2
        frac = torch.clamp(1.3 - 1.45 * r2, 0.01, 1.0).float()
        lp = md + 2.0 * md * (2.0 / 3.0) * frac
        lt = md - md * (2.0 / 3.0) * frac
        s1 = phantoms._tensor_signal(a, lp, lt, bval, bvec)
        a2 = torch.stack([-a[..., 1], a[..., 0], a[..., 2]], dim=-1)
        s2 = phantoms._tensor_signal(a2, lp, lt, bval, bvec)
        slab = (y[sl].abs() < cross["y"]) & (z[sl].abs() < cross["z"])
        w = torch.where(slab, float(cross["weight"]), 0.0).float()
        vol = s0 * ((1.0 - w[..., None]) * s1 + w[..., None] * s2)
        noise = torch.randn(vol.shape, generator=gen, device=device,
                            dtype=torch.float32)
        vol = torch.where(mask[sl][..., None], (vol + sigma * noise).abs(),
                          0.0)
        out[sl].copy_(vol)
    return out, mask.cpu().numpy()
