"""Plain DTI reference: the log-linear least-squares tensor fit.

Basser et al. (1994), J Magn Reson B 103(3):247-254, as Fibers.jl fits it
(src/dti.jl:243-316): per voxel, the log of the strictly positive
samples against the design [-b g g^T, 1]; a voxel is fitted when every
sample is positive, or more than six are and one of them is a b = 0
sample.  Eigenvalues descending; FA, MD and RD from them.

`prec="ref"` solves the normal equations in float64.  `prec="tf32"` is
the control: the same fit in float32 with every matrix product's
operands rounded to TF32 (10 mantissa bits), the precision the card's
tensor cores would give the configuration's float32 products.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import round_tf32

__all__ = ["design", "fit", "tensor_of"]


def design(bval, bvec):
    """[nvol, 7] float64 design of the tensor fit."""
    b = np.asarray(bval, np.float64)
    g = np.asarray(bvec, np.float64)
    gx, gy, gz = g[:, 0], g[:, 1], g[:, 2]
    quad = np.stack([gx * gx, 2 * gx * gy, 2 * gx * gz, gy * gy,
                     2 * gy * gz, gz * gz], axis=1)
    return np.concatenate([-b[:, None] * quad, np.ones((len(b), 1))], axis=1)


def tensor_of(d):
    """[N, 6] unique elements (xx, xy, xz, yy, yz, zz) -> [N, 3, 3]."""
    xx, xy, xz, yy, yz, zz = d.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def fit(signals, bval, bvec, prec="ref", rows=131_072):
    """Fit the rows of `signals` [N, nvol] (float32, on any device), in
    blocks of `rows`.  Returns a dict of [N]-leading tensors: `tensor`
    [N, 3, 3], `evals` [N, 3] descending, `evecs` [N, 3, 3] (column k for
    eigenvalue k), `fa`, `md`, `s0` and `valid`."""
    dev = signals.device
    dt = torch.float64 if prec == "ref" else torch.float32
    A = torch.from_numpy(design(bval, bvec)).to(dev)
    ib0 = torch.from_numpy(np.asarray(bval) == np.min(bval)).to(dev)
    colnorm = torch.sqrt((A * A).sum(0))
    As = (A / colnorm).to(dt)
    outer = (As[:, :, None] * As[:, None, :]).reshape(len(A), -1)
    if prec == "tf32":
        As, outer = round_tf32(As), round_tf32(outer)
    parts = []
    for lo in range(0, signals.shape[0], rows):
        s = signals[lo:lo + rows].to(dt)
        pos = s > 0
        w = pos.to(dt)
        npos = pos.sum(1)
        valid = (npos == s.shape[1]) | ((npos > 6) & (pos & ib0).any(1))
        logs = torch.log(torch.where(pos, s, torch.ones_like(s)))
        wl = w * logs
        if prec == "tf32":
            w, wl = round_tf32(w), round_tf32(wl)
        g = (w @ outer).reshape(-1, 7, 7)
        rhs = wl @ As
        eye = torch.eye(7, dtype=dt, device=dev)
        g = torch.where(valid[:, None, None], g, eye)
        d = torch.linalg.solve(g, rhs) / colnorm.to(dt)
        ten = tensor_of(d[:, :6])
        # LAPACK on the host: the card's batched solver refuses large
        # batches of 3 x 3 matrices
        w3, v3 = np.linalg.eigh(ten.cpu().numpy())
        evals = torch.from_numpy(w3[:, ::-1].copy()).to(dev)
        evecs = torch.from_numpy(v3[:, :, ::-1].copy()).to(dev)
        l1, l2, l3 = evals.unbind(-1)
        md = (l1 + l2 + l3) / 3
        fa = torch.sqrt(1.5 * ((l1 - md) ** 2 + (l2 - md) ** 2
                               + (l3 - md) ** 2)
                        / torch.clamp_min(l1 ** 2 + l2 ** 2 + l3 ** 2, 1e-30))
        z = torch.zeros((), dtype=dt, device=dev)
        parts.append(dict(
            tensor=torch.where(valid[:, None, None], ten, z),
            evals=torch.where(valid[:, None], evals, z),
            evecs=torch.where(valid[:, None, None], evecs, z),
            fa=torch.where(valid, fa, z), md=torch.where(valid, md, z),
            s0=torch.where(valid, torch.exp(d[:, 6]), z), valid=valid))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
