"""Batched closed-form eigendecomposition of symmetric 3x3 matrices.

Counterpart of fibers_tpu/ops/eig3.py, as elementwise torch: eigenvalues
by the trigonometric (Smith) method, eigenvectors by cross products of
rows of (A - lambda I) picking the best-conditioned pair, the same
fallbacks for (near-)degenerate spectra, and a Rayleigh-quotient
refinement.
"""

from __future__ import annotations

import math

import torch

__all__ = ["eigvalsh3", "eigh3"]

_EPS = 1e-30


def _sym_from_unique(u):
    """[..., 6] (xx, xy, xz, yy, yz, zz) -> [..., 3, 3] symmetric."""
    xx, xy, xz, yy, yz, zz = u.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def eigvalsh3(u):
    """Eigenvalues (descending) of symmetric 3x3 matrices given as [..., 6]
    unique elements (xx, xy, xz, yy, yz, zz).  Returns [..., 3]."""
    xx, xy, xz, yy, yz, zz = u.unbind(-1)

    q = (xx + yy + zz) / 3.0
    bxx, byy, bzz = xx - q, yy - q, zz - q
    p2 = (bxx * bxx + byy * byy + bzz * bzz
          + 2.0 * (xy * xy + xz * xz + yz * yz)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, _EPS))

    detb = (bxx * (byy * bzz - yz * yz)
            - xy * (xy * bzz - yz * xz)
            + xz * (xy * yz - byy * xz))
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3

    iso = p2 <= _EPS            # (near-)isotropic: all eigenvalues equal q
    l1 = torch.where(iso, q, l1)
    l2 = torch.where(iso, q, l2)
    l3 = torch.where(iso, q, l3)
    return torch.stack([l1, l2, l3], dim=-1)


def _unit_axis(like, axis):
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def _null_vector(m):
    """Unit vector (approximately) in the null space of symmetric [...,3,3]
    m, via the largest cross product of row pairs."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cs = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                      torch.linalg.cross(r1, r2)], dim=-2)   # [..., 3, 3]
    best = torch.argmax((cs * cs).sum(-1), dim=-1)
    c = torch.take_along_dim(cs, best[..., None, None], dim=-2)[..., 0, :]
    norm2 = (c * c).sum(-1, keepdim=True)
    ok = norm2 > _EPS
    c = torch.where(ok, c / torch.sqrt(torch.clamp_min(norm2, _EPS)),
                    _unit_axis(c, 0))
    return c, ok[..., 0]


def _any_orthonormal(v):
    """A unit vector orthogonal to unit vector v: the coordinate axis least
    aligned with v, with v projected out."""
    ax = torch.argmin(torch.abs(v), dim=-1)
    e = torch.nn.functional.one_hot(ax, 3).to(v.dtype)
    w = e - (e * v).sum(-1, keepdim=True) * v
    return w / torch.sqrt(torch.clamp_min((w * w).sum(-1, keepdim=True),
                                          _EPS))


def eigh3(u):
    """Eigen-decomposition of symmetric 3x3 matrices given as [..., 6].

    Returns (evals [..., 3] descending, evecs [..., 3, 3]) with
    evecs[..., :, k] the unit eigenvector for evals[..., k].  Within
    (near-)degenerate eigenspaces the basis is arbitrary but orthonormal.
    """
    a = _sym_from_unique(u)
    evals = eigvalsh3(u)
    eye = torch.eye(3, dtype=u.dtype, device=u.device)

    v1, ok1 = _null_vector(a - evals[..., 0, None, None] * eye)
    v3, ok3 = _null_vector(a - evals[..., 2, None, None] * eye)

    # l1 ~= l2: build v1 orthogonal to v3; l2 ~= l3: v3 orthogonal to v1;
    # both (isotropic): coordinate axes
    both_bad = ~ok1 & ~ok3
    v1 = torch.where(both_bad[..., None], _unit_axis(v1, 0), v1)
    v3 = torch.where((~ok3 & ok1)[..., None], _any_orthonormal(v1), v3)
    v1 = torch.where((~ok1)[..., None], _any_orthonormal(v3), v1)
    v3 = v3 - (v3 * v1).sum(-1, keepdim=True) * v1
    v3 = v3 / torch.sqrt(torch.clamp_min((v3 * v3).sum(-1, keepdim=True),
                                         _EPS))
    v2 = torch.linalg.cross(v3, v1)

    evecs = torch.stack([v1, v2, v3], dim=-1)

    # Rayleigh quotients v' A v recover the accuracy the f32 trigonometric
    # eigenvalues lose near degenerate spectra
    rq = torch.einsum("...ik,...ij,...jk->...k", evecs, a, evecs)
    order = torch.argsort(-rq, dim=-1, stable=True)
    evals = torch.take_along_dim(rq, order, dim=-1)
    evecs = torch.take_along_dim(evecs, order[..., None, :], dim=-1)
    return evals, evecs
