"""Coordinate transforms and mask membership helpers.

(reference: src/util.jl:18-123)
"""

from __future__ import annotations

import numpy as np

__all__ = ["cart2pol", "pol2cart", "cart2sph", "sph2cart", "ang2rot",
           "isinmask"]


def cart2pol(x, y):
    """(x, y) -> (phi, rho), phi in radians.  (reference: src/util.jl:18-24)"""
    return np.arctan2(y, x), np.hypot(x, y)


def pol2cart(phi, rho):
    """(phi, rho) -> (x, y).  (reference: src/util.jl:33-39)"""
    return rho * np.cos(phi), rho * np.sin(phi)


def cart2sph(x, y, z):
    """(x, y, z) -> (phi, theta, rho), angles in radians.
    (reference: src/util.jl:48-56)"""
    hxy = np.hypot(x, y)
    rho = np.hypot(hxy, z)
    theta = np.arctan2(z, hxy)
    phi = np.arctan2(y, x)
    return phi, theta, rho


def sph2cart(phi, theta, rho):
    """(phi, theta, rho) -> (x, y, z).  (reference: src/util.jl:67-75)"""
    z = rho * np.sin(theta)
    rct = rho * np.cos(theta)
    return rct * np.cos(phi), rct * np.sin(phi), z


def ang2rot(phi, theta):
    """Rz(phi) @ Ry(theta) rotation matrix.  (reference: src/util.jl:85-100)"""
    cf, sf = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    rz = np.array([[cf, -sf, 0], [sf, cf, 0], [0, 0, 1]])
    ry = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]])
    return rz @ ry


def isinmask(point, mask: np.ndarray) -> bool:
    """Is a (0-based) point inside a 3D boolean mask?
    (reference: src/util.jl:108-123, converted to 0-based indexing)"""
    ix, iy, iz = (int(round(float(v))) for v in point[:3])
    if not (0 <= ix < mask.shape[0] and 0 <= iy < mask.shape[1]
            and 0 <= iz < mask.shape[2]):
        return False
    return bool(mask[ix, iy, iz])
