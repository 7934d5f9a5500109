"""ODF sphere tessellations.

The `ODF` container plus the three standard tessellations used by the
reference (reference: src/odf.jl:8-11, src/odf.jl:14, src/odf.jl:1104,
src/odf.jl:3034), packaged as .npz data.  Vertices are antipodally
symmetric: vertex i + n/2 == -vertex i; models work on the half sphere.

Faces use 1-based vertex indices, as in the reference tables — model code
that consumes them converts to 0-based half-sphere indices once, at setup.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = ["ODF", "sphere_362", "sphere_642", "sphere_724", "half_sphere"]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")


@dataclass(frozen=True)
class ODF:
    """Vertices [n, 3] float32 and faces [m, 3] int32 (1-based)."""

    vertices: np.ndarray
    faces: np.ndarray

    @property
    def nvert_half(self) -> int:
        return self.vertices.shape[0] // 2


@lru_cache(maxsize=None)
def _load(name: str) -> ODF:
    with np.load(os.path.join(_DATA_DIR, f"{name}.npz")) as z:
        return ODF(vertices=z["vertices"], faces=z["faces"])


def __getattr__(name: str):
    if name in ("sphere_362", "sphere_642", "sphere_724"):
        return _load(name)
    raise AttributeError(name)


def half_sphere(odf_dirs: ODF):
    """Half-sphere vertices and 0-based folded faces.

    Returns (vertices_lower [n/2, 3] from the second half of the table,
    vertices_upper [n/2, 3] from the first half, faces0 [m, 3] int32 with
    indices folded onto the half sphere, 0-based).

    The reference folds faces by `faces[faces > nvert] -= nvert`
    (reference: src/gqi.jl:63-64) and builds system matrices from
    `vertices[nvert+1:end, :]` (reference: src/gqi.jl:69).
    """
    n = odf_dirs.nvert_half
    faces = odf_dirs.faces.copy()
    faces[faces > n] -= n
    return odf_dirs.vertices[n:], odf_dirs.vertices[:n], faces - 1
