"""Registration transforms: FreeSurfer .lta and FSL .mat readers, composition,
application.  Points are 0-based voxel coordinates throughout.

(reference: src/util.jl:127-454)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Xform", "xfm_read", "xfm_read_mat", "xfm_compose", "xfm_apply",
           "xfm_rotate", "xfm_inv"]


@dataclass
class Xform:
    """Container for an image transform.  (reference: src/util.jl:127-137)"""

    insize: np.ndarray = field(default_factory=lambda: np.zeros(3, int))
    outsize: np.ndarray = field(default_factory=lambda: np.zeros(3, int))
    inres: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    outres: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    invox2ras: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    outvox2ras: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    vox2vox: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    ras2ras: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    voxrot: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))


def _polar_rotation(m3: np.ndarray) -> np.ndarray:
    """Rotation part of a 3x3 matrix via SVD polar decomposition.
    (reference: src/util.jl:266-267)"""
    u, _, vt = np.linalg.svd(np.asarray(m3, dtype=np.float64))
    return (u @ vt).astype(np.float32)


def xfm_read(ltafile: str, dtype=np.float32) -> Xform:
    """Read a FreeSurfer .lta transform (LINEAR_VOX_TO_VOX or
    LINEAR_RAS_TO_RAS).  (reference: src/util.jl:163-270)"""
    vals = {}
    regtype = None
    regmat = None
    readsrc = None

    with open(ltafile) as f:
        lines = f.read().splitlines()

    i = 0
    while i < len(lines):
        ln = lines[i].split()
        if not ln:
            i += 1
            continue
        if ln[0] == "type":
            regtype = int(ln[2])
        elif ln[0] == "1" and len(ln) >= 3 and ln[1] == "4" and ln[2] == "4":
            rows = []
            for k in range(1, 5):
                rows.append([float(w) for w in lines[i + k].split()])
            regmat = np.asarray(rows, dtype=np.float64)
            i += 4
        elif ln[0] == "src":
            readsrc = True
        elif ln[0] == "dst":
            readsrc = False
        elif ln[0] in ("volume", "voxelsize", "xras", "yras", "zras", "cras"):
            key = ("in_" if readsrc else "out_") + ln[0]
            vals[key] = np.array([float(w) for w in ln[2:5]])
        i += 1

    if regtype is None:
        raise ValueError(f"Missing transform type in {ltafile}")
    if regmat is None:
        raise ValueError(f"Missing transform matrix in {ltafile}")
    for side, what in (("in", "source"), ("out", "destination")):
        for k in ("volume", "voxelsize", "xras", "yras", "zras", "cras"):
            if f"{side}_{k}" not in vals:
                raise ValueError(f"Missing {what} {k} in {ltafile}")

    xfm = Xform()
    xfm.insize = vals["in_volume"].astype(int)
    xfm.outsize = vals["out_volume"].astype(int)
    xfm.inres = vals["in_voxelsize"].astype(dtype)
    xfm.outres = vals["out_voxelsize"].astype(dtype)

    def _vox2ras(side):
        v2r3 = np.stack([vals[f"{side}_xras"] * vals[f"{side}_voxelsize"][0],
                         vals[f"{side}_yras"] * vals[f"{side}_voxelsize"][1],
                         vals[f"{side}_zras"] * vals[f"{side}_voxelsize"][2]],
                        axis=1)
        m = np.eye(4)
        m[0:3, 0:3] = v2r3
        m[0:3, 3] = vals[f"{side}_cras"] - (v2r3 @ vals[f"{side}_volume"]) / 2
        return m

    xfm.invox2ras = _vox2ras("in").astype(dtype)
    xfm.outvox2ras = _vox2ras("out").astype(dtype)

    if regtype == 0:      # LINEAR_VOX_TO_VOX
        xfm.vox2vox = regmat.astype(dtype)
        xfm.ras2ras = (xfm.outvox2ras.astype(np.float64) @ regmat
                       @ np.linalg.inv(xfm.invox2ras.astype(np.float64))
                       ).astype(dtype)
    elif regtype == 1:    # LINEAR_RAS_TO_RAS
        xfm.vox2vox = (np.linalg.inv(xfm.outvox2ras.astype(np.float64))
                       @ regmat @ xfm.invox2ras.astype(np.float64)
                       ).astype(dtype)
        xfm.ras2ras = regmat.astype(dtype)
    else:
        raise ValueError(f"Invalid transform type {regtype} in {ltafile}")

    xfm.voxrot = _polar_rotation(xfm.vox2vox[0:3, 0:3])
    return xfm


def xfm_read_mat(matfile: str, inref, outref, dtype=np.float32) -> Xform:
    """Read an FSL .mat transform given input/output reference volumes.
    (reference: src/util.jl:281-320)"""
    xfm = Xform()
    xfm.insize = np.asarray(inref.volsize, dtype=int)
    xfm.outsize = np.asarray(outref.volsize, dtype=int)
    xfm.inres = np.asarray(inref.volres, dtype=dtype)
    xfm.outres = np.asarray(outref.volres, dtype=dtype)
    xfm.invox2ras = np.asarray(inref.vox2ras, dtype=dtype)
    xfm.outvox2ras = np.asarray(outref.vox2ras, dtype=dtype)

    # Convert from FSL-style matrix to true vox2vox
    din = np.diag(list(np.asarray(inref.volres, np.float64)) + [1.0])
    if np.linalg.det(np.asarray(inref.vox2ras, np.float64)) > 0:
        din[0, 0] *= -1
        din[0, 3] = inref.volres[0] * (inref.volsize[0] - 1)

    dout = np.diag(list(np.asarray(outref.volres, np.float64)) + [1.0])
    if np.linalg.det(np.asarray(outref.vox2ras, np.float64)) > 0:
        dout[0, 0] *= -1
        dout[0, 3] = outref.volres[0] * (outref.volsize[0] - 1)

    mat = np.loadtxt(matfile, dtype=np.float64).reshape(4, 4)
    xfm.vox2vox = (np.linalg.inv(dout) @ mat @ din).astype(dtype)
    xfm.ras2ras = (np.asarray(outref.vox2ras, np.float64)
                   @ xfm.vox2vox.astype(np.float64)
                   @ np.linalg.inv(np.asarray(inref.vox2ras, np.float64))
                   ).astype(dtype)
    xfm.voxrot = _polar_rotation(xfm.vox2vox[0:3, 0:3])
    return xfm


def xfm_inv(xfm: Xform) -> Xform:
    """Inverse transform.  (reference: src/util.jl:328-343)"""
    out = Xform()
    out.insize, out.outsize = xfm.outsize, xfm.insize
    out.inres, out.outres = xfm.outres, xfm.inres
    out.invox2ras, out.outvox2ras = xfm.outvox2ras, xfm.invox2ras
    out.vox2vox = np.linalg.inv(
        xfm.vox2vox.astype(np.float64)).astype(xfm.vox2vox.dtype)
    out.ras2ras = np.linalg.inv(
        xfm.ras2ras.astype(np.float64)).astype(xfm.ras2ras.dtype)
    out.voxrot = xfm.voxrot.T.copy()
    return out


def xfm_compose(xfm1: Xform, *rest: Xform) -> Xform:
    """Compose transforms; the last argument is applied first.
    (reference: src/util.jl:356-375)"""
    chain = (xfm1,) + rest
    out = Xform()
    out.insize = chain[-1].insize
    out.outsize = xfm1.outsize
    out.inres = chain[-1].inres
    out.outres = xfm1.outres
    out.invox2ras = chain[-1].invox2ras
    out.outvox2ras = xfm1.outvox2ras

    v = np.eye(4)
    r = np.eye(4)
    for x in chain:
        v = v @ x.vox2vox.astype(np.float64)
        r = r @ x.ras2ras.astype(np.float64)
    out.vox2vox = v.astype(xfm1.vox2vox.dtype)
    out.ras2ras = r.astype(xfm1.ras2ras.dtype)
    out.voxrot = _polar_rotation(out.vox2vox[0:3, 0:3])
    return out


def xfm_apply(xfm: Xform, points: np.ndarray) -> np.ndarray:
    """Apply the vox2vox transform to points (homogeneous with perspective
    divide).  `points` is [..., 3] or [3, n]-style; any array whose total
    length is a multiple of 3 is treated as packed xyz triplets, matching
    the reference (reference: src/util.jl:385-425)."""
    pts = np.asarray(points, dtype=np.float64)
    shape = pts.shape
    flat = pts.reshape(-1, order="F") if pts.ndim == 2 and shape[0] == 3 \
        else pts.reshape(-1)
    tri = flat.reshape(-1, 3)

    m = xfm.vox2vox.astype(np.float64)
    lin = tri @ m[0:3, 0:3].T + m[0:3, 3]
    aff = tri @ m[3, 0:3] + m[3, 3]
    out = lin / aff[:, None]

    if pts.ndim == 2 and shape[0] == 3:
        out = out.reshape(-1, order="C").reshape(shape, order="F")
    else:
        out = out.reshape(shape)
    if np.issubdtype(np.asarray(points).dtype, np.integer):
        out = np.rint(out).astype(np.asarray(points).dtype)
    else:
        out = out.astype(np.asarray(points).dtype)
    return out


def xfm_rotate(xfm: Xform, point: np.ndarray) -> np.ndarray:
    """Apply only the rotation component.  (reference: src/util.jl:435-454)"""
    return (xfm.voxrot.astype(np.float64)
            @ np.asarray(point, np.float64)).astype(
                np.asarray(point).dtype if np.issubdtype(
                    np.asarray(point).dtype, np.floating) else np.float64)
