"""Volume geometry helpers: vox2ras conversions, qform quaternions, orientation.

Host-side numpy; these run once per volume at I/O time, never on device.
Behavioral parity with the reference's geometry helpers
(reference: src/mri.jl:327, src/mri.jl:352, src/mri.jl:391, src/mri.jl:471).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "vox2ras_0to1",
    "vox2ras_tkreg",
    "vox2ras_to_qform",
    "vox2ras_to_orient",
]


def vox2ras_0to1(m0: np.ndarray) -> np.ndarray:
    """Convert a 0-based vox2ras matrix to a 1-based one.

    Pxyz = M0 * [c r s 1]' = M1 * [c+1 r+1 s+1 1]'
    (reference: src/mri.jl:327-339)
    """
    m0 = np.asarray(m0, dtype=np.float64)
    if m0.shape != (4, 4):
        raise ValueError("Input must be a 4x4 matrix")
    q = np.zeros((4, 4))
    q[0:3, 3] = 1.0
    return np.linalg.inv(np.linalg.inv(m0) + q)


def vox2ras_tkreg(voldim, voxres) -> np.ndarray:
    """0-based vox2ras compatible with tkregister matrices.

    (reference: src/mri.jl:352-371)
    """
    voldim = np.asarray(voldim, dtype=np.float64)
    voxres = np.asarray(voxres, dtype=np.float64)
    if len(voldim) < 3 or len(voxres) < 3:
        raise ValueError("Input vectors must have at least 3 elements")
    t = np.zeros((4, 4))
    t[3, 3] = 1.0
    t[0, 0] = -voxres[0]
    t[0, 3] = voxres[0] * voldim[0] / 2
    t[1, 2] = voxres[2]
    t[1, 3] = -voxres[2] * voldim[2] / 2
    t[2, 1] = -voxres[1]
    t[2, 3] = voxres[1] * voldim[1] / 2
    return t


def vox2ras_to_qform(vox2ras: np.ndarray) -> np.ndarray:
    """Convert a (6-DOF) vox2ras matrix to NIfTI qform parameters.

    Returns [quatern_b, quatern_c, quatern_d, qoffset_x, qoffset_y,
    qoffset_z, qfac].  (reference: src/mri.jl:391-462, itself following
    FreeSurfer's mriToNiftiQform / mat44_to_quatern.)
    """
    vox2ras = np.asarray(vox2ras, dtype=np.float64)
    if vox2ras.shape != (4, 4):
        raise ValueError(f"vox2ras size={vox2ras.shape}, must be (4, 4)")

    x, y, z = vox2ras[0, 3], vox2ras[1, 3], vox2ras[2, 3]

    d = np.sqrt((vox2ras[:, 0:3] ** 2).sum(axis=0))
    mdc = vox2ras[0:3, 0:3] / d[None, :]
    det = np.linalg.det(mdc)
    if det == 0:
        raise ValueError("vox2ras determinant is 0")

    r11, r12, r13 = mdc[0]
    r21, r22, r23 = mdc[1]
    r31, r32, r33 = mdc[2]

    if det > 0:
        qfac = 1.0
    else:
        r13, r23, r33 = -r13, -r23, -r33
        qfac = -1.0

    a = r11 + r22 + r33 + 1.0
    if a > 0.5:
        a = 0.5 * np.sqrt(a)
        b = 0.25 * (r32 - r23) / a
        c = 0.25 * (r13 - r31) / a
        d_ = 0.25 * (r21 - r12) / a
    else:
        xd = 1.0 + r11 - (r22 + r33)
        yd = 1.0 + r22 - (r11 + r33)
        zd = 1.0 + r33 - (r11 + r22)
        if xd > 1:
            b = 0.5 * np.sqrt(xd)
            c = 0.25 * (r12 + r21) / b
            d_ = 0.25 * (r13 + r31) / b
            a = 0.25 * (r32 - r23) / b
        elif yd > 1:
            c = 0.5 * np.sqrt(yd)
            b = 0.25 * (r12 + r21) / c
            d_ = 0.25 * (r23 + r32) / c
            a = 0.25 * (r13 - r31) / c
        else:
            d_ = 0.5 * np.sqrt(zd)
            b = 0.25 * (r13 + r31) / d_
            c = 0.25 * (r23 + r32) / d_
            a = 0.25 * (r21 - r12) / d_
        if a < 0:
            b, c, d_ = -b, -c, -d_

    return np.array([b, c, d_, x, y, z, qfac])


def vox2ras_to_orient(vox2ras: np.ndarray) -> str:
    """3-letter anatomical orientation (e.g. 'RAS', 'LIA') of a vox2ras matrix.

    (reference: src/mri.jl:471-499)
    """
    vox2ras = np.asarray(vox2ras, dtype=np.float64)
    letters = []
    for idim in range(3):
        col = vox2ras[0:3, idim]
        imax = int(np.argmax(np.abs(col)))
        pos = col[imax] > 0
        letters.append(("RL", "AP", "SI")[imax][0 if pos else 1])
    return "".join(letters)
