"""DWI b-value / gradient table readers.

(reference: src/mri.jl:2179-2266)
"""

from __future__ import annotations

import numpy as np

__all__ = ["mri_read_bfiles", "mri_read_bfiles_into", "normalize_bvecs"]


def _read_table(infile: str) -> np.ndarray:
    try:
        tab = np.loadtxt(infile, dtype=np.float32, ndmin=2)
    except OSError:
        raise IOError(f"Could not open {infile}")
    except ValueError:
        raise ValueError(f"File {infile} contains non-numeric entries")
    return tab


def mri_read_bfiles(infile1: str, infile2: str):
    """Read b-value and gradient tables (in either argument order).

    Returns (bval [n], bvec [n, 3]).  Row/column layouts are both accepted.
    (reference: src/mri.jl:2179-2229)
    """
    tabs = [_read_table(infile1), _read_table(infile2)]

    ival, ivec = (0, 1) if tabs[0].size < tabs[1].size else (1, 0)

    # b-value table to single column
    if tabs[ival].shape[1] != 1:
        if tabs[ival].shape[0] != 1:
            bad = infile1 if ival == 0 else infile2
            raise ValueError(
                f"Wrong format in table {bad} (should be single column or row)")
        tabs[ival] = tabs[ival].T

    # gradient table to three columns
    if tabs[ivec].shape[1] != 3:
        if tabs[ivec].shape[0] != 3:
            bad = infile1 if ivec == 0 else infile2
            raise ValueError(
                f"Wrong format in table {bad} (should be three columns or rows)")
        tabs[ivec] = tabs[ivec].T

    if tabs[0].shape[0] != tabs[1].shape[0]:
        raise ValueError(
            f"Dimension mismatch between tables in {infile1} "
            f"{tabs[0].shape} and {infile2} {tabs[1].shape}")

    return tabs[ival][:, 0], tabs[ivec]


def normalize_bvecs(bvec: np.ndarray) -> np.ndarray:
    """Unit-normalize gradient rows; zero rows stay zero.
    (reference: src/mri.jl:711-712)"""
    bvec = np.asarray(bvec, dtype=np.float32)
    norm = np.sqrt((bvec ** 2).sum(axis=1, keepdims=True))
    with np.errstate(invalid="ignore", divide="ignore"):
        out = bvec / norm
    out[~np.isfinite(out)] = 0.0
    return out


def mri_read_bfiles_into(dwi, infile1: str, infile2: str):
    """Set dwi.bval/dwi.bvec from table files (any argument order).

    Mirrors `mri_read_bfiles!` (reference: src/mri.jl:2243-2266).
    """
    bval, bvec = mri_read_bfiles(infile1, infile2)

    nframes = dwi.vol.shape[3] if dwi.vol.ndim > 3 else 1
    if bval.shape[0] != nframes:
        raise ValueError(
            f"Number of frames in volume ({nframes}) does not match "
            f"dimensions of table in {infile1} {bval.shape}")

    dwi.bval = bval
    dwi.bvec = normalize_bvecs(bvec)
    return bval, bvec
