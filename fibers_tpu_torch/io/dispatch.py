"""mri_read / mri_write dispatch and result-struct (de)serialization.

(reference: src/mri.jl:611-733, src/mri.jl:1695-1919, src/mri.jl:2276-2311)
"""

from __future__ import annotations

import sys

import os
import re
from dataclasses import fields as dc_fields
from typing import Optional

import numpy as np

from ..core.geometry import vox2ras_to_qform
from ..core.mri import MRI, NIfTIHeader, nifti1_dtype
from .btables import mri_read_bfiles, normalize_bvecs
from .filename import mri_filename
from .mgh import load_mgh, save_mgh
from .nifti import NIFTI_CODES, load_nifti, save_nifti

__all__ = ["mri_read", "mri_write", "mri_read_struct", "mri_write_struct"]


def mri_read(infile: str, result_type: type = None, *legacy,
             headeronly: bool = False, permutedata: bool = False,
             reco: int = 1) -> MRI:
    """Read an image volume (.mgh/.mgz, .nii/.nii.gz, file stem, or Bruker
    scan directory) into an `MRI` structure.

    With a result-struct dataclass as the second argument —
    `mri_read(inbase, RUMBASD)` — reads the set of `<inbase>_<field>`
    files written by the `*_write` functions back into that struct,
    exactly like the reference's generic loader (the tutorial resumes a
    precomputed RUMBA fit this way).  The pre-round-5 positional
    signature `mri_read(path, headeronly[, permutedata[, reco]])` (bool
    second argument) is still accepted, with every legacy positional
    shifted to its old slot.

    (reference: src/mri.jl:611-733 and src/mri.jl:2276-2311)
    """
    if result_type is not None:
        if isinstance(result_type, bool):
            # pre-round-5 signature compatibility: shift ALL legacy
            # positionals, not just the first — silently dropping
            # permutedata/reco would return wrong axis order/reco
            if len(legacy) > 2:
                raise TypeError(
                    f"mri_read takes at most 4 positional arguments "
                    f"({3 + len(legacy)} given)")
            headeronly = result_type
            if len(legacy) >= 1:
                permutedata = legacy[0]
            if len(legacy) == 2:
                reco = legacy[1]
        elif not isinstance(result_type, type):
            raise TypeError(
                "mri_read's second argument must be a result-struct type "
                f"(e.g. RUMBASD) or the headeronly flag, got "
                f"{result_type!r}")
        else:
            if legacy:
                raise TypeError(
                    "mri_read(inbase, Type) takes options as keywords "
                    f"(got {len(legacy)} extra positional arguments)")
            return mri_read_struct(infile, result_type,
                                   headeronly=headeronly,
                                   permutedata=permutedata)
    elif legacy:
        raise TypeError(
            "positional options require the legacy bool second argument "
            "(headeronly); pass keywords instead")
    if os.path.isdir(infile):
        from .bruker import load_bruker
        mri = load_bruker(infile, headeronly=headeronly, reco=reco)
    else:
        fname, fstem, fext = mri_filename(infile)
        if not fname:
            raise ValueError(f"Cannot determine format of {infile}")

        if fext in ("mgh", "mgz"):
            vol, M, mr_parms, volsz = load_mgh(fname, headeronly=headeronly)
            mri = MRI(vol=vol)
            mri.fspec = fname
            mri.pwd = os.getcwd()
            if mr_parms.size:
                mri.tr, mri.flip_angle, mri.te, mri.ti = (
                    float(v) for v in mr_parms)
            if M.size == 0:
                raise ValueError(f"Loading {fname} as MGH")
            mri.vox2ras0 = M
            mri.volsize = np.asarray(volsz[0:3], dtype=np.int32)
            mri.nframes = int(volsz[3]) if len(volsz) >= 4 else 1
        elif fext in ("nii", "nii.gz"):
            hdr, vol = load_nifti(fname, headeronly=headeronly)
            if not headeronly and vol.size == 0:
                raise ValueError(f"Loading {fname} as NIfTI")

            ndim = int(hdr.dim[0])
            if 1 <= ndim <= 7:
                volsz = hdr.dim[1:1 + ndim].astype(int)
            else:
                volsz = hdr.dim[1:]
                volsz = volsz[volsz > 0].astype(int)

            # >4D data folds into dim 4 (reference: src/mri.jl:649-662)
            if len(volsz) < 5:
                mri = MRI(vol=vol)
            else:
                if headeronly:
                    mri = MRI(vol=np.zeros((0, 0, 0, 0), dtype=vol.dtype))
                else:
                    mri = MRI(vol=vol.reshape(
                        (volsz[0], volsz[1], volsz[2], -1), order="F"))

            mri.fspec = fname
            mri.pwd = os.getcwd()
            mri.niftihdr = hdr
            mri.tr = float(hdr.raw["pixdim"][4])  # already msec
            mri.flip_angle = mri.te = mri.ti = 0.0
            mri.vox2ras0 = hdr.vox2ras
            mri.volsize = np.asarray(volsz[0:3], dtype=np.int64)
            mri.nframes = int(volsz[3]) if len(volsz) >= 4 else 1
        else:
            raise ValueError(f"File extension {fext} not supported")

        # Optional DWI table sidecars (reference: src/mri.jl:681-714)
        bfile = _first_existing(fstem, (".bvals", ".bval"))
        gfile = _first_existing(fstem, (".bvecs", ".bvec"))
        if bfile and gfile:
            b, g = mri_read_bfiles(bfile, gfile)
            if b.shape[0] == mri.nframes:
                mri.bval = b
                mri.bvec = normalize_bvecs(g)

    mri.width, mri.height, mri.depth = (int(v) for v in mri.volsize)
    mri.set_geometry()

    if permutedata:
        perm = [1, 0] + list(range(2, mri.vol.ndim))
        mri.vol = np.transpose(mri.vol, perm)
        mri.volsize = mri.volsize[[1, 0, 2]]
        mri.volres = mri.volres[[1, 0, 2]]
        mri.ispermuted = True

    return mri


def _first_existing(stem: str, exts) -> Optional[str]:
    for ext in exts:
        p = stem + ext
        if os.path.isfile(p):
            return p
    return None


def mri_write(mri: MRI, outfile: str, dtype=None) -> bool:
    """Write an MRI volume to .mgh/.mgz or .nii/.nii.gz (geometry derived
    from vox2ras0).  Returns True on error.

    A result struct (DTI/GQI/DSI/RUMBASD/..., anything with MRI fields)
    as the first argument routes to `mri_write_struct(result, outfile)`
    — the write-side mirror of `mri_read(inbase, Type)`.

    (reference: src/mri.jl:1695-1919; struct writers src/dti.jl:331-352,
    src/rusd.jl:637-660)
    """
    if not isinstance(mri, MRI):
        return mri_write_struct(mri, outfile)

    err = True

    if mri.vol.size == 0:
        raise ValueError("Input structure has empty vol field")
    if dtype is None:
        dtype = mri.vol.dtype

    vsz = list(mri.vol.shape) + [1] * max(0, 4 - mri.vol.ndim)

    if mri.volsize is None or len(mri.volsize) == 0:
        mri.volsize = np.asarray(vsz[0:3], dtype=np.int64)
    if mri.nframes == 0:
        mri.nframes = int(vsz[3])
    if mri.vox2ras0 is None or mri.vox2ras0.size == 0:
        mri.vox2ras0 = np.eye(4, dtype=np.float32)
    if mri.volres is None or len(mri.volres) == 0:
        mri.volres = np.sqrt(
            (np.asarray(mri.vox2ras0)[0:3, 0:3] ** 2).sum(axis=0)
        ).astype(np.float32)

    fname, fstem, fext = mri_filename(outfile, False)
    if not fname:
        raise ValueError(f"Cannot determine format of {outfile}")

    if fext in ("mgh", "mgz"):
        M = mri.vox2ras0
        mr_parms = [mri.tr, mri.flip_angle, mri.te, mri.ti]
        vol = mri.vol
        if mri.ispermuted:
            vol = np.transpose(vol, [1, 0] + list(range(2, vol.ndim)))
        err = save_mgh(vol, fname, M, mr_parms)
    elif fext in ("nii", "nii.gz"):
        hdr = _build_nifti_hdr(mri, np.dtype(dtype))
        vol = mri.vol
        if mri.ispermuted:
            vol = np.transpose(vol, [1, 0] + list(range(2, vol.ndim)))
        err = save_nifti(hdr, vol, fname)
    else:
        raise ValueError(f"File extension {fext} not supported")

    if err:
        print(f"WARNING: Problem saving {outfile}", file=sys.stderr)

    # DWI table sidecars (reference: src/mri.jl:1908-1916)
    if mri.bval is not None and len(mri.bval):
        np.savetxt(fstem + ".bvals", np.asarray(mri.bval).reshape(-1, 1),
                   fmt="%.12g")
    if mri.bvec is not None and np.asarray(mri.bvec).size:
        np.savetxt(fstem + ".bvecs", np.asarray(mri.bvec), fmt="%.12g")

    return err


def _build_nifti_hdr(mri: MRI, dtype: np.dtype) -> NIfTIHeader:
    """Construct the on-disk NIfTI header from MRI geometry.

    (reference: src/mri.jl:1741-1889)
    """
    raw = np.zeros((), dtype=nifti1_dtype())[()]
    raw["sizeof_hdr"] = 348

    dim = np.ones(8, dtype=np.int64)
    dim[0] = 4 if mri.nframes > 1 else 3
    vs = mri.volsize[[1, 0, 2]] if mri.ispermuted else mri.volsize[0:3]
    dim[1:4] = vs
    dim[4] = mri.nframes

    # FreeSurfer >32k-columns hack (reference: src/mri.jl:1754-1759)
    if dim[1] > 2 ** 15:
        raw["glmin"] = dim[1]
        dim[1] = -1
    raw["dim"] = dim.astype(np.int16)

    if dtype not in NIFTI_CODES:
        raise ValueError(f"Data type {dtype} not supported")
    raw["datatype"] = NIFTI_CODES[dtype]
    raw["bitpix"] = dtype.itemsize * 8

    volres = mri.volres[[1, 0, 2]] if mri.ispermuted else mri.volres[0:3]
    pixdim = np.zeros(8, dtype=np.float32)
    pixdim[1:4] = volres
    pixdim[4] = mri.tr

    raw["vox_offset"] = 352
    raw["scl_slope"] = mri.niftihdr.raw["scl_slope"]
    raw["scl_inter"] = mri.niftihdr.raw["scl_inter"]
    raw["xyzt_units"] = 2 | 16      # mm | msec
    raw["cal_max"] = float(np.max(mri.vol))
    raw["cal_min"] = float(np.min(mri.vol))
    # the reference's descrip: the two packages write identical files
    raw["descrip"] = b"FreeSurfer python/jax"
    raw["qform_code"] = 1           # NIFTI_XFORM_SCANNER_ANAT
    raw["sform_code"] = 1

    # Qform (6 DOF) (reference: src/mri.jl:1826-1833)
    b, c, d, x, y, z, qfac = vox2ras_to_qform(mri.vox2ras0)
    pixdim[0] = qfac
    raw["pixdim"] = pixdim
    raw["quatern_b"] = b
    raw["quatern_c"] = c
    raw["quatern_d"] = d
    raw["quatern_x"] = x
    raw["quatern_y"] = y
    raw["quatern_z"] = z

    # Sform (any affine) (reference: src/mri.jl:1836-1838)
    raw["srow_x"] = np.asarray(mri.vox2ras0[0, :], dtype=np.float32)
    raw["srow_y"] = np.asarray(mri.vox2ras0[1, :], dtype=np.float32)
    raw["srow_z"] = np.asarray(mri.vox2ras0[2, :], dtype=np.float32)

    raw["intent_name"] = b"huh?"
    raw["magic"] = b"n+1\x00"

    return NIfTIHeader(raw=raw, dim=dim)


# ------------------------------------------------------------------ #
# Result-struct serialization convention: each MRI field of a result
# dataclass maps to <base>_<field>.nii.gz, lists of MRI to
# <base>_<field><i>.nii.gz, scalars to <base>_<field>.txt.
# (reference: src/dti.jl:344-349, src/mri.jl:2276-2311)
# ------------------------------------------------------------------ #

def mri_write_struct(result, basename: str) -> None:
    """Write every field of a result dataclass using the reference's
    field-per-file convention."""
    for f in dc_fields(result):
        if f.name.startswith("_"):
            continue          # private runtime state (e.g. device peaks)
        val = getattr(result, f.name)
        if isinstance(val, MRI):
            mri_write(val, f"{basename}_{f.name}.nii.gz")
        elif isinstance(val, (list, tuple)) and val and isinstance(val[0], MRI):
            for i, v in enumerate(val):
                mri_write(v, f"{basename}_{f.name}{i + 1}.nii.gz")
        elif val is None:
            continue
        else:
            np.savetxt(f"{basename}_{f.name}.txt",
                       np.atleast_1d(np.asarray(val, dtype=np.float32)),
                       fmt="%.9g")


def mri_read_struct(inbase: str, result_type, headeronly: bool = False,
                    permutedata: bool = False):
    """Read a set of <base>_<field> files back into a result dataclass.

    Mirrors `mri_read(inbase, Type)` (reference: src/mri.jl:2276-2311).
    """
    absbase = os.path.abspath(inbase)
    dirname = os.path.dirname(absbase)
    flist = sorted(
        os.path.join(dirname, f) for f in os.listdir(dirname))

    import typing

    kwargs = {}
    for f in dc_fields(result_type):
        if f.name.startswith("_"):
            continue          # private runtime state, never on disk
        ftype = f.type
        if isinstance(ftype, str):
            is_mri = ftype.split(".")[-1] == "MRI"
            is_mri_list = ("MRI" in ftype) and any(
                ftype.replace(" ", "").lower().startswith(p)
                for p in ("list[", "typing.list[", "tuple["))
        else:
            origin = typing.get_origin(ftype)
            args = typing.get_args(ftype)
            is_mri = ftype is MRI
            is_mri_list = origin in (list, tuple) and MRI in args
        if is_mri:
            infile = f"{absbase}_{f.name}.nii.gz"
            kwargs[f.name] = mri_read(infile, headeronly=headeronly,
                                      permutedata=permutedata)
        elif is_mri_list:
            pat = re.compile(
                "^" + re.escape(absbase) + "_" + re.escape(f.name)
                + r"[0-9]*\.nii\.gz$")
            infiles = [p for p in flist if pat.match(p)]
            kwargs[f.name] = [
                mri_read(p, headeronly=headeronly, permutedata=permutedata)
                for p in infiles]
        else:
            mat = np.loadtxt(f"{absbase}_{f.name}.txt", dtype=np.float32)
            kwargs[f.name] = float(mat) if mat.size == 1 else mat

    return result_type(**kwargs)
