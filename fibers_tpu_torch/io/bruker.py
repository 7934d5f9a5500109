"""Bruker ParaVision scan-directory reader.

Parses the `method`, `acqp`, `pdata/N/reco`, `pdata/N/visu_pars` JCAMP-DX
text files plus the `2dseq` raw binary, restores slope/offset intensity and
receiver gain, and builds the vox2ras from VisuCoreOrientation/Position.
(reference: src/mri.jl:812-1189)
"""

from __future__ import annotations

import os

import numpy as np

from ..core.mri import MRI
from .btables import normalize_bvecs

__all__ = ["load_bruker"]


def _read_numbers_multiline(lines, i, nval, dtype=float):
    """Collect `nval` whitespace-separated numbers starting at lines[i+1].

    Handles the PV360 `@N*(v)` run-length shorthand
    (reference: src/mri.jl:975-987).  Returns (values, next_index).
    """
    vals = []
    j = i
    while len(vals) < nval:
        j += 1
        ln = lines[j].strip()
        if ln.startswith(f"@{nval}"):
            inner = ln.split("(", 1)[1].split(")", 1)[0]
            vals.extend([dtype(inner)] * nval)
        else:
            vals.extend(dtype(w) for w in ln.split())
    return vals, j


def _paren_count(ln):
    inner = ln.split("(", 1)[1].split(")", 1)[0]
    parts = [p.strip() for p in inner.split(",")]
    n = 1
    for p in parts:
        n *= int(p)
    return n


def load_bruker(indir: str, headeronly: bool = False, reco: int = 1) -> MRI:
    dname = os.path.abspath(indir)
    methfile = os.path.join(dname, "method")
    acqpfile = os.path.join(dname, "acqp")
    recofile = os.path.join(dname, "pdata", str(reco), "reco")
    visufile = os.path.join(dname, "pdata", str(reco), "visu_pars")
    imgfile = os.path.join(dname, "pdata", str(reco), "2dseq")

    if not all(os.path.isfile(p) for p in (methfile, acqpfile, recofile,
                                           imgfile)):
        raise FileNotFoundError(
            "Input directory must contain the files: method, acqp, "
            f"pdata/{reco}/reco, pdata/{reco}/2dseq")

    mri = MRI(vol=np.zeros((0, 0, 0, 0), dtype=np.float32))
    mri.fspec = imgfile
    mri.pwd = os.getcwd()

    slicethick = 1.0
    nslice = 1
    nb0 = 0

    # ---- method file (reference: src/mri.jl:837-906) ----
    with open(methfile) as f:
        lines = f.read().splitlines()

    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("##$PVM_SpatResol="):
            i += 1
            mri.volres = np.array([float(w) for w in lines[i].split()],
                                  dtype=np.float32)
        elif ln.startswith("##$PVM_Matrix="):
            i += 1
            mri.volsize = np.array([int(float(w)) for w in lines[i].split()],
                                   dtype=np.int64)
        elif ln.startswith("##$PVM_SliceThick="):
            slicethick = float(ln.split("=", 1)[1])
        elif ln.startswith("##$PVM_SPackArrNSlices="):
            i += 1
            nslice = int(sum(float(w) for w in lines[i].split()))
        elif ln.startswith("##$EchoTime="):
            mri.te = float(ln.split("=", 1)[1])
        elif ln.startswith("##$PVM_RepetitionTime="):
            mri.tr = float(ln.split("=", 1)[1])
        elif ln.startswith("##$PVM_DwAoImages="):
            nb0 = int(ln.split("=", 1)[1])
        elif ln.startswith("##$PVM_DwDir="):
            nval = _paren_count(ln)
            vals, i = _read_numbers_multiline(lines, i, nval)
            bvec = np.asarray(vals, dtype=np.float32).reshape(-1, 3)
            mri.bvec = normalize_bvecs(bvec)
        elif ln.startswith("##$PVM_DwEffBval="):
            nval = _paren_count(ln)
            vals, i = _read_numbers_multiline(lines, i, nval)
            mri.bval = np.asarray(vals, dtype=np.float32)
        i += 1

    # b=0 volumes are in the b-value list but not the vector list
    # (reference: src/mri.jl:910-914)
    if mri.bvec.size and nb0 > 0:
        mri.bvec = np.vstack([np.zeros((nb0, 3), np.float32), mri.bvec])

    is2d = (len(mri.volres) == 2 and len(mri.volsize) == 2)
    if is2d:
        mri.volres = np.append(mri.volres, np.float32(slicethick))
        mri.volsize = np.append(mri.volsize, nslice)

    # ---- acqp: receiver gain (reference: src/mri.jl:924-940) ----
    gain = 1.0
    with open(acqpfile) as f:
        for ln in f:
            if ln.startswith("##$RG="):
                gain = float(ln.split("=", 1)[1])
    gain /= 64.0

    # ---- reco file (reference: src/mri.jl:942-1015) ----
    with open(recofile) as f:
        lines = f.read().splitlines()

    image_type = ""
    data_type = np.int32
    int_offset: list = []
    int_slope: list = []
    byte_order = ""

    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("##$RECO_image_type="):
            image_type = ln.split("=", 1)[1]
        elif ln.startswith("##$RECO_wordtype="):
            wt = ln.split("=", 1)[1]
            data_type = {
                "_32BIT_FLOAT": np.float32,
                "_32BIT_SGN_INT": np.int32,
                "_16BIT_SGN_INT": np.int16,
                "_8BIT_UNSGN_INT": np.uint8,
            }.get(wt, np.int32)
        elif ln.startswith("##$RECO_map_offset="):
            nval = _paren_count(ln)
            vals, i = _read_numbers_multiline(lines, i, nval)
            int_offset.extend(vals)
        elif ln.startswith("##$RECO_map_slope"):
            nval = _paren_count(ln)
            vals, i = _read_numbers_multiline(lines, i, nval)
            int_slope.extend(vals)
        elif ln.startswith("##$RECO_byte_order="):
            byte_order = ln.split("=", 1)[1]
        i += 1

    if image_type == "COMPLEX_IMAGE":
        # Real and imaginary frames share the same slope/offset
        int_slope = int_slope + int_slope
        int_offset = int_offset + int_offset

    mri.image_type = image_type
    mri.nframes = (len(int_slope) // nslice) if is2d else len(int_slope)

    # ---- visu_pars (reference: src/mri.jl:1027-1104) ----
    data_units = ""
    visu_size: list = []
    visu_order: list = []
    visu_fov: list = []
    visu_orient: list = []
    visu_pos: list = []

    if os.path.isfile(visufile):
        with open(visufile) as f:
            lines = f.read().splitlines()
        i = 0
        while i < len(lines):
            ln = lines[i]
            if ln.startswith("##$VisuCoreDataUnits="):
                i += 1
                data_units = lines[i].replace("<", "").replace(">", "")
            elif ln.startswith("##$VisuCoreSize="):
                i += 1
                visu_size = [int(float(w)) for w in lines[i].split()]
            elif ln.startswith("##$VisuCoreExtent="):
                i += 1
                visu_fov = [float(w) for w in lines[i].split()]
            elif ln.startswith("##$VisuCoreOrientation="):
                nval = _paren_count(ln)
                visu_orient, i = _read_numbers_multiline(lines, i, nval)
                if is2d:
                    # One orientation per slice: use the middle slice
                    k = (len(visu_orient) // 9 // 2) * 9
                    visu_orient = visu_orient[k:k + 9]
            elif ln.startswith("##$VisuCorePosition="):
                nval = _paren_count(ln)
                visu_pos, i = _read_numbers_multiline(lines, i, nval)
                if is2d:
                    k = (len(visu_pos) // 3 // 2) * 3
                    visu_pos = visu_pos[k:k + 3]
            elif ln.startswith("##$VisuAcqGradEncoding"):
                i += 1
                words = lines[i].split()
                def _idx(name):
                    return words.index(name) + 1 if name in words else None
                if is2d:
                    visu_order = [_idx("read_enc"), _idx("phase_enc"), 3]
                else:
                    visu_order = [_idx("read_enc"), _idx("phase_enc"),
                                  _idx("slice_enc")]
            i += 1

    # Update resolution and matrix size (reference: src/mri.jl:1106-1118)
    if visu_fov and visu_size:
        if is2d:
            visu_fov = visu_fov + [float(mri.volsize[2] * mri.volres[2])]
            visu_size = visu_size + [int(mri.volsize[2])]
        dv = np.asarray(visu_fov) / np.asarray(visu_size)
        mri.volres = dv.astype(np.float32)
        mri.volsize = np.asarray(visu_size, dtype=np.int64)

    if not visu_orient:
        visu_orient = [1, 0, 0, 0, 1, 0, 0, 0, 1]
    if not visu_pos:
        visu_pos = [0, 0, 0]

    # vox2ras from orientation/position (reference: src/mri.jl:1129-1133)
    o = visu_orient
    rot = np.array([[o[0], o[3], o[6], visu_pos[0]],
                    [o[1], o[4], o[7], visu_pos[1]],
                    [o[2], o[5], o[8], visu_pos[2]],
                    [0, 0, 0, 1]], dtype=np.float64)
    mri.vox2ras0 = (rot @ np.diag(list(mri.volres) + [1.0])).astype(np.float32)

    if headeronly:
        return mri

    # ---- 2dseq raw data (reference: src/mri.jl:1139-1157) ----
    if not visu_order or visu_order == [1, 2, 3]:
        shape = tuple(int(v) for v in mri.volsize) + (int(mri.nframes),)
    else:
        vs = visu_size if visu_size else [
            int(mri.volsize[k - 1]) for k in visu_order]
        shape = tuple(int(v) for v in vs) + (int(mri.nframes),)

    bo = "<" if byte_order == "littleEndian" else ">"
    raw = np.fromfile(imgfile, dtype=np.dtype(data_type).newbyteorder(bo))
    raw = raw[:int(np.prod(shape))].reshape(shape, order="F")
    raw = raw.astype(data_type)

    # Intensity slope/offset restore (reference: src/mri.jl:1159-1180)
    if data_type == np.float32:
        mri.vol = raw
    else:
        vol = np.empty(shape, dtype=np.float32)
        if is2d:    # One slope/offset per slice
            k = 0
            for iframe in range(mri.nframes):
                for islice in range(int(mri.volsize[2])):
                    vol[:, :, islice, iframe] = (
                        raw[:, :, islice, iframe].astype(np.float64)
                        / int_slope[k] + int_offset[k])
                    k += 1
        else:       # One slope/offset per volume
            for iframe in range(mri.nframes):
                vol[:, :, :, iframe] = (
                    raw[:, :, :, iframe].astype(np.float64)
                    / int_slope[iframe] + int_offset[iframe])
        mri.vol = vol

    # Receiver-gain normalization for unitless magnitude/complex images
    # (reference: src/mri.jl:1182-1186)
    if image_type != "PHASE_IMAGE" and not data_units:
        mri.vol = mri.vol / np.float32(gain)

    return mri
