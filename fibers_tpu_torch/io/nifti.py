"""NIfTI-1 reader/writer, byte-faithful to the reference's behavior.

Differences from the reference implementation (src/mri.jl:1394-1672,
src/mri.jl:2059-2166): compression is handled with in-process zlib/gzip
streams instead of `zcat`/`gzip` subprocesses and temp files, and header
parsing uses a structured numpy dtype instead of per-field pointer loads.
The parsed values, unit normalization, qform/sform logic and the written
byte stream are behaviorally identical.
"""

from __future__ import annotations

import sys

import gzip
import io as _io

import numpy as np

from ..core.mri import NIfTIHeader, nifti1_dtype

__all__ = ["load_nifti", "load_nifti_hdr", "save_nifti", "NIFTI_DTYPES"]

# NIfTI datatype code <-> numpy dtype (reference: src/mri.jl:1604-1627)
NIFTI_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
NIFTI_CODES = {np.dtype(v): k for k, v in NIFTI_DTYPES.items()}


def _open_maybe_gz(fname: str):
    """Binary stream over a possibly-gzipped file (in-process, no subprocess)."""
    if fname.lower().endswith(".gz"):
        return gzip.open(fname, "rb")
    return open(fname, "rb")


def _parse_hdr(buffer: bytes, fname: str = "") -> NIfTIHeader:
    if len(buffer) < 348:
        raise ValueError(f"Short NIfTI header in {fname}")

    headsize = np.frombuffer(buffer[:4], dtype="<i4")[0]
    if headsize == 348:
        bo, do_bswap = "<", False
    elif np.frombuffer(buffer[:4], dtype=">i4")[0] == 348:
        bo, do_bswap = ">", True
    else:
        raise ValueError(
            f"Invalid header size {headsize} found in NIfTI header")

    rec = np.frombuffer(buffer[:348], dtype=nifti1_dtype(bo))[0]
    # Native-endian mutable copy
    raw = np.zeros((), dtype=nifti1_dtype())[()]
    for name in raw.dtype.names:
        raw[name] = rec[name]

    # FreeSurfer >32k-columns hack (reference: src/mri.jl:1428-1434)
    # Normalized dims can exceed int16 range, so they live in hdr.dim
    # (int64), not in the raw record.
    dim = raw["dim"].astype(np.int64)
    if dim[1] < 0:
        dim[1] = int(raw["glmin"])
        raw["glmin"] = 0

    # FreeSurfer ico7 surface hack (reference: src/mri.jl:1436-1439)
    nspatial = int(np.prod(dim[1:4]))
    if nspatial == 163842:
        dim[1:4] = (163842, 1, 1)

    # Unit normalization to mm / msec (reference: src/mri.jl:1441-1487)
    xyzunits = raw["xyzt_units"] & 7
    if xyzunits == 1:
        xyzscale = 1000.0       # meters
    elif xyzunits == 2:
        xyzscale = 1.0          # mm
    elif xyzunits == 3:
        xyzscale = 0.001        # microns
    else:
        print(f"WARNING: xyz units code {xyzunits} is unrecognized, "
              "assuming mm", file=sys.stderr)
        xyzscale = 1.0

    tunits = raw["xyzt_units"] & 56
    if tunits == 8:
        tscale = 1000.0         # seconds
    elif tunits == 16:
        tscale = 1.0            # msec
    elif tunits == 32:
        tscale = 0.001          # microsec
    else:
        tscale = 0.0            # no time scale

    pixdim = raw["pixdim"].copy()
    pixdim[1:4] *= xyzscale
    pixdim[4] *= tscale
    raw["pixdim"] = pixdim
    for row in ("srow_x", "srow_y", "srow_z"):
        raw[row] = raw[row] * xyzscale
    raw["xyzt_units"] = 2 | 16

    # Sform matrix (reference: src/mri.jl:1490-1493)
    sform = np.vstack([
        raw["srow_x"], raw["srow_y"], raw["srow_z"],
        np.array([0, 0, 0, 1], np.float32),
    ]).astype(np.float32)

    # Qform matrix from quaternion (reference: src/mri.jl:1496-1537)
    b = float(raw["quatern_b"])
    c = float(raw["quatern_c"])
    d = float(raw["quatern_d"])
    x = float(raw["quatern_x"])
    y = float(raw["quatern_y"])
    z = float(raw["quatern_z"])
    a = 1.0 - (b * b + c * c + d * d)
    if abs(a) < 1.0e-7:
        a = 1.0 / np.sqrt(b * b + c * c + d * d)
        b, c, d = b * a, c * a, d * a
        a = 0.0
    else:
        a = np.sqrt(a)
    r11 = a * a + b * b - c * c - d * d
    r12 = 2 * b * c - 2 * a * d
    r13 = 2 * b * d + 2 * a * c
    r21 = 2 * b * c + 2 * a * d
    r22 = a * a + c * c - b * b - d * d
    r23 = 2 * c * d - 2 * a * b
    r31 = 2 * b * d - 2 * a * c
    r32 = 2 * c * d + 2 * a * b
    r33 = a * a + d * d - c * c - b * b
    if pixdim[0] < 0.0:
        r13, r23, r33 = -r13, -r23, -r33
    qmdc = np.array([[r11, r12, r13], [r21, r22, r23], [r31, r32, r33]])
    dscale = np.diag(pixdim[1:4].astype(np.float64))
    qform = np.eye(4)
    qform[0:3, 0:3] = qmdc @ dscale
    qform[0:3, 3] = (x, y, z)
    qform = qform.astype(np.float32)

    # vox2ras policy: sform over qform (reference: src/mri.jl:1539-1555)
    if raw["sform_code"] != 0:
        vox2ras = sform
    elif raw["qform_code"] != 0:
        vox2ras = qform
    else:
        print(f"WARNING: neither sform or qform are valid in {fname}", file=sys.stderr)
        vox2ras = np.eye(4, dtype=np.float32)
        vox2ras[0, 0], vox2ras[1, 1], vox2ras[2, 2] = pixdim[1:4]

    return NIfTIHeader(raw=raw, do_bswap=do_bswap, sform=sform, qform=qform,
                       vox2ras=vox2ras, dim=dim)


def load_nifti_hdr(fname: str) -> NIfTIHeader:
    """Load and normalize a NIfTI-1 header (uncompressed file).

    (reference: src/mri.jl:1394-1558)
    """
    with open(fname, "rb") as f:
        return _parse_hdr(f.read(348), fname)


def load_nifti(fname: str, headeronly: bool = False):
    """Load a .nii/.nii.gz volume.  Returns (NIfTIHeader, ndarray).

    (reference: src/mri.jl:1576-1672)
    """
    with _open_maybe_gz(fname) as f:
        buf = f.read() if not headeronly else f.read(352)

    hdr = _parse_hdr(buf[:348], fname)

    # Volume dimensions: use the ndim field when valid (NIfTI standard);
    # fall back to last-nonzero like the reference (src/mri.jl:1601) for
    # malformed headers that leave ndim at 0.
    dim_arr = hdr.dim
    ndim = int(dim_arr[0])
    if 1 <= ndim <= 7:
        lastdim = ndim
    else:
        nz = np.nonzero(dim_arr)[0]
        lastdim = nz[-1] if len(nz) else 0
    dim = tuple(int(v) for v in dim_arr[1:lastdim + 1])

    if hdr.raw["datatype"] not in NIFTI_DTYPES:
        raise ValueError(f"Data type {hdr.raw['datatype']} not supported")
    dtype = NIFTI_DTYPES[int(hdr.raw["datatype"])]

    if headeronly:
        return hdr, np.zeros((0,) * max(len(dim), 1), dtype=dtype)

    offset = int(round(float(hdr.raw["vox_offset"])))
    n = int(np.prod(dim)) if dim else 0
    data = buf[offset:offset + n * np.dtype(dtype).itemsize]
    if len(data) < n * np.dtype(dtype).itemsize:
        raise ValueError(
            f"{fname}: expected a {dim} volume but file is truncated")

    bo = ">" if hdr.do_bswap else "<"
    vol = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder(bo))
    # NIfTI data is Fortran-ordered (first index fastest)
    vol = vol.reshape(dim, order="F")
    if hdr.do_bswap:
        vol = vol.astype(dtype)  # to native byte order
    else:
        vol = np.asarray(vol)

    slope = float(hdr.raw["scl_slope"])
    inter = float(hdr.raw["scl_inter"])
    if slope != 0 and not (inter == 0 and slope == 1):
        # Rescale; preserve the on-disk numeric class like the reference
        # (reference: src/mri.jl:1665-1669)
        scaled = vol.astype(np.float64) * slope + inter
        if np.issubdtype(dtype, np.integer):
            vol = np.rint(scaled).astype(dtype)
        else:
            vol = scaled.astype(dtype)

    return hdr, vol


def save_nifti(hdr: NIfTIHeader, vol: np.ndarray, fname: str) -> bool:
    """Write a volume as .nii or .nii.gz.  Returns True on error.

    (reference: src/mri.jl:2059-2166)
    """
    gzip_needed = fname.lower().endswith(".gz")

    # FreeSurfer ico7 hack (reference: src/mri.jl:2070-2074)
    if vol.shape[0] == 163842:
        nframes = vol.shape[3] if vol.ndim > 3 else 1
        vol = vol.reshape((27307, 1, 6, nframes), order="F")

    raw = hdr.raw
    if int(raw["datatype"]) in NIFTI_DTYPES:
        dtype = NIFTI_DTYPES[int(raw["datatype"])]
    else:
        print(f"WARNING: data type {raw['datatype']} not supported, "
              "but writing as float", file=sys.stderr)
        dtype = np.float32

    buf = _io.BytesIO()
    rec = np.zeros((), dtype=nifti1_dtype("<"))[()]
    for name in rec.dtype.names:
        rec[name] = raw[name]
    buf.write(rec.tobytes())
    buf.write(b"\x00" * 4)  # pad header to 352 bytes

    data = np.asarray(vol)
    if np.issubdtype(np.dtype(dtype), np.integer) and np.issubdtype(
            data.dtype, np.floating):
        data = np.rint(data)
    data = data.astype("<" + np.dtype(dtype).str[1:], copy=False)
    buf.write(data.tobytes(order="F"))

    payload = buf.getvalue()
    expected = 352 + np.dtype(dtype).itemsize * data.size
    err = len(payload) != expected

    if gzip_needed:
        with open(fname, "wb") as f:
            with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
                gz.write(payload)
    else:
        with open(fname, "wb") as f:
            f.write(payload)

    return err
