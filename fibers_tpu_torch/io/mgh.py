"""FreeSurfer .mgh/.mgz reader/writer (big-endian format).

(reference: src/mri.jl:1217-1372, src/mri.jl:1939-2036)
Compression uses in-process gzip instead of `zcat`/`gzip` subprocesses.
"""

from __future__ import annotations

import gzip
import io as _io
import struct

import numpy as np

__all__ = ["load_mgh", "save_mgh", "MGH_DTYPES"]

# MGH type codes (reference: src/mri.jl:1288-1312)
MRI_UCHAR = 0
MRI_INT = 1
MRI_LONG = 2
MRI_FLOAT = 3
MRI_SHORT = 4
MRI_BITMAP = 5
MRI_USHRT = 10

MGH_DTYPES = {
    MRI_FLOAT: np.float32,
    MRI_UCHAR: np.uint8,
    MRI_SHORT: np.int16,
    MRI_USHRT: np.uint16,
    MRI_INT: np.int32,
}
MGH_CODES = {
    np.dtype(np.float32): MRI_FLOAT,
    np.dtype(np.uint8): MRI_UCHAR,
    np.dtype(np.int32): MRI_INT,
    np.dtype(np.int64): MRI_LONG,
    np.dtype(np.int16): MRI_SHORT,
    np.dtype(np.uint16): MRI_USHRT,
}

UNUSED_SPACE_SIZE = 256
USED_SPACE_SIZE = 3 * 4 + 4 * 3 * 4  # space for the RAS transform


def load_mgh(fname: str, slices=None, frames=None, headeronly: bool = False):
    """Load a .mgh/.mgz file.

    Returns (vol, M, mr_parms, volsz) where M is the 0-based vox2ras matrix
    and mr_parms = [tr, flip_angle, te, ti].  Optional 1-based `slices`/
    `frames` subset selection.  (reference: src/mri.jl:1217-1372)
    """
    opener = gzip.open if fname.lower().endswith("gz") else open
    with opener(fname, "rb") as f:
        buf = f.read()

    pos = 0

    def read_i4(n=1):
        nonlocal pos
        out = np.frombuffer(buf, dtype=">i4", count=n, offset=pos)
        pos += 4 * n
        return out

    def read_i2(n=1):
        nonlocal pos
        out = np.frombuffer(buf, dtype=">i2", count=n, offset=pos)
        pos += 2 * n
        return out

    def read_f4(n=1):
        nonlocal pos
        out = np.frombuffer(buf, dtype=">f4", count=n, offset=pos)
        pos += 4 * n
        return out

    _version = int(read_i4()[0])
    ndim1 = int(read_i4()[0])
    ndim2 = int(read_i4()[0])
    ndim3 = int(read_i4()[0])
    nframes = int(read_i4()[0])
    typecode = int(read_i4()[0])
    _dof = int(read_i4()[0])

    if slices is not None and np.any(np.asarray(slices) > ndim3):
        raise ValueError(f"Some slices={slices} exceed nslices={ndim3}")
    if frames is not None and np.any(np.asarray(frames) > nframes):
        raise ValueError(f"Some frames={frames} exceed nframes={nframes}")

    unused_space_size = UNUSED_SPACE_SIZE - 2
    ras_good_flag = int(read_i2()[0])

    M = np.zeros((0, 0), dtype=np.float32)
    if ras_good_flag > 0:
        delta = read_f4(3).astype(np.float64)
        mdc = read_f4(9).astype(np.float64).reshape((3, 3), order="F")
        pxyz_c = read_f4(3).astype(np.float64)

        d = np.diag(delta)
        pcrs_c = np.array([ndim1, ndim2, ndim3], dtype=np.float64) / 2
        pxyz_0 = pxyz_c - mdc @ d @ pcrs_c

        M = np.eye(4, dtype=np.float64)
        M[0:3, 0:3] = mdc @ d
        M[0:3, 3] = pxyz_0
        M = M.astype(np.float32)
        unused_space_size -= USED_SPACE_SIZE

    pos += unused_space_size
    nv = ndim1 * ndim2 * ndim3 * nframes
    volsz = np.array([ndim1, ndim2, ndim3, nframes], dtype=np.int32)

    if typecode not in MGH_DTYPES:
        raise ValueError(f"Unsupported MGH type code {typecode}")
    dtype = MGH_DTYPES[typecode]
    itemsize = np.dtype(dtype).itemsize

    mr_parms = np.zeros(0, dtype=np.float32)

    if headeronly:
        pos += nv * itemsize
        if pos + 16 <= len(buf):
            mr_parms = np.frombuffer(buf, dtype=">f4", count=4,
                                     offset=pos).astype(np.float32)
        return np.zeros((0, 0, 0, 0), np.float32), M, mr_parms, volsz

    be = np.dtype(dtype).newbyteorder(">")
    if slices is None and frames is None:
        vol = np.frombuffer(buf, dtype=be, count=nv, offset=pos)
        vol = vol.astype(dtype).reshape((ndim1, ndim2, ndim3, nframes),
                                        order="F")
        pos += nv * itemsize
    else:
        frames = list(range(1, nframes + 1)) if frames is None else list(frames)
        slices = list(range(1, ndim3 + 1)) if slices is None else list(slices)
        nvslice = ndim1 * ndim2
        nvvol = nvslice * ndim3
        filepos0 = pos
        vol = np.zeros((ndim1, ndim2, len(slices), len(frames)), dtype=dtype)
        for iframe, frame in enumerate(frames):
            for islice, sl in enumerate(slices):
                off = ((frame - 1) * nvvol + (sl - 1) * nvslice) * itemsize \
                    + filepos0
                plane = np.frombuffer(buf, dtype=be, count=nvslice, offset=off)
                vol[:, :, islice, iframe] = plane.astype(dtype).reshape(
                    (ndim1, ndim2), order="F")
        pos = nframes * nvvol * itemsize + filepos0

    if pos + 16 <= len(buf):
        mr_parms = np.frombuffer(buf, dtype=">f4", count=4,
                                 offset=pos).astype(np.float32)

    return vol, M, mr_parms, volsz


def save_mgh(vol: np.ndarray, fname: str, M=None, mr_parms=None) -> bool:
    """Write a volume as .mgh/.mgz.  Returns True on error.

    (reference: src/mri.jl:1939-2036)
    """
    if M is None:
        M = np.eye(4)
    if mr_parms is None:
        mr_parms = np.zeros(4)
    M = np.asarray(M, dtype=np.float64)
    mr_parms = np.asarray(mr_parms, dtype=np.float64)
    if M.shape != (4, 4):
        raise ValueError(f"M size={M.shape}, must be (4, 4)")
    if mr_parms.size != 4:
        raise ValueError(f"mr_parms length={mr_parms.size}, must be 4")

    vol = np.asarray(vol)
    if vol.ndim < 4:
        vol = vol.reshape(vol.shape + (1,) * (4 - vol.ndim))
    ndim1, ndim2, ndim3, frames = vol.shape

    if vol.dtype not in MGH_CODES:
        raise ValueError(f"Unsupported MGH dtype {vol.dtype}")
    typecode = MGH_CODES[vol.dtype]

    buf = _io.BytesIO()
    buf.write(struct.pack(">iiiiii", 1, ndim1, ndim2, ndim3, frames, typecode))
    buf.write(struct.pack(">i", 1))  # dof (not used)

    mdcd = M[0:3, 0:3]
    delta = np.sqrt((mdcd ** 2).sum(axis=0))
    mdc = mdcd / delta[None, :]
    pcrs_c = np.array([ndim1 / 2, ndim2 / 2, ndim3 / 2, 1.0])
    pxyz_c = (M @ pcrs_c)[0:3]

    buf.write(struct.pack(">h", 1))  # ras_good_flag = 1
    buf.write(delta.astype(">f4").tobytes())
    buf.write(mdc.astype(">f4").tobytes(order="F"))
    buf.write(pxyz_c.astype(">f4").tobytes())

    unused_space_size = UNUSED_SPACE_SIZE - 2 - USED_SPACE_SIZE
    buf.write(b"\x00" * unused_space_size)

    be = np.dtype(vol.dtype).newbyteorder(">")
    buf.write(vol.astype(be).tobytes(order="F"))

    buf.write(mr_parms.astype(">f4").tobytes())

    payload = buf.getvalue()
    expected = (4 * 7 + 2 + unused_space_size + 4 * 19
                + vol.dtype.itemsize * vol.size)
    err = len(payload) != expected

    if fname.lower().endswith("gz"):
        with open(fname, "wb") as f:
            with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
                gz.write(payload)
    else:
        with open(fname, "wb") as f:
            f.write(payload)

    return err
