"""The MRI volume container.

Mirrors the reference's `MRI` struct (reference: src/mri.jl:80-130): a volume
array plus acquisition geometry (vox2ras matrices, direction cosines, voxel
sizes) and DWI tables.  The volume lives as a host numpy array; model code
moves (masked, batched) data to device explicitly.

Design difference from the reference: the MRI class derives all redundant
geometry via `set_geometry()` from `vox2ras0` exactly like
`mri_set_geometry!` (reference: src/mri.jl:751-792), but is a plain Python
class, not a pytree — device code never sees it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .geometry import vox2ras_0to1, vox2ras_tkreg

__all__ = ["MRI", "NIfTIHeader"]


# NIfTI-1 header layout, 348 bytes, little- or big-endian.
# Field names/types follow the standard (and reference: src/mri.jl:25-69).
NIFTI1_FIELDS = [
    ("sizeof_hdr", "i4", ()),
    ("data_type", "S10", ()),
    ("db_name", "S18", ()),
    ("extents", "i4", ()),
    ("session_error", "i2", ()),
    ("regular", "u1", ()),
    ("dim_info", "u1", ()),
    ("dim", "i2", (8,)),
    ("intent_p1", "f4", ()),
    ("intent_p2", "f4", ()),
    ("intent_p3", "f4", ()),
    ("intent_code", "i2", ()),
    ("datatype", "i2", ()),
    ("bitpix", "i2", ()),
    ("slice_start", "i2", ()),
    ("pixdim", "f4", (8,)),
    ("vox_offset", "f4", ()),
    ("scl_slope", "f4", ()),
    ("scl_inter", "f4", ()),
    ("slice_end", "i2", ()),
    ("slice_code", "i1", ()),
    ("xyzt_units", "i1", ()),
    ("cal_max", "f4", ()),
    ("cal_min", "f4", ()),
    ("slice_duration", "f4", ()),
    ("toffset", "f4", ()),
    ("glmax", "i4", ()),
    ("glmin", "i4", ()),
    ("descrip", "S80", ()),
    ("aux_file", "S24", ()),
    ("qform_code", "i2", ()),
    ("sform_code", "i2", ()),
    ("quatern_b", "f4", ()),
    ("quatern_c", "f4", ()),
    ("quatern_d", "f4", ()),
    ("quatern_x", "f4", ()),
    ("quatern_y", "f4", ()),
    ("quatern_z", "f4", ()),
    ("srow_x", "f4", (4,)),
    ("srow_y", "f4", (4,)),
    ("srow_z", "f4", (4,)),
    ("intent_name", "S16", ()),
    ("magic", "S4", ()),
]


def nifti1_dtype(byteorder: str = "<") -> np.dtype:
    """Structured numpy dtype for the 348-byte NIfTI-1 header."""
    dt = np.dtype([(n, byteorder + t, s) for (n, t, s) in NIFTI1_FIELDS])
    assert dt.itemsize == 348
    return dt


@dataclass
class NIfTIHeader:
    """Parsed NIfTI-1 header plus derived transforms.

    `raw` is the structured-array record holding every standard header field;
    attribute access is forwarded to it.  The derived fields mirror the
    reference's additions (reference: src/mri.jl:71-76).
    """

    raw: np.void = None
    do_bswap: bool = False
    sform: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    qform: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    vox2ras: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    # Normalized dim: int64 copy of raw['dim'] with the FreeSurfer >32k-col
    # and ico7 hacks applied (values can exceed int16 range, so it cannot
    # live in the raw record; reference: src/mri.jl:1428-1439).
    dim: np.ndarray = field(default_factory=lambda: np.zeros(8, np.int64))

    def __post_init__(self):
        if self.raw is None:
            self.raw = np.zeros((), dtype=nifti1_dtype())[()]

    def __getattr__(self, name):
        raw = object.__getattribute__(self, "raw")
        if raw is not None and name in raw.dtype.names:
            return raw[name]
        raise AttributeError(name)


def _empty_f32(*shape):
    return np.zeros(shape, dtype=np.float32)


@dataclass
class MRI:
    """Header and image data of an MRI volume or volume series.

    Field names match the reference MRI struct (reference: src/mri.jl:80-130)
    so that code written against Fibers.jl translates directly.
    """

    vol: np.ndarray
    ispermuted: bool = False
    image_type: str = ""
    niftihdr: NIfTIHeader = field(default_factory=NIfTIHeader)

    fspec: str = ""
    pwd: str = ""

    flip_angle: float = 0.0
    tr: float = 0.0
    te: float = 0.0
    ti: float = 0.0

    vox2ras0: np.ndarray = field(default_factory=lambda: _empty_f32(0, 0))
    volsize: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    height: int = 0
    width: int = 0
    depth: int = 0
    nframes: int = 0

    vox2ras: np.ndarray = field(default_factory=lambda: _empty_f32(0, 0))
    nvoxels: int = 0
    xsize: float = 0.0
    ysize: float = 0.0
    zsize: float = 0.0

    x_r: float = 0.0
    x_a: float = 0.0
    x_s: float = 0.0
    y_r: float = 0.0
    y_a: float = 0.0
    y_s: float = 0.0
    z_r: float = 0.0
    z_a: float = 0.0
    z_s: float = 0.0
    c_r: float = 0.0
    c_a: float = 0.0
    c_s: float = 0.0

    vox2ras1: np.ndarray = field(default_factory=lambda: _empty_f32(0, 0))
    Mdc: np.ndarray = field(default_factory=lambda: _empty_f32(0, 0))
    volres: np.ndarray = field(default_factory=lambda: _empty_f32(0))
    tkrvox2ras: np.ndarray = field(default_factory=lambda: _empty_f32(0, 0))

    bval: np.ndarray = field(default_factory=lambda: _empty_f32(0))
    bvec: np.ndarray = field(default_factory=lambda: _empty_f32(0, 0))

    # ------------------------------------------------------------------ #

    @classmethod
    def like(cls, ref: "MRI", nframes: Optional[int] = None,
             dtype=None) -> "MRI":
        """New zero-filled MRI with header copied from `ref`.

        Mirrors `MRI(ref, nframes, type)` (reference: src/mri.jl:249-265).
        """
        if nframes is None:
            nframes = ref.nframes
        if dtype is None:
            dtype = ref.vol.dtype
        shape = tuple(int(s) for s in ref.volsize)
        if nframes != 1:
            shape = shape + (int(nframes),)
        out = cls(vol=np.zeros(shape, dtype=dtype))
        for name in (
            "ispermuted", "image_type", "niftihdr", "pwd", "flip_angle",
            "tr", "te", "ti", "vox2ras0", "volsize", "height", "width",
            "depth", "vox2ras", "nvoxels", "xsize", "ysize", "zsize",
            "x_r", "x_a", "x_s", "y_r", "y_a", "y_s", "z_r", "z_a", "z_s",
            "c_r", "c_a", "c_s", "vox2ras1", "Mdc", "volres", "tkrvox2ras",
        ):
            setattr(out, name, getattr(ref, name))
        out.nframes = int(nframes)
        return out

    def set_geometry(self) -> None:
        """Derive redundant geometry fields from vox2ras0.

        Mirrors `mri_set_geometry!` (reference: src/mri.jl:751-792).
        """
        self.vox2ras = self.vox2ras0

        self.nvoxels = int(self.width) * int(self.height) * int(self.depth)
        self.xsize = float(np.sqrt((self.vox2ras[:, 0] ** 2).sum()))
        self.ysize = float(np.sqrt((self.vox2ras[:, 1] ** 2).sum()))
        self.zsize = float(np.sqrt((self.vox2ras[:, 2] ** 2).sum()))

        self.x_r, self.x_a, self.x_s = (self.vox2ras[0:3, 0] / self.xsize).tolist()
        self.y_r, self.y_a, self.y_s = (self.vox2ras[0:3, 1] / self.ysize).tolist()
        self.z_r, self.z_a, self.z_s = (self.vox2ras[0:3, 2] / self.zsize).tolist()

        ic = np.array([self.width / 2, self.height / 2, self.depth / 2, 1.0])
        c = self.vox2ras @ ic
        self.c_r, self.c_a, self.c_s = float(c[0]), float(c[1]), float(c[2])

        self.vox2ras1 = vox2ras_0to1(self.vox2ras).astype(np.float32)
        self.Mdc = (
            self.vox2ras[0:3, 0:3]
            @ np.diag(1.0 / np.array([self.xsize, self.ysize, self.zsize]))
        ).astype(np.float32)
        self.volres = np.array([self.xsize, self.ysize, self.zsize],
                               dtype=np.float32)
        self.tkrvox2ras = vox2ras_tkreg(self.volsize, self.volres).astype(
            np.float32)


def _mri_repr(self):
    v = self.__dict__.get("vol")
    from .lazy import LazyVolume

    if isinstance(v, LazyVolume):
        shape, extra = v.shape, " (device-resident, lazy)"
    else:
        shape, extra = getattr(v, "shape", None), ""
    nbv = len(self.bval) if self.bval is not None else 0
    return (f"MRI(vol={shape}{extra}, volres="
            f"{np.round(np.asarray(self.volres), 4).tolist()}, "
            f"nframes={self.nframes}, bvals={nbv})")


MRI.__repr__ = _mri_repr


# `vol` is a transparent lazy property: model fits may assign a
# core.lazy.LazyVolume (device-resident batch); the first host access
# materializes it into the usual numpy volume.  Plain numpy assignments
# behave exactly as a normal attribute.
def _mri_get_vol(self):
    v = self.__dict__.get("vol")
    from .lazy import LazyVolume

    if isinstance(v, LazyVolume):
        v = v.materialize()
        self.__dict__["vol"] = v
    return v


def _mri_set_vol(self, v):
    self.__dict__["vol"] = v


MRI.vol = property(_mri_get_vol, _mri_set_vol)
