"""TrackVis .trk tractogram container and I/O.

Streamline coordinates in memory are 0-based voxel coordinates; the .trk
format stores them as 0.5-based mm coordinates, converted on read/write
exactly as the reference does (reference: src/trk.jl:410-412, src/trk.jl:476).
"""

from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.geometry import vox2ras_to_orient
from ..core.mri import MRI
from ..core.xform import Xform, xfm_apply
from ..utils.profiling import count

__all__ = ["Tract", "trk_read", "trk_write", "str_add", "str_merge",
           "str_xform"]

_HDR_FIELDS_CHECKED = (
    "id_string", "dim", "voxel_size", "origin", "n_scalars", "scalar_name",
    "n_properties", "property_name", "vox_to_ras", "reserved", "voxel_order",
    "voxel_order_original", "image_orientation_patient", "pad1", "invert_x",
    "invert_y", "invert_z", "swap_xy", "swap_yz", "swap_zx", "version",
    "hdr_size",
)


@dataclass
class Tract:
    """Header and streamline data in the .trk v2 layout.
    (reference: src/trk.jl:11-42)"""

    id_string: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8))
    dim: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int16))
    voxel_size: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    origin: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    n_scalars: int = 0
    scalar_name: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.uint8))
    n_properties: int = 0
    property_name: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.uint8))
    vox_to_ras: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32))
    reserved: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8))
    voxel_order: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8))
    voxel_order_original: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8))
    image_orientation_patient: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    pad1: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    invert_x: int = 0
    invert_y: int = 0
    invert_z: int = 0
    swap_xy: int = 0
    swap_yz: int = 0
    swap_zx: int = 0
    n_count: int = 0
    version: int = 0
    hdr_size: int = 0

    npts: List[int] = field(default_factory=list)
    properties: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32))
    xyz: List[np.ndarray] = field(default_factory=list)
    scalars: List[np.ndarray] = field(default_factory=list)

    # Packed fast path for large tractograms (millions of streamlines):
    # one flat [total_points, 3] array + per-line counts instead of a
    # Python list of small matrices.  `materialize()` exposes the list
    # view on demand; trk_write has a vectorized writer for this layout.
    packed_xyz: Optional[np.ndarray] = None
    packed_scalars: Optional[np.ndarray] = None   # [total, n_scalars]

    def __len__(self) -> int:
        """Number of streamlines (either storage mode)."""
        return len(self.npts)

    def set_packed(self, flat_pts: np.ndarray, npts: np.ndarray,
                   scalars: Optional[np.ndarray] = None) -> None:
        """Adopt packed streamline storage ([total, 3] + counts +
        optional per-point scalars [total, ns]).

        `npts` is always an int32 ndarray in packed mode (materialize()
        converts it to the list representation used by the per-line
        mode), so consumers see one type per storage mode."""
        self.packed_xyz = np.ascontiguousarray(flat_pts, dtype=np.float32)
        self.npts = np.asarray(npts, np.int32)
        self.n_count = int(len(npts))
        self.xyz = []
        self.scalars = []
        if scalars is not None:
            scalars = np.asarray(scalars, np.float32)
            if scalars.ndim == 1:
                scalars = scalars[:, None]
            self.packed_scalars = np.ascontiguousarray(scalars)
            self.n_scalars = scalars.shape[1]
        else:
            self.packed_scalars = None

    def materialize(self) -> None:
        """Populate the per-streamline `xyz` list from packed storage
        (views into the flat array, no copies).  Reading `.xyz` on a
        packed Tract calls this automatically."""
        if self.packed_xyz is None or self.__dict__.get("xyz"):
            return
        offsets = np.concatenate([[0], np.cumsum(np.asarray(self.npts))])
        self.__dict__["xyz"] = [
            self.packed_xyz[offsets[i]:offsets[i + 1]].T
            for i in range(self.n_count)]
        if self.packed_scalars is not None:
            self.scalars = [
                self.packed_scalars[offsets[i]:offsets[i + 1]].T
                for i in range(self.n_count)]
        else:
            self.scalars = [np.zeros((0, int(n)), np.float32)
                            for n in np.asarray(self.npts)]
        self.npts = [int(n) for n in np.asarray(self.npts)]

    @classmethod
    def from_ref(cls, ref: MRI) -> "Tract":
        """Header from a reference volume's geometry.
        (reference: src/trk.jl:88-144)"""
        tr = cls()
        orient = vox2ras_to_orient(ref.vox2ras)

        # Patient-to-scanner transform: x/y columns of vox2ras in LPS,
        # divided by voxel size (reference: src/trk.jl:102-108)
        res2 = ref.volres[[1, 0]] if ref.ispermuted else ref.volres[0:2]
        p2s = (np.diag([-1.0, -1.0, 1.0]) @ ref.vox2ras[0:3, 0:2]
               @ np.diag(1.0 / np.asarray(res2, np.float64)))

        tr.id_string = np.frombuffer(b"TRACK\x00", dtype=np.uint8).copy()
        if ref.ispermuted:
            tr.dim = np.asarray(ref.volsize[[1, 0, 2]], np.int16)
            tr.voxel_size = np.asarray(ref.volres[[1, 0, 2]], np.float32)
        else:
            tr.dim = np.asarray(ref.volsize, np.int16)
            tr.voxel_size = np.asarray(ref.volres, np.float32)
        tr.origin = np.zeros(3, np.float32)

        tr.n_scalars = 0
        tr.scalar_name = np.zeros((10, 20), np.uint8)
        tr.n_properties = 0
        tr.property_name = np.zeros((10, 20), np.uint8)

        tr.vox_to_ras = np.asarray(ref.vox2ras, np.float32)
        tr.reserved = np.zeros(444, np.uint8)
        tr.voxel_order = np.frombuffer(
            orient.encode() + b"\x00", dtype=np.uint8).copy()
        tr.voxel_order_original = tr.voxel_order.copy()
        tr.image_orientation_patient = np.asarray(
            p2s, np.float32).flatten(order="F")
        tr.pad1 = np.zeros(2, np.uint8)

        tr.n_count = 0
        tr.version = 2
        tr.hdr_size = 1000
        return tr


def _tract_repr(self):
    packed = self.packed_xyz is not None and not self.__dict__.get("xyz")
    npts_total = (int(np.asarray(self.npts).sum())
                  if len(self.npts) else 0)
    return (f"Tract(n_count={self.n_count}, points={npts_total}, "
            f"voxel_size={np.round(self.voxel_size, 4).tolist()}"
            f"{', packed' if packed else ''})")


Tract.__repr__ = _tract_repr


# `xyz` transparently materializes the per-streamline list view when the
# Tract holds packed storage, so user code written against the reference's
# list-of-matrices API works on packed tractograms unchanged.
def _tract_get_xyz(self):
    v = self.__dict__.get("xyz")
    if self.packed_xyz is not None and not v:
        self.materialize()
        v = self.__dict__["xyz"]
    return v


def _tract_set_xyz(self, v):
    self.__dict__["xyz"] = v


Tract.xyz = property(_tract_get_xyz, _tract_set_xyz)


def str_add(tr: Tract, xyz, scalars=None, properties=None) -> None:
    """Append streamlines (list of [3, npts] arrays) to a Tract, with
    optional per-point scalars and per-streamline properties.
    (reference: src/trk.jl:166-266)"""
    tr.materialize()
    tr.packed_xyz = None
    if isinstance(tr.npts, np.ndarray):
        tr.npts = [int(n) for n in tr.npts]
    xyz = [np.asarray(m, np.float32) for m in xyz]
    if any(m.shape[0] != 3 for m in xyz):
        raise ValueError("Each streamline must be defined as a matrix with "
                         "3 rows")

    add_scalars = scalars is not None and len(scalars) > 0
    add_properties = properties is not None and np.size(properties) > 0

    if add_scalars:
        scalars = [np.asarray(s, np.float32) for s in scalars]
        if scalars[0].ndim == 2:
            if any(m.shape[1] != s.shape[1] for m, s in zip(xyz, scalars)):
                raise ValueError("Inconsistent number of points between "
                                 "streamlines and scalars")
            nscal = scalars[0].shape[0]
            if any(s.shape[0] != nscal for s in scalars):
                raise ValueError("Inconsistent number of scalars between "
                                 "streamlines")
        else:
            if any(m.shape[1] != s.shape[0] for m, s in zip(xyz, scalars)):
                raise ValueError("Inconsistent number of points between "
                                 "streamlines and scalars")
            nscal = 1
        if tr.n_count == 0:
            tr.n_scalars = nscal
    else:
        nscal = 0

    if tr.n_scalars != nscal:
        raise ValueError(f"Must have {tr.n_scalars} input scalars per point "
                         "to append to Tract structure")

    if add_properties:
        properties = np.asarray(properties, np.float32)
        if properties.ndim == 2:
            if len(xyz) != properties.shape[1]:
                raise ValueError("Inconsistent number of streamlines and "
                                 "property values")
            nprop = properties.shape[0]
        else:
            if len(xyz) != properties.shape[0]:
                raise ValueError("Inconsistent number of streamlines and "
                                 "property values")
            nprop = 1
            properties = properties[None, :]
        if tr.n_count == 0:
            tr.n_properties = nprop
    else:
        nprop = 0

    if tr.n_properties != nprop:
        raise ValueError(f"Must have {tr.n_properties} input properties per "
                         "streamline to append to Tract structure")

    tr.n_count += len(xyz)

    for istr, m in enumerate(xyz):
        tr.npts.append(int(m.shape[1]))
        tr.xyz.append(m)
        if add_scalars:
            s = scalars[istr]
            tr.scalars.append(s if s.ndim == 2 else s[None, :])
        else:
            tr.scalars.append(np.zeros((0, m.shape[1]), np.float32))

    if add_properties:
        tr.properties = (np.hstack([tr.properties, properties])
                         if tr.properties.size else properties)
    else:
        empty = np.zeros((0, len(xyz)), np.float32)
        tr.properties = (np.hstack([tr.properties, empty])
                         if tr.properties.shape[0] else empty)


def str_merge(tr1: Tract, *rest: Tract) -> Tract:
    """Merge streamlines from Tracts with matching headers.
    (reference: src/trk.jl:275-308)"""
    import copy
    tr1.materialize()
    for t in rest:
        t.materialize()
    tr = copy.deepcopy(tr1)
    for trnew in rest:
        for name in _HDR_FIELDS_CHECKED:
            a, b = getattr(tr, name), getattr(trnew, name)
            same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b)
            if not same:
                raise ValueError(f"Mismatch in header field {name} between "
                                 "input tracts")
        tr.n_count += trnew.n_count
        tr.npts.extend(trnew.npts)
        tr.xyz.extend(trnew.xyz)
        tr.scalars.extend(trnew.scalars)
        tr.properties = np.hstack([tr.properties, trnew.properties]) \
            if tr.properties.size or trnew.properties.size else tr.properties

    return tr


def str_xform(xfm: Xform, tr: Tract) -> Tract:
    """Apply a transform to streamline coordinates; rewrite geometry header.
    (reference: src/trk.jl:316-347)"""
    import copy
    tr.materialize()
    out = copy.deepcopy(tr)

    out.dim = np.asarray(xfm.outsize, np.int16)
    out.voxel_size = np.asarray(xfm.outres, np.float32)
    out.vox_to_ras = np.asarray(xfm.outvox2ras, np.float32)

    orient = vox2ras_to_orient(out.vox_to_ras)
    out.voxel_order = np.frombuffer(
        orient.encode() + b"\x00", dtype=np.uint8).copy()
    out.voxel_order_original = out.voxel_order.copy()

    p2s = (np.diag([-1.0, -1.0, 1.0]) @ out.vox_to_ras[0:3, 0:2]
           @ np.diag(1.0 / np.asarray(out.voxel_size[0:2], np.float64)))
    out.image_orientation_patient = np.asarray(
        p2s, np.float32).flatten(order="F")

    out.xyz = [xfm_apply(xfm, m) for m in tr.xyz]
    return out


def trk_read(infile: str) -> Tract:
    """Read a .trk file.  (reference: src/trk.jl:358-423)"""
    with open(infile, "rb") as f:
        buf = f.read()

    tr = Tract()
    pos = 0

    def take(dtype, n):
        nonlocal pos
        out = np.frombuffer(buf, dtype=dtype, count=n, offset=pos).copy()
        pos += np.dtype(dtype).itemsize * n
        return out

    tr.id_string = take(np.uint8, 6)
    tr.dim = take("<i2", 3)
    tr.voxel_size = take("<f4", 3)
    tr.origin = take("<f4", 3)
    tr.n_scalars = int(take("<i2", 1)[0])
    tr.scalar_name = take(np.uint8, 200).reshape(10, 20)
    tr.n_properties = int(take("<i2", 1)[0])
    tr.property_name = take(np.uint8, 200).reshape(10, 20)
    tr.vox_to_ras = take("<f4", 16).reshape(4, 4)
    tr.reserved = take(np.uint8, 444)
    tr.voxel_order = take(np.uint8, 4)
    tr.voxel_order_original = take(np.uint8, 4)
    tr.image_orientation_patient = take("<f4", 6)
    tr.pad1 = take(np.uint8, 2)
    tr.invert_x = int(take(np.uint8, 1)[0])
    tr.invert_y = int(take(np.uint8, 1)[0])
    tr.invert_z = int(take(np.uint8, 1)[0])
    tr.swap_xy = int(take(np.uint8, 1)[0])
    tr.swap_yz = int(take(np.uint8, 1)[0])
    tr.swap_zx = int(take(np.uint8, 1)[0])
    tr.n_count = int(take("<i4", 1)[0])
    tr.version = int(take("<i4", 1)[0])
    tr.hdr_size = int(take("<i4", 1)[0])

    vsz = tr.voxel_size.astype(np.float32)
    ns, npr = tr.n_scalars, tr.n_properties

    if ns == 0 and npr == 0 and tr.n_count > 0:
        # Packed fast path: one scan over the record stream (native C when
        # built, numpy otherwise) into flat [total, 3] voxel coords.
        # Trim any trailing partial word so a truncated file fails with
        # the dedicated malformed-stream error, not an opaque numpy one.
        nbytes = (len(buf) - pos) // 4 * 4
        payload = np.frombuffer(buf, "<f4", count=nbytes // 4, offset=pos)
        from .. import native
        clib = native.lib()
        max_pts = max(0, (len(payload) - tr.n_count) // 3)
        if clib is not None:
            npts_out = np.empty(tr.n_count, np.int32)
            pts = np.empty((max_pts, 3), np.float32)
            vszc = np.ascontiguousarray(vsz)
            payload_c = np.ascontiguousarray(payload)
            got = clib.unpack_trk_records(
                native.as_f32_ptr(payload_c), len(payload), 3, 0,
                native.as_f32_ptr(vszc),
                native.as_i32_ptr(npts_out), tr.n_count,
                native.as_f32_ptr(pts), max_pts)
            if got != tr.n_count:
                raise ValueError(f"Malformed .trk record stream in "
                                 f"{infile}")
            total = int(npts_out.sum())
            tr.set_packed(pts[:total], npts_out)
        else:
            ints = payload.view(np.int32)
            counts = np.empty(tr.n_count, np.int32)
            p = 0
            for i in range(tr.n_count):
                if p >= len(ints):
                    raise ValueError(
                        f"Malformed .trk record stream in {infile}")
                m = int(ints[p])
                if m < 0 or p + 1 + 3 * m > len(ints):
                    raise ValueError(
                        f"Malformed .trk record stream in {infile}")
                counts[i] = m
                p += 1 + 3 * m
            rec_off = np.zeros(tr.n_count, np.int64)
            np.cumsum(1 + 3 * counts[:-1].astype(np.int64),
                      out=rec_off[1:])
            is_count = np.zeros(p, bool)
            is_count[rec_off] = True
            pts = payload[:p][~is_count].reshape(-1, 3) / vsz - 0.5
            tr.set_packed(pts.astype(np.float32), counts)
        tr.properties = np.zeros((0, tr.n_count), np.float32)
        return tr

    props_list = []
    for _ in range(tr.n_count):
        n = int(take("<i4", 1)[0])
        tr.npts.append(n)
        rec = take("<f4", n * (3 + ns)).reshape(n, 3 + ns)
        # mm -> 0-based voxel coordinates (reference: src/trk.jl:410-412)
        tr.xyz.append(
            np.ascontiguousarray((rec[:, 0:3] / vsz - 0.5).T))
        tr.scalars.append(np.ascontiguousarray(rec[:, 3:].T))
        props_list.append(take("<f4", npr))

    if props_list and npr > 0:
        tr.properties = np.stack(props_list, axis=1)
    else:
        tr.properties = np.zeros((npr, tr.n_count), np.float32)

    return tr


def _trk_header_bytes(tr: Tract) -> bytes:
    buf = _io.BytesIO()

    def pad_bytes(arr, n):
        b = np.asarray(arr, np.uint8).tobytes()
        return b[:n].ljust(n, b"\x00")

    buf.write(pad_bytes(tr.id_string, 6))
    buf.write(np.asarray(tr.dim, "<i2").tobytes())
    buf.write(np.asarray(tr.voxel_size, "<f4").tobytes())
    buf.write(np.asarray(tr.origin, "<f4").tobytes())
    buf.write(struct.pack("<h", tr.n_scalars))
    buf.write(pad_bytes(tr.scalar_name, 200))
    buf.write(struct.pack("<h", tr.n_properties))
    buf.write(pad_bytes(tr.property_name, 200))
    buf.write(np.asarray(tr.vox_to_ras, "<f4").tobytes())
    buf.write(pad_bytes(tr.reserved, 444))
    buf.write(pad_bytes(tr.voxel_order, 4))
    buf.write(pad_bytes(tr.voxel_order_original, 4))
    buf.write(np.asarray(tr.image_orientation_patient, "<f4").tobytes())
    buf.write(pad_bytes(tr.pad1, 2))
    buf.write(struct.pack("<6B", tr.invert_x, tr.invert_y, tr.invert_z,
                          tr.swap_xy, tr.swap_yz, tr.swap_zx))
    buf.write(struct.pack("<iii", tr.n_count, tr.version, tr.hdr_size))
    return buf.getvalue()


def _pack_records(npts, pts, vsz, scalars=None):
    """Record stream [count_i, (xyz+scalars)*npts_i]... as one flat f32
    buffer with bitcast int32 counts, voxel->mm conversion fused in.
    The native line-parallel interleave (`pack_trk_lines`, with or
    without per-point scalars) when the C helper built; otherwise
    vectorized numpy over a boolean count-slot mask."""
    from ..utils.hostbuf import scratch

    npts = np.asarray(npts, np.int64)
    n = len(npts)
    total = int(npts.sum())
    ns = 0 if scalars is None else int(scalars.shape[1])
    width = 3 + ns
    # pooled: the record buffer is written to the file and dropped by
    # every caller, and fresh ~100 MB-scale allocations pay a ~0.1 GB/s
    # first-touch fault cost on the benchmark host (utils.hostbuf)
    out = scratch("trk.records", n + width * total, np.float32)
    if n == 0:
        return out
    from .. import native
    clib = native.lib()
    if clib is not None:
        npts32 = np.ascontiguousarray(npts, np.int32)
        p = np.ascontiguousarray(pts, np.float32)
        sc = None if ns == 0 else np.ascontiguousarray(scalars, np.float32)
        if p.shape != (total, 3) or (sc is not None and len(sc) != total):
            raise ValueError(f"{total} points in the counts, points "
                             f"{p.shape}, scalars "
                             f"{None if sc is None else sc.shape}")
        if clib.pack_trk_lines(
                n, native.as_i32_ptr(npts32), native.as_f32_ptr(p),
                None if sc is None else native.as_f32_ptr(sc), ns,
                native.as_f32_ptr(vsz), native.as_f32_ptr(out)) == 0:
            return out
    rec_off = np.empty(n, np.int64)
    if n > 1:
        np.cumsum(1 + width * npts[:-1], out=rec_off[1:])
    rec_off[0] = 0
    is_count = scratch("trk.iscount", n + width * total, bool)
    is_count[:] = False
    is_count[rec_off] = True
    out.view(np.int32)[is_count] = npts.astype(np.int32)
    pts_mm = (np.asarray(pts, np.float32) + np.float32(0.5)) * vsz[None, :]
    if ns:
        pts_mm = np.concatenate(
            [pts_mm, np.asarray(scalars, np.float32)], axis=1)
    out[~is_count] = pts_mm.reshape(-1)
    return out


def _trk_write_packed(tr: Tract, outfile: str) -> bool:
    """Vectorized writer for packed tractograms (with or without packed
    per-point scalars; no properties)."""
    vsz = np.ascontiguousarray(tr.voxel_size, np.float32)
    out = _pack_records(tr.npts, tr.packed_xyz, vsz, tr.packed_scalars)
    header = _trk_header_bytes(tr)
    with open(outfile, "wb", buffering=1 << 22) as f:
        f.write(header)
        out.astype("<f4", copy=False).tofile(f)
    return len(header) != 1000


class TrkSink:
    """Incremental TrackVis writer: header first (streamline count known
    up front), then chunks of packed lines appended as they arrive — so
    file output overlaps with whatever produces the points (used by
    `stream(..., trk_sink=...)` to hide the write under device fetches).
    Every byte it writes is counted as `trk.bytes` (utils/profiling.py).
    """

    def __init__(self, outfile: str, tr: Tract, n_count: int):
        tr.n_count = int(n_count)
        self._n_count = int(n_count)
        self._outfile = outfile
        self._vsz = np.ascontiguousarray(tr.voxel_size, np.float32)
        self._f = open(outfile, "wb", buffering=1 << 22)
        header = _trk_header_bytes(tr)
        self._f.write(header)
        count("trk.bytes", len(header))
        self._written = 0

    def _write(self, out: np.ndarray) -> None:
        """Write packed records to the file."""
        out.astype("<f4", copy=False).tofile(self._f)
        count("trk.bytes", 4 * out.size)

    def append(self, pts: np.ndarray, npts: np.ndarray,
               scalars: np.ndarray = None) -> None:
        """Append lines (pts [total, 3] voxel coords, counts [nlines],
        optional per-point scalars [total, ns])."""
        npts = np.asarray(npts, np.int64)
        if len(npts) == 0:
            return
        self._write(_pack_records(npts, pts, self._vsz, scalars))
        self._written += len(npts)

    def append_deltas(self, q: np.ndarray, npts: np.ndarray,
                      anchors: np.ndarray, qscale: float) -> bool:
        """Append lines straight from an int8 error-feedback delta wire
        buffer (`q` [total*3] line-order deltas, `anchors` [nlines, 3]
        line anchor positions, see tract/stream.py) — fused native
        decode + record pack, one pass, no [total, 3] float32
        intermediate.  Returns False when the native helper is
        unavailable (caller falls back to decode + append)."""
        from .. import native

        clib = native.lib()
        if clib is None or not hasattr(clib, "decode_delta_trk_records"):
            return False
        npts32 = np.ascontiguousarray(npts, np.int32)
        n = len(npts32)
        if n == 0:
            return True
        off = np.zeros(n, np.int64)
        np.cumsum(npts32[:-1], dtype=np.int64, out=off[1:])
        total = int(off[-1] + npts32[-1])
        from ..utils.hostbuf import scratch
        q = np.ascontiguousarray(q[:total * 3], np.int8)
        anch = np.ascontiguousarray(anchors, np.float32)
        out = scratch("trk.records", n + 3 * total, np.float32)
        clib.decode_delta_trk_records(
            native.as_i8_ptr(q), native.as_i64_ptr(off),
            native.as_i32_ptr(npts32), native.as_f32_ptr(anch),
            n, np.float32(1.0 / qscale), native.as_f32_ptr(self._vsz),
            native.as_f32_ptr(out))
        self._write(out)
        self._written += n
        return True

    def append_deltas6(self, words: np.ndarray, npts: np.ndarray,
                       anchors: np.ndarray, qscale: float) -> bool:
        """append_deltas for the packed 6-bit wire (`words` uint32, see
        tract/stream.py _compact mode="i6"): fused native field-extract +
        decode + record pack, skipping even the int8 expansion.  Returns
        False when the native helper is unavailable."""
        from .. import native

        clib = native.lib()
        if clib is None or not hasattr(clib, "decode_delta6_trk_records"):
            return False
        npts32 = np.ascontiguousarray(npts, np.int32)
        n = len(npts32)
        if n == 0:
            return True
        off = np.zeros(n, np.int64)
        np.cumsum(npts32[:-1], dtype=np.int64, out=off[1:])
        total = int(off[-1] + npts32[-1])
        from ..utils.hostbuf import scratch
        w = np.ascontiguousarray(words.view(np.uint32))
        need = ((total * 3 + 15) // 16) * 3
        if len(w) < need:
            return False
        anch = np.ascontiguousarray(anchors, np.float32)
        out = scratch("trk.records", n + 3 * total, np.float32)
        clib.decode_delta6_trk_records(
            native.as_u32_ptr(w), native.as_i64_ptr(off),
            native.as_i32_ptr(npts32), native.as_f32_ptr(anch),
            n, np.float32(1.0 / qscale), native.as_f32_ptr(self._vsz),
            native.as_f32_ptr(out))
        self._write(out)
        self._written += n
        return True

    def close(self) -> None:
        self._f.close()
        # The header's n_count was written up front; a mismatch with what
        # was actually appended means the producer lost/duplicated lines
        # and the file is inconsistent — fail loudly, not silently.
        if self._written != self._n_count:
            raise IOError(
                f"TrkSink {self._outfile}: header says {self._n_count} "
                f"streamlines but {self._written} were appended")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            self._f.close()      # don't mask the original exception
            return
        self.close()


def trk_write(tr: Tract, outfile: str) -> bool:
    """Write a .trk file.  Returns True on error.
    (reference: src/trk.jl:433-495)"""
    if (tr.packed_xyz is not None and not tr.__dict__.get("xyz")
            and (tr.n_scalars == 0 or tr.packed_scalars is not None)
            and tr.n_properties == 0):
        return _trk_write_packed(tr, outfile)

    buf = _io.BytesIO()
    buf.write(_trk_header_bytes(tr))

    vsz = np.asarray(tr.voxel_size, np.float32)
    for istr in range(tr.n_count):
        n = tr.npts[istr]
        buf.write(struct.pack("<i", n))
        # 0-based voxel -> 0.5-based mm (reference: src/trk.jl:476)
        pts = (np.asarray(tr.xyz[istr], np.float32) + 0.5) * vsz[:, None]
        scal = np.asarray(tr.scalars[istr], np.float32)
        rec = np.vstack([pts, scal]) if scal.size else pts
        buf.write(rec.astype("<f4").tobytes(order="F"))
        if tr.properties.size:
            buf.write(np.asarray(tr.properties[:, istr], "<f4").tobytes())

    payload = buf.getvalue()
    npts_total = sum(int(np.asarray(m).shape[1]) * 3 for m in tr.xyz)
    nscal_total = sum(int(np.asarray(s).size) for s in tr.scalars)
    expected = (866 + 4 * (3 + len(tr.npts)) + 2 * 5 + 4 * 28
                + 4 * (npts_total + nscal_total + int(tr.properties.size)))
    err = len(payload) != expected

    with open(outfile, "wb") as f:
        f.write(payload)

    return err
