"""Deterministic streamline tractography as a lockstep masked integrator,
in PyTorch.

Counterpart of the deterministic engine of fibers_tpu/tract/stream.py
(reference: src/stream.jl:340-374, 501-541, 625-790).  All streams of a
chunk advance together: each step is a batched voxel gather, the greedy
minimum-bending-angle vector choice with sign flip, and a masked state
update; termination is a monotone active mask, so the saved points of a
stream form a prefix of the step axis.  `lax.scan` becomes a Python loop
over the steps.

JAX clamps out-of-range gather indices and torch does not, so every
gather here goes through an index that `_flat_index` has already pointed
at a valid voxel (its `inb` flag stops the stream).

The driver is one loop over seed chunks: propagate, compact the kept
lines on the device into their final point order, copy them to pinned
host memory, append them to the .trk sink (or collect them for a
`Tract`).  The LCM and microscopy modes (tract/modes.py) run through the
same driver.  Only the exact float32 point wire exists; the reference's
quantized wires and its tunnel-shaped fetch pipeline are not ported.

`stream_new_line` propagates one seed through the batched engine;
`stream_new_point` and `stream_micro_new_point` are the reference's
single-step numpy functions over a `StreamWork` of host volumes.
"""

from __future__ import annotations

import contextlib
import struct
import sys
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ..core.handoff import DevicePeaks
from ..core.mri import MRI
from ..device import resolve
from ..io.trk import Tract, TrkSink
from ..utils.prng import prng_key, uniform

__all__ = ["stream", "StreamConfig", "StreamWork", "stream_new_line",
           "stream_new_point", "stream_micro_new_point", "propagate_chunk",
           "peaks_to_ovecs"]


def peaks_to_ovecs(rec, device: bool = False):
    """(ovecs, fs) tractography inputs from a reconstruction result.

    GQI peaks are unit vertex directions with separate `qa` amplitude
    volumes, returned as they are.  Peaks that carry their amplitude in
    their magnitude (RUMBA-SD, reference: src/rusd.jl:602-633) are split
    into unit directions and amplitude volumes.  `device=True` returns the
    fit's `DevicePeaks` instead, for `stream(peaks, mask=...)` with no
    fetch or re-upload.
    """
    if device:
        pk = getattr(rec, "_peak_dev", None)
        if pk is None:
            raise ValueError(
                f"{type(rec).__name__} carries no device-resident peaks "
                "(was it read back from disk?); call without device=True")
        return pk
    if hasattr(rec, "qa"):
        return list(rec.peak), list(rec.qa)

    ovecs, fs = [], []
    for pk in rec.peak:
        v = np.asarray(pk.vol, np.float32)
        a = np.linalg.norm(v, axis=-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            u = np.where(a[..., None] > 0, v / a[..., None], 0.0)
        ov = MRI.like(pk, 3, np.float32)
        ov.vol = u.astype(np.float32)
        fv = MRI.like(pk, 1, np.float32)
        fv.vol = a.astype(np.float32)
        ovecs.append(ov)
        fs.append(fv)
    return ovecs, fs


@dataclass
class StreamConfig:
    """Tractography parameters; names and defaults are those of
    fibers_tpu.tract.stream.StreamConfig (reference: src/stream.jl:730)."""

    f_thresh: float = 0.03
    fa_thresh: float = 0.1
    nsub: Optional[int] = 3
    len_min: int = 3
    len_max: Optional[int] = None
    ang_thresh: Optional[float] = 45.0
    step_size: Optional[float] = 0.5
    smooth_coeff: Optional[float] = 0.2
    search_dist: int = 15
    search_ang: float = 10.0
    lcm_thresh: float = 0.099
    verbose: bool = False
    seed_rng: int = 0
    chunk: int = 1 << 17
    # exact float32 points; the only point wire the port has
    exact_points: bool = False
    # "auto"/"f32": exact float32 points.  "i8"/"i6" are not ported yet.
    wire: str = "auto"
    # stream lines to this .trk path chunk by chunk; the returned Tract
    # then carries header + counts but not the points
    trk_sink: Optional[str] = None
    # multi-device seeds: not ported yet
    mesh: Optional[object] = None


# ------------------------------------------------------------------ #
# Propagation
# ------------------------------------------------------------------ #

def _flat_index(ipos, shape3):
    """Flat voxel index of integer positions [..., 3], pointed at voxel 0
    where out of bounds, and the in-bounds flag."""
    nx, ny, nz = shape3
    ix, iy, iz = ipos.unbind(-1)
    inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
           & (iz >= 0) & (iz < nz))
    flat = (ix * ny + iy) * nz + iz
    return torch.where(inb, flat, torch.zeros_like(flat)), inb


def _pick_by_angle(vec_now, vecs):
    """Greedy choice among candidate vectors [S, nvec, 3]: max |cos| to the
    current direction, sign-flipped to align.  Returns (vnext, ok, ivec).
    (reference: src/stream.jl:340-374)"""
    cos = (vecs * vec_now[:, None, :]).sum(dim=2)
    iszero = (vecs == 0).all(dim=2)
    ninf = torch.tensor(-torch.inf, dtype=cos.dtype, device=cos.device)
    cos = torch.where(iszero, ninf, cos)
    cabs = torch.where(iszero, ninf, cos.abs())
    ivec = torch.argmax(cabs, dim=1)
    c = torch.gather(cos, 1, ivec[:, None])[:, 0]
    v = torch.gather(vecs, 1, ivec[:, None, None].expand(-1, 1, 3))[:, 0, :]
    ok = torch.isfinite(c)
    vnext = torch.where((c > 0)[:, None], v, -v)
    return vnext, ok, ivec


def _smooth_dir(vec, vnext, smooth_coeff):
    """EMA smoothing of the next direction, renormalised (reference:
    src/stream.jl:672-677)."""
    if smooth_coeff == 0.0:
        return vnext
    vsm = smooth_coeff * vec + (1.0 - smooth_coeff) * vnext
    return vsm / torch.clamp_min(
        torch.sqrt((vsm * vsm).sum(dim=1, keepdim=True)), 1e-20)


def _propagate(pos0, vec0, npts0, ovecs_flat, nsteps, shape3, step_size,
               cosang_thresh, smooth_coeff, len_max):
    """Lockstep propagation of one direction for S streams.

    Masking is baked into the orientation vectors: every vector outside
    the mask is zero, so an out-of-mask voxel has no candidate and stops
    the stream.  `npts0` carries the running per-line point count (the
    forward pass's when propagating backward), so both directions share
    the reference's single length budget (reference: src/stream.jl:
    648-686).

    Returns (out [nsteps, S, 3] saved positions, saved [nsteps, S],
    npts_total [S])."""
    s = pos0.shape[0]
    dev = pos0.device
    outs = torch.empty((nsteps, s, 3), dtype=pos0.dtype, device=dev)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    pos, vec, npts = pos0, vec0, npts0
    active = torch.ones(s, dtype=torch.bool, device=dev)
    for t in range(nsteps):
        pos_next = pos + vec * step_size
        flat, inb = _flat_index(torch.round(pos_next).to(torch.int64), shape3)
        vnext, okvec, _ = _pick_by_angle(vec, ovecs_flat[flat])

        # save the CURRENT position (pre-step), as the reference does
        save = active & inb & okvec
        npts = npts + save.to(npts.dtype)
        outs[t] = pos
        saved[t] = save

        # post-save stopping rules
        cosang = (vec * vnext).sum(dim=1)
        cont = save & (cosang >= cosang_thresh) & (npts <= len_max)

        # EMA smoothing, then advance
        pos = torch.where(cont[:, None], pos_next, pos)
        vec = torch.where(cont[:, None], _smooth_dir(vec, vnext,
                                                     smooth_coeff), vec)
        active = cont
    return outs, saved, npts


def _seed_state(seeds, subs, ovecs_flat, shape3):
    """Start positions [S, 3] (seed voxel + sub-voxel offset, host arrays)
    and the first orientation vector at each seed voxel (reference:
    src/stream.jl:645-650), on the device of `ovecs_flat`."""
    pos0 = torch.from_numpy(np.asarray(seeds + subs, np.float32)).to(
        ovecs_flat.device)
    flat, _ = _flat_index(torch.round(pos0).to(torch.int64), shape3)
    return pos0, ovecs_flat[flat][:, 0, :]


def propagate_chunk(seeds, subs, ovecs_flat, shape3, nsteps, step_size,
                    cosang_thresh, smooth_coeff, len_max):
    """Forward + backward propagation of a chunk of seed positions.

    seeds, subs: [S, 3] host arrays (seed voxel, sub-voxel offset).
    Returns (fwd_out, fwd_n, bwd_out, bwd_n) on the device of
    `ovecs_flat`: [nsteps, S, 3] saved points and [S] int32 counts."""
    dev = ovecs_flat.device
    pos0, v0 = _seed_state(seeds, subs, ovecs_flat, shape3)
    zero = torch.zeros(pos0.shape[0], dtype=torch.int32, device=dev)
    args = (ovecs_flat, nsteps, shape3, step_size, cosang_thresh,
            smooth_coeff, len_max)
    fwd_out, fwd_saved, npts_f = _propagate(pos0, v0, zero, *args)
    bwd_out, bwd_saved, _ = _propagate(pos0, -v0, npts_f, *args)
    return (fwd_out, fwd_saved.sum(dim=0, dtype=torch.int32),
            bwd_out, bwd_saved.sum(dim=0, dtype=torch.int32))


# ------------------------------------------------------------------ #
# Compaction and the chunk driver
# ------------------------------------------------------------------ #

def _compact(fwd_out, bwd_out, fwd_n, bwd_n, keep, line_off, total):
    """Scatter one propagated chunk into its final ragged line layout on
    the device: each kept line is its reversed forward prefix, then its
    backward prefix (the reference's prepend/append order).  Points of
    dropped streams and unsaved steps go to a spare row past `total` that
    is cut off.  fwd_out/bwd_out: [nsteps, S, ...] per-step values, the
    points [.., 3] or the LCM's per-point scalar flags (the counterpart
    of the reference's _compact_scalars).  Returns [total, ...] in line
    order."""
    nsteps = fwd_out.shape[0]
    dev = fwd_out.device
    t_idx = torch.arange(nsteps, dtype=torch.int64, device=dev)[:, None]
    fwd_n = fwd_n.to(torch.int64)[None, :]
    bwd_n = bwd_n.to(torch.int64)[None, :]
    off = line_off[None, :]
    keep = keep[None, :]
    spare = torch.tensor(total, dtype=torch.int64, device=dev)
    dst_f = torch.where((t_idx < fwd_n) & keep, off + fwd_n - 1 - t_idx,
                        spare)
    dst_b = torch.where((t_idx < bwd_n) & keep, off + fwd_n + t_idx, spare)
    tail = tuple(fwd_out.shape[2:])
    out = torch.empty((total + 1,) + tail, dtype=fwd_out.dtype, device=dev)
    out[dst_f.reshape(-1)] = fwd_out.reshape((-1,) + tail)
    out[dst_b.reshape(-1)] = bwd_out.reshape((-1,) + tail)
    return out[:total]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy, through pinned memory for a CUDA tensor."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


class _TrkStream(TrkSink):
    """The shared `TrkSink`, for a writer that learns the streamline count
    only as chunks finish: the header goes out with a count of 0 and the
    real count is written into it (the int32 at byte 988 of the 1000-byte
    TrackVis v2 header) when the sink closes."""

    _N_COUNT_AT = 988

    def __init__(self, outfile: str, tr: Tract):
        super().__init__(outfile, tr, 0)

    def close(self) -> None:
        self._f.seek(self._N_COUNT_AT)
        self._f.write(struct.pack("<i", self._written))
        self._n_count = self._written
        super().close()


def _drive(launch, starts, len_min, tr, trk_sink, has_scalars=False):
    """One loop over seed chunks: propagate, compact the kept lines on the
    device, copy them to the host, append them to the sink or keep them
    for the Tract.  Returns the finished Tract.

    launch(lo) -> (fwd_out, fwd_n, bwd_out, bwd_n) or, with has_scalars,
    (..., fwd_scal, bwd_scal): [nsteps, S] int8 per-point flags that go
    with the points as the Tract's one scalar."""
    if has_scalars:
        tr.n_scalars = 1          # before the sink writes the header
    sink = _TrkStream(trk_sink, tr) if trk_sink is not None else None
    counts, parts, sparts = [], [], []
    with sink if sink is not None else contextlib.nullcontext():
        for lo in starts:
            fwd_out, fwd_n_d, bwd_out, bwd_n_d, *scal = launch(lo)
            fwd_n, bwd_n = _to_host(torch.stack([fwd_n_d, bwd_n_d]))
            tot = fwd_n.astype(np.int64) + bwd_n
            keep = tot >= len_min
            if not keep.any():
                continue
            npts = tot[keep]
            off = np.zeros(len(tot), np.int64)
            off[keep] = np.concatenate([[0], np.cumsum(npts)[:-1]])
            dev = fwd_out.device
            lines = (fwd_n_d, bwd_n_d, torch.from_numpy(keep).to(dev),
                     torch.from_numpy(off).to(dev), int(npts.sum()))
            pts = _to_host(_compact(fwd_out, bwd_out, *lines))
            sc = _to_host(_compact(*scal, *lines)).astype(np.float32) \
                if has_scalars else None
            npts = npts.astype(np.int32)
            counts.append(npts)
            if sink is not None:
                sink.append(pts, npts, None if sc is None else sc[:, None])
            else:
                parts.append(pts)
                sparts.append(sc)
    npts = np.concatenate(counts) if counts else np.zeros(0, np.int32)
    if sink is not None:
        tr.npts = npts
        tr.n_count = int(len(npts))
        return tr
    scalars = None
    if has_scalars:
        scalars = np.concatenate(sparts) if sparts else \
            np.zeros(0, np.float32)
    tr.set_packed(np.concatenate(parts) if parts
                  else np.zeros((0, 3), np.float32), npts, scalars=scalars)
    return tr


# ------------------------------------------------------------------ #
# Setup
# ------------------------------------------------------------------ #

def _build_ovec_array(ovecs: List[MRI], fs, f_thresh, mask_array):
    """[nx,ny,nz,nvec,3] orientation array with per-vector amplitude
    masking; accepts 3D vectors or 2D in-plane angles (deg or rad).
    A copy of fibers_tpu/tract/stream.py:_build_ovec_array (that module
    imports jax at its top).  (reference: src/stream.jl:130-173)"""
    nx, ny, nz = ovecs[0].vol.shape[:3]
    nvec = len(ovecs)
    arr = np.zeros((nx, ny, nz, nvec, 3), np.float32)

    for i, ov in enumerate(ovecs):
        vol = ov.vol if ov.vol.ndim == 4 else ov.vol[..., None]
        if fs is not None:
            fvol = fs[i].vol if fs[i].vol.ndim == 3 else fs[i].vol[..., 0]
            omask = mask_array & (fvol >= f_thresh)
        else:
            omask = mask_array

        if vol.shape[3] == 3:
            arr[..., i, :] = vol * omask[..., None]
        elif vol.shape[3] == 1:
            ang = vol[..., 0]
            thrudim = int(np.argmax(ov.volres))
            strdims = [d for d in range(3) if d != thrudim]
            eps = np.finfo(np.float32).eps
            if (ang.min() >= -np.pi / 2 - eps
                    and ang.max() <= np.pi / 2 + eps):
                c, s = np.cos(ang), np.sin(ang)
            elif ang.min() >= -90 and ang.max() <= 90:
                c = np.cos(np.radians(ang))
                s = np.sin(np.radians(ang))
            else:
                raise ValueError("Input orientations should be 3D vectors "
                                 "or angles in [-90, 90]")
            arr[..., i, strdims[0]] = c * omask
            arr[..., i, strdims[1]] = s * omask
        else:
            raise ValueError("Orientation input must have 1 or 3 frames")
    return arr


def _build_ovec_device(vecs, amp, idx, gate_flat, f_thresh, nxyz):
    """Masked [nxyz, nvec, 3] orientation array from a device peak batch:
    amplitude threshold, mask gate and unit directions in one scatter
    (the device counterpart of _build_ovec_array)."""
    n = idx.shape[0]
    v = vecs[:n]
    ok = (amp[:n] >= f_thresh) & gate_flat[idx][:, None]
    v = torch.where(ok[..., None], v, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))
    out = torch.zeros((nxyz,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    out[idx] = v
    return out


def _warn_range(name, thresh, lo, hi):
    if thresh < lo or thresh > hi:
        print(f"WARNING: The value of {name}_thresh ({thresh}) is outside "
              f"the range of most values in the {name} volume ({lo}, {hi})",
              file=sys.stderr)


class StreamWork:
    """Tractography workspace: resolved config defaults, intersected masks
    and the flat [nxyz, nvec, 3] orientation field on the device.
    Counterpart of fibers_tpu.tract.stream.StreamWork (reference:
    src/stream.jl:43-334).

    `ovec` is a `DevicePeaks` (the field is built where the peaks live)
    or host orientation MRIs (the field is built on the host and uploaded
    to `device`, None: the card)."""

    def __init__(self, ovec, *, f=None, fa=None, mask=None,
                 cfg: Optional[StreamConfig] = None, device=None, **kwargs):
        cfg = cfg or StreamConfig()
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise TypeError(f"Unknown stream option {k}")
            setattr(cfg, k, v)
        self.cfg = cfg

        self.device_peaks = ovec if isinstance(ovec, DevicePeaks) else None
        if self.device_peaks is not None:
            if mask is None:
                raise ValueError(
                    "stream with device-resident peaks requires mask=")
            if f is not None:
                raise ValueError(
                    "device-resident peaks carry their own amplitudes; "
                    "f= is not accepted")
            self.ovecs = None
            self.fs = None
            self.shape3 = self.device_peaks.shape3
            volres = self.device_peaks.volres
            self.device = self.device_peaks.device
        else:
            self.ovecs = [ovec] if isinstance(ovec, MRI) else list(ovec)
            self.fs = None if f is None else (
                [f] if isinstance(f, MRI) else list(f))
            self.shape3 = tuple(self.ovecs[0].vol.shape[:3])
            volres = self.ovecs[0].volres
            self.device = resolve(device)
        nx, ny, nz = self.shape3

        # microscopy regime switches defaults (reference:
        # src/stream.jl:83-92)
        self.domicro = float(np.min(volres)) <= 0.05
        self.nsub = cfg.nsub if cfg.nsub is not None else \
            (0 if self.domicro else 3)
        self.ang_thresh = cfg.ang_thresh if cfg.ang_thresh is not None \
            else (20.0 if self.domicro else 45.0)
        self.step_size = cfg.step_size if cfg.step_size is not None else \
            (1.0 if self.domicro else 0.5)
        self.smooth_coeff = cfg.smooth_coeff \
            if cfg.smooth_coeff is not None else \
            (0.0 if self.domicro else 0.2)
        self.len_max = cfg.len_max if cfg.len_max is not None else \
            max(nx, ny, nz)

        # brain mask (reference: src/stream.jl:94-117)
        if mask is None:
            mask_array = np.zeros(self.shape3, bool)
            for ov in self.ovecs:
                vol = ov.vol if ov.vol.ndim == 4 else ov.vol[..., None]
                mask_array |= (vol != 0).any(axis=3)
        else:
            mvol = mask.vol if mask.vol.ndim == 3 else mask.vol[..., 0]
            mask_array = mvol > 0

        if fa is not None:
            favol = fa.vol if fa.vol.ndim == 3 else fa.vol[..., 0]
            inmask = favol[mask_array]
            _warn_range("fa", cfg.fa_thresh, np.quantile(inmask, 1e-5),
                        np.quantile(inmask, 0.9))
            mask_array = mask_array & (favol >= cfg.fa_thresh)

        if self.device_peaks is not None and cfg.f_thresh > 0:
            pk = self.device_peaks
            a = pk.amp[:len(pk.idx), 0]
            q = torch.quantile(a, torch.tensor([1e-5, 0.9], dtype=a.dtype,
                                               device=a.device))
            _warn_range("f", cfg.f_thresh, *(float(x) for x in q.cpu()))
        elif self.fs is not None:
            f0 = self.fs[0].vol if self.fs[0].vol.ndim == 3 else \
                self.fs[0].vol[..., 0]
            inmask = f0[mask_array]
            _warn_range("f", cfg.f_thresh, np.quantile(inmask, 1e-5),
                        np.quantile(inmask, 0.9))

        self.mask_array = mask_array
        if self.device_peaks is not None:
            pk = self.device_peaks
            dev = self.device
            self.nvec = pk.nvec
            self.ovec_arr = None
            self.ovec_flat = _build_ovec_device(
                pk.vecs, pk.amp, torch.from_numpy(
                    np.asarray(pk.idx, np.int64)).to(dev),
                torch.from_numpy(mask_array.reshape(-1)).to(dev),
                float(cfg.f_thresh), int(np.prod(self.shape3)))
        else:
            self.nvec = len(self.ovecs)
            self.ovec_arr = _build_ovec_array(self.ovecs, self.fs,
                                              cfg.f_thresh, mask_array)
            self.ovec_flat = torch.from_numpy(
                self.ovec_arr.reshape(-1, self.nvec, 3)).to(self.device)


def _seed_voxels(mask_array, seed):
    """[nseed, 3] seed voxel indices: the mask's, or the seed volume's
    (reference: src/stream.jl:743-754)."""
    if seed is None:
        return np.argwhere(mask_array)
    svol = seed.vol if seed.vol.ndim == 3 else seed.vol[..., 0]
    if svol.shape != mask_array.shape:
        raise ValueError(
            f"Dimension mismatch between seed mask {svol.shape} and "
            f"brain mask {mask_array.shape}")
    return np.argwhere(svol > 0)


def stream_new_line(seed_vox, sub_vox, work: StreamWork) -> np.ndarray:
    """The bidirectional streamline of one seed voxel as a [3, npts]
    polyline (reference: src/stream.jl:625-686): a single-stream chunk
    through the batched engine, exact float32 points."""
    seeds = np.asarray(seed_vox, np.float32)[None, :]
    subs = np.asarray(sub_vox, np.float32)[None, :]
    fwd, fwd_n, bwd, bwd_n = propagate_chunk(
        seeds, subs, work.ovec_flat, work.shape3, int(work.len_max) + 2,
        float(work.step_size), float(np.cos(np.radians(work.ang_thresh))),
        float(work.smooth_coeff), int(work.len_max))
    n = int(_to_host(fwd_n + bwd_n)[0])
    one = torch.ones(1, dtype=torch.bool, device=fwd.device)
    zero = torch.zeros(1, dtype=torch.int64, device=fwd.device)
    flat = _to_host(_compact(fwd, bwd, fwd_n, bwd_n, one, zero, n))
    return np.ascontiguousarray(flat.T)


def stream_new_point(pos_now, vec_now, work: StreamWork):
    """One deterministic (angle-greedy) propagation step on the host.
    (reference: src/stream.jl:501-541, exported as `stream_new_point!`)

    Returns (pos_next [3], vec_next [3], ok).  ok=False mirrors the
    reference's early `return false` (out of volume, out of mask, or no
    valid orientation vector); pos/vec come back unchanged then.  The
    picked vec_next is unsmoothed: the line driver applies the angle
    threshold and smoothing afterwards, like the reference.  A copy of
    fibers_tpu.tract.stream.stream_new_point."""
    pos_now = np.asarray(pos_now, np.float64)
    vec_now = np.asarray(vec_now, np.float64)
    nx, ny, nz = work.shape3
    pos_next = pos_now + vec_now * float(work.step_size)
    inext = np.round(pos_next).astype(int)
    if not ((0 <= inext[0] < nx) and (0 <= inext[1] < ny)
            and (0 <= inext[2] < nz)):
        return pos_now, vec_now, False
    if not work.mask_array[tuple(inext)]:
        return pos_now, vec_now, False
    vecs = work.ovec_arr[tuple(inext)].astype(np.float64)   # [nvec, 3]
    live = (vecs != 0).any(axis=1)
    if not live.any():
        return pos_now, vec_now, False
    cos = vecs @ vec_now
    cabs = np.where(live, np.abs(cos), -np.inf)
    iv = int(np.argmax(cabs))
    vec_next = vecs[iv] if cos[iv] > 0 else -vecs[iv]
    return pos_next, vec_next, True


def stream_micro_new_point(pos_now, vec_now, work: StreamWork):
    """One microscopy cone-search propagation step on the host.
    (reference: src/stream.jl:547-619, exported as
    `stream_micro_new_point!`)

    Returns (pos_next [3], vec_next [3], ok): pos_next is the chosen
    search-window voxel (integer coordinates, like the reference's jump),
    vec_next the sign-aligned orientation there.  A copy of
    fibers_tpu.tract.stream.stream_micro_new_point."""
    from .modes import _micro_search_dist, _search_window

    pos_now = np.asarray(pos_now, np.float64)
    vec_now = np.asarray(vec_now, np.float64)
    nx, ny, nz = work.shape3

    win = getattr(work, "_micro_window", None)
    if win is None:
        win = work._micro_window = _search_window(_micro_search_dist(work))
    win_off, win_dir = win

    pos_next = pos_now + vec_now * float(work.step_size)
    inext = np.round(pos_next).astype(int)
    if not ((0 <= inext[0] < nx) and (0 <= inext[1] < ny)
            and (0 <= inext[2] < nz)):
        return pos_now, vec_now, False
    if not work.mask_array[tuple(inext)]:
        return pos_now, vec_now, False

    search_cos = float(np.cos(np.radians(work.cfg.search_ang)))
    cells = inext[None, :] + win_off                       # [W, 3]
    inb = ((cells >= 0) & (cells < np.array([nx, ny, nz]))).all(axis=1)
    cand = np.where(inb)[0]
    cand = cand[work.mask_array[tuple(cells[cand].T)]]
    cand = cand[(win_dir[cand] @ vec_now) > search_cos]
    if len(cand) == 0:
        return pos_now, vec_now, False

    wvec = work.ovec_arr[tuple(cells[cand].T)][:, 0, :].astype(np.float64)
    cos = wvec @ vec_now
    ib = int(np.argmax(np.abs(cos)))
    if not np.isfinite(cos[ib]):
        return pos_now, vec_now, False
    vec_next = wvec[ib] if cos[ib] > 0 else -wvec[ib]
    return cells[cand[ib]].astype(np.float64), vec_next, True


def _check_ported(cfg: StreamConfig):
    if cfg.wire not in ("auto", "f32", "i8", "i6"):
        raise ValueError(f"Unknown wire mode {cfg.wire!r} "
                         "(expected auto/f32/i8/i6)")
    if cfg.wire in ("i8", "i6") and not cfg.exact_points:
        raise NotImplementedError(
            f"stream(wire={cfg.wire!r}): the quantized point wires are not "
            "ported yet (ROADMAP A14); use wire='f32'")
    if cfg.mesh is not None:
        raise NotImplementedError(
            "stream(mesh=): multi-device tractography is not ported yet "
            "(ROADMAP A13)")


def stream(ovec: Union[MRI, List[MRI], DevicePeaks], *,
           odf: Optional[MRI] = None, f=None, fa: Optional[MRI] = None,
           mask: Optional[MRI] = None, seed: Optional[MRI] = None,
           lcms: Optional[MRI] = None, cfg: Optional[StreamConfig] = None,
           device=None, **kwargs) -> Tract:
    """Streamline tractography.  Returns a `Tract`.

    Mirrors fibers_tpu.tract.stream.stream (reference: src/stream.jl:
    730-790): builds masks and the orientation field, seeds nsub jittered
    streams per seed voxel, propagates both ways, and assembles the lines
    that reach `len_min` points.  Keyword arguments matching
    `StreamConfig` fields override its defaults.  `odf` is accepted for
    API parity and ignored, like the reference.

    Points are exact float32 (`wire="auto"`/"f32", or `exact_points`).
    `device` places a host orientation field (None: the card);
    `DevicePeaks` stay where they are.  `lcms=` runs the probabilistic LCM
    mode and a voxel size <= 0.05 mm the microscopy mode (tract/modes.py),
    both from host volumes only.  The quantized point wires and `mesh=`
    are not ported yet and raise.
    """
    del odf
    work = StreamWork(ovec, f=f, fa=fa, mask=mask, cfg=cfg, device=device,
                      **kwargs)
    cfg = work.cfg
    _check_ported(cfg)
    if lcms is not None or work.domicro:
        if work.device_peaks is not None:
            raise ValueError("device-resident peaks drive the "
                             "deterministic engine only; pass host "
                             "volumes for LCM/microscopy modes")
        from .modes import stream_lcm, stream_micro
        if lcms is not None:
            return stream_lcm(work, seed, lcms)
        return stream_micro(work, seed)
    seed_idx = _seed_voxels(work.mask_array, seed)

    # sub-voxel jitter: nsub offsets shared by all seed voxels, the same
    # draw as the reference's jax.random.uniform (utils/prng.py)
    if work.nsub > 0:
        subs = uniform(prng_key(cfg.seed_rng), (work.nsub, 3),
                       -0.5 + 1e-6, 0.5 - 1e-6)
    else:
        subs = np.zeros((1, 3), np.float32)
    seeds_all = np.repeat(seed_idx.astype(np.float32), len(subs), axis=0)
    subs_all = np.tile(subs, (len(seed_idx), 1))

    ref = mask if mask is not None else work.ovecs[0]
    tr = Tract.from_ref(ref)
    nsteps = int(work.len_max) + 2
    cosang_thresh = float(np.cos(np.radians(work.ang_thresh)))

    def launch(lo):
        hi = min(lo + cfg.chunk, len(seeds_all))
        return propagate_chunk(
            seeds_all[lo:hi], subs_all[lo:hi], work.ovec_flat, work.shape3,
            nsteps, float(work.step_size), cosang_thresh,
            float(work.smooth_coeff), int(work.len_max))

    starts = list(range(0, len(seeds_all), cfg.chunk))
    return _drive(launch, starts, cfg.len_min, tr, cfg.trk_sink)
