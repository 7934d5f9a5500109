"""Deterministic streamline tractography as a lockstep masked integrator,
in PyTorch.

Counterpart of the deterministic engine of fibers_tpu/tract/stream.py
(reference: src/stream.jl:340-374, 501-541, 625-790).  All streams of a
chunk advance together: each step is a batched voxel gather, the greedy
minimum-bending-angle vector choice with sign flip, and a masked state
update; termination is a monotone active mask, so the saved points of a
stream form a prefix of the step axis.  The `lax.scan` of one direction
becomes one launch of a hand-written CUDA kernel on the card, a Python
loop over the steps on the CPU (ops/kernels/propagate.py).

JAX clamps out-of-range gather indices and torch does not, so every
gather goes through an index that has already been pointed at a valid
voxel (`_flat_index`, or the kernel's own bounds test; its `inb` flag
stops the stream).

The driver is one loop over seed chunks: propagate (the next chunk is
launched before this one's counts are fetched), compact the kept lines
on the device into their final point order, copy them to pinned host
memory, and hand them to a writer thread that decodes, packs and appends
them to the .trk sink while the loop goes on with the next chunk (or
collect them for a `Tract`).  The LCM and microscopy modes
(tract/modes.py) run through the same driver.  The point wire is exact
float32 positions, or the reference's error-feedback deltas ("i8",
"i6"): the step loop quantizes each saved point's step at 1/qscale voxel
while carrying the decoded position, so no error accumulates; the
compaction packs them on the device and the host decodes them natively,
straight into the .trk with a sink.  The reference's tunnel-shaped fetch pipeline is not ported.

`stream_new_line` propagates one seed through the batched engine;
`stream_new_point` and `stream_micro_new_point` are the reference's
single-step numpy functions over a `StreamWork` of host volumes.
"""

from __future__ import annotations

import collections
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from .. import native
from ..core.handoff import DevicePeaks
from ..core.mri import MRI
from ..device import resolve, upload
from ..io.trk import Tract, TrkSink
from ..ops.kernels.propagate import _flat_index, propagate_pair
from ..parallel.mesh import as_mesh, as_tensor, pad_to_multiple
from ..utils.hostbuf import scratch
from ..utils.prng import prng_key, uniform
from ..utils.profiling import count, span

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
    # exact float32 points whatever `wire` says
    exact_points: bool = False
    # point wire: "auto" and "f32" exact float32 points (the reference's
    # "auto" picks i8 on its accelerators); "i8" int8 error-feedback
    # deltas (error <= ~2*step_size/127 voxel, no drift); "i6" the same
    # in 6-bit fields, 25% fewer bytes (<= ~2*step_size/31 voxel)
    wire: str = "auto"
    # stream lines to this .trk path chunk by chunk; the returned Tract
    # then carries header + counts but not the points
    trk_sink: Optional[str] = None
    # shard every chunk's seeds over the mesh's "data" axis
    # (parallel/mesh.py); the orientation field is replicated
    mesh: Optional[object] = None


# ------------------------------------------------------------------ #
# Propagation
# ------------------------------------------------------------------ #

def _seed_state(seeds, subs, ovecs_flat, shape3):
    """Start positions [S, 3] (seed voxel + sub-voxel offset, host arrays)
    and the first orientation vector at each seed voxel (reference:
    src/stream.jl:645-650), on the device of `ovecs_flat`."""
    pos0 = upload(np.asarray(seeds + subs, np.float32), ovecs_flat.device)
    flat, _ = _flat_index(torch.round(pos0).to(torch.int64), shape3)
    return pos0, ovecs_flat[flat][:, 0, :].contiguous()


def propagate_chunk(seeds, subs, ovecs_flat, shape3, nsteps, step_size,
                    cosang_thresh, smooth_coeff, len_max, emit="points",
                    qscale=254.0, dmax=127):
    """Forward + backward propagation of a chunk of seed positions.

    seeds, subs: [S, 3] host arrays (seed voxel, sub-voxel offset).
    Returns (fwd_out, fwd_n, bwd_out, bwd_n, anchor) on the device of
    `ovecs_flat`: [nsteps, S, 3] saved points (emit="points") or int8
    deltas (emit="deltas"), [S] int32 counts, and the forward chain's
    final quantized position [S, 3], the line anchor of the delta
    decode."""
    return propagate_shards([(seeds, subs, ovecs_flat)], shape3, nsteps,
                            step_size, cosang_thresh, smooth_coeff,
                            len_max, emit, qscale, dmax)[0]


def propagate_shards(parts, shape3, nsteps, step_size, cosang_thresh,
                     smooth_coeff, len_max, emit="points", qscale=254.0,
                     dmax=127):
    """`propagate_chunk` for the seed shards `parts` [(seeds, subs,
    ovecs_flat)], each on its field's device: one `propagate_pair` call
    per shard, both directions.  On the card each is one kernel launch
    that does not wait for the card, so the devices of a mesh work at
    once.  The backward direction starts from the forward counts, so both
    share the reference's single length budget (reference:
    src/stream.jl:648-686).  Each direction's count is its npts less the
    npts it started from (a save adds one).  Returns one (fwd_out, fwd_n,
    bwd_out, bwd_n, anchor) per shard."""
    args = (nsteps, shape3, step_size, cosang_thresh, smooth_coeff, len_max,
            emit, qscale, dmax)
    out = []
    for seeds, subs, ov in parts:
        p0, v0 = _seed_state(seeds, subs, ov, shape3)
        zero = torch.zeros(p0.shape[0], dtype=torch.int32, device=p0.device)
        fo, _, nf, fq, bo, _, nb = propagate_pair(p0, v0, zero, ov, *args)
        out.append((fo, nf, bo, nb - nf, fq))
    return out


# ------------------------------------------------------------------ #
# Compaction and the chunk driver
# ------------------------------------------------------------------ #

def _compact(fwd_out, bwd_out, fwd_n, bwd_n, keep, line_off, total,
             mode="f32"):
    """Scatter one propagated chunk into its final ragged line layout on
    the device: each kept line is its reversed forward prefix, then its
    backward prefix (the reference's prepend/append order).  Points of
    dropped streams and unsaved steps go to a spare row past `total` that
    is cut off.

    mode="f32": fwd_out/bwd_out are [nsteps, S, ...] per-step values, the
    points [.., 3] or the LCM's per-point scalar flags (the counterpart
    of the reference's _compact_scalars); returns [total, ...] in line
    order.  mode="i8"/"i6": they are int8 step deltas and the result is
    the line-order deltas line[j] - line[j-1] (forward deltas negated and
    shifted by one, since that segment is laid out reversed; each line's
    first slot keeps its zero), [total, 3] int8 for "i8" and the 6-bit
    packing of them (`_pack6`) for "i6".  (fibers_tpu/tract/stream.py:
    _compact)"""
    nsteps = fwd_out.shape[0]
    dev = fwd_out.device
    t_idx = torch.arange(nsteps, dtype=torch.int64, device=dev)[:, None]
    fwd_n = fwd_n.to(torch.int64)[None, :]
    bwd_n = bwd_n.to(torch.int64)[None, :]
    off = line_off[None, :]
    keep = keep[None, :]
    tail = tuple(fwd_out.shape[2:])
    dst_b = torch.where((t_idx < bwd_n) & keep, off + fwd_n + t_idx, total)
    if mode == "f32":
        dst_f = torch.where((t_idx < fwd_n) & keep, off + fwd_n - 1 - t_idx,
                            total)
        out = torch.empty((total + 1,) + tail, dtype=fwd_out.dtype,
                          device=dev)
        fwd_out = fwd_out.reshape((-1,) + tail)
    else:
        # zero-initialised: each line's first slot must read "no delta"
        dst_f = torch.where((t_idx >= 1) & (t_idx < fwd_n) & keep,
                            off + fwd_n - t_idx, total)
        out = torch.zeros((total + 1,) + tail, dtype=fwd_out.dtype,
                          device=dev)
        fwd_out = -fwd_out.reshape((-1,) + tail)
    out[dst_f.reshape(-1)] = fwd_out
    out[dst_b.reshape(-1)] = bwd_out.reshape((-1,) + tail)
    out = out[:total]
    return _pack6(out) if mode == "i6" else out


def _pack6(q: torch.Tensor) -> torch.Tensor:
    """int8 deltas in [-31, 31] -> the 6-bit wire: sign-offset fields
    (d + 32) & 63, 16 to 3 words (fields 5 and 10 straddle a word
    boundary), the field count padded to a multiple of 16 with zero
    deltas.  Built in int64 and kept to the low 32 bits as int32 (torch
    has few uint32 kernels); the host reads the words as uint32.
    (fibers_tpu/tract/stream.py:_compact mode="i6"; inverse `_unpack6`)"""
    q = q.reshape(-1)
    pad = (-q.numel()) % 16
    if pad:
        q = torch.cat([q, q.new_zeros(pad)])
    g = ((q.to(torch.int64) + 32) & 63).reshape(-1, 16)
    w0 = (g[:, 0] | (g[:, 1] << 6) | (g[:, 2] << 12) | (g[:, 3] << 18)
          | (g[:, 4] << 24) | ((g[:, 5] & 3) << 30))
    w1 = ((g[:, 5] >> 2) | (g[:, 6] << 4) | (g[:, 7] << 10)
          | (g[:, 8] << 16) | (g[:, 9] << 22) | ((g[:, 10] & 15) << 28))
    w2 = ((g[:, 10] >> 4) | (g[:, 11] << 2) | (g[:, 12] << 8)
          | (g[:, 13] << 14) | (g[:, 14] << 20) | (g[:, 15] << 26))
    w = torch.stack([w0, w1, w2], dim=1).reshape(-1)
    # low 32 bits as a signed value, then an exact int32 cast
    return (w - ((w & 0x80000000) << 1)).to(torch.int32)


def _unpack6(raw, nvals):
    """Expand the packed 6-bit wire (uint32 words; 16 sign-offset fields
    per 3 words, `_pack6`) to int8 deltas of length >= nvals, which then
    feed the int8 decoders unchanged.  The result is a pooled scratch
    view (utils/hostbuf.py): valid only until the next _unpack6 call.
    A copy of fibers_tpu/tract/stream.py:_unpack6."""
    w = np.ascontiguousarray(raw.view(np.uint32))
    ngroups = (nvals + 15) // 16
    out = scratch("wire.unpack6", ngroups * 16, np.int8)
    clib = native.lib()
    if clib is not None:
        clib.unpack_sext6(native.as_u32_ptr(w),
                          np.int64(ngroups * 16), native.as_i8_ptr(out))
        return out
    g = w[:ngroups * 3].reshape(-1, 3)
    w0, w1, w2 = g[:, 0], g[:, 1], g[:, 2]
    v = scratch("wire.unpack6v", ngroups * 16,
                np.uint32).reshape(ngroups, 16)
    v[:, 0] = w0
    v[:, 1] = w0 >> 6
    v[:, 2] = w0 >> 12
    v[:, 3] = w0 >> 18
    v[:, 4] = w0 >> 24
    v[:, 5] = (w0 >> 30) | (w1 << np.uint32(2))
    v[:, 6] = w1 >> 4
    v[:, 7] = w1 >> 10
    v[:, 8] = w1 >> 16
    v[:, 9] = w1 >> 22
    v[:, 10] = (w1 >> 28) | (w2 << np.uint32(4))
    v[:, 11] = w2 >> 2
    v[:, 12] = w2 >> 8
    v[:, 13] = w2 >> 14
    v[:, 14] = w2 >> 20
    v[:, 15] = w2 >> 26
    out[:] = ((v & 63).astype(np.int16) - 32).astype(np.int8).reshape(-1)
    return out


def _decode_points(raw, total, mode, npts=None, anchors=None, out=None,
                   qscale=254.0):
    """Decode a fetched wire buffer to [total, 3] positions (into `out`
    when given).  mode="i8": raw holds int8 line-order deltas; each line
    is its anchor + cumulative deltas / qscale.  mode="i6": 6-bit fields,
    expanded to int8, then decoded as i8.  A copy of
    fibers_tpu/tract/stream.py:_decode_points."""
    if mode == "i6":
        raw = _unpack6(raw, total * 3)
        mode = "i8"
    if out is None:
        out = np.empty((total, 3), np.float32)
    if mode == "i8":
        q = np.ascontiguousarray(raw.view(np.int8).reshape(-1)[:total * 3])
        off = np.zeros(len(npts), np.int64)
        np.cumsum(npts[:-1], dtype=np.int64, out=off[1:])
        clib = native.lib()
        if clib is not None:
            # one integer-accumulate pass per line, OpenMP-parallel
            anch = np.ascontiguousarray(anchors, np.float32)
            npts32 = np.ascontiguousarray(npts, np.int32)
            clib.decode_delta_lines(
                native.as_i8_ptr(q), native.as_i64_ptr(off),
                native.as_i32_ptr(npts32), native.as_f32_ptr(anch),
                len(npts), np.float32(1.0 / qscale),
                native.as_f32_ptr(out))
            return out
        # numpy fallback: global integer cumsum, per-line rebase to the
        # anchor (the first slot of each line holds a zero delta)
        c = np.cumsum(q.reshape(-1, 3), axis=0, dtype=np.int64)
        base = anchors.astype(np.float64) - c[off] * (1.0 / qscale)
        out[:] = (c * (1.0 / qscale)
                  + np.repeat(base, npts, axis=0)).astype(np.float32)
        return out
    out[:] = raw[:total * 3].reshape(total, 3)
    return out


def _wire_mode(cfg, step_size):
    """The point wire: (mode, emit, qscale, dmax).  "auto" and "f32" (and
    `exact_points`) give exact float32 points, "i8"/"i6" int8 or 6-bit
    error-feedback deltas with the full quantizer range per step,
    qscale = dmax / step_size.  (fibers_tpu/tract/stream.py:_wire_mode,
    with "auto" resolved as on the reference's CPU backend)"""
    if cfg.wire not in ("auto", "f32", "i8", "i6"):
        raise ValueError(f"Unknown wire mode {cfg.wire!r} "
                         "(expected auto/f32/i8/i6)")
    mode = "f32" if cfg.exact_points or cfg.wire == "auto" else cfg.wire
    emit = "points" if mode == "f32" else "deltas"
    dmax = 31 if mode == "i6" else 127
    return mode, emit, dmax / max(float(step_size), 1e-6), dmax


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy, through pinned memory for a CUDA tensor
    (its bytes counted as `transfer.d2h_bytes`)."""
    if t.device.type != "cuda":
        return t.numpy()
    count("transfer.d2h_bytes", t.nbytes)
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


def _fetch_lines(part, len_min, mode, has_scalars):
    """One propagated seed shard's kept lines on the host: its counts
    (and, for a delta wire, its anchors) in one blocking copy, then the
    compaction on its device and a blocking copy of the lines.  Returns
    (npts, raw, anchors, flags) host arrays: int32 point counts, the wire
    buffer, the [n, 3] line anchors (delta wires, else None) and the int8
    per-point flags (`has_scalars`, else None); None when no line is
    kept."""
    fwd_out, fwd_n_d, bwd_out, bwd_n_d, anchor, *scal = part
    s = fwd_n_d.shape[0]
    meta = [fwd_n_d, bwd_n_d]
    if mode != "f32":
        # the anchors' bits ride with the counts: one copy
        meta.append(anchor.reshape(-1).view(torch.int32))
    meta = _to_host(torch.cat(meta))
    tot = meta[:s].astype(np.int64) + meta[s:2 * s]
    keep = tot >= len_min
    if not keep.any():
        return None
    npts = tot[keep]
    off = np.zeros(len(tot), np.int64)
    off[keep] = np.concatenate([[0], np.cumsum(npts)[:-1]])
    dev = fwd_out.device
    lines = (fwd_n_d, bwd_n_d, upload(keep, dev), upload(off, dev),
             int(npts.sum()))
    raw = _to_host(_compact(fwd_out, bwd_out, *lines, mode))
    flags = _to_host(_compact(*scal, *lines)) if has_scalars else None
    anch = None if mode == "f32" else \
        meta[2 * s:].view(np.float32).reshape(s, 3)[keep]
    return npts.astype(np.int32), raw, anch, flags


def _chunk_lines(launch, starts, len_min, mode, has_scalars):
    """The chunk loop's device side, on the calling thread: yields each
    seed shard's kept lines (`_fetch_lines`) in seed order.  Chunk i+1 is
    launched before chunk i's counts copy (the reference's f32 wave of
    two), so the card has it queued while the host syncs and compacts;
    each chunk's raw outputs are dropped with its compaction, so at most
    two chunks of them are on the card.  `launch` is called once per
    chunk, in order."""
    ahead = launch(starts[0]) if starts else None
    for i in range(len(starts)):
        out, ahead = ahead, None
        if i + 1 < len(starts):
            ahead = launch(starts[i + 1])
        parts = out if isinstance(out, list) else [out]
        del out
        for k in range(len(parts)):
            with span("stream.fetch"):
                lines = _fetch_lines(parts[k], len_min, mode, has_scalars)
            parts[k] = None
            if lines is not None:
                yield lines


class _WriterTimes:
    """Seconds the .trk writer thread spent decoding, packing and writing
    chunks (`busy`), and seconds the chunk loop waited on it (`stall`:
    what of the writer's work stayed on the critical path), summed over
    every stream into a sink since the last `reset()`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.busy = self.stall = 0.0


writer_times = _WriterTimes()


def _append_lines(sink, npts, raw, anchors, flags, mode, qscale):
    """Append one shard's fetched lines to the sink: the fused native
    decode of a delta wire into records, else decode + pack."""
    if flags is None and mode != "f32" and _append_fused(
            sink, raw, npts, anchors, mode, qscale):
        return
    pts = raw if mode == "f32" else _decode_points(
        raw, int(npts.sum()), mode, npts=npts, anchors=anchors,
        qscale=qscale)
    sink.append(pts, npts,
                None if flags is None else flags.astype(np.float32)[:, None])


class _Writer:
    """The sink's writer thread: one worker appends the submitted chunks
    in order while the calling thread launches, compacts and copies the
    next ones.  The worker gets host numpy arrays only and calls nothing
    of torch: the pooled `scratch` views of the decode and the packing
    live and die on it, and the calling thread keeps its own reference
    to every array it hands over (pinned memory) until the chunk is
    written, so pinned blocks are freed on the calling thread.  At most
    `DEPTH` chunks are in flight; a worker error is raised on the calling
    thread at the next `submit` or at `drain`."""

    DEPTH = 2

    def __init__(self, sink, mode, qscale):
        self._args = (sink, mode, qscale)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="trk-writer")
        self._inflight = collections.deque()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._inflight.clear()

    def submit(self, lines):
        while self._inflight and (len(self._inflight) >= self.DEPTH
                                  or self._inflight[0][0].done()):
            self._wait_oldest()
        # the worker takes the arrays out of the box, so that it holds no
        # reference once the chunk is written
        self._inflight.append((self._pool.submit(self._write, [lines]),
                               lines))

    def drain(self):
        while self._inflight:
            self._wait_oldest()

    def _wait_oldest(self):
        t0 = time.perf_counter()
        try:
            with span("stream.wait"):
                self._inflight[0][0].result()
        finally:
            writer_times.stall += time.perf_counter() - t0
            self._inflight.popleft()

    def _write(self, box):
        t0 = time.perf_counter()
        try:
            with span("stream.write"):
                _append_lines(self._args[0], *box.pop(), *self._args[1:])
        finally:
            writer_times.busy += time.perf_counter() - t0


def _drive(launch, starts, len_min, tr, trk_sink, has_scalars=False,
           mode="f32", qscale=254.0):
    """One loop over seed chunks: propagate, compact the kept lines on the
    device, copy them to the host (`_chunk_lines`), then append them to
    the sink on its writer thread (`_Writer`) or keep them for the Tract.
    Returns the finished Tract.

    launch(lo) -> (fwd_out, fwd_n, bwd_out, bwd_n, anchor) or, with
    has_scalars, (..., fwd_scal, bwd_scal): [nsteps, S] int8 per-point
    flags that go with the points as the Tract's one scalar.  A sharded
    launch returns a list of such tuples, one per seed shard in seed
    order; each is compacted on its own device.  `mode`: the point wire
    (`_wire_mode`); with "i8"/"i6" the outputs are deltas, the anchors
    come to the host in the one copy of the counts, and the host decodes
    (natively into the .trk records with a sink).  Without a sink the
    lines are decoded on the calling thread, as they are assembled."""
    if has_scalars:
        tr.n_scalars = 1          # before the sink writes the header
    chunks = _chunk_lines(launch, starts, len_min, mode, has_scalars)
    counts = []
    if trk_sink is not None:
        with _TrkStream(trk_sink, tr) as sink, \
                _Writer(sink, mode, qscale) as writer:
            for lines in chunks:
                counts.append(lines[0])
                writer.submit(lines)
            writer.drain()
        tr.npts = np.concatenate(counts) if counts else \
            np.zeros(0, np.int32)
        tr.n_count = int(len(tr.npts))
        return tr
    parts, sparts = [], []
    for npts, raw, anch, flags in chunks:
        counts.append(npts)
        parts.append(raw if mode == "f32" else _decode_points(
            raw, int(npts.sum()), mode, npts=npts, anchors=anch,
            qscale=qscale))
        sparts.append(None if flags is None else flags.astype(np.float32))
    npts = np.concatenate(counts) if counts else np.zeros(0, np.int32)
    scalars = None
    if has_scalars:
        scalars = np.concatenate(sparts) if sparts else \
            np.zeros(0, np.float32)
    tr.set_packed(np.concatenate(parts) if parts
                  else np.zeros((0, 3), np.float32), npts, scalars=scalars)
    return tr


def _append_fused(sink, raw, npts, anchors, mode, qscale):
    """The sink's fused native decode of a delta wire chunk straight into
    .trk records; False when the native library is missing."""
    if mode == "i6":
        return sink.append_deltas6(raw.view(np.uint32), npts, anchors,
                                   qscale)
    return sink.append_deltas(raw.reshape(-1), npts, anchors, qscale)


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


def _quantiles(a: torch.Tensor, qs) -> List[float]:
    """The quantiles `qs` of a 1-D float32 tensor of any length, with
    `jnp.quantile`'s linear interpolation in float32 (position
    q * (n - 1), the floor and ceil neighbours weighted by its fraction;
    NaN if any value is NaN): one sort on the tensor's device and one
    copy of the few values needed to the host.  (`torch.quantile` stops
    at 2^24 values.)"""
    n = a.numel()
    if n == 0:
        return [float("nan")] * len(qs)
    f32 = np.float32
    top = f32(n) - f32(1)                    # n - 1 as jnp takes it, in f32
    pos = np.asarray(qs, f32) * top
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = f32(1) - w_high
    at = np.concatenate([np.clip(low, 0, top), np.clip(high, 0, top)])
    srt = torch.sort(a.reshape(-1)).values
    # python ints index with no host-to-device copy; f32(n) - 1 can pass
    # n - 1, where jnp's gather clamps; NaN sorts last
    picks = torch.stack([srt[min(int(i), n - 1)] for i in at] + [srt[n - 1]])
    vals = picks.cpu().numpy().astype(f32)
    if np.isnan(vals[-1]):
        return [float("nan")] * len(qs)
    k = len(pos)
    return [float(x) for x in vals[:k] * w_low + vals[k:2 * k] * w_high]


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

    `ovec` is a `DevicePeaks` (the field is built where the peaks live),
    a dense field on a device (a tensor [X, Y, Z, 3], e.g. a column of
    `st_recon`'s lazy eigenvectors: masked where it lies), or host
    orientation MRIs (the field is built on the host and uploaded to
    `device`, None: the card, or to a mesh's first device).  The two
    device inputs need `mask=`, which also gives the geometry of a dense
    field (`ref`, the .trk header's volume).
    With `cfg.mesh` the field is copied to each of the mesh's devices:
    `fields` maps each device to its copy."""

    def __init__(self, ovec, *, f=None, fa=None, mask=None,
                 cfg: Optional[StreamConfig] = None, device=None, **kwargs):
        cfg = cfg or StreamConfig()
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise TypeError(f"Unknown stream option {k}")
            setattr(cfg, k, v)
        cfg.mesh = as_mesh(cfg.mesh)
        self.cfg = cfg

        self.device_peaks = ovec if isinstance(ovec, DevicePeaks) else None
        self.device_field = ovec if isinstance(ovec, torch.Tensor) else None
        self._mask_dev = None
        if self.device_peaks is not None or self.device_field is not None:
            if mask is None:
                raise ValueError(
                    "stream from a device-resident field requires mask=")
            if f is not None:
                raise ValueError(
                    "a device-resident field carries no amplitudes of its "
                    "own to threshold; f= is not accepted")
            self.ovecs = None
            self.fs = None
        if self.device_peaks is not None:
            self.shape3 = self.device_peaks.shape3
            volres = self.device_peaks.volres
            self.device = self.device_peaks.device
        elif self.device_field is not None:
            fd = self.device_field
            if fd.dim() != 4 or fd.shape[-1] != 3:
                raise ValueError(f"a device field is [X, Y, Z, 3], not "
                                 f"{list(fd.shape)}")
            self.shape3 = tuple(int(n) for n in fd.shape[:3])
            volres = np.asarray(mask.volres)
            self.device = fd.device
        else:
            self.ovecs = [ovec] if isinstance(ovec, MRI) else list(ovec)
            self.fs = None if f is None else (
                [f] if isinstance(f, MRI) else list(f))
            self.shape3 = tuple(self.ovecs[0].vol.shape[:3])
            volres = self.ovecs[0].volres
            self.device = resolve(device) if cfg.mesh is None else \
                cfg.mesh.data_devices[0]
        nx, ny, nz = self.shape3
        self.ref = mask if self.ovecs is None else self.ovecs[0]

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
            if mask_array.shape != self.shape3:
                raise ValueError(f"Dimension mismatch between the "
                                 f"orientations {self.shape3} and the mask "
                                 f"{mask_array.shape}")

        if fa is not None:
            favol = fa.vol if fa.vol.ndim == 3 else fa.vol[..., 0]
            inmask = favol[mask_array]
            _warn_range("fa", cfg.fa_thresh, np.quantile(inmask, 1e-5),
                        np.quantile(inmask, 0.9))
            mask_array = mask_array & (favol >= cfg.fa_thresh)

        if self.device_peaks is not None and cfg.f_thresh > 0:
            pk = self.device_peaks
            _warn_range("f", cfg.f_thresh, *_quantiles(
                as_tensor(pk.amp[:len(pk.idx), 0]), (1e-5, 0.9)))
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
                as_tensor(pk.vecs, dev), as_tensor(pk.amp, dev),
                torch.from_numpy(
                    np.asarray(pk.idx, np.int64)).to(dev),
                torch.from_numpy(mask_array.reshape(-1)).to(dev),
                float(cfg.f_thresh), int(np.prod(self.shape3)))
        elif self.device_field is not None:
            # zero outside the mask, as the host route's vol * mask
            self.nvec = 1
            self.ovec_arr = None
            keep = self.mask_flat().reshape(self.shape3 + (1,))
            self.ovec_flat = (self.device_field.float() * keep).reshape(
                -1, 1, 3)
        else:
            self.nvec = len(self.ovecs)
            self.ovec_arr = _build_ovec_array(self.ovecs, self.fs,
                                              cfg.f_thresh, mask_array)
            self.ovec_flat = torch.from_numpy(
                self.ovec_arr.reshape(-1, self.nvec, 3)).to(self.device)
        self.fields = {self.ovec_flat.device: self.ovec_flat}
        if cfg.mesh is not None:
            for d in cfg.mesh.distinct_devices():
                if d not in self.fields:
                    self.fields[d] = self.ovec_flat.to(d)

    def mask_flat(self) -> torch.Tensor:
        """The tracking mask, flat [nxyz] bool, on the field's device
        (uploaded on the first call)."""
        if self._mask_dev is None:
            self._mask_dev = torch.from_numpy(
                self.mask_array.reshape(-1)).to(self.device)
        return self._mask_dev


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
    fwd, fwd_n, bwd, bwd_n, _ = propagate_chunk(
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


def _launch_sharded(seeds, subs, mesh, fields, args):
    """One chunk's seeds split over the mesh's data axis (this process's
    shards), padded to a multiple of it with out-of-volume seeds (-10),
    as fibers_tpu/tract/stream.py:1157-1164 does; propagated by
    `propagate_shards`, one launch per shard and direction on the card.
    The padding seeds are cut from the
    results, so only real seeds reach `_drive`, in seed order."""
    m = len(seeds)
    per = pad_to_multiple(m, mesh.ndata) // mesh.ndata
    pad = per * mesh.ndata - m
    seeds = np.concatenate([seeds, np.full((pad, 3), -10.0, np.float32)])
    subs = np.concatenate([subs, np.zeros((pad, 3), np.float32)])
    shards = [(i, min(per, m - i * per)) for i in range(mesh.ndata)
              if mesh.is_local(i) and i * per < m]
    outs = propagate_shards(
        [(seeds[i * per:(i + 1) * per], subs[i * per:(i + 1) * per],
          fields[mesh.data_devices[i]]) for i, _ in shards], *args)
    return [(fo[:, :r], fn[:r], bo[:, :r], bn[:r], fq[:r])
            for (_, r), (fo, fn, bo, bn, fq) in zip(shards, outs)]


def stream(ovec: Union[MRI, List[MRI], DevicePeaks, torch.Tensor], *,
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

    Points: exact float32 with `wire="auto"` (the default) or "f32", or
    with `exact_points`; `wire="i8"` quantizes them to int8 error-feedback
    deltas at 1/qscale voxel (qscale = 127/step_size; error <= ~2/qscale
    at every point, no drift) and "i6" to 6-bit ones (qscale =
    31/step_size), decoded on the host as in the reference.  `device`
    places a host orientation field (None: the card);
    `DevicePeaks` stay where they are.  `mesh=` (parallel/mesh.py) shards
    each chunk's seeds over the mesh's "data" axis, padded to a multiple
    of it with out-of-volume seeds, against a copy of the field on every
    device; the lines come out in seed order, as without a mesh.
    `ovec` may also be a dense field on a device, a tensor [X, Y, Z, 3],
    with `mask=`: it is masked where it lies (`StreamWork`).  A voxel
    size <= 0.05 mm runs the microscopy mode (tract/modes.py) from host
    volumes, a dense device field or `DevicePeaks`; `lcms=` runs the
    probabilistic LCM mode, from host volumes only.  Both run unsharded
    (on a mesh's first device), as in the reference.
    """
    del odf
    with span("stream.work"):
        work = StreamWork(ovec, f=f, fa=fa, mask=mask, cfg=cfg,
                          device=device, **kwargs)
    cfg = work.cfg
    wire = _wire_mode(cfg, work.step_size)
    if lcms is not None or work.domicro:
        from .modes import stream_lcm, stream_micro
        if lcms is not None:
            if work.ovecs is None:
                raise ValueError("the LCM mode reads host orientation "
                                 "volumes; a device-resident field drives "
                                 "the deterministic and microscopy modes")
            return stream_lcm(work, seed, lcms, wire)
        return stream_micro(work, seed, wire)
    with span("stream.work"):
        seed_idx = _seed_voxels(work.mask_array, seed)
        # sub-voxel jitter: nsub offsets shared by all seed voxels, the
        # same draw as the reference's jax.random.uniform (utils/prng.py)
        if work.nsub > 0:
            subs = uniform(prng_key(cfg.seed_rng), (work.nsub, 3),
                           -0.5 + 1e-6, 0.5 - 1e-6)
        else:
            subs = np.zeros((1, 3), np.float32)
        seeds_all = np.repeat(seed_idx.astype(np.float32), len(subs),
                              axis=0)
        subs_all = np.tile(subs, (len(seed_idx), 1))

    tr = Tract.from_ref(mask if mask is not None else work.ref)
    nsteps = int(work.len_max) + 2
    cosang_thresh = float(np.cos(np.radians(work.ang_thresh)))

    mode, emit, qscale, dmax = wire
    args = (work.shape3, nsteps, float(work.step_size), cosang_thresh,
            float(work.smooth_coeff), int(work.len_max), emit, qscale, dmax)

    def launch(lo):
        hi = min(lo + cfg.chunk, len(seeds_all))
        if cfg.mesh is None:
            return propagate_chunk(seeds_all[lo:hi], subs_all[lo:hi],
                                   work.ovec_flat, *args)
        return _launch_sharded(seeds_all[lo:hi], subs_all[lo:hi],
                               cfg.mesh, work.fields, args)

    starts = list(range(0, len(seeds_all), cfg.chunk))
    return _drive(launch, starts, cfg.len_min, tr, cfg.trk_sink, mode=mode,
                  qscale=qscale)
