"""Probabilistic (LCM) and microscopy (cone-search) tractography modes,
in PyTorch.

Counterpart of fibers_tpu/tract/modes.py: lockstep versions of the
reference's `stream_pick_by_lcm!` (reference: src/stream.jl:380-495) and
`stream_micro_new_point!` (reference: src/stream.jl:547-619), driven by
the deterministic engine's chunk loop (`stream._drive`).

LCM: the sub-voxel jitter is drawn from the second half of
`split(PRNGKey(seed_rng))` and the per-chunk keys from
`split(key, 2 * nchunks)`, bit for bit as in the reference
(utils/prng.py).  The categorical draws cannot be: each (chunk,
direction) draws counter-based Philox uniforms under its key
(`ops/kernels/propagate_lcm.py:lcm_uniforms`), the same in the kernel and
the plain loop, so LCM lines match the reference in distribution (the
reference itself draws from Julia's global RNG).  Each saved point
carries one scalar, the method-difference flag.

Micro: jumps land on integer voxels, so the lines equal the reference's
exactly.  Its integer point wire, deltas of one voxel (qscale = 1), is
exact too when the seeds are voxel centres (nsub = 0) and no jump can
leave the delta range; otherwise an explicit i8/i6 warns and the points
go as float32, as in the reference.

Both engines emit the point wire of `stream._wire_mode`: float32 points
or error-feedback deltas (`ops/kernels/propagate.py:_quantize_step`).
Each direction of a chunk is one call of its engine's step loop,
`propagate_lcm_dir` or `propagate_micro_dir`: one hand-written kernel
launch on the card, the plain loop of torch operations on the CPU.
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import torch

from ..io.trk import Tract
from ..ops.kernels.propagate_lcm import EDGETYPE, propagate_lcm_dir
from ..ops.kernels.propagate_micro import propagate_micro_dir
from ..utils.prng import prng_key, split, uniform
from ..utils.profiling import count, span
from .stream import _drive, _seed_state, _seed_voxels

__all__ = ["stream_lcm", "stream_micro"]


# ------------------------------------------------------------------ #
# LCM probabilistic mode
# ------------------------------------------------------------------ #

def stream_lcm(work, seed, lcms, wire):
    """Driver for probabilistic LCM tractography over a `StreamWork` of
    host orientation volumes, with the point wire `wire` (mode, emit,
    qscale, dmax).  (reference: src/stream.jl:199-244, 380-495)"""
    cfg = work.cfg
    dev = work.device
    lcm_vol = np.asarray(lcms.vol, np.float32)
    lcm_max = lcm_vol.max()
    if cfg.lcm_thresh > lcm_max:
        print(f"WARNING: The value of lcm_thresh ({cfg.lcm_thresh}) is "
              f"greater than the maximum value in the lcms volume "
              f"({lcm_max})", file=sys.stderr)
    lcm_vol = lcm_vol * (lcm_vol >= cfg.lcm_thresh)

    # 2-D in-plane set-up: the through-plane dim is the all-zero one of
    # the first orientation volume (reference: src/stream.jl:222-231)
    ov0 = work.ovecs[0].vol
    ov0 = ov0 if ov0.ndim == 4 else ov0[..., None]
    zero_dims = [d for d in range(min(3, ov0.shape[3]))
                 if not np.any(ov0[..., d])]
    thrudim = zero_dims[0] if zero_dims else 2
    strdims = [d for d in range(3) if d != thrudim]
    dxyz = np.zeros((3, 4), np.int64)
    dxyz[strdims[0], :] = [-1, 0, 1, 0]
    dxyz[strdims[1], :] = [0, -1, 0, 1]

    seed_idx = _seed_voxels(work.mask_array, seed)
    key = prng_key(cfg.seed_rng)
    if work.nsub > 0:
        key, sk = split(key)
        subs = uniform(sk, (work.nsub, 3), -0.5 + 1e-6, 0.5 - 1e-6)
    else:
        subs = np.zeros((1, 3), np.float32)
    seeds_all = np.repeat(seed_idx.astype(np.float32), len(subs), axis=0)
    subs_all = np.tile(subs, (len(seed_idx), 1))

    mask_flat = work.mask_flat()
    lcms_flat = torch.from_numpy(
        lcm_vol.reshape(-1, lcm_vol.shape[3])).to(dev)
    dxyz_t = torch.from_numpy(dxyz).to(dev)
    edget = torch.from_numpy(EDGETYPE.astype(np.int64)).to(dev)
    nsteps = int(work.len_max) + 2
    mode, emit, qscale, dmax = wire
    args = (mask_flat, work.ovec_flat, lcms_flat, dxyz_t, edget, strdims,
            nsteps, work.shape3, float(work.step_size),
            float(work.smooth_coeff), int(work.len_max), emit, qscale, dmax)

    starts = list(range(0, len(seeds_all), cfg.chunk))
    # per-chunk keys, fixed up front as in the reference
    ckeys = split(key, 2 * max(len(starts), 1))

    def launch(lo):
        hi = min(lo + cfg.chunk, len(seeds_all))
        pos0, v0 = _seed_state(seeds_all[lo:hi], subs_all[lo:hi],
                               work.ovec_flat, work.shape3)
        i = lo // cfg.chunk
        zero = torch.zeros(pos0.shape[0], dtype=torch.int32, device=dev)
        fpts, _, fflag, nf, fq = propagate_lcm_dir(ckeys[2 * i], pos0, v0,
                                                   zero, *args)
        bpts, _, bflag, nb, _ = propagate_lcm_dir(ckeys[2 * i + 1], pos0,
                                                  -v0, nf, *args)
        # each direction's count: its npts less those it started from
        return fpts, nf, bpts, nb - nf, fq, fflag, bflag

    return _drive(launch, starts, cfg.len_min, Tract.from_ref(work.ref),
                  cfg.trk_sink, has_scalars=True, mode=mode, qscale=qscale)


# ------------------------------------------------------------------ #
# Microscopy cone-search mode
# ------------------------------------------------------------------ #

def _search_window(search_dist):
    """Window offsets and unit direction vectors for the cone search
    (reference: src/stream.jl:252-277).  Only in-ball offsets are kept.
    A copy of fibers_tpu/tract/modes.py:_search_window."""
    rx, ry, rz = search_dist
    xs = np.arange(-rx, rx + 1)
    ys = np.arange(-ry, ry + 1)
    zs = np.arange(-rz, rz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    off = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    rho = np.stack([gx / (rx + 0.5) if rx > 0 else gx * 0.0,
                    gy / (ry + 0.5) if ry > 0 else gy * 0.0,
                    gz / (rz + 0.5) if rz > 0 else gz * 0.0],
                   axis=-1).reshape(-1, 3)
    r = np.linalg.norm(rho, axis=1)
    keep = (r < 1) & (r > 0)
    dirs = np.zeros_like(rho)
    dirs[keep] = rho[keep] / r[keep, None]
    return off[keep].astype(np.int32), dirs[keep].astype(np.float32)


def _micro_search_dist(work):
    """Per-axis search distance: zero through-plane for 2-D angle
    inputs (host volumes of one frame); a device field holds 3-D
    vectors."""
    search_dist = [int(work.cfg.search_dist)] * 3
    ov0 = work.ovecs[0] if work.ovecs is not None else None
    if ov0 is not None and (ov0.vol.ndim == 3 or ov0.vol.shape[3] == 1):
        search_dist[int(np.argmax(ov0.volres))] = 0
    return search_dist


def _micro_wire(wire, cfg, nsub, step_size):
    """The micro mode's point wire: a quantized wire with deltas of one
    voxel (qscale = 1), exact because cone-search jumps land on integer
    voxels from integer seeds, when nsub == 0 and the largest jump per
    axis (search_dist + the tentative step) stays inside the delta range;
    otherwise float32 points, with a RuntimeWarning for an explicit
    i8/i6.  (fibers_tpu/tract/modes.py:419-438)"""
    mode, emit, qscale, dmax = wire
    if mode == "f32":
        return wire
    if nsub == 0 and int(cfg.search_dist) + int(np.ceil(step_size)) < dmax:
        return mode, emit, 1.0, dmax
    if cfg.wire in ("i8", "i6"):
        warnings.warn(
            f"stream_micro: wire={cfg.wire!r} cannot represent this "
            f"configuration (nsub={nsub}, search_dist={cfg.search_dist}, "
            f"step_size={step_size}); using exact f32 points instead",
            RuntimeWarning, stacklevel=4)
    return "f32", "points", qscale, dmax


def _reference_chunk(cfg, nwin):
    """The reference's micro chunk for a window of `nwin` cells
    (fibers_tpu/tract/modes.py:441): `cfg.chunk` shrunk W // 32 times to
    size the plain loop's [S, W, 3] window tensors."""
    return max(256, cfg.chunk // max(1, nwin // 32))


def _micro_chunk(cfg, nwin, device):
    """Streams a chunk of the micro mode on `device`: the kernel on the
    card builds no window tensor and takes `cfg.chunk`; the plain loop on
    the CPU takes the reference's rule (`_reference_chunk`).  Micro lines
    have no draws: they do not depend on the chunk."""
    if device.type == "cuda":
        return cfg.chunk
    return _reference_chunk(cfg, nwin)


def stream_micro(work, seed, wire):
    """Driver for microscopy cone-search tractography over a
    `StreamWork` (host orientation volumes or a device-resident field),
    with the point wire `wire` (mode, emit, qscale, dmax; `_micro_wire`
    adjusts it).  The span `stream.micro` holds the chunk loop; the
    counters `micro.launches` and `micro.window_cells` (W a launch) count
    the step-loop launches and the window cells each one scans a step.
    (reference: src/stream.jl:547-619)"""
    cfg = work.cfg
    dev = work.device
    win_off, win_dir = _search_window(_micro_search_dist(work))

    seed_idx = _seed_voxels(work.mask_array, seed)
    if work.nsub > 0:
        subs = uniform(prng_key(cfg.seed_rng), (work.nsub, 3),
                       -0.5 + 1e-6, 0.5 - 1e-6)
    else:
        subs = np.zeros((1, 3), np.float32)
    seeds_all = np.repeat(seed_idx.astype(np.float32), len(subs), axis=0)
    subs_all = np.tile(subs, (len(seed_idx), 1))

    mask_flat = work.mask_flat()
    vec_first = work.ovec_flat[:, 0, :].contiguous()
    nsteps = int(work.len_max) + 2
    mode, emit, qscale, dmax = _micro_wire(wire, cfg, work.nsub,
                                           work.step_size)
    args = (mask_flat, vec_first,
            torch.from_numpy(win_off.astype(np.int64)).to(dev),
            torch.from_numpy(win_dir).to(dev), nsteps, work.shape3,
            float(work.step_size), float(np.cos(np.radians(work.ang_thresh))),
            float(np.cos(np.radians(cfg.search_ang))),
            float(work.smooth_coeff), int(work.len_max), emit, qscale, dmax)

    chunk = _micro_chunk(cfg, len(win_off), dev)

    def launch(lo):
        hi = min(lo + chunk, len(seeds_all))
        pos0, v0 = _seed_state(seeds_all[lo:hi], subs_all[lo:hi],
                               work.ovec_flat, work.shape3)
        zero = torch.zeros(pos0.shape[0], dtype=torch.int32, device=dev)
        fpts, _, nf, fq = propagate_micro_dir(pos0, v0, zero, *args)
        bpts, _, nb, _ = propagate_micro_dir(pos0, -v0, nf, *args)
        count("micro.launches", 2)
        count("micro.window_cells", 2 * len(win_off))
        # each direction's count: its npts less those it started from
        return fpts, nf, bpts, nb - nf, fq

    starts = list(range(0, len(seeds_all), chunk))
    with span("stream.micro"):
        return _drive(launch, starts, cfg.len_min, Tract.from_ref(work.ref),
                      cfg.trk_sink, mode=mode, qscale=qscale)
