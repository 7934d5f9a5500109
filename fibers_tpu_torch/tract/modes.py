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
direction) seeds an explicit `torch.Generator` on the stream's device
with the 64 bits of its key and draws Gumbel-max samples from it, so LCM
lines match the reference in distribution (the reference itself draws
from Julia's global RNG).  Each saved point carries one scalar, the
method-difference flag.

Micro: exact float32 points only (the reference's integer point wire is
ROADMAP A14); jumps land on integer voxels, so the lines equal the
reference's exactly.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..io.trk import Tract
from ..utils.prng import prng_key, split, uniform
from .stream import (_drive, _flat_index, _pick_by_angle, _seed_state,
                     _seed_voxels, _smooth_dir)

__all__ = ["stream_lcm", "stream_micro"]


# Voxel edges connected by the i-th element of a vectorized LCM
# (reference: src/stream.jl:234-235); 0-based edge ids 0..3
EDGETYPE = np.array([[0, 0, 0, 0, 1, 1, 1, 2, 2, 3],
                     [0, 1, 2, 3, 1, 2, 3, 2, 3, 3]], np.int32)


def _take(x, i):
    """x [S, n, ...] at per-row index i [S] -> [S, ...]."""
    idx = i.view(-1, *([1] * (x.dim() - 1))).expand(-1, 1, *x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


# ------------------------------------------------------------------ #
# LCM probabilistic mode
# ------------------------------------------------------------------ #

def _propagate_lcm(gen, pos0, vec0, npts0, mask_flat, ovecs_flat, lcms_flat,
                   dxyz, strdims, nsteps, shape3, step_size, smooth_coeff,
                   len_max):
    """One direction of LCM-guided propagation for S streams.

    Carries the previously chosen vector index (the reference continues
    along it while not entering a new voxel, src/stream.jl:399-411).
    `dxyz` [3, 4] holds the in-plane increments of the four voxel edges,
    `strdims` the two in-plane dimensions.  Returns (out [nsteps, S, 3]
    positions, saved [nsteps, S], flags [nsteps, S] int8
    method-difference flags, npts [S])."""
    dev = pos0.device
    s = pos0.shape[0]
    edget = torch.from_numpy(EDGETYPE.astype(np.int64)).to(dev)
    jumps = dxyz.T.to(torch.float32)                     # [4, 3]
    a, b = strdims
    ninf = torch.tensor(-torch.inf, device=dev)
    tiny = torch.finfo(torch.float32).tiny

    outs = torch.empty((nsteps, s, 3), dtype=torch.float32, device=dev)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    flags = torch.empty((nsteps, s), dtype=torch.int8, device=dev)
    pos, vec, npts = pos0, vec0, npts0
    ivec_prev = torch.zeros(s, dtype=torch.int64, device=dev)
    active = torch.ones(s, dtype=torch.bool, device=dev)
    for t in range(nsteps):
        pos_next = pos + vec * step_size
        ipos_next = torch.round(pos_next).to(torch.int64)
        ipos_now = torch.round(pos).to(torch.int64)
        flat, inb = _flat_index(ipos_next, shape3)
        inmask = mask_flat[flat] & inb
        vecs = ovecs_flat[flat]                          # [S, nvec, 3]

        # conventional angle pick, for the difference indicator
        _, ok_ang, ivec_ang = _pick_by_angle(vec, vecs)

        dvox = ipos_now - ipos_next                      # [S, 3]
        same_vox = (dvox == 0).all(dim=1)

        # not entering a new voxel: continue along the previous index
        v_prev = _take(vecs, ivec_prev)
        cos_prev = (vec * v_prev).sum(dim=1)
        v_same = torch.where((cos_prev > 0)[:, None], v_prev, -v_prev)

        # entering a new voxel: sample the LCM.  A diagonal jump keeps
        # only its slower-changing in-plane dim (src/stream.jl:422-437).
        d1 = (pos - pos_next).abs()
        faster_b = d1[:, a] < d1[:, b]
        is_diag = (dvox[:, a] != 0) & (dvox[:, b] != 0)
        dvox = dvox.clone()
        dvox[:, b] = torch.where(is_diag & faster_b, 0, dvox[:, b])
        dvox[:, a] = torch.where(is_diag & ~faster_b, 0, dvox[:, a])

        edge_match = (dvox[:, :, None] == dxyz[None, :, :]).all(dim=1)
        entry = torch.argmax(edge_match.to(torch.int32), dim=1)
        # no matching edge (through-plane or >1-voxel jump): the reference
        # leaves the entry edge unset, which zeroes every LCM element and
        # stops the stream (src/stream.jl:414-446, 488-494)
        matched = edge_match.any(dim=1)

        lcm = lcms_flat[flat]                            # [S, 10]
        has_entry = ((edget[0][None, :] == entry[:, None])
                     | (edget[1][None, :] == entry[:, None]))
        lcm = torch.where(has_entry & matched[:, None], lcm,
                          torch.zeros((), device=dev))
        havelcm = lcm.sum(dim=1) > 0
        logits = torch.log(torch.clamp_min(lcm, 1e-30))
        u = torch.rand(lcm.shape, generator=gen, device=dev)
        gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
        ilcm = torch.argmax(logits + gumbel, dim=1)

        e0, e1 = edget[0][ilcm], edget[1][ilcm]
        exit_edge = torch.where(e0 == entry, e1, e0)
        jumpvec = jumps[exit_edge]                       # [S, 3]

        # the vector best aligned with the jump toward the exit edge
        cos_j = (vecs * jumpvec[:, None, :]).sum(dim=2)
        iszero = (vecs == 0).all(dim=2)
        cabs = torch.where(iszero, ninf, cos_j.abs())
        cos_j = torch.where(iszero, ninf, cos_j)
        ivec_new = torch.argmax(cabs, dim=1)
        cbest = _take(cos_j, ivec_new)
        vbest = _take(vecs, ivec_new)
        v_new = torch.where((cbest > 0)[:, None], vbest, -vbest)
        ok_new = torch.isfinite(cbest) & havelcm

        vnext = torch.where(same_vox[:, None], v_same, v_new)
        ivec_next = torch.where(same_vox, ivec_prev, ivec_new)
        save = active & inb & inmask & (same_vox | ok_new) & ok_ang

        npts = npts + save.to(npts.dtype)
        outs[t] = pos
        saved[t] = save
        # method-difference flag, in both branches (src/stream.jl:530-536)
        flags[t] = ((ivec_next != ivec_ang) & save).to(torch.int8)

        # no angle threshold in LCM mode (src/stream.jl:668-671)
        cont = save & (npts <= len_max)
        pos = torch.where(cont[:, None], pos_next, pos)
        vec = torch.where(cont[:, None], _smooth_dir(vec, vnext,
                                                     smooth_coeff), vec)
        ivec_prev = ivec_next
        active = cont
    return outs, saved, flags, npts


def _key_seed(key) -> int:
    """The 64 bits of a threefry key pair, as a torch.Generator seed."""
    return (int(key[0]) << 32) | int(key[1])


def stream_lcm(work, seed, lcms):
    """Driver for probabilistic LCM tractography over a `StreamWork` of
    host orientation volumes.  (reference: src/stream.jl:199-244,
    380-495)"""
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

    mask_flat = torch.from_numpy(work.mask_array.reshape(-1)).to(dev)
    lcms_flat = torch.from_numpy(
        lcm_vol.reshape(-1, lcm_vol.shape[3])).to(dev)
    dxyz_t = torch.from_numpy(dxyz).to(dev)
    nsteps = int(work.len_max) + 2
    args = (mask_flat, work.ovec_flat, lcms_flat, dxyz_t, strdims, nsteps,
            work.shape3, float(work.step_size), float(work.smooth_coeff),
            int(work.len_max))

    starts = list(range(0, len(seeds_all), cfg.chunk))
    # per-chunk keys, fixed up front as in the reference
    ckeys = split(key, 2 * max(len(starts), 1))

    def launch(lo):
        hi = min(lo + cfg.chunk, len(seeds_all))
        pos0, v0 = _seed_state(seeds_all[lo:hi], subs_all[lo:hi],
                               work.ovec_flat, work.shape3)
        i = lo // cfg.chunk
        gf = torch.Generator(device=dev).manual_seed(_key_seed(ckeys[2 * i]))
        gb = torch.Generator(device=dev).manual_seed(
            _key_seed(ckeys[2 * i + 1]))
        zero = torch.zeros(pos0.shape[0], dtype=torch.int32, device=dev)
        fpts, fsav, fflag, nf = _propagate_lcm(gf, pos0, v0, zero, *args)
        bpts, bsav, bflag, _ = _propagate_lcm(gb, pos0, -v0, nf, *args)
        return (fpts, fsav.sum(dim=0, dtype=torch.int32),
                bpts, bsav.sum(dim=0, dtype=torch.int32), fflag, bflag)

    return _drive(launch, starts, cfg.len_min, Tract.from_ref(work.ovecs[0]),
                  cfg.trk_sink, has_scalars=True)


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
    inputs."""
    search_dist = [int(work.cfg.search_dist)] * 3
    ov0 = work.ovecs[0]
    if ov0.vol.ndim == 3 or ov0.vol.shape[3] == 1:
        search_dist[int(np.argmax(ov0.volres))] = 0
    return search_dist


def _propagate_micro(pos0, vec0, npts0, mask_flat, vec_first, win_off,
                     win_dir, nsteps, shape3, step_size, cosang_thresh,
                     search_cosang, smooth_coeff, len_max):
    """One direction of cone-search propagation for S streams: each step
    looks at the window [S, W] around the tentative voxel and jumps to the
    in-mask, in-cone voxel whose first vector is best aligned.
    `vec_first` is the [nxyz, 3] first orientation vector per voxel.
    Returns (out [nsteps, S, 3], saved [nsteps, S], npts [S])."""
    dev = pos0.device
    s = pos0.shape[0]
    ninf = torch.tensor(-torch.inf, device=dev)
    outs = torch.empty((nsteps, s, 3), dtype=torch.float32, device=dev)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    pos, vec, npts = pos0, vec0, npts0
    active = torch.ones(s, dtype=torch.bool, device=dev)
    for t in range(nsteps):
        pos_next = pos + vec * step_size
        ipos = torch.round(pos_next).to(torch.int64)
        flat, inb = _flat_index(ipos, shape3)
        inmask = mask_flat[flat] & inb

        # the search window around the tentative voxel
        wpos = ipos[:, None, :] + win_off[None, :, :]    # [S, W, 3]
        wflat, winb = _flat_index(wpos, shape3)
        wmask = mask_flat[wflat] & winb

        # in the search cone around the current direction?
        conedot = (vec[:, None, :] * win_dir[None, :, :]).sum(dim=2)
        incone = wmask & (conedot > search_cosang)

        wvec = vec_first[wflat]                          # [S, W, 3]
        cosang = (vec[:, None, :] * wvec).sum(dim=2)
        cosang = torch.where(incone, cosang, ninf)
        cabs = torch.where(torch.isfinite(cosang), cosang.abs(), ninf)

        iwin = torch.argmax(cabs, dim=1)
        cbest = _take(cosang, iwin)
        save = active & inb & inmask & torch.isfinite(cbest)
        next_vox = _take(wpos, iwin)
        vbest = _take(wvec, iwin)
        vnext = torch.where((cbest > 0)[:, None], vbest, -vbest)

        npts = npts + save.to(npts.dtype)
        outs[t] = pos
        saved[t] = save

        cosadv = (vec * vnext).sum(dim=1)
        cont = save & (cosadv >= cosang_thresh) & (npts <= len_max)
        pos = torch.where(cont[:, None], next_vox.to(torch.float32), pos)
        vec = torch.where(cont[:, None], _smooth_dir(vec, vnext,
                                                     smooth_coeff), vec)
        active = cont
    return outs, saved, npts


def stream_micro(work, seed):
    """Driver for microscopy cone-search tractography over a
    `StreamWork` of host orientation volumes.
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

    mask_flat = torch.from_numpy(work.mask_array.reshape(-1)).to(dev)
    vec_first = work.ovec_flat[:, 0, :].contiguous()
    nsteps = int(work.len_max) + 2
    args = (mask_flat, vec_first,
            torch.from_numpy(win_off.astype(np.int64)).to(dev),
            torch.from_numpy(win_dir).to(dev), nsteps, work.shape3,
            float(work.step_size), float(np.cos(np.radians(work.ang_thresh))),
            float(np.cos(np.radians(cfg.search_ang))),
            float(work.smooth_coeff), int(work.len_max))

    # the windowed gather is W times heavier; shrink the chunk
    chunk = max(256, cfg.chunk // max(1, len(win_off) // 32))

    def launch(lo):
        hi = min(lo + chunk, len(seeds_all))
        pos0, v0 = _seed_state(seeds_all[lo:hi], subs_all[lo:hi],
                               work.ovec_flat, work.shape3)
        zero = torch.zeros(pos0.shape[0], dtype=torch.int32, device=dev)
        fpts, fsav, nf = _propagate_micro(pos0, v0, zero, *args)
        bpts, bsav, _ = _propagate_micro(pos0, -v0, nf, *args)
        return (fpts, fsav.sum(dim=0, dtype=torch.int32),
                bpts, bsav.sum(dim=0, dtype=torch.int32))

    starts = list(range(0, len(seeds_all), chunk))
    return _drive(launch, starts, cfg.len_min, Tract.from_ref(work.ovecs[0]),
                  cfg.trk_sink)
