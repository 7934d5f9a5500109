"""Plain reference of microscopy cone-search tractography (Fibers.jl
src/stream.jl:547-619, the regime of src/stream.jl:83-92).

A stream at position p heading v takes the tentative voxel round(p + v
step) (halves to even).  It stops there when that voxel lies outside the
volume or the mask.  Otherwise it looks at every cell of the search
window around that voxel: the offsets o of the ball |o / (d + 1/2)| < 1
(o = 0 left out), d the search distance, in C order of (ox, oy, oz),
each with the unit direction o / (d + 1/2) normalised.  A cell counts
when it lies in the volume and the mask and its direction is inside the
search cone (cos to v > cos(search_ang)); among those the stream jumps
to the one whose orientation has the largest |cos| to v (the first on
ties), flipped to align with v.  Its current point is saved when the
jump exists; the stream stops after a jump whose turn exceeds `ang`
degrees, when no cell counts, or once its line holds more than
`len_max` points.  A line: the forward points reversed, then the
backward ones (which start from the forward count's budget), kept with
`len_min` points or more.  No smoothing, integer seeds (nsub 0).

Every step here is a batch of torch operations over the whole [S, W, 3]
window of the streams still running (no tiling, no kernel); finished
streams drop out of the batch.  `dtype` float32 is the reference;
bfloat16 (the field rounded to it, every product and comparison in it)
is the control.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["window", "track", "line_index"]


def window(search_dist):
    """(offsets [W, 3] int64, unit directions [W, 3] float64) of the
    search window of `search_dist` voxels on each axis."""
    d = int(search_dist)
    r = np.arange(-d, d + 1)
    off = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    rel = off / (d + 0.5)
    norm = np.sqrt((rel * rel).sum(1))
    keep = (norm > 0) & (norm < 1)
    return off[keep].astype(np.int64), rel[keep] / norm[keep, None]


def _direction(pos, vec, steps, budget, field, mask, shape3, off, wdir,
               step, cos_turn, cos_cone, len_max):
    """One direction of every stream from the whole voxels `pos` [S, 3]
    (int64) heading `vec`, with `budget` [S] points already on their
    lines: (points [P, 3] int64 voxels, their stream [P], their step [P],
    each stream's point count at the end, the budget's included)."""
    dev = field.device
    nx, ny, nz = shape3
    dims = torch.tensor([nx, ny, nz], device=dev)
    strides = torch.tensor([ny * nz, nz, 1], device=dev)
    live = torch.arange(pos.shape[0], device=dev)
    npts = budget.clone()
    pts, who, when = [], [], []
    for t in range(steps):
        if live.numel() == 0:
            break
        p, v = pos[live], vec[live]
        # positions are whole voxels: the step's sum in float32 (exact for
        # a whole voxel), whatever the dtype of the directions
        tent = torch.round(p.float() + v.float() * step).to(torch.int64)
        ok = ((tent >= 0) & (tent < dims)).all(1)
        ok &= mask[(torch.where(ok[:, None], tent, 0) * strides).sum(1)]
        cells = tent[:, None, :] + off[None]                # [S, W, 3]
        inside = ((cells >= 0) & (cells < dims)).all(2)
        flat = (torch.where(inside[..., None], cells, 0) * strides).sum(2)
        cone = (v[:, None, :] * wdir[None]).sum(2) > cos_cone
        counts = inside & mask[flat] & cone
        cand = field[flat]                                  # [S, W, 3]
        cos = (v[:, None, :] * cand).sum(2)
        cos = torch.where(counts, cos, -torch.inf)
        score = torch.where(torch.isfinite(cos), cos.abs(), -torch.inf)
        best = torch.argmax(score, 1)
        c = cos.gather(1, best[:, None])[:, 0]
        jump = ok & torch.isfinite(c)
        # the current point is saved when the jump exists
        pts.append(p[jump])
        who.append(live[jump])
        when.append(torch.full((int(jump.sum()),), t, device=dev))
        npts[live] += jump.to(npts.dtype)
        vb = cand[torch.arange(len(live), device=dev), best]
        vn = torch.where((c > 0)[:, None], vb, -vb)
        go = jump & ((v * vn).sum(1) >= cos_turn) & (npts[live] <= len_max)
        moved = live[go]
        pos[moved] = cells[torch.arange(len(live), device=dev), best][go]
        vec[moved] = vn[go]
        live = moved
    return torch.cat(pts), torch.cat(who), torch.cat(when), npts


def track(field, mask, shape3, seeds, search_dist=15, search_ang=10.0,
          ang=20.0, step=1.0, len_min=3, len_max=None, max_steps=None,
          chunk=4096, dtype=torch.float32):
    """Lines from the integer seed voxels `seeds` [S, 3] (host) through the
    first orientation of `field` [X*Y*Z, 3] (float32, zero outside the
    mask) and the flat `mask` [X*Y*Z] bool, both on the device to track
    on.  Returns (points [P, 3] int64 voxels, npts [L] int64 of the kept
    lines, kept [S] bool), lines in seed order.  `max_steps` (default
    len_max + 2) caps the steps of each direction: with len_min steps
    the counts tell which seeds are kept (no line reaches len_min points
    in fewer steps), not the whole lines."""
    dev = field.device
    len_max = int(max(shape3)) if len_max is None else int(len_max)
    steps = len_max + 2 if max_steps is None else int(max_steps)
    off, wdir = window(search_dist)
    off = torch.from_numpy(off).to(dev)
    wdir = torch.from_numpy(wdir).to(dev, torch.float32).to(dtype)
    f = field.to(dtype)
    cos_turn = float(np.float32(np.cos(np.radians(ang))))
    cos_cone = float(np.float32(np.cos(np.radians(search_ang))))
    ny, nz = shape3[1], shape3[2]
    args = (f, mask, shape3, off, wdir, step, cos_turn, cos_cone, len_max)
    pts, npts, kept = [], [], []
    for lo in range(0, len(seeds), chunk):
        s = torch.from_numpy(np.asarray(seeds[lo:lo + chunk], np.int64)) \
            .to(dev)
        v0 = f[(s[:, 0] * ny + s[:, 1]) * nz + s[:, 2]]
        zero = torch.zeros(len(s), dtype=torch.int32, device=dev)
        fp, fw, ft, nf = _direction(s.clone(), v0.clone(), steps, zero,
                                    *args)
        bp, bw, bt, total = _direction(s.clone(), -v0, steps, nf, *args)
        keep = total >= len_min
        # each stream's forward points by descending step, then its
        # backward points by ascending step
        span = 2 * steps + 1
        key = torch.cat([fw * span + (steps - 1 - ft),
                         bw * span + steps + bt])
        mine = keep[torch.cat([fw, bw])]
        order = torch.argsort(key[mine])
        pts.append(torch.cat([fp, bp])[mine][order])
        npts.append(total[keep].to(torch.int64))
        kept.append(keep)
    return torch.cat(pts), torch.cat(npts).cpu(), torch.cat(kept).cpu()


def line_index(kept):
    """For each seed, the index of its line among the kept ones (the
    count of kept seeds before it)."""
    k = torch.as_tensor(kept).to(torch.int64)
    return torch.cumsum(k, 0) - k
