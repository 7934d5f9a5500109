"""Plain reference of deterministic streamline tractography, and a reader
of the TrackVis files it is compared with.

The tracking follows Fibers.jl (src/stream.jl:340-374, 625-686, 730-790):
each seed voxel is seeded `nsub` times at the same sub-voxel offsets
(drawn once from `seed_rng`, as `jax.random.uniform` draws them); a
stream steps `step` voxels along its direction, takes the voxel of the
rounded new position, picks the orientation there with the largest
|cos| to its direction (sign-flipped to align), saves its current point
when the new voxel is in the volume and has an orientation, stops once
the turn exceeds `ang` degrees or the line holds `len_max` points, and
smooths its direction as an EMA (`smooth`).  Both directions share one
length budget: the backward run starts from the forward count.  A line
is the reversed forward points, then the backward ones, and is kept
when it has `len_min` points or more.

The tracking here runs from an orientation field it is given (the
field's voxels outside the tracking mask are zero).  `dtype` float32 is
the reference; bfloat16 is the control.  Each step is a batch of torch
operations over a chunk of streams, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .prng import prng_key, uniform

__all__ = ["jitter", "track", "read_trk", "to_mm", "compare_lines"]


def jitter(nsub, seed_rng=0):
    """[nsub, 3] float32 sub-voxel offsets."""
    return uniform(prng_key(seed_rng), (nsub, 3), -0.5 + 1e-6, 0.5 - 1e-6)


def _steps(pos, vec, npts, field, shape3, nsteps, step, cosang, smooth,
           len_max):
    """One direction: (points [nsteps, S, 3], saved [nsteps, S], npts,
    visited flat voxel indices)."""
    nx, ny, nz = shape3
    active = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    pts = torch.empty((nsteps,) + tuple(pos.shape), dtype=pos.dtype,
                      device=pos.device)
    saved = torch.empty((nsteps, pos.shape[0]), dtype=torch.bool,
                        device=pos.device)
    seen = []
    for t in range(nsteps):
        nxt = pos + vec * step
        i = torch.round(nxt).to(torch.int64)
        ix, iy, iz = i.unbind(-1)
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
               & (iz < nz))
        flat = torch.where(inb, (ix * ny + iy) * nz + iz, 0)
        seen.append(flat[active])
        cand = field[flat]                                  # [S, nvec, 3]
        cos = (cand * vec[:, None, :]).sum(dim=2)
        empty = (cand == 0).all(dim=2)
        cos = torch.where(empty, -torch.inf, cos)
        pick = torch.argmax(torch.where(empty, -torch.inf, cos.abs()), 1)
        c = torch.gather(cos, 1, pick[:, None])[:, 0]
        v = torch.gather(cand, 1, pick[:, None, None].expand(-1, 1, 3))[:, 0]
        vnext = torch.where((c > 0)[:, None], v, -v)
        save = active & inb & torch.isfinite(c)
        npts = npts + save.to(npts.dtype)
        pts[t] = pos
        saved[t] = save
        go = save & ((vec * vnext).sum(dim=1) >= cosang) & (npts <= len_max)
        if smooth != 0.0:
            sm = smooth * vec + (1.0 - smooth) * vnext
            sm = sm / torch.clamp_min(
                torch.sqrt((sm * sm).sum(dim=1, keepdim=True)), 1e-20)
        else:
            sm = vnext
        pos = torch.where(go[:, None], nxt, pos)
        vec = torch.where(go[:, None], sm, vec)
        active = go
    return pts, saved, npts, torch.cat(seen)


def track(field, shape3, seed_vol, nsub=3, step=0.5, ang=45.0,
          smooth=0.2, len_min=3, len_max=None, seed_rng=0, chunk=1 << 17,
          dtype=torch.float32):
    """Every line from the seeds of `seed_vol` (host [X, Y, Z], > 0 marks
    a seed voxel) through `field` [X*Y*Z, nvec, 3] (float32, on the
    device to track on).  Returns (points [P, 3] in voxels, npts [L]
    int64, counts): `counts` holds `streams`, `points` (saved by every
    stream, kept or not) and `visited` (the distinct voxels each chunk of
    `chunk` streams reads, summed over the chunks)."""
    dev = field.device
    len_max = int(max(shape3)) if len_max is None else int(len_max)
    nsteps = len_max + 2
    cosang = float(np.float32(np.cos(np.radians(ang))))
    seeds = np.argwhere(seed_vol > 0).astype(np.float32)
    subs = jitter(nsub, seed_rng)
    start = (np.repeat(seeds, nsub, axis=0)
             + np.tile(subs, (len(seeds), 1))).astype(np.float32)
    f = field.to(dtype)
    nx, ny, nz = shape3
    pts, counts, visited, saved = [], [], 0, 0
    for lo in range(0, len(start), chunk):
        p0 = torch.from_numpy(start[lo:lo + chunk]).to(dev)
        i = torch.round(p0).to(torch.int64)
        v0 = f[(i[:, 0] * ny + i[:, 1]) * nz + i[:, 2], 0]
        p0 = p0.to(dtype)
        zero = torch.zeros(len(p0), dtype=torch.int32, device=dev)
        args = (f, shape3, nsteps, step, cosang, smooth, len_max)
        fo, fs, fn, seen_f = _steps(p0, v0, zero, *args)
        bo, bs, bn, seen_b = _steps(p0, -v0, fn, *args)
        visited += int(torch.unique(torch.cat([seen_f, seen_b])).numel())
        saved += int(fs.sum()) + int(bs.sum())
        keep = bn >= len_min
        # a line: the forward points reversed, then the backward points
        both = torch.cat([fo.flip(0), bo], dim=0)          # [2T, S, 3]
        sv = torch.cat([fs.flip(0), bs], dim=0)
        sv = sv & keep[None, :]
        sel = sv.T                                          # [S, 2T]
        pts.append(both.transpose(0, 1)[sel].float())
        counts.append(sel.sum(1)[keep].cpu())
    return (torch.cat(pts), torch.cat(counts).to(torch.int64),
            dict(streams=len(start), points=saved, visited=visited))


def to_mm(pts, voxel_mm):
    """Voxel coordinates to TrackVis millimetres, (v + 0.5) * voxel size,
    in float32."""
    return (pts.float() + 0.5) * torch.tensor(
        np.asarray(voxel_mm, np.float32), device=pts.device)


def read_trk(path, nscalars=0):
    """(points [P, 3] float32 mm, npts [L] int64, header count) of a
    TrackVis file: a 1000-byte header, then per line an int32 count and
    its points."""
    with open(path, "rb") as fh:
        head = fh.read(1000)
        body = np.fromfile(fh, dtype="<i4")
    count = int(np.frombuffer(head, "<i4", 1, 988)[0])
    width = 3 + nscalars
    offs = np.empty(count, np.int64)
    pos = 0
    for k in range(count):
        offs[k] = pos
        pos += 1 + width * int(body[pos])
    if pos != len(body):
        raise ValueError(f"{path}: {len(body) - pos} words past its "
                         f"{count} lines")
    npts = body[offs].astype(np.int64)
    is_count = np.zeros(len(body), bool)
    is_count[offs] = True
    pts = body[~is_count].view("<f4").reshape(-1, width)[:, :3]
    return pts, npts, count


def compare_lines(pts_a, npts_a, pts_b, npts_b, tol):
    """Share of the lines of b that a does not reproduce: a line differs
    when its point count does, or a point lies farther than `tol` (in
    any coordinate).  Lines pair by their order; when the numbers of
    lines differ they cannot be paired, and the share is 1."""
    if len(npts_a) != len(npts_b):
        return 1.0
    if len(npts_b) == 0:
        return 0.0
    dev = pts_b.device
    na = torch.as_tensor(np.asarray(npts_a), device=dev)
    nb = torch.as_tensor(np.asarray(npts_b), device=dev)
    off_a, off_b = torch.cumsum(na, 0) - na, torch.cumsum(nb, 0) - nb
    same = na == nb
    n = nb[same]
    line = torch.repeat_interleave(
        torch.arange(len(nb), device=dev)[same], n)
    within = torch.arange(int(n.sum()), device=dev) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    pa = torch.as_tensor(pts_a, device=dev)
    gap = (pa[off_a[line] + within].float()
           - pts_b[off_b[line] + within].float()).abs().amax(1)
    worst = torch.zeros(len(nb), device=dev).scatter_reduce(
        0, line, gap, "amax", include_self=True)
    return float((~same | ~(worst <= tol)).float().mean())
