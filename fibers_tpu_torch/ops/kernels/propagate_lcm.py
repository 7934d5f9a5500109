"""One direction of the LCM-guided (probabilistic) integrator: the
hand-written CUDA kernel and its plain PyTorch version.

Counterpart of `fibers_tpu/tract/modes.py:_propagate_lcm`, the jitted
`lax.scan` over the LCM step (XLA, not Pallas; the reference's
`stream_pick_by_lcm!`, src/stream.jl:380-495).  All S streams of a chunk
advance `nsteps` steps: while a stream stays in its voxel it continues
along the vector it chose last; entering a new voxel it draws the exit
edge from the voxel's local connection matrix (LCM) by Gumbel-max and
takes the vector best aligned with the jump to that edge.  The kernel is
`fibers_tpu_torch/csrc/propagate_lcm.cu`: a thread a stream in
persistent blocks that keep their threads busy as streams stop, the draw
computed only where and as far as it can matter, so a direction is one
launch (after a small one that tables what each step reads of the LCM
rows) where the plain loop makes a few hundred a step.

The draws are counter-based, so that both versions compute the same
numbers: the uniform of element j of stream i of the chunk at step t is a
word of Philox4x32-10 (Salmon et al., SC'11) keyed by the direction's
64-bit key, counter (i, t, j // 4, 0), word j % 4; its top 24 bits times
2^-24, clamped at the smallest normal float (`lcm_uniforms`).  The plain
version computes Philox in torch int64 operations, each 32 x 32-bit
product split into 16-bit halves so that nothing overflows.  The
reference draws from `jax.random.categorical`, so the lines match it in
distribution (ROADMAP C8).

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
`propagate_lcm_dir_plain`.  On the card the kernel equals the plain loop
bit for bit; `lcm_selfcheck` holds its logf, its sum of ten, its argmax
and its uniforms to torch's.
"""

from __future__ import annotations

import numpy as np
import torch

from .propagate import (_INT32_MAX, _check_array, _check_step_loop,
                        _flat_index, _index_bits, _pick_by_angle,
                        _quantize_step, _smooth_dir, _take)

__all__ = ["EDGETYPE", "lcm_uniforms", "philox4x32_10", "propagate_lcm_dir",
           "propagate_lcm_dir_plain", "lcm_selfcheck"]

# Voxel edges connected by the i-th element of a vectorized LCM
# (reference: src/stream.jl:234-235); 0-based edge ids 0..3
EDGETYPE = np.array([[0, 0, 0, 0, 1, 1, 1, 2, 2, 3],
                     [0, 1, 2, 3, 1, 2, 3, 2, 3, 3]], np.int32)

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m):
    """(high, low) 32-bit words of a * m for int64 tensors a in [0, 2^32)
    and a Python int m < 2^32, without overflowing int64: a's 16-bit
    halves times m are each below 2^48."""
    x = (a & 0xFFFF) * m
    y = (a >> 16) * m
    z = ((y & 0xFFFF) << 16) + x
    return (y >> 16) + (z >> 32), z & _M32


def philox4x32_10(c0, c1, c2, c3, key):
    """Philox4x32-10 on counter words c0..c3 (int64 tensors in [0, 2^32),
    broadcast together) under the key (k0, k1) of two Python ints: the four
    output words, int64 in [0, 2^32)."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def lcm_uniforms(key, s, t, device="cpu"):
    """The [s, 10] float32 uniforms of streams 0..s-1 at step t under
    `key`, as the kernel draws them (module docstring)."""
    i = torch.arange(s, dtype=torch.int64, device=device)[:, None]
    blk = torch.arange(3, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10(i, zero + t, blk, zero, key)
    w = torch.stack(torch.broadcast_tensors(*words), dim=2).reshape(s, 12)
    u = (w[:, :10] >> 8).to(torch.float32) * 2.0 ** -24
    return torch.clamp_min(u, torch.finfo(torch.float32).tiny)


def propagate_lcm_dir_plain(key, pos0, vec0, npts0, mask_flat, ovecs_flat,
                            lcms_flat, dxyz, edget, strdims, nsteps, shape3,
                            step_size, smooth_coeff, len_max, emit="points",
                            qscale=254.0, dmax=127):
    """Plain PyTorch version of `propagate_lcm_dir`: a Python loop over
    the steps, each a batch of torch operations.  Same arguments and
    results."""
    dev = pos0.device
    s = pos0.shape[0]
    jumps = dxyz.T.to(torch.float32)                     # [4, 3]
    a, b = strdims

    deltas = emit == "deltas"
    outs = torch.empty((nsteps, s, 3), device=dev,
                       dtype=torch.int8 if deltas else torch.float32)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    flags = torch.empty((nsteps, s), dtype=torch.int8, device=dev)
    pos, vec, npts, pos_q = pos0, vec0, npts0, pos0
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
        lcm = torch.where(has_entry & matched[:, None], lcm, 0.0)
        havelcm = lcm.sum(dim=1) > 0
        logits = torch.log(torch.clamp_min(lcm, 1e-30))
        gumbel = -torch.log(-torch.log(lcm_uniforms(key, s, t, dev)))
        ilcm = torch.argmax(logits + gumbel, dim=1)

        e0, e1 = edget[0][ilcm], edget[1][ilcm]
        exit_edge = torch.where(e0 == entry, e1, e0)
        jumpvec = jumps[exit_edge]                       # [S, 3]

        # the vector best aligned with the jump toward the exit edge
        cos_j = (vecs * jumpvec[:, None, :]).sum(dim=2)
        iszero = (vecs == 0).all(dim=2)
        cabs = torch.where(iszero, -torch.inf, cos_j.abs())
        cos_j = torch.where(iszero, -torch.inf, cos_j)
        ivec_new = torch.argmax(cabs, dim=1)
        cbest = _take(cos_j, ivec_new)
        vbest = _take(vecs, ivec_new)
        v_new = torch.where((cbest > 0)[:, None], vbest, -vbest)
        ok_new = torch.isfinite(cbest) & havelcm

        vnext = torch.where(same_vox[:, None], v_same, v_new)
        ivec_next = torch.where(same_vox, ivec_prev, ivec_new)
        save = active & inb & inmask & (same_vox | ok_new) & ok_ang

        npts = npts + save.to(npts.dtype)
        if deltas:
            outs[t], pos_q = _quantize_step(pos, pos_q, save, qscale, dmax)
        else:
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
    return outs, saved, flags, npts, pos_q


def _check(pos0, vec0, npts0, mask_flat, ovecs_flat, lcms_flat, dxyz, edget,
           strdims, nsteps, shape3, emit, dmax):
    name = "propagate_lcm_dir"
    _check_step_loop(name, pos0, vec0, npts0, nsteps, emit, dmax,
                     mask_flat=mask_flat, ovecs_flat=ovecs_flat,
                     lcms_flat=lcms_flat, dxyz=dxyz, edget=edget)
    nxyz = int(np.prod(shape3))
    _check_array(name, "mask_flat", mask_flat, (nxyz,), torch.bool)
    _check_array(name, "ovecs_flat", ovecs_flat, (nxyz, None, 3),
                 torch.float32)
    _check_array(name, "lcms_flat", lcms_flat, (nxyz, 10), torch.float32)
    _check_array(name, "dxyz", dxyz, (3, 4), torch.int64)
    _check_array(name, "edget", edget, (2, 10), torch.int64)
    a, b = strdims
    if {int(a), int(b)} - {0, 1, 2} or a == b:
        raise ValueError(f"{name}: strdims must be two distinct dims of "
                         f"0..2, got {strdims}")


def propagate_lcm_dir(key, pos0, vec0, npts0, mask_flat, ovecs_flat,
                      lcms_flat, dxyz, edget, strdims, nsteps, shape3,
                      step_size, smooth_coeff, len_max, emit="points",
                      qscale=254.0, dmax=127):
    """Lockstep LCM-guided propagation of one direction for the S streams
    at pos0 [S, 3] f32, heading vec0 [S, 3] f32, with npts0 [S] int32
    points already on their lines, through the volume `shape3`: mask_flat
    [nx*ny*nz] bool, ovecs_flat [nx*ny*nz, nvec, 3] f32 candidates and
    lcms_flat [nx*ny*nz, 10] f32 thresholded LCMs; dxyz [3, 4] int64 holds
    the in-plane increments of the four voxel edges, edget [2, 10] int64
    is `EDGETYPE`, `strdims` the two in-plane dims; all contiguous.  `key`
    is the direction's key, two 32-bit words, and draws with
    `lcm_uniforms`.  The previously chosen vector index is carried (the
    reference continues along it while not entering a new voxel,
    src/stream.jl:399-411); there is no angle threshold.

    emit="points": out is the saved float32 positions.  emit="deltas":
    out is the int8 error-feedback step deltas at 1/qscale voxel, clipped
    to [-dmax, dmax], zero where nothing is saved.

    Returns (out [nsteps, S, 3], saved [nsteps, S] bool, flags [nsteps,
    S] int8 method-difference flags, npts_total [S] int32, anchor [S, 3]
    f32), as `propagate_dir` plus the flags.  On the card: one launch on
    the current stream of the tensors' device (after the table of what
    each step reads of the LCM rows, 128 bytes a voxel), nothing read
    back."""
    _check(pos0, vec0, npts0, mask_flat, ovecs_flat, lcms_flat, dxyz, edget,
           strdims, nsteps, shape3, emit, dmax)
    dev = pos0.device
    if dev.type == "cpu":
        return propagate_lcm_dir_plain(
            key, pos0, vec0, npts0, mask_flat, ovecs_flat, lcms_flat, dxyz,
            edget, strdims, nsteps, shape3, step_size, smooth_coeff,
            len_max, emit, qscale, dmax)
    if dev.type != "cuda":
        raise ValueError(f"propagate_lcm_dir: no kernel for device {dev}")
    deltas = emit == "deltas"
    s = pos0.shape[0]
    out = torch.empty((nsteps, s, 3), device=dev,
                      dtype=torch.int8 if deltas else torch.float32)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    flags = torch.empty((nsteps, s), dtype=torch.int8, device=dev)
    npts = torch.empty_like(npts0)
    anchor = torch.empty_like(pos0)
    if s == 0 or nsteps == 0:
        npts.copy_(npts0)
        anchor.copy_(pos0)
        return out, saved, flags, npts, anchor
    from ._build import load_library
    lib = load_library()
    f32 = np.float32
    nx, ny, nz = (int(n) for n in shape3)
    # the stream counter, the groups' stop counts and each stream's steps;
    # the launch clears the counters
    scratch = torch.empty(1 + (s + 31) // 32 + s, dtype=torch.int32,
                          device=dev)
    # what a step entering each voxel through each edge reads of its LCM
    # row, 32 bytes a (voxel, edge): the launch fills it
    table = torch.empty((lcms_flat.shape[0], 4, 8), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the scalars as torch's kernels take Python floats: cast to f32
        err = lib.propagate_lcm_launch(
            pos0.data_ptr(), vec0.data_ptr(), npts0.data_ptr(),
            mask_flat.data_ptr(), ovecs_flat.data_ptr(), lcms_flat.data_ptr(),
            table.data_ptr(), dxyz.data_ptr(), edget.data_ptr(), s,
            int(nsteps),
            ovecs_flat.shape[1], nx, ny, nz, int(strdims[0]),
            int(strdims[1]), int(key[0]) & _M32, int(key[1]) & _M32,
            f32(step_size), f32(smooth_coeff), f32(1.0 - smooth_coeff),
            int(smooth_coeff != 0.0), min(int(len_max), _INT32_MAX),
            int(deltas), f32(qscale), f32(1.0 / qscale), f32(dmax),
            out.data_ptr(), saved.data_ptr(), flags.data_ptr(),
            npts.data_ptr(), anchor.data_ptr(), scratch.data_ptr(),
            _index_bits(shape3), stream)
    if err != 0:
        raise RuntimeError(f"propagate_lcm_dir: kernel launch failed with "
                           f"cudaError {err} (S={s}, nsteps={nsteps}, "
                           f"nvec={ovecs_flat.shape[1]})")
    propagate_lcm_dir.launches += 1
    return out, saved, flags, npts, anchor


propagate_lcm_dir.launches = 0


def lcm_selfcheck(n: int = 1 << 22, device="cuda", seed: int = 0) -> dict:
    """The kernel's arithmetic against torch's on the card.  Returns, for
    each check, the elements where they differ (bits, or indices): all 0,
    the kernel computes as torch does.

    - "log": logf against torch.log on `n` positive floats over the
      whole exponent range, the LCM logits' clamp (1e-30) included;
    - "gumbel": -log(-log(u)) against torch's on all 2^24 uniforms the
      draws can give (u = k * 2^-24, k < 2^24, clamped at the smallest
      normal float);
    - "sum10": the sum of a row of ten (`havelcm`) against
      `Tensor.sum(dim=1)` on [n / 8, 10] rows of mixed signs and
      magnitudes, some elements zero;
    - "argmax10": the draw's argmax against `torch.argmax(dim=1)` on rows
      with ties, -inf and NaN;
    - "uniforms": the kernel's uniforms against `lcm_uniforms` for 2^16
      streams at two steps;
    - "gumbel_max": the Gumbel values above the bound the kernel's pruned
      draw assumes (17), of all 2^24 uniforms;
    - "draw": the kernel's draw (only the elements the entry edge keeps,
      or all ten where its guard fails) against torch's argmax over all
      ten elements of the masked row, on the rows of "sum10" with NaNs,
      values below the logits' clamp and ties, each masked to an entry
      edge's four elements or to a random subset."""
    from ._build import load_library
    lib = load_library()
    dev = torch.device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = n // 8
    x_log = torch.exp2(torch.empty(n).uniform_(-149, 128, generator=g))
    x_log[:8] = torch.tensor([1e-30, 1.0, 0.5, 2.0, 1e-38, 1e-45, 3.4e38,
                              torch.finfo(torch.float32).tiny])
    rows = torch.randn((m, 10), generator=g) * torch.exp2(
        torch.randint(-30, 31, (m, 10), generator=g).float())
    rows[torch.rand((m, 10), generator=g) < 0.3] = 0.0
    picks = torch.randint(0, 4, (m, 10), generator=g).float()
    picks[torch.rand((m, 10), generator=g) < 0.05] = -torch.inf
    picks[torch.rand((m, 10), generator=g) < 0.02] = torch.nan
    # the draw's rows: "sum10"'s with NaNs, values below the clamp, ties
    # and rows of zeros, each with the mask of an entry edge or a random one
    drows = rows.abs().clone()
    r = torch.rand((m, 10), generator=g)
    drows[r < 0.03] = torch.nan
    drows[(r >= 0.03) & (r < 0.1)] = 1e-35
    drows[(r >= 0.1) & (r < 0.15)] = 0.25
    drows[torch.rand(m, generator=g) < 0.05] = 0.0
    edges = torch.from_numpy(EDGETYPE.astype(np.int64))
    entry = torch.randint(0, 4, (m,), generator=g)
    keep = ((edges[0][None] == entry[:, None])
            | (edges[1][None] == entry[:, None]))
    rand_keep = torch.rand((m, 10), generator=g) < 0.4
    keep = torch.where((torch.rand(m, generator=g) < 0.2)[:, None],
                       rand_keep, keep)
    bits = (keep.long() << torch.arange(10)).sum(dim=1).float()
    keep, drows = keep.to(dev), drows.to(dev)
    drows_x = torch.cat([drows, bits[:, None].to(dev),
                         torch.log(torch.clamp_min(drows, 1e-30))], dim=1)
    x_log, rows, picks = x_log.to(dev), rows.to(dev), picks.to(dev)
    k = torch.arange(1 << 24, device=dev, dtype=torch.float32) * 2.0 ** -24
    u = torch.clamp_min(k, torch.finfo(torch.float32).tiny)
    key, ns = (0x1234ABCD, 0x9E3779B9), 1 << 16

    def run(mode, x, count, dtype, t=0, width=1):
        out = torch.empty(count * width, dtype=dtype, device=dev)
        err = lib.propagate_lcm_selfcheck(
            mode, 0 if x is None else x.data_ptr(), out.data_ptr(), count,
            key[0], key[1], t, stream)
        if err != 0:
            raise RuntimeError(f"lcm_selfcheck: launch failed with "
                               f"cudaError {err}")
        return out

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ours = dict(
            log=run(0, x_log, n, torch.float32),
            gumbel=run(1, None, 1 << 24, torch.float32),
            sum10=run(2, rows, m, torch.float32),
            argmax10=run(3, picks, m, torch.int32),
            uniforms=torch.cat([run(4, None, ns, torch.float32, t, 10)
                                for t in (0, 1023)]),
            draw=run(5, drows_x, m, torch.int32, 77))
    masked = torch.where(keep, drows, 0.0)
    logits = torch.log(torch.clamp_min(masked, 1e-30))
    draws = -torch.log(-torch.log(lcm_uniforms(key, m, 77, dev)))
    theirs = dict(
        log=torch.log(x_log), gumbel=-torch.log(-torch.log(u)),
        sum10=rows.sum(dim=1),
        argmax10=torch.argmax(picks, dim=1).to(torch.int32),
        uniforms=torch.cat([lcm_uniforms(key, ns, t, dev).reshape(-1)
                            for t in (0, 1023)]),
        draw=torch.argmax(logits + draws, dim=1).to(torch.int32))
    as_bits = lambda v: v.view(torch.int32)
    got = {name: int((as_bits(theirs[name]) != as_bits(ours[name])).sum())
           for name in ours}
    got["gumbel_max"] = int((ours["gumbel"] > 17.0).sum())
    return got
