"""One direction of the microscopy cone-search integrator: the
hand-written CUDA kernel and its plain PyTorch version.

Counterpart of `fibers_tpu/tract/modes.py:_propagate_micro`, the jitted
`lax.scan` over the cone-search step (XLA, not Pallas; the reference's
`stream_micro_new_point!`, src/stream.jl:547-619).  All S streams of a
chunk advance `nsteps` steps: each step looks at the window of W cells
around the tentative voxel and jumps to the in-mask, in-cone cell whose
first vector is best aligned with the current direction.  The kernel is
`fibers_tpu_torch/csrc/propagate_micro.cu`: persistent warps, each taking
the next stream when its own one stops, with the window in shared memory,
the cone test before any gather and the frozen tails of stopped streams
written 32 streams at a time, so a direction is one launch where the
plain loop makes a few dozen a step over [S, W] tensors.

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
`propagate_micro_dir_plain`, the step loop in torch operations.  On the
card the kernel equals the plain loop bit for bit (`window_selfcheck`
holds its sums of three over the window to torch's); jumps land on
integer voxels, so the lines are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .propagate import (_INT32_MAX, _check_array, _check_step_loop,
                        _flat_index, _index_bits, _quantize_step,
                        _smooth_dir, _take)

__all__ = ["propagate_micro_dir", "propagate_micro_dir_plain",
           "window_selfcheck"]


def propagate_micro_dir_plain(pos0, vec0, npts0, mask_flat, vec_first,
                              win_off, win_dir, nsteps, shape3, step_size,
                              cosang_thresh, search_cosang, smooth_coeff,
                              len_max, emit="points", qscale=1.0, dmax=127):
    """Plain PyTorch version of `propagate_micro_dir`: a Python loop over
    the steps, each a batch of torch operations.  Same arguments and
    results."""
    dev = pos0.device
    s = pos0.shape[0]
    deltas = emit == "deltas"
    outs = torch.empty((nsteps, s, 3), device=dev,
                       dtype=torch.int8 if deltas else torch.float32)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    pos, vec, npts, pos_q = pos0, vec0, npts0, pos0
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
        cosang = torch.where(incone, cosang, -torch.inf)
        cabs = torch.where(torch.isfinite(cosang), cosang.abs(), -torch.inf)

        iwin = torch.argmax(cabs, dim=1)
        cbest = _take(cosang, iwin)
        save = active & inb & inmask & torch.isfinite(cbest)
        next_vox = _take(wpos, iwin)
        vbest = _take(wvec, iwin)
        vnext = torch.where((cbest > 0)[:, None], vbest, -vbest)

        npts = npts + save.to(npts.dtype)
        if deltas:
            outs[t], pos_q = _quantize_step(pos, pos_q, save, qscale, dmax)
        else:
            outs[t] = pos
        saved[t] = save

        cosadv = (vec * vnext).sum(dim=1)
        cont = save & (cosadv >= cosang_thresh) & (npts <= len_max)
        pos = torch.where(cont[:, None], next_vox.to(torch.float32), pos)
        vec = torch.where(cont[:, None], _smooth_dir(vec, vnext,
                                                     smooth_coeff), vec)
        active = cont
    return outs, saved, npts, pos_q


def _check(pos0, vec0, npts0, mask_flat, vec_first, win_off, win_dir, nsteps,
           shape3, emit, dmax):
    name = "propagate_micro_dir"
    _check_step_loop(name, pos0, vec0, npts0, nsteps, emit, dmax,
                     mask_flat=mask_flat, vec_first=vec_first,
                     win_off=win_off, win_dir=win_dir)
    nxyz = int(np.prod(shape3))
    _check_array(name, "mask_flat", mask_flat, (nxyz,), torch.bool)
    _check_array(name, "vec_first", vec_first, (nxyz, 3), torch.float32)
    _check_array(name, "win_off", win_off, (None, 3), torch.int64)
    _check_array(name, "win_dir", win_dir, (win_off.shape[0], 3),
                 torch.float32)


def propagate_micro_dir(pos0, vec0, npts0, mask_flat, vec_first, win_off,
                        win_dir, nsteps, shape3, step_size, cosang_thresh,
                        search_cosang, smooth_coeff, len_max, emit="points",
                        qscale=1.0, dmax=127):
    """Lockstep cone-search propagation of one direction for the S
    streams at pos0 [S, 3] f32, heading vec0 [S, 3] f32, with npts0 [S]
    int32 points already on their lines, through the volume `shape3`:
    mask_flat [nx*ny*nz] bool, vec_first [nx*ny*nz, 3] f32 (each voxel's
    first orientation vector) and the search window's W >= 1 cells,
    win_off [W, 3] int64 offsets and win_dir [W, 3] f32 unit directions
    (`tract/modes.py:_search_window`), all contiguous.  A cell counts
    when it lies in the volume and the mask and its direction is within
    the search cone (cos > search_cosang); the stream jumps to the one
    whose vector has the largest |cos| to its direction (the first on
    ties) and stops when none counts, when that angle passes
    cosang_thresh or when its line holds more than len_max points.

    emit="points": out is the saved float32 positions.  emit="deltas":
    out is the int8 error-feedback step deltas at 1/qscale voxel, clipped
    to [-dmax, dmax], zero where nothing is saved.

    Returns (out [nsteps, S, 3], saved [nsteps, S] bool, npts_total [S]
    int32, anchor [S, 3] f32), as `propagate_dir`.  On the card: one
    launch on the current stream of the tensors' device, nothing read
    back: the launch clears the counters of a scratch buffer allocated
    here (the next stream, the stopped streams of each group of 32) on
    that stream, then runs the kernel."""
    _check(pos0, vec0, npts0, mask_flat, vec_first, win_off, win_dir, nsteps,
           shape3, emit, dmax)
    args = (nsteps, shape3, step_size, cosang_thresh, search_cosang,
            smooth_coeff, len_max, emit, qscale, dmax)
    dev = pos0.device
    if dev.type == "cpu":
        return propagate_micro_dir_plain(pos0, vec0, npts0, mask_flat,
                                         vec_first, win_off, win_dir, *args)
    if dev.type != "cuda":
        raise ValueError(f"propagate_micro_dir: no kernel for device {dev}")
    deltas = emit == "deltas"
    s = pos0.shape[0]
    out = torch.empty((nsteps, s, 3), device=dev,
                      dtype=torch.int8 if deltas else torch.float32)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    npts = torch.empty_like(npts0)
    anchor = torch.empty_like(pos0)
    if s == 0 or nsteps == 0:
        npts.copy_(npts0)
        anchor.copy_(pos0)
        return out, saved, npts, anchor
    scratch = torch.empty(1 + (s + 31) // 32 + s, dtype=torch.int32,
                          device=dev)
    from ._build import load_library
    lib = load_library()
    f32 = np.float32
    nx, ny, nz = (int(n) for n in shape3)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the scalars as torch's kernels take Python floats: cast to f32
        err = lib.propagate_micro_launch(
            pos0.data_ptr(), vec0.data_ptr(), npts0.data_ptr(),
            mask_flat.data_ptr(), vec_first.data_ptr(), win_off.data_ptr(),
            win_dir.data_ptr(), s, int(nsteps), win_off.shape[0], nx, ny, nz,
            f32(step_size), f32(cosang_thresh), f32(search_cosang),
            f32(smooth_coeff), f32(1.0 - smooth_coeff),
            int(smooth_coeff != 0.0), min(int(len_max), _INT32_MAX),
            int(deltas), f32(qscale), f32(1.0 / qscale), f32(dmax),
            out.data_ptr(), saved.data_ptr(), npts.data_ptr(),
            anchor.data_ptr(), scratch.data_ptr(), _index_bits(shape3),
            stream)
    if err != 0:
        raise RuntimeError(f"propagate_micro_dir: kernel launch failed with "
                           f"cudaError {err} (S={s}, nsteps={nsteps}, "
                           f"W={win_off.shape[0]})")
    propagate_micro_dir.launches += 1
    return out, saved, npts, anchor


propagate_micro_dir.launches = 0


def window_selfcheck(search_dist=(15, 15, 0), n_streams: int = 4096,
                     device="cuda", seed: int = 0) -> int:
    """The kernel's sums of three over the search window against torch's,
    on the card, in the step loop's two layouts: conedot, `(vec[:, None,
    :] * win_dir[None]).sum(dim=2)` ([S, W, 3] · [1, W, 3]), and cosang,
    `(vec[:, None, :] * wvec).sum(dim=2)` ([S, W, 3] · [S, 1, 3]), for
    `n_streams` random unit directions, the window of `search_dist` (W =
    748 by default) and random cell vectors of mixed magnitudes.

    Returns the sums where the kernel and torch differ in a bit: 0, the
    kernel sums as torch does."""
    from ._build import load_library
    from ...tract.modes import _search_window
    lib = load_library()
    dev = torch.device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    _, wdir = _search_window(search_dist)
    w = len(wdir)
    vec = torch.nn.functional.normalize(
        torch.randn((n_streams, 3), generator=g), dim=1).to(dev)
    wvec = (torch.randn((n_streams * w, 3), generator=g) * torch.exp2(
        torch.randint(-20, 21, (n_streams * w, 3), generator=g).float())
            ).to(dev)
    wdir = torch.from_numpy(wdir).to(dev)
    n = n_streams * w
    ours = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(2)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.propagate_micro_window_selfcheck(
            wdir.data_ptr(), vec.data_ptr(), ours[0].data_ptr(), n, w, w,
            stream)
        err = err or lib.propagate_micro_window_selfcheck(
            wvec.data_ptr(), vec.data_ptr(), ours[1].data_ptr(), n, n, w,
            stream)
    if err != 0:
        raise RuntimeError(f"window_selfcheck: launch failed with cudaError "
                           f"{err}")
    torch_sums = ((vec[:, None, :] * wdir[None]).sum(dim=2).reshape(-1),
                  (vec[:, None, :] * wvec.reshape(n_streams, w, 3))
                  .sum(dim=2).reshape(-1))
    bits = lambda x: x.view(torch.int32)
    return sum(int((bits(t) != bits(o)).sum())
               for t, o in zip(torch_sums, ours))
