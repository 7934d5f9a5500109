"""The deterministic streamline integrator, one direction or both
directions of a chunk: the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of `fibers_tpu/tract/stream.py:_propagate`, the jitted
`lax.scan` over the step function (XLA, not Pallas).  All S streams of a
chunk advance `nsteps` steps from (pos0, vec0) through the flat
orientation field [nx*ny*nz, nvec, 3]: the voxel of the next position,
the greedy max-|cos| candidate with sign flip, the save of the current
point (or of its error-feedback delta), the three stop rules and the EMA
smoothing.  The kernels are in `fibers_tpu_torch/csrc/propagate.cu`: a
thread runs every step of a stream with its state in registers, so a
direction (`propagate_dir`) or both directions (`propagate_pair`, two
chains a thread) are one launch where the plain loop makes ~63 a step.

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
`propagate_dir_plain`, the step loop in torch operations.  On the card
the kernel equals the plain loop bit for bit: it rounds every multiply
and add apart (`__fmul_rn`, `__fadd_rn`), sums three products in the
order of torch's CUDA reduction (`sum3_selfcheck` holds it to
`Tensor.sum` on the card), and takes IEEE square roots and quotients.

The step helpers (`_flat_index`, `_take`, `_pick_by_angle`,
`_smooth_dir`, `_quantize_step`) live here and are shared with the LCM
and microscopy step loops (`propagate_lcm.py`, `propagate_micro.py`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["propagate_dir", "propagate_dir_plain", "propagate_pair",
           "propagate_pair_plain", "sum3_selfcheck"]

_INT32_MAX = 2 ** 31 - 1


def _index_bits(shape3) -> int:
    """The kernels' index arithmetic for a volume of `shape3`: 32-bit when
    it holds fewer than 2^31 voxels and each dimension is below 2^29 (the
    kernels then clamp a voxel coordinate to +-2^30, which keeps it, and a
    micro window cell of it, outside the volume), else 64-bit."""
    if int(np.prod([int(n) for n in shape3])) < 2 ** 31 \
            and max(int(n) for n in shape3) < 2 ** 29:
        return 32
    return 64


def _flat_index(ipos, shape3):
    """Flat voxel index of integer positions [..., 3], pointed at voxel 0
    where out of bounds, and the in-bounds flag."""
    nx, ny, nz = shape3
    ix, iy, iz = ipos.unbind(-1)
    inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
           & (iz >= 0) & (iz < nz))
    flat = (ix * ny + iy) * nz + iz
    return torch.where(inb, flat, torch.zeros_like(flat)), inb


def _take(x, i):
    """x [S, n, ...] at per-row index i [S] -> [S, ...]."""
    idx = i.view(-1, *([1] * (x.dim() - 1))).expand(-1, 1, *x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def _pick_by_angle(vec_now, vecs):
    """Greedy choice among candidate vectors [S, nvec, 3]: max |cos| to the
    current direction, sign-flipped to align.  Returns (vnext, ok, ivec).
    (reference: src/stream.jl:340-374)"""
    cos = (vecs * vec_now[:, None, :]).sum(dim=2)
    iszero = (vecs == 0).all(dim=2)
    cos = torch.where(iszero, -torch.inf, cos)
    cabs = torch.where(iszero, -torch.inf, cos.abs())
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


def _quantize_step(pos, pos_q, save, qscale, dmax):
    """One step of the error-feedback quantizer: (delta [S, 3], integral
    float32 values for an int8 store, and the new decoded position).
    d = clip(round((pos - pos_q) * qscale), -dmax, dmax), zero where the
    point is not saved, and pos_q advances by d / qscale with the step
    rounded to float32, as the reference's weak constants are.

    The reference's `pos_q + d * (1 / qscale)` is one fused multiply-add
    in XLA: a single rounding.  Here it is a float64 sum rounded once to
    float32, which is the same number: d (|d| <= 127) times the float32
    step is exact in float64, and so is its sum with a float32 position
    of a volume's size."""
    d = torch.clamp(torch.round((pos - pos_q) * qscale), -dmax, dmax)
    d = torch.where(save[:, None], d, 0.0)
    step = float(np.float32(1.0 / qscale))
    return d, torch.add(pos_q.double(), d, alpha=step).float()


def propagate_dir_plain(pos0, vec0, npts0, ovecs_flat, nsteps, shape3,
                        step_size, cosang_thresh, smooth_coeff, len_max,
                        emit="points", qscale=254.0, dmax=127):
    """Plain PyTorch version of `propagate_dir`: a Python loop over the
    steps, each a batch of torch operations.  Same arguments and
    results."""
    deltas = emit == "deltas"
    s, dev = pos0.shape[0], pos0.device
    pos, vec, npts, pos_q = pos0, vec0, npts0, pos0
    active = torch.ones(s, dtype=torch.bool, device=dev)
    outs = torch.empty((nsteps, s, 3), device=dev,
                       dtype=torch.int8 if deltas else pos0.dtype)
    saved = torch.empty((nsteps, s), dtype=torch.bool, device=dev)
    for t in range(nsteps):
        pos_next = pos + vec * step_size
        flat, inb = _flat_index(torch.round(pos_next).to(torch.int64),
                                shape3)
        vnext, okvec, _ = _pick_by_angle(vec, ovecs_flat[flat])

        # save the CURRENT position (pre-step), as the reference does
        save = active & inb & okvec
        npts = npts + save.to(npts.dtype)
        if deltas:
            outs[t], pos_q = _quantize_step(pos, pos_q, save, qscale, dmax)
        else:
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
    return outs, saved, npts, pos_q


def propagate_pair_plain(pos0, vec0, npts0, ovecs_flat, nsteps, shape3,
                         step_size, cosang_thresh, smooth_coeff, len_max,
                         emit="points", qscale=254.0, dmax=127):
    """Plain PyTorch version of `propagate_pair`: the forward direction,
    then the backward one from its counts (two `propagate_dir_plain`
    calls).  Same arguments and results."""
    args = (nsteps, shape3, step_size, cosang_thresh, smooth_coeff,
            len_max, emit, qscale, dmax)
    fwd = propagate_dir_plain(pos0, vec0, npts0, ovecs_flat, *args)
    out_b, saved_b, npts_b, _ = propagate_dir_plain(pos0, -vec0, fwd[2],
                                                    ovecs_flat, *args)
    return (*fwd, out_b, saved_b, npts_b)


def _check_array(name, what, t, shape, dtype):
    """t must be a `dtype` tensor of `shape` (None: any length >= 1)."""
    if t.dim() != len(shape) or any(
            n != want if want is not None else n < 1
            for n, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: {what} must be {list(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


def _check_step_loop(name, pos0, vec0, npts0, nsteps, emit, dmax,
                     **tables):
    """The checks of every propagation wrapper: the start state pos0,
    vec0 [S, 3] f32 and npts0 [S] int32, the point wire, nsteps, and all
    tensors (the state and the named `tables`) contiguous on one
    device."""
    s = pos0.shape[0] if pos0.dim() == 2 else 1
    _check_array(name, "pos0", pos0, (s, 3), torch.float32)
    _check_array(name, "vec0", vec0, (s, 3), torch.float32)
    _check_array(name, "npts0", npts0, (s,), torch.int32)
    tensors = dict(pos0=pos0, vec0=vec0, npts0=npts0, **tables)
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: arguments on several devices {devs}")
    if emit not in ("points", "deltas"):
        raise ValueError(f"{name}: emit must be 'points' or 'deltas', got "
                         f"{emit!r}")
    if not 0 < dmax <= 127:
        raise ValueError(f"{name}: dmax {dmax} outside int8")
    if nsteps < 0:
        raise ValueError(f"{name}: nsteps {nsteps} < 0")
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _check(name, pos0, vec0, npts0, ovecs_flat, nsteps, shape3, emit,
           dmax):
    _check_step_loop(name, pos0, vec0, npts0, nsteps, emit, dmax,
                     ovecs_flat=ovecs_flat)
    _check_array(name, "ovecs_flat", ovecs_flat,
                 (int(np.prod(shape3)), None, 3), torch.float32)


def _launch(name, pair, pos0, vec0, npts0, ovecs_flat, nsteps, shape3,
            step_size, cosang_thresh, smooth_coeff, len_max, emit, qscale,
            dmax):
    """One launch of the one-direction (pair False) or two-direction
    kernel on the current stream of the tensors' card: the outputs of the
    forward (or only) direction, then with `pair` the backward one's out,
    saved and npts; and whether it launched (not for S = 0 or nsteps =
    0).  Raises if the launch is refused."""
    dev = pos0.device
    deltas = emit == "deltas"
    s = pos0.shape[0]

    def outputs():
        return (torch.empty((nsteps, s, 3), device=dev,
                            dtype=torch.int8 if deltas else torch.float32),
                torch.empty((nsteps, s), dtype=torch.bool, device=dev),
                torch.empty_like(npts0))

    out, saved, npts = outputs()
    anchor = torch.empty_like(pos0)
    back = outputs() if pair else (None, None, None)
    if s == 0 or nsteps == 0:
        npts.copy_(npts0)
        anchor.copy_(pos0)
        if pair:
            back[2].copy_(npts0)
        return (out, saved, npts, anchor) + (back if pair else ()), False
    from ._build import load_library
    lib = load_library()
    f32 = np.float32
    nx, ny, nz = (int(n) for n in shape3)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the scalars as torch's kernels take Python floats: cast to f32
        err = lib.propagate_launch(
            pos0.data_ptr(), vec0.data_ptr(), npts0.data_ptr(),
            ovecs_flat.data_ptr(), s, int(nsteps), ovecs_flat.shape[1],
            nx, ny, nz, f32(step_size), f32(cosang_thresh),
            f32(smooth_coeff), f32(1.0 - smooth_coeff),
            int(smooth_coeff != 0.0), min(int(len_max), _INT32_MAX),
            int(deltas), f32(qscale), f32(1.0 / qscale), f32(dmax),
            out.data_ptr(), saved.data_ptr(), npts.data_ptr(),
            anchor.data_ptr(), *(ptr(t) for t in back), int(pair),
            _index_bits(shape3), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (S={s}, nsteps={nsteps}, "
                           f"nvec={ovecs_flat.shape[1]})")
    return (out, saved, npts, anchor) + (back if pair else ()), True


def propagate_dir(pos0, vec0, npts0, ovecs_flat, nsteps, shape3, step_size,
                  cosang_thresh, smooth_coeff, len_max, emit="points",
                  qscale=254.0, dmax=127):
    """Lockstep propagation of one direction for the S streams at pos0
    [S, 3] f32, heading vec0 [S, 3] f32, with npts0 [S] int32 points
    already on their lines, through ovecs_flat [nx*ny*nz, nvec, 3] f32
    of the volume `shape3`, all contiguous.  Masking is baked into the
    field: every vector outside the mask is zero, so an out-of-mask voxel
    has no candidate and stops the stream.  `npts0` is the running count
    of each line (the forward direction's when propagating backward), so
    both directions share one length budget.

    emit="points": out is the saved float32 positions.  emit="deltas":
    out is the int8 error-feedback step deltas at 1/qscale voxel, clipped
    to [-dmax, dmax], zero where nothing is saved.

    Returns (out [nsteps, S, 3], saved [nsteps, S] bool, npts_total [S]
    int32, anchor [S, 3] f32): `anchor` is the quantized chain's final
    position (pos0 with emit="points").  On the card: one launch on the
    current stream of the tensors' device, nothing read back."""
    _check("propagate_dir", pos0, vec0, npts0, ovecs_flat, nsteps, shape3,
           emit, dmax)
    args = (nsteps, shape3, step_size, cosang_thresh, smooth_coeff,
            len_max, emit, qscale, dmax)
    dev = pos0.device
    if dev.type == "cpu":
        return propagate_dir_plain(pos0, vec0, npts0, ovecs_flat, *args)
    if dev.type != "cuda":
        raise ValueError(f"propagate_dir: no kernel for device {dev}")
    outs, launched = _launch("propagate_dir", False, pos0, vec0, npts0,
                             ovecs_flat, *args)
    propagate_dir.launches += launched
    return outs


propagate_dir.launches = 0


def propagate_pair(pos0, vec0, npts0, ovecs_flat, nsteps, shape3,
                   step_size, cosang_thresh, smooth_coeff, len_max,
                   emit="points", qscale=254.0, dmax=127):
    """Both directions of the S streams at pos0 [S, 3] f32: forward along
    vec0 [S, 3] f32 with npts0 [S] int32 points already on the lines, and
    backward along -vec0 with the forward counts, so that both share one
    length budget (reference: src/stream.jl:648-686) -- `propagate_dir`
    for (vec0, npts0), then for (-vec0, its npts).  Arguments as
    `propagate_dir`'s.

    Returns (out, saved, npts, anchor, out_b, saved_b, npts_b): the
    forward direction's four results and the backward direction's out,
    saved and npts (its total count, forward points included); the
    backward anchor is not kept.  On the card: one launch, two chains a
    thread, on the current stream of the tensors' device, nothing read
    back."""
    _check("propagate_pair", pos0, vec0, npts0, ovecs_flat, nsteps, shape3,
           emit, dmax)
    args = (nsteps, shape3, step_size, cosang_thresh, smooth_coeff,
            len_max, emit, qscale, dmax)
    dev = pos0.device
    if dev.type == "cpu":
        return propagate_pair_plain(pos0, vec0, npts0, ovecs_flat, *args)
    if dev.type != "cuda":
        raise ValueError(f"propagate_pair: no kernel for device {dev}")
    outs, launched = _launch("propagate_pair", True, pos0, vec0, npts0,
                             ovecs_flat, *args)
    propagate_pair.launches += launched
    return outs


propagate_pair.launches = 0


def sum3_selfcheck(n: int = 1 << 22, device="cuda", seed: int = 0) -> int:
    """The kernel's sum of three products (`csrc/propagate.cu:dot3`)
    against torch's `(a * b).sum(dim=-1)` on the card, on `n` random
    pairs of [3] rows of mixed magnitudes and signs (some components
    zero), laid out as the step loop's two sums are: [n, 3] rows and
    [n / 4, 4, 3] candidates times a broadcast [n / 4, 1, 3] direction.

    Returns the rows where the kernel and torch differ in a bit: 0, the
    kernel sums as torch does."""
    from ._build import load_library
    lib = load_library()
    dev = torch.device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = n // 4

    def rows(k):
        x = torch.randn((k, 3), generator=g) * torch.exp2(
            torch.randint(-20, 21, (k, 3), generator=g).float())
        x[torch.rand((k, 3), generator=g) < 0.05] = 0.0
        return x.to(dev)

    a, b = rows(n), rows(n)
    cand, head = rows(4 * m).reshape(m, 4, 3), rows(m)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ours = torch.empty(n, dtype=torch.float32, device=dev)
        err = lib.propagate_sum3_selfcheck(a.data_ptr(), b.data_ptr(),
                                           ours.data_ptr(), n, 0, stream)
        ours_c = torch.empty(4 * m, dtype=torch.float32, device=dev)
        err = err or lib.propagate_sum3_selfcheck(
            cand.data_ptr(), head.data_ptr(), ours_c.data_ptr(), 4 * m, 4,
            stream)
    if err != 0:
        raise RuntimeError(f"sum3_selfcheck: launch failed with cudaError "
                           f"{err}")
    torch_sums = ((a * b).sum(dim=-1),
                  (cand * head[:, None, :]).sum(dim=2).reshape(-1))
    bits = lambda x: x.view(torch.int32)
    return sum(int((bits(t) != bits(o)).sum())
               for t, o in zip(torch_sums, (ours, ours_c)))
