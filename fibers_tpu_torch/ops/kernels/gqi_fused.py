"""Fused GQI reconstruction tile: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of fibers_tpu/ops/pallas/gqi_fused.py.  One pass per voxel
tile: clamp signals at 0 (NaN kept), ODF = s @ A_t at f32 precision, the
strict local-max mask over face neighbours, per-voxel (min, mean, valid)
stats, and the top-3 peaks of each voxel.  The kernel is
`fibers_tpu_torch/csrc/gqi_fused.cu` (3xTF32 tensor cores); its source
note says what bounds it and how.

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
`gqi_fused_plain`, the same function in plain PyTorch, which the CPU
tests hold against the JAX package.
"""

from __future__ import annotations

import torch

from ..peaks import peak_mask

__all__ = ["gqi_fused", "gqi_fused_plain", "NPEAK"]

NPEAK = 3


def gqi_fused_plain(signals, A_t, nbr, nbr_ok):
    """Plain PyTorch version: clamp -> matmul -> neighbour gather ->
    where/amax, the stats, and the top-3 of where(peak, odf, 0) from a
    stable descending sort, so ties fall to the lower vertex as
    `lax.top_k`'s do.  Same arguments and results as `gqi_fused`."""
    s = signals.clamp_min(0.0)
    odf = torch.matmul(s, A_t)
    peak = peak_mask(odf, nbr, nbr_ok)
    stats = torch.stack([odf.amin(dim=1), odf.mean(dim=1),
                         (s.amax(dim=1) > 0).to(odf.dtype)], dim=1)
    masked = torch.where(peak, odf, torch.zeros((), dtype=odf.dtype,
                                                device=odf.device))
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return odf, peak, stats, vals[:, :NPEAK], idx[:, :NPEAK]


def _check(signals, A_t, nbr, nbr_ok):
    if signals.dim() != 2 or A_t.dim() != 2 or nbr.dim() != 2:
        raise ValueError("gqi_fused: signals [N, nvol], A_t [nvol, nvert], "
                         "nbr [nvert, maxdeg] expected")
    n, nvol = signals.shape
    if A_t.shape[0] != nvol:
        raise ValueError(f"gqi_fused: A_t has {A_t.shape[0]} rows, signals "
                         f"have {nvol} columns")
    nvert = A_t.shape[1]
    if nvert < NPEAK:
        raise ValueError(f"gqi_fused: nvert={nvert} < {NPEAK} peaks")
    if nbr.shape[0] != nvert or nbr_ok.shape != nbr.shape:
        raise ValueError(f"gqi_fused: neighbour table {tuple(nbr.shape)} / "
                         f"{tuple(nbr_ok.shape)} does not fit nvert={nvert}")
    if signals.dtype != torch.float32 or A_t.dtype != torch.float32:
        raise TypeError("gqi_fused: signals and A_t must be float32")
    if nbr.dtype != torch.int32 or nbr_ok.dtype != torch.bool:
        raise TypeError("gqi_fused: nbr must be int32 and nbr_ok bool")
    devs = {t.device for t in (signals, A_t, nbr, nbr_ok)}
    if len(devs) != 1:
        raise ValueError(f"gqi_fused: arguments on several devices {devs}")
    return n, nvol, nvert, nbr.shape[1]


def gqi_fused(signals, A_t, nbr, nbr_ok):
    """signals [N, nvol] f32, A_t [nvol, nvert] f32, nbr [nvert, maxdeg]
    int32 and nbr_ok [nvert, maxdeg] bool from `build_neighbors`.

    Returns (odf [N, nvert] f32, peak mask [N, nvert] bool, stats [N, 3]
    f32 holding (min, mean, valid), vals [N, 3] f32, idx [N, 3] int64):
    vals/idx are the three largest entries of where(peak, odf, 0),
    descending, ties to the lower vertex; a slot is a peak iff its value
    is > 0 (as `ops.peaks.top_peaks`).  A row holding a NaN has a NaN
    ODF, min and mean, no peak, and valid 0, as in the JAX package.  N is
    any size; maxdeg at most 8 for the kernel (any on the CPU).
    """
    n, nvol, nvert, maxdeg = _check(signals, A_t, nbr, nbr_ok)
    if signals.device.type == "cpu":
        return gqi_fused_plain(signals, A_t, nbr, nbr_ok)
    if signals.device.type != "cuda":
        raise ValueError(f"gqi_fused: no kernel for device {signals.device}")
    for name, t in (("signals", signals), ("A_t", A_t), ("nbr", nbr),
                    ("nbr_ok", nbr_ok)):
        if not t.is_contiguous():
            raise ValueError(f"gqi_fused: {name} must be contiguous")
    if maxdeg > 8:
        raise ValueError(f"gqi_fused: the kernel takes at most 8 neighbours "
                         f"per vertex, the table has {maxdeg}")
    # the kernel gathers through nbr: reject out-of-range entries here
    if nbr.numel() and (int(nbr.min()) < 0 or int(nbr.max()) >= nvert):
        raise ValueError("gqi_fused: neighbour index out of range")

    from ._build import load_library
    lib = load_library()
    dev = signals.device
    odf = torch.empty((n, nvert), dtype=torch.float32, device=dev)
    peak = torch.empty((n, nvert), dtype=torch.bool, device=dev)
    stats = torch.empty((n, 3), dtype=torch.float32, device=dev)
    vals = torch.empty((n, NPEAK), dtype=torch.float32, device=dev)
    idx = torch.empty((n, NPEAK), dtype=torch.int64, device=dev)
    if n == 0:
        return odf, peak, stats, vals, idx
    # the padded A_t and the packed neighbour table, made by the launch
    scratch = torch.empty(lib.gqi_fused_scratch_bytes(nvol, nvert),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gqi_fused_launch(
            signals.data_ptr(), A_t.data_ptr(), nbr.data_ptr(),
            nbr_ok.data_ptr(), odf.data_ptr(), peak.data_ptr(),
            stats.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            scratch.data_ptr(), n, nvol, nvert, maxdeg, stream)
        smem = lib.gqi_fused_smem_bytes(nvol, nvert, maxdeg) if err else 0
    if err != 0:
        raise RuntimeError(
            f"gqi_fused: kernel launch failed with cudaError {err} (N={n}, "
            f"nvol={nvol}, nvert={nvert}, maxdeg={maxdeg}, shared memory "
            f"{smem} B; -1: no block shape fits)")
    gqi_fused.launches += 1
    return odf, peak, stats, vals, idx


gqi_fused.launches = 0
