"""RUMBA-SD's dense TV stencil: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of fibers_tpu/ops/pallas/tv_stencil.py (`tv_multiplier`) and
of fibers_tpu/models/rumba.py:_tv_stencil.  Over a channels-minor
[X, Y, Z, C] component stack it computes the TV multiplier
1/(|1 - lam*div(grad v/|grad v|)| + 1e-7) with forward differences, a
clamped upper edge and zero-padded divergence boundary rows (reference:
src/rusd.jl:183-235).  The kernel is `fibers_tpu_torch/csrc/tv_stencil.cu`.

Precision follows the TPU kernel: a bf16 stack takes its differences in
bf16 and everything after them in f32, on the card and in the plain
version alike.  (The reference's CPU path runs its whole stencil in bf16;
that is the one place the port parts from it.)

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
the plain version.
"""

from __future__ import annotations

import torch

__all__ = ["tv_multiplier", "tv_multiplier_plain", "stencil_plain",
           "rn_selfcheck"]


def _forward_diff(v, dim):
    """v[min(i+1, n-1)] - v[i] along `dim`, in v's dtype, as f32."""
    n = v.shape[dim]
    nxt = torch.cat([v.narrow(dim, 1, n - 1), v.narrow(dim, n - 1, 1)], dim)
    return (nxt - v).float()


def _backward_diff(g, dim):
    """g[i] - g[i-1] along `dim`, with g[-1] taken as 0.  With g = 0 at
    the upper edge this is the reference's divergence with its lead row
    g[0] and last row -g[n-2]."""
    n = g.shape[dim]
    prev = torch.cat([torch.zeros_like(g.narrow(dim, 0, 1)),
                      g.narrow(dim, 0, n - 1)], dim)
    return g - prev


def stencil_plain(vol4, lam3, three_div=False):
    """The stencil in plain PyTorch.  `three_div` divides each gradient
    component by the norm (the two-slice experiment's arithmetic) instead
    of multiplying by one reciprocal."""
    gx = _forward_diff(vol4, 0)
    gy = _forward_diff(vol4, 1)
    gz = _forward_diff(vol4, 2)
    if three_div:
        norm = torch.sqrt(gx * gx + gy * gy + gz * gz + 1e-7)
        gx, gy, gz = gx / norm, gy / norm, gz / norm
    else:
        ninv = 1.0 / torch.sqrt(gx * gx + gy * gy + gz * gz + 1e-7)
        gx, gy, gz = gx * ninv, gy * ninv, gz * ninv
    div = (_backward_diff(gx, 0) + _backward_diff(gy, 1)
           + _backward_diff(gz, 2))
    return 1.0 / (torch.abs(1.0 - lam3[..., None] * div) + 1e-7)


def tv_multiplier_plain(vol4, lam3):
    """Plain PyTorch version of `tv_multiplier`: same arguments and
    result."""
    return stencil_plain(vol4, lam3)


def check_stack(name, vol4, lam3, dtypes=(torch.float32,)):
    """Validate a [X, Y, Z, C] stack and its [X, Y, Z] f32 lam."""
    if vol4.dim() != 4 or lam3.dim() != 3:
        raise ValueError(f"{name}: vol4 [X, Y, Z, C] and lam3 [X, Y, Z] "
                         "expected")
    if tuple(lam3.shape) != tuple(vol4.shape[:3]):
        raise ValueError(f"{name}: lam3 {tuple(lam3.shape)} does not match "
                         f"the stack {tuple(vol4.shape)}")
    if vol4.dtype not in dtypes or lam3.dtype != torch.float32:
        raise TypeError(f"{name}: vol4 must be one of {dtypes} and lam3 "
                        f"float32, got {vol4.dtype} and {lam3.dtype}")
    if vol4.device != lam3.device:
        raise ValueError(f"{name}: arguments on several devices "
                         f"{vol4.device}, {lam3.device}")
    if min(vol4.shape) < 1:
        raise ValueError(f"{name}: empty stack {tuple(vol4.shape)}")


def launch_stack(name, entry, vol4, lam3, *extra):
    """Launch a dense-stack kernel `entry` of the library on the current
    stream; returns the [X, Y, Z, C] f32 output.  Raises on a device that
    is not CUDA and on a refused launch."""
    if vol4.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {vol4.device}")
    for what, t in (("vol4", vol4), ("lam3", lam3)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    from ._build import load_library
    lib = load_library()
    X, Y, Z, C = vol4.shape
    out = torch.empty((X, Y, Z, C), dtype=torch.float32, device=vol4.device)
    with torch.cuda.device(vol4.device):
        stream = torch.cuda.current_stream(vol4.device).cuda_stream
        err = getattr(lib, entry)(vol4.data_ptr(), *extra, lam3.data_ptr(),
                                  out.data_ptr(), X, Y, Z, C, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (shape {tuple(vol4.shape)})")
    return out


def tv_multiplier(vol4, lam3):
    """TV multiplier of a [X, Y, Z, C] component stack (f32 or bf16; C
    any size) under the [X, Y, Z] f32 weights `lam3`.  Returns
    [X, Y, Z, C] f32."""
    check_stack("tv_multiplier", vol4, lam3,
                (torch.float32, torch.bfloat16))
    if vol4.device.type == "cpu":
        return tv_multiplier_plain(vol4, lam3)
    out = launch_stack("tv_multiplier", "tv_multiplier_launch", vol4, lam3,
                       int(vol4.dtype == torch.bfloat16))
    tv_multiplier.launches += 1
    return out


tv_multiplier.launches = 0


def rn_selfcheck(device="cuda") -> int:
    """The number of float bit patterns on which the sweep kernels'
    branch-free square root and reciprocal (csrc/tv_common.cuh:
    `sqrt_fast`, `rcp_fast`) differ from `__fsqrt_rn` and
    `__fdiv_rn(1, x)`, over all 2^32 patterns, each where the kernels use
    it.  0: the kernels round as the IEEE intrinsics everywhere."""
    from ._build import load_library
    lib = load_library()
    dev = torch.device(device)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tv_rn_selfcheck(0, 1 << 32, bad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rn_selfcheck: launch failed with cudaError "
                           f"{err}")
    return int(bad.item())
