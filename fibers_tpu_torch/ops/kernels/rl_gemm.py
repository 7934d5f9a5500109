"""RUMBA-SD's Richardson-Lucy products in the reference's matrix-unit
arithmetic: the hand-written CUDA kernel on bf16 tensor cores and its
plain PyTorch version.

Counterpart of the three `jnp.dot(..., precision=hp)` of the reference's
iteration program, `fibers_tpu/models/rumba.py:_rumba_step_core`
(:360-361 num and den, :379 dodf), at its matrix-unit precisions
(:46-55):

    passes = 3  ("high"):    each operand x = hi + lo, hi = bf16_rn(x),
                             lo = bf16_rn(x - hi); lo_a@hi_b + hi_a@lo_b
                             + hi_a@hi_b in f32 accumulation;
    passes = 1  ("default"): hi_a@hi_b, bf16-rounded operands, f32
                             accumulation.

`pack_rl(b)` builds b's bf16 planes once (a fit packs its kernel matrix
and the transpose once per device); `rl_gemm(a, packed, passes)` computes
a @ b, and with `a2` also a2 @ b in the same launch (num and den).  The
kernel is `fibers_tpu_torch/csrc/rl_gemm.cu`: wgmma products that the
tensor core sums over one k16 step, each step's sum then added to an f32
accumulator.

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
the plain version, `rl_gemm_plain`.  On the card the kernel and the plain
version take the same products of the same bf16 parts, add them to the
f32 accumulator in the same chunks of K, and differ only in the rounding
of the sums within a chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["RLPacked", "pack_rl", "rl_gemm", "rl_gemm_plain", "split_bf16"]

PASSES = (1, 3)
# the depth of K whose products the kernel's tensor core sums before each
# add to its f32 accumulator: one k16 step (csrc/rl_gemm.cu).  One step
# keeps the mma.sync kernel's distance from the exact product on the fit's
# own operands, two read up to 1.7x that (PERF.md §6, B13)
STEP = 16


def split_bf16(x):
    """x = hi + lo as two f32 tensors of bf16 values: hi = bf16_rn(x),
    lo = bf16_rn(x - hi).  A NaN stays NaN in both; an infinity gives an
    infinite hi and a NaN lo."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def rl_gemm_plain(a, b, passes):
    """Plain PyTorch version of `rl_gemm` on f32 `a` [M, K] and `b`
    [K, N], in the kernel's order: for each STEP-deep chunk of K, the
    chunk's sum of the bf16 parts' products, (lo_a@hi_b + hi_a@lo_b) +
    hi_a@hi_b for passes=3 (`split_bf16`) and hi_a@hi_b, the bf16-rounded
    operands, for passes=1, added to an f32 accumulator one chunk after
    another."""
    if passes not in PASSES:
        raise ValueError(f"rl_gemm_plain: passes must be 1 or 3, got "
                         f"{passes!r}")
    if passes == 3:
        ah, al = split_bf16(a)
        bh, bl = split_bf16(b)
    else:
        ah, bh = a.bfloat16().float(), b.bfloat16().float()
    acc = None
    for k0 in range(0, a.shape[1], STEP):
        s = slice(k0, k0 + STEP)
        d = torch.matmul(ah[:, s], bh[s])
        if passes == 3:
            d = (torch.matmul(al[:, s], bh[s]) + torch.matmul(ah[:, s], bl[s])
                 ) + d
        acc = d if acc is None else acc.add_(d)
    return acc


@dataclass
class RLPacked:
    """B [K, N] f32 and, on the card, its packed bf16 planes (`hi`, `lo`:
    uint8 buffers the kernel reads in fragment order)."""

    b: torch.Tensor
    hi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None


def _f32_2d(name, what, t):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
            or t.dim() != 2:
        raise TypeError(f"{name}: {what} must be a 2-D float32 tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def pack_rl(b):
    """`b` [K, N] f32 for `rl_gemm`: on the card its bf16 hi and lo planes,
    zero-padded to the mma tiles, built by one small kernel launch (not
    counted in `rl_gemm.launches`); on the CPU `b` alone."""
    name = "pack_rl"
    _f32_2d(name, "b", b)
    k, n = b.shape
    if k < 1 or n < 1:
        raise ValueError(f"{name}: b {tuple(b.shape)} is empty")
    if b.device.type == "cpu":
        return RLPacked(b)
    if b.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {b.device}")
    from ._build import load_library
    lib = load_library()
    words = lib.rl_gemm_plane_words(k, n)
    hi = torch.empty(8 * words, dtype=torch.uint8, device=b.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.rl_pack_launch(b.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                 k, n, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (b {tuple(b.shape)})")
    return RLPacked(b, hi, lo)


def rl_gemm(a, packed, passes, out=None, a2=None, out2=None):
    """a @ b in the reference's matrix-unit arithmetic (`passes` 3 or 1,
    the module's docstring), for f32 `a` [M, K] and `packed` =
    `pack_rl(b)` of b [K, N].  With `a2` [M, K] also a2 @ b, in the same
    launch; it then returns (c, c2).

    Results go into `out` / `out2` ([M, N] f32, contiguous; new tensors
    when None), which must not overlap the operands.  All operands
    contiguous f32 on one device; any shape.  A row of `a` holding a
    NaN gives a NaN row.  With passes=3 an infinite element of `a` gives
    NaN in its row (its lo part is inf - inf), in the kernel and the plain
    version alike, where the f32 product gives inf."""
    name = "rl_gemm"
    if passes not in PASSES:
        raise ValueError(f"{name}: passes must be 1 or 3, got {passes!r}")
    if not isinstance(packed, RLPacked):
        raise TypeError(f"{name}: packed must come from pack_rl")
    k, n = packed.b.shape
    ops = [("a", a)] + ([("a2", a2)] if a2 is not None else [])
    for what, t in ops:
        _f32_2d(name, what, t)
        if t.shape[1] != k:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} does not "
                             f"match b {tuple(packed.b.shape)}")
    m = a.shape[0]
    if a2 is not None and a2.shape[0] != m:
        raise ValueError(f"{name}: a {tuple(a.shape)} and a2 "
                         f"{tuple(a2.shape)} differ in rows")
    if out2 is not None and a2 is None:
        raise ValueError(f"{name}: out2 without a2")
    outs = [("out", out), ("out2", out2)]
    for what, t in outs:
        if t is None:
            continue
        _f32_2d(name, what, t)
        if tuple(t.shape) != (m, n):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {(m, n)}")
        for _, o in ops:
            if _overlap(t, o):
                raise ValueError(f"{name}: {what} overlaps an operand")
    if out is not None and out2 is not None and _overlap(out, out2):
        raise ValueError(f"{name}: out and out2 overlap")
    devs = {t.device for _, t in ops + outs if t is not None}
    devs.add(packed.b.device)
    if len(devs) != 1:
        raise ValueError(f"{name}: arguments on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        c = _plain_into(a, packed.b, passes, out)
        if a2 is None:
            return c
        return c, _plain_into(a2, packed.b, passes, out2)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if packed.hi is None:
        raise ValueError(f"{name}: packed holds no planes for the card")
    c = torch.empty((m, n), dtype=torch.float32, device=dev) \
        if out is None else out
    c2 = None
    if a2 is not None:
        c2 = torch.empty_like(c) if out2 is None else out2
    from ._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rl_gemm_launch(
            a.data_ptr(), None if a2 is None else a2.data_ptr(),
            packed.hi.data_ptr(), packed.lo.data_ptr(), c.data_ptr(),
            None if c2 is None else c2.data_ptr(), m, k, n, passes, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (a {tuple(a.shape)}, b {(k, n)}, passes "
                           f"{passes})")
    if m:
        rl_gemm.launches += 1
    return c if a2 is None else (c, c2)


rl_gemm.launches = 0


def _overlap(x, y):
    """Whether the storage ranges of two contiguous tensors meet."""
    if x.device != y.device or x.numel() == 0 or y.numel() == 0:
        return False
    x0, y0 = x.data_ptr(), y.data_ptr()
    return x0 < y0 + y.nbytes and y0 < x0 + x.nbytes


def _plain_into(a, b, passes, out):
    c = rl_gemm_plain(a, b, passes)
    if out is None:
        return c
    return out.copy_(c)
