"""The two launch variants of the dense TV stencil from the TV-variant
experiment (benchmarks/exp_tv_variants.py): hand-written CUDA kernels and
their plain PyTorch versions.

- `tv_dimsem` (`exp_tv_variants.py:37`): `tv_multiplier`'s x-sweep with
  the component chunk as the slowest index of the launch grid instead of
  the fastest, the ported form of that TPU grid (component axis
  outermost, declared parallel).  It computes exactly what
  `tv_multiplier` computes; its plain version is `tv_multiplier_plain`.
- `tv_2slice` (`exp_tv_variants.py:95`): the x-sweep advancing two
  x-slices per loop iteration and barrier, with the experiment's
  arithmetic: each gradient component divided by the norm (three
  divides, `_tv_kernel2`).  X must be even.

Both take f32 stacks only.  Both are instances of
`fibers_tpu_torch/csrc/tv_common.cuh:sweep_kernel`, launched from
`csrc/tv_stencil.cu`.  Nothing in the port's fits calls them;
`chip_smoke.py` times them against `tv_multiplier` at the same shape.
"""

from __future__ import annotations

from .tv_stencil import (check_stack, launch_stack, stencil_plain,
                         tv_multiplier_plain)

__all__ = ["tv_dimsem", "tv_dimsem_plain", "tv_2slice", "tv_2slice_plain"]


def tv_dimsem_plain(vol4, lam3):
    """Plain PyTorch version of `tv_dimsem`."""
    return tv_multiplier_plain(vol4, lam3)


def tv_2slice_plain(vol4, lam3):
    """Plain PyTorch version of `tv_2slice` (three divides)."""
    _check_even(vol4)
    return stencil_plain(vol4, lam3, three_div=True)


def _check_even(vol4):
    if vol4.shape[0] % 2:
        raise ValueError(f"tv_2slice: X must be even, got "
                         f"{tuple(vol4.shape)}")


def tv_dimsem(vol4, lam3):
    """`tv_multiplier` launched with the component chunk outermost; f32
    [X, Y, Z, C] stack and [X, Y, Z] lam -> [X, Y, Z, C] f32."""
    check_stack("tv_dimsem", vol4, lam3)
    if vol4.device.type == "cpu":
        return tv_dimsem_plain(vol4, lam3)
    out = launch_stack("tv_dimsem", "tv_dimsem_launch", vol4, lam3)
    tv_dimsem.launches += 1
    return out


def tv_2slice(vol4, lam3):
    """The stencil two x-slices per iteration with three divides by the
    norm; f32 [X, Y, Z, C] stack (X even) and [X, Y, Z] lam ->
    [X, Y, Z, C] f32."""
    check_stack("tv_2slice", vol4, lam3)
    _check_even(vol4)
    if vol4.device.type == "cpu":
        return tv_2slice_plain(vol4, lam3)
    out = launch_stack("tv_2slice", "tv_2slice_launch", vol4, lam3)
    tv_2slice.launches += 1
    return out


tv_dimsem.launches = 0
tv_2slice.launches = 0
