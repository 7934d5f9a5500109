"""Synthetic microscopy blocks, made on the card from the run's seed.

A configuration's `block` names the grid, the tissue mask and the
tubes; `make_block` draws one subject of it.  The geometry is fixed by
the configuration; the seed and the subject's number change only the
noise, so every seed gives the same work.  The image is computed on the
card in float32, slab by slab along x, and copied into pinned host
memory, where a pipeline reads it as a lab reads a block from disk.

The image: bright tubes along a smoothly bending fibre field.  Two
scalar fields f and g, each a coordinate plus sine bends (in voxels),
have gradients that span the plane across the fibres, so the fibre
direction is grad f x grad g; the product of two raised cosine gratings
of f and g, of period `period` voxels, is bright along tubes that
follow it.  Inside the crossing slab (|z - z0| < half-width) a second
family of tubes runs along y (gratings of x and z), at half weight
each.  Intensity s0 (floor + (1 - floor) tubes) inside the ellipsoid
tissue mask, zero outside, then |image + sigma N(0, 1)| everywhere, as
magnitude images are (Rician-like).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["make_block", "tissue_mask", "seed_lattice"]


def _planes(block, lo, hi, device):
    """Voxel coordinates x, y, z [hi - lo, Y, Z] (float32) of the planes
    [lo, hi) and the normalised ones (-1 to 1 across the block)."""
    nx, ny, nz = (int(n) for n in block["shape"])
    x = torch.arange(lo, hi, dtype=torch.float32, device=device)
    y = torch.arange(ny, dtype=torch.float32, device=device)
    z = torch.arange(nz, dtype=torch.float32, device=device)
    x, y, z = torch.meshgrid(x, y, z, indexing="ij")
    norm = [2 * c / max(n - 1, 1) - 1 for c, n in ((x, nx), (y, ny),
                                                   (z, nz))]
    return (x, y, z), norm


def _in_mask(block, norm):
    r = [float(v) for v in block["mask_radii"]]
    return (norm[0] / r[0]) ** 2 + (norm[1] / r[1]) ** 2 \
        + (norm[2] / r[2]) ** 2 < 1.0


def _grating(f, g, period):
    w = 2 * math.pi / period
    return 0.25 * (1 + torch.cos(w * f)) * (1 + torch.cos(w * g))


def _tubes(block, xyz):
    """The tube image in [0, 1] at the voxel coordinates `xyz`."""
    x, y, z = xyz
    t = block["tubes"]
    p = float(t["period"])
    (a1, a2), (l1, l2), (m1, m2) = t["bend"], t["bend_len"], t["cross_len"]
    tau = 2 * math.pi
    f = x + a1 * torch.sin(tau * z / l1 + tau * y / m1)
    g = y + a2 * torch.sin(tau * z / l2 + tau * x / m2)
    img = _grating(f, g, p)
    z0, hw = (float(v) for v in t["crossing_z"])
    slab = (z - z0).abs() < hw
    return torch.where(slab, 0.5 * (img + _grating(x, z, p)), img)


def tissue_mask(block, device) -> np.ndarray:
    """The ellipsoid tissue mask [X, Y, Z] (host bool)."""
    shape = tuple(int(n) for n in block["shape"])
    out = np.empty(shape, bool)
    step = max(1, shape[0] // 16)
    for lo in range(0, shape[0], step):
        hi = min(lo + step, shape[0])
        _, norm = _planes(block, lo, hi, device)
        out[lo:hi] = _in_mask(block, norm).cpu().numpy()
    return out


def make_block(block, seed: int, subject: int, device) -> torch.Tensor:
    """One subject's image block [X, Y, Z] float32 in pinned host memory
    (plain host memory off the card)."""
    from .phantoms import noise_seed
    shape = tuple(int(n) for n in block["shape"])
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed(seed, subject))
    out = torch.empty(shape, dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")
    s0, floor = float(block["s0"]), float(block["floor"])
    sigma = float(block["noise_sigma"])
    step = max(1, shape[0] // 16)
    for lo in range(0, shape[0], step):
        hi = min(lo + step, shape[0])
        xyz, norm = _planes(block, lo, hi, device)
        img = s0 * (floor + (1 - floor) * _tubes(block, xyz))
        img = torch.where(_in_mask(block, norm), img, 0.0)
        noise = torch.randn(img.shape, generator=gen, device=device,
                            dtype=torch.float32)
        out[lo:hi].copy_((img + sigma * noise).abs())
    return out


def seed_lattice(mask: np.ndarray, every: int) -> np.ndarray:
    """Seed voxels every `every`-th voxel on each axis inside `mask`: a
    uint8 [X, Y, Z] 0/1 volume."""
    sv = np.zeros(mask.shape, np.uint8)
    k = int(every)
    sv[::k, ::k, ::k] = mask[::k, ::k, ::k]
    return sv
