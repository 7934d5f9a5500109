"""Synthetic diffusion scans, made on the card from the run's seed.

A configuration's `scan` names the grid, the b-table and the signal
model; `make_subject` draws one subject of it.  The geometry (the
ellipsoid brain mask, the smooth fibre field) and the b-table are fixed
by the configuration; the seed and the subject's number only change the
noise, so every seed gives the same work.  The volume is computed on the
card in float32 and copied once into pinned host memory, where a
pipeline reads it as it would read a loaded scan.

The signal models are those of the repository's benchmark phantoms
(`bench.py:make_brain`, `benchmarks/bench_models.py:_signal`), rewritten
here in torch:

- "graded": two shells, a tensor whose anisotropy falls from the centre
  to the rim (mean diffusivity 0.7e-3 mm^2/s), and a central slab with a
  second fibre at 90 degrees in-plane with half the signal;
- "single": one fibre everywhere, lambda_par 1.7e-3 and lambda_perp
  0.3e-3 mm^2/s.

Both: s0 = 100, and |signal + sigma * N(0, 1)| inside the mask, zero
outside.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["btable", "geometry", "make_subject", "noise_seed", "seed_voxels"]


def noise_seed(seed: int, subject: int) -> int:
    """A 63-bit generator seed for subject `subject` of run seed `seed`."""
    return (int(seed) * 1_000_003 + 7_919 * int(subject) + 1) % (2 ** 63)


def btable(scan):
    """(bval [nvol] f32, bvec [nvol, 3] f32): `b0` volumes, then each shell
    of `shells` ([b, n]) on the first n points of one Fibonacci sphere of
    as many points as the largest shell."""
    nb0 = int(scan["b0"])
    shells = [(float(b), int(n)) for b, n in scan["shells"]]
    nsh = max(n for _, n in shells)
    i = np.arange(nsh)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    zz = 1 - 2 * (i + 0.5) / nsh
    r = np.sqrt(1 - zz * zz)
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), zz], axis=1)
    bval = np.concatenate([np.zeros(nb0)] + [np.full(n, b)
                                             for b, n in shells])
    bvec = np.concatenate([np.zeros((nb0, 3))] + [dirs[:n]
                                                  for _, n in shells])
    return bval.astype(np.float32), bvec.astype(np.float32)


def geometry(shape, device):
    """Normalised coordinates x, y, z [X, Y, Z] (float64), the ellipsoid
    brain mask and the unit fibre axis [X, Y, Z, 3] (float32)."""
    nx, ny, nz = shape
    x, y, z = torch.meshgrid(
        *(torch.linspace(-1, 1, n, dtype=torch.float64, device=device)
          for n in (nx, ny, nz)), indexing="ij")
    mask = (x ** 2 / 0.81 + y ** 2 / 0.81 + z ** 2 / 0.92) < 1.0
    th = 0.8 * x + 1.3 * y
    ph = 1.1 * z + 0.5 * x
    ax = torch.stack([torch.cos(ph) * torch.cos(th),
                      torch.cos(ph) * torch.sin(th), torch.sin(ph)],
                     dim=-1).float()
    return x, y, z, mask, ax


def _tensor_signal(ax, lp, lt, bval, bvec):
    """exp(-b (lt + (lp - lt) (g . ax)^2)) [..., nvol], float32."""
    dots = ax @ bvec.T
    quad = lt[..., None] + (lp - lt)[..., None] * dots ** 2
    return torch.exp(-bval * quad)


def make_subject(scan, seed: int, subject: int, device):
    """One subject of `scan` on `device`: the float32 DWI volume
    [X, Y, Z, nvol] in pinned host memory, and the brain mask [X, Y, Z]
    (bool, host).  Work on the card is done slab by slab along x."""
    shape = tuple(int(n) for n in scan["shape"])
    sig = scan["signal"]
    bval_h, bvec_h = btable(scan)
    bval = torch.from_numpy(bval_h).to(device)
    bvec = torch.from_numpy(bvec_h).to(device)
    x, y, z, mask, ax = geometry(shape, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(noise_seed(seed, subject))
    out = torch.empty(shape + (len(bval_h),), dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")
    s0, sigma = float(sig["s0"]), float(sig["noise_sigma"])
    step = max(1, shape[0] // 8)
    for lo in range(0, shape[0], step):
        sl = slice(lo, min(lo + step, shape[0]))
        a = ax[sl]
        if sig["model"] == "graded":
            r2 = x[sl] ** 2 + y[sl] ** 2 + z[sl] ** 2
            frac = torch.clamp(1.3 - 1.45 * r2, 0.01, 1.0).float()
            md = float(sig["md"])
            lp = md + 2.0 * md * (2.0 / 3.0) * frac
            lt = md - md * (2.0 / 3.0) * frac
            s1 = _tensor_signal(a, lp, lt, bval, bvec)
            cross = sig["crossing"]
            slab = ((y[sl].abs() < cross["y"]) & (z[sl].abs() < cross["z"]))
            a2 = torch.stack([-a[..., 1], a[..., 0], a[..., 2]], dim=-1)
            s2 = _tensor_signal(a2, lp, lt, bval, bvec)
            w = torch.where(slab, float(cross["weight"]), 0.0).float()
            vol = s0 * ((1.0 - w[..., None]) * s1 + w[..., None] * s2)
        elif sig["model"] == "single":
            lp = torch.full(a.shape[:3], float(sig["lambda_par"]),
                            device=device)
            lt = torch.full(a.shape[:3], float(sig["lambda_perp"]),
                            device=device)
            vol = s0 * _tensor_signal(a, lp, lt, bval, bvec)
        else:
            raise ValueError(f"unknown signal model {sig['model']!r}")
        m = mask[sl][..., None]
        noise = torch.randn(vol.shape, generator=gen, device=device,
                            dtype=torch.float32)
        vol = torch.where(m, (vol + sigma * noise).abs(), 0.0)
        out[sl].copy_(vol)
    return out, mask.cpu().numpy()


def seed_voxels(mask: np.ndarray, target_streams: int, nsub: int):
    """Seed voxels spread evenly over the mask's voxels (C order) so that
    `nsub` jittered streams a voxel give about `target_streams` streams
    (as bench.py seeds its pipeline).  Returns a float32 [X, Y, Z] 0/1
    volume."""
    idx = np.flatnonzero(mask)
    n = min(max(1, target_streams // nsub), len(idx))
    pick = idx[np.linspace(0, len(idx) - 1, n, dtype=np.int64)]
    sv = np.zeros(mask.size, np.float32)
    sv[pick] = 1
    return sv.reshape(mask.shape)

