"""Plain structure-tensor reference (Fibers.jl src/structens.jl:40-88).

A Gaussian pre-smooth of width sigma, Scharr gradients (the central
difference [-1/2, 0, 1/2] along the axis, [3, 10, 3] / 16 along the
other two), the six products of the gradient, and a Gaussian post-smooth
of width rho; every filter a correlation with the edge-inclusive
reflecting boundary, and a Gaussian of 2 max(2 ceil(sigma) // 1,
ceil(2 sigma)) + 1 taps (ImageFiltering's default length), normalised.
Returns the tensor's six unique elements [X, Y, Z, 6] (xx, xy, xz, yy,
yz, zz) in `dtype`: float64 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tensor"]

SMOOTH = np.array([3.0, 10.0, 3.0]) / 16.0
DERIV = np.array([-0.5, 0.0, 0.5])


def gaussian(sigma):
    r = max(int(4 * np.ceil(sigma)) // 2, int(np.ceil(2 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    return k / k.sum()


def _reflect(n, r):
    """Indices of an axis of length n padded by r on each side, reflected
    edge-inclusively (as often as needed)."""
    out = []
    for j in range(-r, n + r):
        while j < 0 or j >= n:
            j = -1 - j if j < 0 else 2 * n - 1 - j
        out.append(j)
    return np.asarray(out, np.int64)


def correlate(vol, k, axis):
    """out[i] = sum_t k[t] vol[i + t - r] along `axis`, reflected."""
    r = (len(k) - 1) // 2
    n = vol.shape[axis]
    pad = vol.index_select(axis, torch.from_numpy(_reflect(n, r)).to(
        vol.device))
    out = None
    for t, w in enumerate(k):
        if w == 0:
            continue
        term = pad.narrow(axis, t, n) * torch.tensor(w, dtype=vol.dtype,
                                                     device=vol.device)
        out = term if out is None else out + term
    return out


def tensor(vol, sigma, rho, dtype=torch.float64):
    v = vol.to(dtype)
    if sigma > 0:
        for ax in range(3):
            v = correlate(v, gaussian(sigma), ax)
    grads = []
    for d in range(3):
        g = v
        for ax in range(3):
            g = correlate(g, DERIV if ax == d else SMOOTH, ax)
        grads.append(g)
    gx, gy, gz = grads
    comps = [gx * gx, gx * gy, gx * gz, gy * gy, gy * gz, gz * gz]
    if rho > 0:
        out = []
        for c in comps:
            for ax in range(3):
                c = correlate(c, gaussian(rho), ax)
            out.append(c)
        comps = out
    return torch.stack(comps, -1)
