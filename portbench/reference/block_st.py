"""The plain structure tensor of a block too large for one pass, and its
primary eigenvector.

`reference/structens.py:tensor` (float64, reflecting at the volume's
faces) runs on slabs of planes along x, each with a halo as wide as its
filters reach (the pre-smooth radius, 1 for the gradient, the
post-smooth radius), and keeps the slab: a plane that far from a cut
holds what the whole volume would give it, so the slabs join into the
whole volume's tensor.  The primary eigenvector is that of the smallest
eigenvalue, from `torch.linalg.eigh` in float64.
"""

from __future__ import annotations

import torch

from . import structens as ref_st

__all__ = ["halo", "slabs", "tensor", "eigen"]

# matrices a `torch.linalg.eigh` call takes (cuSOLVER's batched solver
# refuses batches of millions)
EIGH_BATCH = 1 << 14


def halo(sigma, rho):
    """How far the chain reaches along an axis."""
    def radius(s):
        return (len(ref_st.gaussian(s)) - 1) // 2 if s > 0 else 0
    return radius(sigma) + 1 + radius(rho)


def slabs(n, per):
    """(a, b): the slabs of `per` planes of an axis of length n."""
    return [(a, min(a + per, n)) for a in range(0, n, per)]


def tensor(image, a, b, sigma, rho, device, dtype=torch.float64):
    """The six unique elements [b - a, Y, Z, 6] of the structure tensor
    of the planes [a, b) of `image` [X, Y, Z] (a host tensor), in
    `dtype`."""
    h = halo(sigma, rho)
    lo, hi = max(a - h, 0), min(b + h, image.shape[0])
    part = image[lo:hi].to(device)
    return ref_st.tensor(part, sigma, rho, dtype=dtype)[a - lo:b - lo]


def eigen(six):
    """Ascending eigenvalues [N, 3] and the primary (smallest-eigenvalue)
    unit eigenvector [N, 3] of tensors given as [N, 6] (xx, xy, xz, yy,
    yz, zz), in float64, `EIGH_BATCH` matrices a call."""
    t = six.double()
    xx, xy, xz, yy, yz, zz = t.unbind(-1)
    m = torch.stack([torch.stack([xx, xy, xz], -1),
                     torch.stack([xy, yy, yz], -1),
                     torch.stack([xz, yz, zz], -1)], -2)
    parts = [torch.linalg.eigh(m[i:i + EIGH_BATCH])
             for i in range(0, len(m), EIGH_BATCH)]
    if not parts:
        return m.new_zeros((0, 3)), m.new_zeros((0, 3))
    return (torch.cat([w for w, _ in parts]),
            torch.cat([v[..., :, 0] for _, v in parts]))
