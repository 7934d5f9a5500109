"""ODF local-peak detection on sphere tessellations, in PyTorch.

Counterpart of fibers_tpu/ops/peaks.py: a vertex survives iff its
amplitude is strictly greater than every vertex it shares a face with
(reference: src/gqi.jl:180-201), as a padded neighbour gather + max.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_neighbors", "peak_mask", "top_peaks", "topk_lower_first"]


def build_neighbors(faces0: np.ndarray, nvert: int):
    """Padded face-neighbour table from 0-based folded faces [m, 3].

    Returns (nbr [nvert, maxdeg] int32, nbr_valid [nvert, maxdeg] bool).
    Padding entries point at vertex 0 with valid=False.

    A copy of fibers_tpu/ops/peaks.py:build_neighbors (that module
    imports jax at its top)."""
    neigh = [set() for _ in range(nvert)]
    for a, b, c in faces0:
        neigh[a].update((b, c))
        neigh[b].update((a, c))
        neigh[c].update((a, b))
    maxdeg = max(len(s) for s in neigh)
    nbr = np.zeros((nvert, maxdeg), np.int32)
    ok = np.zeros((nvert, maxdeg), bool)
    for v, s in enumerate(neigh):
        idx = sorted(s)
        nbr[v, :len(idx)] = idx
        ok[v, :len(idx)] = True
    return nbr, ok


def peak_mask(o, nbr, nbr_valid):
    """[..., nvert] amplitudes -> boolean mask of strict local maxima:
    a vertex is dropped if ANY co-face vertex has amplitude >= its own
    (reference: src/gqi.jl:185-196)."""
    gathered = o[..., nbr.long()]                 # [..., nvert, maxdeg]
    gathered = torch.where(nbr_valid, gathered, -torch.inf)
    return o > gathered.amax(dim=-1)


def topk_lower_first(x, k):
    """The k largest values along the last axis, descending, and their
    indices, with the lower index first among equal values: `lax.top_k`'s
    order, which `torch.topk` does not promise.  A stable descending sort
    cut to k.  NaN sorts first in both.  `lax.top_k` puts +0 before -0
    where the sort takes them as equal; no caller has a -0 to rank (a
    non-peak is an exact +0, and a peak is strictly greater than its
    neighbours, which are >= 0 in DSI and RUMBA-SD).

    Returns (vals [..., k], idx [..., k] int64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_peaks(o, is_peak, k):
    """Top-k peak amplitudes and vertex indices, sorted descending.

    Non-peak vertices contribute 0 (reference: src/gqi.jl:198-200); a slot
    is valid iff its amplitude is > 0.  Equal amplitudes come lower
    vertex first, in the valid and the invalid slots alike, as the
    reference's `lax.top_k` orders them.

    Returns (vals [..., k], idx [..., k] int64, valid [..., k])."""
    masked = torch.where(is_peak, o, torch.zeros((), dtype=o.dtype,
                                                 device=o.device))
    vals, idx = topk_lower_first(masked, k)
    return vals, idx, vals > 0
