"""One step of every compute path, over a device mesh or one device.

Counterpart of fibers_tpu/parallel/pipeline.py: the DTI masked-WLS solve,
the GQI product with its peaks (the `gqi_fused` kernel, once per data
shard), one RUMBA-SD Richardson-Lucy update with the TV term resharded
over components (`tv_multiplier` on every mesh device; `tv_fused` on one
device), and a block of lockstep streamline steps.  The multi-device dry
run of the repository (`chip_smoke.py`'s `[mesh]` phase) calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.odf import half_sphere
from ..device import resolve
from ..models.dti import _design_dti, _masked_wls, dti_maps
from ..models.gqi import _gqi_kernel_fused, gqi_design
from ..models.rumba import _build_kernel, _tv_fn, besseli_ratio
from ..ops.eig3 import eigh3
from ..ops.kernels.propagate import propagate_dir
from ..ops.peaks import build_neighbors
from .mesh import (ShardedRows, _move, as_mesh, map_shards, put_batch,
                   replicate, row_mean)

__all__ = ["build_constants", "full_recon_step"]


def build_constants(bval, bvec, odf_dirs):
    """Host-side constant operands for `full_recon_step`."""
    A_dti = _design_dti(bval, bvec)
    ib0 = (bval == bval.min()).astype(np.float32)
    A_gqi = gqi_design(bval, bvec, odf_dirs)
    kernel, _ = _build_kernel(bval, bvec, odf_dirs, 1.7e-3, 0.2e-3,
                              3.0e-3, 0.8e-4)
    _, verts_first, faces0 = half_sphere(odf_dirs)
    nbr, nbr_ok = build_neighbors(faces0, odf_dirs.nvert_half)
    return dict(A_dti=A_dti, ib0=ib0, A_gqi=A_gqi, kernel=kernel,
                verts_first=verts_first.astype(np.float32),
                nbr=nbr, nbr_ok=nbr_ok)


def _host(x):
    return x.cpu().numpy() if isinstance(x, (torch.Tensor, ShardedRows)) \
        else np.asarray(x)


def full_recon_step(signals, rumba_signal, fodf, sig2, lam_flat, tv_idx,
                    seeds, seed_vecs, mask_flat, ovecs_flat, A_dti, ib0,
                    A_gqi, kernel, verts_first, nbr, nbr_ok, shape3,
                    tv_shape3, mesh=None, device=None):
    """One step of every compute path.  The leading axes of `signals`,
    `rumba_signal`, `fodf`, `sig2`, `tv_idx` (each row's TV-grid cell),
    `seeds` and `seed_vecs` are batch axes: with `mesh` they are sharded
    over its data axis (host arrays are placed with `put_batch`,
    `ShardedRows` are used as they are), else they go to `device` (None:
    the card).  The other operands are host arrays, copied to every
    device.

    Returns (fa, odf, peaks, qa, fodf', sig2', lam', points, npts), as
    fibers_tpu.parallel.pipeline.full_recon_step does: the row outputs
    are `ShardedRows` on a mesh, tensors otherwise; lam' [prod(tv_shape3)]
    and the points [8, S, 3] are tensors (on the mesh's first device).
    QA is normalised by the max mean ODF of every shard and lambda by
    the mean sigma^2 of every row, as in the reference."""
    mesh = as_mesh(mesh)
    dev = resolve(device) if mesh is None else mesh.data_devices[0]

    def rows(x):
        if mesh is None:
            return x.to(dev) if isinstance(x, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if isinstance(x, ShardedRows):
            return x
        if len(x) % mesh.ndata:
            raise ValueError(f"full_recon_step: {len(x)} rows do not split "
                             f"evenly over {mesh.ndata} data shards")
        return put_batch(_host(x), mesh)

    def const(x):
        return replicate(np.ascontiguousarray(x), mesh, dev)

    signals, rsig, fodf, sig2 = (rows(x) for x in (signals, rumba_signal,
                                                   fodf, sig2))
    seeds, seed_vecs = rows(seeds), rows(seed_vecs)
    tv_idx = _host(tv_idx).astype(np.int64)
    kern = const(kernel)

    # --- DTI masked WLS + eigendecomposition ---
    def dti(s, A, w):
        d, valid = _masked_wls(s, A, w)
        evals, _ = eigh3(d[:, 0:6])
        _, _, fa = dti_maps(evals[:, 0], evals[:, 1], evals[:, 2])
        return torch.where(valid, fa, fa.new_zeros(()))
    fa = map_shards(dti, signals, const(A_dti), const(ib0))

    # --- GQI ODF + peaks: the fused kernel once per data shard ---
    odf, peaks, qa, _ = _gqi_kernel_fused(
        signals, const(np.asarray(A_gqi).T), const(verts_first),
        const(nbr), const(nbr_ok))

    # --- one RUMBA-SD Richardson-Lucy + TV update ---
    def rl_part(f, rs, s2, k):
        dodf = torch.matmul(f, k.T)
        dodf_sig = (rs * dodf) / s2
        iratio = besseli_ratio(1, dodf_sig)
        rl = torch.matmul(rs * iratio, k) / (torch.matmul(dodf, k) + 1e-7)
        resid = (rs ** 2 + dodf ** 2) / 2 - (s2 * dodf_sig) * iratio
        s2_new = torch.clamp(resid.sum(dim=1, keepdim=True) / rs.shape[1],
                             (1.0 / 80) ** 2, (1.0 / 8) ** 2)
        return rl, s2_new
    rl, sig2_new = map_shards(rl_part, fodf, rsig, sig2, kern)
    n_rows = fodf.shape[0]
    lam_h = _host(lam_flat).astype(np.float32)
    lam_d = const(lam_h)
    tv = _tv_fn(mesh, tv_idx, tuple(tv_shape3), n_rows, fodf.shape[1], False,
                dev)(fodf, lam_d)
    fodf_new = map_shards(lambda f, r, t: torch.clamp_min(f * r * t, 0.0),
                          fodf, rl, tv)
    lam_new = torch.clamp_min(row_mean(sig2_new, n_rows),
                              (1.0 / 30) ** 2).expand(lam_h.shape).contiguous()

    # --- a block of streamline-integration steps ---
    # stopping relies on mask-zeroed orientation vectors
    ov = const(np.asarray(ovecs_flat, np.float32)
               * np.asarray(mask_flat, np.float32)[:, None, None])
    cos45 = float(np.cos(np.radians(45.0)))
    if mesh is None:
        sets = [(seeds, seed_vecs, torch.zeros(seeds.shape[0],
                                               dtype=torch.int32,
                                               device=dev), ov)]
    else:
        sets = [(p, v, torch.zeros(p.shape[0], dtype=torch.int32,
                                   device=p.device), ov[p.device])
                for (_, p), (_, v) in zip(seeds.local(), seed_vecs.local())]
    out = [propagate_dir(*st, 8, tuple(shape3), 0.5, cos45, 0.2, 64)
           for st in sets]
    pts = torch.cat([_move(o[0], dev) for o in out], dim=1)
    if mesh is None:
        npts = out[0][2]
    else:
        it = iter(o[2] for o in out)
        npts = ShardedRows([None if s is None else next(it)
                            for s in seeds.shards], mesh, seeds.rows)
    return fa, odf, peaks, qa, fodf_new, sig2_new, lam_new, pts, npts
