"""RUMBA-SD's TV multiplier fused with the mask embed and unembed: the
hand-written CUDA kernel and its plain PyTorch version.

Counterpart of fibers_tpu/ops/pallas/tv_fused.py.  It computes what
embedding the fODF rows into the dense [X, Y, Z, C] TV grid (zeros
outside the mask), the dense stencil (`tv_stencil.tv_multiplier`) and the
gather back to rows compute together, but reads the fODF row table and
writes multiplier rows without forming the grid.  The kernel is
`fibers_tpu_torch/csrc/tv_fused.cu`.

The tables are two index maps over the TV crop: `cellrow`, the row of
each crop cell (-1 outside the mask), and `rowcell`, the crop cell of
each mask row.  They are checked once, when built.

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
`tv_fused_plain`, the embed gather, `tv_multiplier_plain` and the unembed
gather: numerically the reference's unfused TV term
(fibers_tpu/models/rumba.py:301-316).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .tv_stencil import tv_multiplier_plain

__all__ = ["FusedTVTables", "build_tables", "tv_fused", "tv_fused_plain"]


@dataclass(frozen=True)
class FusedTVTables:
    """Index tables of the fused TV kernel over an (X, Y, Z) crop.

    cellrow: [X*Y*Z] int32, the row of each cell, -1 outside the mask.
    rowcell: [nmask] int32, the cell of each mask row.
    The two must be inverse maps on the mask; the constructor checks
    it."""

    cellrow: torch.Tensor
    rowcell: torch.Tensor
    shape3: tuple

    def __post_init__(self):
        ncell = int(np.prod(self.shape3))
        cr, rc = self.cellrow, self.rowcell
        if cr.dtype != torch.int32 or rc.dtype != torch.int32:
            raise TypeError("FusedTVTables: int32 tables expected")
        if cr.shape != (ncell,) or rc.dim() != 1:
            raise ValueError(f"FusedTVTables: cellrow {tuple(cr.shape)} / "
                             f"rowcell {tuple(rc.shape)} do not fit the "
                             f"crop {self.shape3}")
        if cr.device != rc.device:
            raise ValueError("FusedTVTables: tables on several devices")
        nmask = rc.shape[0]
        if nmask and (int(rc.min()) < 0 or int(rc.max()) >= ncell):
            raise ValueError("FusedTVTables: rowcell out of range")
        if int(cr.min()) < -1 or int(cr.max()) >= nmask:
            raise ValueError("FusedTVTables: cellrow out of range")
        rows = torch.arange(nmask, dtype=torch.int32, device=rc.device)
        if (int((cr >= 0).sum()) != nmask
                or not torch.equal(cr[rc.long()], rows)):
            raise ValueError("FusedTVTables: cellrow and rowcell are not "
                             "inverse maps on the mask")

    @property
    def nmask(self) -> int:
        return int(self.rowcell.shape[0])


def build_tables(idx_tv, tv_shape3, device=None) -> FusedTVTables:
    """Tables for the mask cells `idx_tv` (flat indices into the crop
    `tv_shape3`, one per mask row, in row order), on `device`."""
    idx_tv = np.asarray(idx_tv, np.int64)
    ncell = int(np.prod(tv_shape3))
    cellrow = np.full(ncell, -1, np.int32)
    cellrow[idx_tv] = np.arange(len(idx_tv), dtype=np.int32)
    dev = torch.device("cpu") if device is None else torch.device(device)
    return FusedTVTables(
        cellrow=torch.from_numpy(cellrow).to(dev),
        rowcell=torch.from_numpy(idx_tv.astype(np.int32)).to(dev),
        shape3=tuple(int(s) for s in tv_shape3))


def embed_index(tabs: FusedTVTables, pad_row: int) -> torch.Tensor:
    """Cell -> row gather index of the embed, with `pad_row` (a zero row
    appended to the rows) for cells outside the mask."""
    cr = tabs.cellrow.long()
    return torch.where(cr >= 0, cr, torch.full_like(cr, pad_row))


def tv_fused_plain(rows, lam3, tabs: FusedTVTables, out=None):
    """Plain PyTorch version of `tv_fused`: embed gather ->
    `tv_multiplier_plain` -> unembed gather.  Same arguments and result."""
    out = _out(rows, out)
    n, C = rows.shape
    X, Y, Z = tabs.shape3
    rows_p = torch.cat([rows, rows.new_zeros((1, C))])
    v = rows_p[embed_index(tabs, n)].reshape(X, Y, Z, C)
    tv = tv_multiplier_plain(v, lam3).reshape(X * Y * Z, C)
    out[:tabs.nmask] = tv[tabs.rowcell.long()]
    return out


def _out(rows, out):
    if out is None:
        return torch.ones_like(rows)
    if out.shape != rows.shape or out.dtype != torch.float32 \
            or out.device != rows.device or not out.is_contiguous():
        raise ValueError(f"tv_fused: out must be a contiguous float32 "
                         f"{tuple(rows.shape)} tensor on {rows.device}")
    return out


def _check(rows, lam3, tabs):
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise TypeError("tv_fused: rows must be a [R, C] float32 table")
    if tuple(lam3.shape) != tuple(tabs.shape3) \
            or lam3.dtype != torch.float32:
        raise ValueError(f"tv_fused: lam3 must be float32 {tabs.shape3}, "
                         f"got {lam3.dtype} {tuple(lam3.shape)}")
    if rows.shape[0] < tabs.nmask:
        raise ValueError(f"tv_fused: {rows.shape[0]} rows for "
                         f"{tabs.nmask} mask cells")
    devs = {rows.device, lam3.device, tabs.cellrow.device}
    if len(devs) != 1:
        raise ValueError(f"tv_fused: arguments on several devices {devs}")


def tv_fused(rows, lam3, tabs: FusedTVTables, out=None):
    """TV multiplier rows of the fODF row table `rows` [R, C] f32 (rows
    past tabs.nmask are padding; C any size) under the crop's [X, Y, Z]
    f32 weights `lam3`.

    Writes the multiplier of every mask row into `out` ([R, C] f32,
    allocated as ones when None; its padding rows are left as they are)
    and returns it."""
    _check(rows, lam3, tabs)
    if rows.device.type == "cpu":
        return tv_fused_plain(rows, lam3, tabs, out)
    if rows.device.type != "cuda":
        raise ValueError(f"tv_fused: no kernel for device {rows.device}")
    for what, t in (("rows", rows), ("lam3", lam3)):
        if not t.is_contiguous():
            raise ValueError(f"tv_fused: {what} must be contiguous")
    out = _out(rows, out)
    from ._build import load_library
    lib = load_library()
    X, Y, Z = tabs.shape3
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.tv_fused_launch(
            rows.data_ptr(), lam3.data_ptr(), tabs.cellrow.data_ptr(),
            tabs.rowcell.data_ptr(), out.data_ptr(), tabs.nmask, X, Y, Z,
            rows.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"tv_fused: kernel launch failed with cudaError "
                           f"{err} (rows {tuple(rows.shape)}, crop "
                           f"{tabs.shape3})")
    tv_fused.launches += 1
    return out


tv_fused.launches = 0
