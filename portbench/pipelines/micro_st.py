"""The microscopy block chain of `fibers_tpu_torch`.

A subject is one image block in pinned host memory, as a lab reads it
from disk, taken through the public API: `st_recon(block, sigma, rho,
lazy=True)` (slab by slab on the card; its eigenvectors and eigenvalues
stay there), the primary eigenvector (column 0: the eigenvalues ascend)
taken on the card, then `stream(field, mask=, seed=)` in the microscopy
regime that the voxel size selects (ang 20, step 1, nsub 0, no
smoothing: the regime's defaults, left unset; search_dist 15 and
search_ang 10, the reference's defaults, as the configuration states
them) into a .trk on the point wire of the configuration.  The benchmark's
spans: `micro_st` around `st_recon` and the eigenvector, `micro_stream`
around `stream` and its writer.  No run opens the program's own tracer
(`profiling.collect()`): the profiler would draw its spans on the
device's row, where `portbench/trace.py` counts them busy.  Each window
subject's stream-steps are counted from the lines the sink received:
their points, and one final search a direction.

The check compares what the timed path produced for the traffic's
`checked` window subject with the plain references: the structure tensor
against the float64 reference run in slabs (`reference/block_st.py`),
the largest gap over the largest element; the share of masked voxels
whose primary eigenvector lies more than `dir_deg` from float64's, among
those whose two smallest eigenvalues differ by more than `eig_gap` of
the second; and every `line_every`-th seed's line of the .trk read back
against the plain cone search (`reference/micro.py`) from the program's
own field and mask, which tells, from the first len_min steps of every
seed, which seeds keep a line and so which line of the .trk is whose.
The control is the reference one precision down: the structure tensor
in bfloat16 and its primary eigenvectors, and the field and the
tracking in bfloat16.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import microscopy
from ..reference import block_st
from ..reference import micro as ref_micro
from ..reference import tract as ref_tract

__all__ = ["Cell"]


class Cell:
    """One run's subjects of the microscopy chain: the blocks, differing
    in noise only, the tissue mask and the seed lattice."""

    def __init__(self, cfg, traffic, seed, checkdir, device="cuda"):
        import fibers_tpu_torch as tt
        self.tt, self.cfg, self.traffic = tt, cfg, traffic
        self.dev = torch.device(device)
        if traffic["output"] != "trk":
            raise ValueError("the microscopy chain takes the trk traffic")
        blk, st = cfg["block"], cfg["stream"]
        self.shape3 = tuple(int(n) for n in blk["shape"])
        self.subjects = [microscopy.make_block(blk, seed, k, self.dev)
                         for k in range(int(traffic["subjects"]))]
        self.mask_np = microscopy.tissue_mask(blk, self.dev)
        self.mask = self._mri(self.mask_np.view(np.uint8))
        self.seed_vol = microscopy.seed_lattice(self.mask_np,
                                                st["seed_every"])
        self.seed = self._mri(self.seed_vol)
        self.checkpath = os.path.join(checkdir, "portbench_checked.trk")
        self.kept = None
        self.facts = dict(n_voxels=int(np.prod(self.shape3)),
                          window_cells=len(ref_micro.window(
                              st["search_dist"])[0]),
                          sigma=float(cfg["st"]["sigma"]),
                          rho=float(cfg["st"]["rho"]))
        self.counters = {"stream_steps": 0.0}

    def _mri(self, vol):
        res = float(self.cfg["block"]["voxel_mm"])
        m = self.tt.MRI(vol=vol)
        m.vox2ras0 = np.diag([res, res, res, 1.0]).astype(np.float32)
        m.volsize = np.asarray(self.shape3)
        m.width, m.height, m.depth = self.shape3
        m.nframes = 1
        m.set_geometry()
        return m

    def subject(self, i, span):
        """Window subject `i` (-1: the warm-up), through the API."""
        checked = i == int(self.traffic["checked"])
        ev, el, tr = self._chain(self.subjects[i % len(self.subjects)],
                                 span, self.checkpath if checked
                                 else os.devnull)
        if i >= 0:
            self.counters["stream_steps"] += float(
                int(tr.npts.sum()) + 2 * len(tr.npts))
        if checked:
            self.kept = (i, ev, el)

    def _chain(self, block, span, trk):
        """st_recon -> the primary eigenvector -> stream into `trk`;
        returns the lazy eigenvectors and eigenvalues and the Tract."""
        tt, st, sd = self.tt, self.cfg["st"], self.cfg["stream"]
        with span("micro_st"):
            ev, el = tt.st_recon(block.numpy(), st["sigma"], st["rho"],
                                 lazy=True, device=self.dev)
            field = ev.device[..., :, 0]
        with span("micro_stream"):
            tr = tt.stream(field, mask=self.mask, seed=self.seed, nsub=None,
                           ang_thresh=None, step_size=None,
                           smooth_coeff=None, search_dist=sd["search_dist"],
                           search_ang=sd["search_ang"], wire=sd["wire"],
                           trk_sink=trk)
        del field
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return ev, el, tr

    def release(self):
        """After the window: the checked subject's outputs stay on the
        card for the check; everything else of the program is dropped."""
        i, ev, el = self.kept
        self.kept = None
        self.out = (ev.device, el.device)
        self.checked_subject = i
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- #
    # the check
    # ---------------------------------------------------------------- #

    def _st_numbers(self, k, tensor_of):
        """(st_tensor_gap, st_dir_flips) of the tensors that `tensor_of(a,
        b)` gives for the planes [a, b) (six elements [p, Y, Z, 6] and
        their primary eigenvectors [p, Y, Z, 3]) against the float64
        reference of subject k's block."""
        chk, st = self.cfg["check"], self.cfg["st"]
        mask = torch.from_numpy(self.mask_np).to(self.dev)
        cos_max = float(np.cos(np.radians(chk["dir_deg"])))
        gap = top = 0.0
        flips = counted = 0
        for a, b in block_st.slabs(self.shape3[0], int(chk["slab"])):
            ref = block_st.tensor(self.subjects[k], a, b, st["sigma"],
                                  st["rho"], self.dev)
            six, vec = tensor_of(a, b)
            gap = max(gap, float((six.double() - ref).abs().max()))
            top = max(top, float(ref.abs().max()))
            m = mask[a:b]
            w, u = block_st.eigen(ref[m])
            sel = (w[:, 1] - w[:, 0]) > chk["eig_gap"] * w[:, 1].abs()
            cos = (vec[m][sel].double() * u[sel]).sum(-1).abs()
            flips += int((cos < cos_max).sum())
            counted += int(sel.sum())
            del ref, six, vec, w, u
        return gap / top, flips / max(counted, 1)

    def _program_tensor(self, a, b):
        evecs, evals = self.out
        v = evecs[a:b].double()
        s = torch.einsum("...ik,...k,...jk->...ij", v, evals[a:b].double(),
                         v)
        six = torch.stack([s[..., 0, 0], s[..., 0, 1], s[..., 0, 2],
                           s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]], -1)
        return six, evecs[a:b, ..., :, 0]

    def _field(self):
        """The program's own field [X*Y*Z, 3] and flat mask, as `stream`
        builds them from the timed path's eigenvectors."""
        mask = torch.from_numpy(self.mask_np).to(self.dev)
        f = (self.out[0][..., :, 0] * mask[..., None]).reshape(-1, 3)
        return f, mask.reshape(-1)

    def _track(self, field, mask, seeds, **kw):
        st = self.cfg["stream"]
        return ref_micro.track(
            field, mask, self.shape3, seeds, search_dist=st["search_dist"],
            search_ang=st["search_ang"], ang=st["ang"], step=st["step"],
            len_min=st["len_min"], **kw)

    def _checked_seeds(self):
        seeds = np.argwhere(self.seed_vol > 0)
        return seeds, np.arange(0, len(seeds), int(
            self.cfg["check"]["line_every"]))

    def check(self):
        """The numbers compared, each with its limit: [(name, value,
        limit)]."""
        k = self.checked_subject % len(self.subjects)
        gap, flips = self._st_numbers(k, self._program_tensor)
        got = {"st_tensor_gap": gap, "st_dir_flips": flips}
        field, mask = self._field()
        seeds, pick = self._checked_seeds()
        _, _, kept = self._track(field, mask, seeds,
                                 max_steps=self.cfg["stream"]["len_min"])
        pts, npts, _ = ref_tract.read_trk(self.checkpath)
        os.remove(self.checkpath)
        res = float(self.cfg["block"]["voxel_mm"])
        vox = np.rint(pts / np.float32(res) - 0.5).astype(np.int64)
        pick = pick[kept.numpy()[pick]]
        if len(npts) != int(kept.sum()):
            got["micro_lines_off"] = 1.0
        else:
            line = ref_micro.line_index(kept).numpy()[pick]
            off = np.concatenate([[0], np.cumsum(npts)])
            mine = np.concatenate([vox[off[j]:off[j + 1]] for j in line]
                                  + [vox[:0]])
            ref_pts, ref_n, _ = self._track(field, mask, seeds[pick])
            got["micro_lines_off"] = ref_tract.compare_lines(
                mine, npts[line], ref_pts, ref_n.numpy(), 0.0)
        self.numbers = got
        limits = self.cfg["limits"]
        return [(name, got[name], limits[name]) for name in limits
                if name in got]

    def control(self):
        """The numbers compared when the plain reference one precision
        down stands in the program's place on the checked subject: the
        structure tensor in bfloat16 and the primary eigenvectors of it,
        then the program's field and the tracking in bfloat16 against the
        float32 tracking of the same field."""
        k = self.checked_subject % len(self.subjects)
        st = self.cfg["st"]

        def bf16(a, b):
            six = block_st.tensor(self.subjects[k], a, b, st["sigma"],
                                  st["rho"], self.dev, torch.bfloat16)
            _, u = block_st.eigen(six.reshape(-1, 6))
            return six, u.reshape(six.shape[:-1] + (3,)).to(torch.bfloat16)
        gap, flips = self._st_numbers(k, bf16)
        field, mask = self._field()
        seeds, pick = self._checked_seeds()
        a_pts, a_n, _ = self._track(field, mask, seeds[pick],
                                    dtype=torch.bfloat16)
        r_pts, r_n, _ = self._track(field, mask, seeds[pick])
        return {"st_tensor_gap": gap, "st_dir_flips": flips,
                "micro_lines_off": ref_tract.compare_lines(
                    a_pts, a_n.numpy(), r_pts, r_n.numpy(), 0.0)}
