"""The RUMBA-SD subject chain of `fibers_tpu_torch`.

A subject is one DWI volume in host memory taken through the public API:
`rumba_rec` (the deconvolution, its u12 signal wire by default), then
`st_recon` on the mean DWI (lazy: its outputs stay on the card), then
`peaks_to_ovecs(rec, device=True)` -> `stream` of ~1M streams on the
configuration's point wire into a .trk.

The check compares what the timed path produced for the traffic's
`checked` window subject with the plain references: the fODF and GFA
after the fit (relative L2 gaps over every voxel: a fit's widest gap is
set by the rounding order of any two float32 fits, amplified over 600
iterations in a few voxels, and does not separate the precisions), its
first peak, the structure tensor, and every line of the .trk read back
against the lines the float32 reference tracks from the program's own
peaks (which the peak comparison checks by itself).
The control is the program's own "default" precision (one bf16 pass of
the products), with the structure tensor and the tracking of the
reference in bfloat16.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import phantoms
from ..reference import rumba as ref_rumba
from ..reference.gqi import sphere
from ..reference import structens as ref_st
from ..reference import tract as ref_tract
from .dti_gqi import Cell as _DtiCell

__all__ = ["Cell"]


def _unit(v):
    """Unit directions and amplitudes of amplitude-scaled peak vectors, as
    the program splits them."""
    a = torch.sqrt((v * v).sum(-1))
    u = torch.where(a[..., None] > 0, v / torch.clamp_min(a[..., None],
                                                          1e-30), 0.0)
    return u, a


class Cell(_DtiCell):
    """One run's subjects of the RUMBA-SD chain (the scan, the phantoms
    and the seeds as the DTI + GQI pipeline makes them)."""

    def __init__(self, cfg, traffic, seed, checkdir, device="cuda"):
        super().__init__(cfg, traffic, seed, checkdir, device)
        fit = cfg["fit"]
        verts, _ = sphere(fit["sphere"])
        nvert = len(verts) // 2
        _, crop = ref_rumba._crop(self.mask_np)
        bval, _ = phantoms.btable(cfg["scan"])
        self.facts = dict(n_voxels=int(self.mask_np.sum()),
                          ndir=int((bval != bval.min()).sum()) + 1,
                          ncomp=nvert + 2, nvert=nvert,
                          niter=int(fit["niter"]), crop=list(crop),
                          passes=3 if fit["precision"] == "high" else 1)
        self.counters = {"writer_stall_s": 0.0, "signal_s": 0.0,
                         "iterate_s": 0.0}

    def subject(self, i, span):
        """Window subject `i` (-1: the warm-up, on a few iterations),
        through the API."""
        fit = self.cfg["fit"]
        checked = i == int(self.traffic["checked"])
        rum, st_out = self._chain(
            self.subjects[i % len(self.subjects)][0], span,
            int(fit["warm_iter"]) if i < 0 else int(fit["niter"]),
            fit["precision"], self.checkpath if checked else os.devnull,
            count=i >= 0)
        if checked:
            self.kept = (i, rum, st_out)

    def _chain(self, dwi, span, niter, precision, trk, count=False):
        """rumba_rec -> st_recon on the mean DWI -> stream into `trk`;
        returns the fit and the structure tensor's lazy outputs."""
        tt, fit, st = self.tt, self.cfg["fit"], self.cfg["stream"]
        timings = {} if getattr(span, "traced", False) else None
        with span("rumba"):
            rum = tt.rumba_rec(
                dwi, self.mask, getattr(tt, fit["sphere"]), niter=niter,
                lam_para=fit["lam_par"], lam_perp=fit["lam_perp"],
                lam_csf=fit["lam_csf"], lam_gm=fit["lam_gm"],
                precision=precision, signal_wire=fit["signal_wire"],
                use_tv=fit["tv"], device=self.dev, timings=timings)
        if timings is not None and count:
            self.counters["signal_s"] += timings["signal"]
            self.counters["iterate_s"] += timings["iterate"]
        with span("structens"):
            st_out = tt.st_recon(np.asarray(dwi.vol).mean(axis=3),
                                 sigma=fit["st_sigma"], rho=fit["st_rho"],
                                 lazy=True, device=self.dev)
        from fibers_tpu_torch.tract.stream import writer_times
        writer_times.reset()
        with span("stream"):
            pk = tt.peaks_to_ovecs(rum, device=True)
            tt.stream(pk, mask=self.mask, seed=self.seed, nsub=st["nsub"],
                      f_thresh=st["f_thresh"], step_size=st["step"],
                      ang_thresh=st["ang"], smooth_coeff=st["smooth"],
                      len_min=st["len_min"], wire=st["wire"], trk_sink=trk)
        if count:
            self.counters["writer_stall_s"] += writer_times.stall
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return rum, st_out

    def _host(self, rum, st_out):
        """A fit's and structure tensor's outputs as host rows in mask
        order: fODF [N, nvert], GFA [N], peaks [N, 5, 3], and the
        structure tensor's eigenvectors [X, Y, Z, 3, 3] and ascending
        eigenvalues [X, Y, Z, 3]."""
        idx = np.flatnonzero(self.mask_np)
        fodf = rum.fodf.vol
        return dict(
            fodf=fodf.reshape(-1, fodf.shape[-1])[idx],
            gfa=rum.gfa.vol.reshape(-1)[idx],
            peaks=np.stack([p.vol.reshape(-1, 3)[idx] for p in rum.peak],
                           1),
            st_vec=np.asarray(st_out[0]), st_val=np.asarray(st_out[1]))

    def release(self):
        i, rum, st_out = self.kept
        self.out_host = self._host(rum, st_out)
        self.checked_subject = i
        self.kept = None
        del rum, st_out
        torch.cuda.empty_cache()

    def _reference(self, k):
        """The float32 reference fit of input subject k: (fODF [N, nvert],
        GFA [N], peak vectors [N, 5, 3]), and the float64 structure tensor
        of its mean DWI [X, Y, Z, 6]."""
        fit, scan = self.cfg["fit"], self.cfg["scan"]
        bval, bvec = phantoms.btable(scan)
        sig = ref_rumba.signal_rows(self.signals(k), bval,
                                    fit["signal_wire"])
        K = ref_rumba.kernel_matrix(bval, bvec, fit["sphere"],
                                    fit["lam_par"], fit["lam_perp"],
                                    fit["lam_csf"], fit["lam_gm"])
        fodf = ref_rumba.fit(sig, K, self.mask_np, int(fit["niter"]),
                             use_tv=fit["tv"])
        del sig
        full, f_iso, gfa = ref_rumba.post(fodf, K.shape[1] - 2)
        del fodf
        vecs, _ = ref_rumba.peaks(full, f_iso, fit["sphere"])
        mean = self.subjects[k][1].to(self.dev).double().mean(-1)
        ten = ref_st.tensor(mean, fit["st_sigma"], fit["st_rho"])
        return dict(fodf=full, gfa=gfa, peaks=vecs, st=ten)

    def _compare(self, out, ref, lines=None, tract_dtype=None):
        """{number: value} of `out` (device tensors: fodf, gfa, peaks, st)
        against the reference `ref`."""
        st, scan = self.cfg["stream"], self.cfg["scan"]
        u_o, _ = _unit(out["peaks"][:, 0].float())
        u_r, _ = _unit(ref["peaks"][:, 0].float())
        same = (u_o - u_r).abs().amax(-1) <= 1e-4
        f_ref, g_ref = ref["fodf"], ref["gfa"]
        s_ref = ref["st"]
        got = {
            "rumba_fodf_l2": float((out["fodf"] - f_ref).double().norm()
                                   / f_ref.double().norm()),
            "rumba_gfa_l2": float((out["gfa"] - g_ref).double().norm()
                                  / g_ref.double().norm()),
            "rumba_peak_flips": float((~same).double().mean()),
            "st_tensor_gap": float((out["st"].double() - s_ref).abs().max()
                                   / s_ref.abs().max()),
        }
        # tracking: the reference in float32 from out's own peaks
        shape3 = tuple(scan["shape"])
        idx = torch.from_numpy(np.flatnonzero(self.mask_np)).to(self.dev)
        u, a = _unit(out["peaks"].float())
        u = torch.where((a >= st["f_thresh"])[..., None], u, 0.0)
        field = torch.zeros((int(np.prod(shape3)),) + tuple(u.shape[1:]),
                            dtype=torch.float32, device=self.dev)
        field[idx] = u
        kw = dict(nsub=st["nsub"], step=st["step"], ang=st["ang"],
                  smooth=st["smooth"], len_min=st["len_min"])
        pts_r, n_r, counts = ref_tract.track(field, shape3, self.seed_vol,
                                             **kw)
        mm = [scan["voxel_mm"]] * 3
        if lines is None:
            pts_c, n_c, _ = ref_tract.track(field, shape3, self.seed_vol,
                                            dtype=tract_dtype, **kw)
            lines = (ref_tract.to_mm(pts_c, mm), n_c.numpy())
        got["stream_lines_off"] = ref_tract.compare_lines(
            lines[0], lines[1], ref_tract.to_mm(pts_r, mm), n_r.numpy(),
            st["tol_mm"])
        got["_counts"] = counts
        return got

    def _device_out(self, h):
        d = self.dev
        vec = torch.from_numpy(h["st_vec"]).to(d, torch.float64)
        val = torch.from_numpy(h["st_val"]).to(d, torch.float64)
        s = torch.einsum("...ik,...k,...jk->...ij", vec, val, vec)
        s = torch.stack([s[..., 0, 0], s[..., 0, 1], s[..., 0, 2],
                         s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]], -1)
        return dict(fodf=torch.from_numpy(h["fodf"]).to(d),
                    gfa=torch.from_numpy(h["gfa"]).to(d),
                    peaks=torch.from_numpy(h["peaks"]).to(d), st=s)

    def check(self):
        """The numbers compared, each with its limit: [(name, value,
        limit)].  The reference fit stays for `control`."""
        out = self._device_out(self.out_host)
        self.out_host = None
        k = self.checked_subject % len(self.subjects)
        ref = self._ref = self._reference(k)
        pts, npts, _ = ref_tract.read_trk(self.checkpath)
        os.remove(self.checkpath)
        got = self._compare(out, ref,
                            lines=(torch.from_numpy(pts).to(self.dev), npts))
        counts = got.pop("_counts")
        self.facts.update(streams_seeded=counts["streams"],
                          points=counts["points"], visited=counts["visited"],
                          nvec=ref_rumba.NPEAK,
                          wire=self.cfg["stream"]["wire"])
        self.numbers = got
        limits = self.cfg["limits"]
        return [(name, got[name], limits[name]) for name in limits
                if name in got]

    def control(self, precision="default"):
        """The numbers compared when the program runs its own next
        precision down (the products' one bf16 pass, "default") on the
        checked subject's input, beside the structure tensor and the
        tracking of the reference in bfloat16."""
        k = int(self.traffic["checked"]) % len(self.subjects)
        rum, st_out = self._chain(self.subjects[k][0], _quiet,
                                  int(self.cfg["fit"]["niter"]), precision,
                                  os.devnull)
        h = self._host(rum, st_out)
        del rum, st_out
        out = self._device_out(h)
        fit = self.cfg["fit"]
        mean = self.subjects[k][1].to(self.dev).double().mean(-1)
        out["st"] = ref_st.tensor(mean, fit["st_sigma"], fit["st_rho"],
                                  dtype=torch.bfloat16)
        ref = getattr(self, "_ref", None) or self._reference(k)
        got = self._compare(out, ref, tract_dtype=torch.bfloat16)
        got.pop("_counts", None)
        return got


def _quiet(name):
    """A span that records nothing (the control's run is not timed)."""
    return contextlib.nullcontext()
