"""The DTI + GQI subject pipeline of `fibers_tpu_torch`.

A subject is one DWI volume in host memory taken through the public API:
`prepare_batch` -> `dti_fit` -> `gqi_rec` and then, with the traffic's
`output` "trk", `peaks_to_ovecs(device=True).first(npeaks)` -> `stream`
into a .trk; with "maps", the GQI peaks and QA are brought to host
memory beside the DTI maps that `dti_fit` returns there.

The check compares what the timed path produced for the traffic's
`checked` window subject with the plain references in
`portbench/reference/`: the tensor and FA of the DTI fit, the GQI ODF,
first peak and QA, and (trk) every line of the .trk read back against
the lines the reference tracks from the program's own first peaks and
FA mask, which the two comparisons before it check by themselves.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import phantoms
from ..reference import dti as ref_dti
from ..reference import gqi as ref_gqi
from ..reference import tract as ref_tract

__all__ = ["Cell", "compare", "reference_outputs"]


def _field(out, idx, nxyz, fa_thresh, f_thresh, npeaks, dev):
    """The orientation field [nxyz, npeaks, 3] that the tracking reads:
    the first `npeaks` peak vectors where FA >= fa_thresh and the peak's
    QA >= f_thresh, zero elsewhere."""
    vecs = out["vecs"][:, :npeaks].float()
    gate = (out["fa"].float() >= fa_thresh)[:, None] & (
        out["qa"][:, :npeaks].float() >= f_thresh)
    field = torch.zeros((nxyz, npeaks, 3), dtype=torch.float32, device=dev)
    field[torch.as_tensor(idx, device=dev)] = torch.where(
        gate[..., None], vecs, 0.0)
    return field


def reference_outputs(signals, scan, fit, prec):
    """The plain fits of `signals` [N, nvol] at `prec` ("ref" or "tf32"):
    the dict of outputs the comparison reads."""
    bval, bvec = phantoms.btable(scan)
    d = ref_dti.fit(signals, bval, bvec, prec)
    g = ref_gqi.fit(signals, bval, bvec, fit["sphere"], prec)
    return dict(tensor=d["tensor"], fa=d["fa"], odf=g["odf"],
                vecs=g["vecs"], qa=g["qa"])


def compare(out, ref, cfg, seed_vol, mask, lines=None, tract_dtype=None):
    """The numbers compared, as {name: value}: `out` (the program's or a
    control's outputs) against `ref`, the float64 reference fits.  With
    `lines` ((points mm [P, 3], npts [L]) of the .trk), or with
    `tract_dtype` (a control's own tracking, in that dtype), also the
    share of lines the float32 reference does not reproduce when it
    tracks from `out`'s own peaks and FA mask."""
    scan, st = cfg["scan"], cfg.get("stream")
    t_ref = ref["tensor"]
    scale = torch.clamp_min(torch.diagonal(t_ref, dim1=-2, dim2=-1)
                            .sum(-1) / 3, 1e-30)
    gap = (out["tensor"].double() - t_ref).abs().amax((-2, -1)) / scale
    odf_r = ref["odf"]
    v_out, v_ref = out["vecs"][:, 0].float(), ref["vecs"][:, 0].float()
    same = (v_out == v_ref).all(-1)
    qa_gap = (out["qa"][:, 0].double() - ref["qa"][:, 0]).abs()
    got = {
        "dti_tensor_gap": float(gap.max()),
        "dti_fa_gap": float((out["fa"].double() - ref["fa"]).abs().max()),
        "gqi_odf_gap": float((out["odf"].double() - odf_r).abs().max()
                             / odf_r.abs().max()),
        "gqi_peak_flips": float((~same).double().mean()),
        "gqi_qa_gap": float(qa_gap[same].max()) if bool(same.any())
        else float("inf"),
    }
    if lines is None and tract_dtype is None:
        return got
    dev = odf_r.device
    shape3 = tuple(scan["shape"])
    idx = np.flatnonzero(mask)
    field = _field(out, idx, int(np.prod(shape3)), st["fa_thresh"],
                   st["f_thresh"], st["npeaks"], dev)
    kw = dict(nsub=st["nsub"], step=st["step"], ang=st["ang"],
              smooth=st["smooth"], len_min=st["len_min"])
    pts_r, n_r, counts = ref_tract.track(field, shape3, seed_vol, **kw)
    mm = [scan["voxel_mm"]] * 3
    if lines is None:
        pts_c, n_c, _ = ref_tract.track(field, shape3, seed_vol,
                                        dtype=tract_dtype, **kw)
        lines = (ref_tract.to_mm(pts_c, mm), n_c.numpy())
    got["stream_lines_off"] = ref_tract.compare_lines(
        lines[0], lines[1], ref_tract.to_mm(pts_r, mm), n_r.numpy(),
        st["tol_mm"])
    got["_counts"] = counts
    return got


class Cell:
    """One run's subjects of the DTI + GQI pipeline.

    cfg: the configuration (its `scan`, `fit`, `stream`, `limits`);
    traffic: the mix (`output`, `subjects`, `checked`); `checkdir`: where
    the checked subject's .trk goes."""

    def __init__(self, cfg, traffic, seed, checkdir, device="cuda"):
        import fibers_tpu_torch as tt
        self.tt, self.cfg, self.traffic = tt, cfg, traffic
        self.dev = torch.device(device)
        scan = cfg["scan"]
        bval, bvec = phantoms.btable(scan)
        self.subjects = []
        for k in range(int(traffic["subjects"])):
            vol, mask = phantoms.make_subject(scan, seed, k, self.dev)
            self.subjects.append((self._mri(vol.numpy(), bval, bvec), vol))
        self.mask_np = mask
        self.mask = tt.MRI.like(self.subjects[0][0], 1, np.float32)
        self.mask.vol = mask.astype(np.float32)
        self.trk = traffic["output"] == "trk"
        self.checkpath = os.path.join(checkdir, "portbench_checked.trk")
        if self.trk:
            st = cfg["stream"]
            self.seed = tt.MRI.like(self.mask, 1, np.float32)
            self.seed_vol = phantoms.seed_voxels(mask, st["streams"],
                                                 st["nsub"])
            self.seed.vol = self.seed_vol
        self.sphere = getattr(tt, cfg["fit"]["sphere"])
        self.kept = None
        verts, faces = ref_gqi.sphere(cfg["fit"]["sphere"])
        self.facts = dict(n_voxels=int(mask.sum()), nvol=len(bval),
                          nvert=len(verts) // 2,
                          maxdeg=ref_gqi.neighbours(
                              faces, len(verts) // 2).shape[1])
        self.counters = {"writer_stall_s": 0.0}

    def _mri(self, vol, bval, bvec):
        tt = self.tt
        shape = tuple(self.cfg["scan"]["shape"])
        res = float(self.cfg["scan"]["voxel_mm"])
        dwi = tt.MRI(vol=vol)
        dwi.vox2ras0 = np.diag([res, res, res, 1.0]).astype(np.float32)
        dwi.volsize = np.asarray(shape)
        dwi.width, dwi.height, dwi.depth = shape
        dwi.nframes = vol.shape[3]
        dwi.set_geometry()
        dwi.bval, dwi.bvec = bval, bvec
        return dwi

    def subject(self, i, span):
        """Window subject `i` (-1: the warm-up), through the API."""
        tt = self.tt
        dwi = self.subjects[i % len(self.subjects)][0]
        checked = i == int(self.traffic["checked"])
        with span("batch"):
            batch = tt.prepare_batch(dwi, self.mask, device=self.dev,
                                     wire=self.cfg["fit"]["wire"])
        with span("dti"):
            dti = tt.dti_fit(dwi, self.mask, batch=batch)
        with span("gqi"):
            gqi = tt.gqi_rec(dwi, self.mask, self.sphere, batch=batch)
        if self.trk:
            from fibers_tpu_torch.tract.stream import writer_times
            st = self.cfg["stream"]
            writer_times.reset()
            with span("stream"):
                pk = tt.peaks_to_ovecs(gqi, device=True).first(
                    st["npeaks"])
                tract = tt.stream(
                    pk, fa=dti.fa, mask=self.mask, seed=self.seed,
                    nsub=st["nsub"], f_thresh=st["f_thresh"],
                    fa_thresh=st["fa_thresh"], step_size=st["step"],
                    ang_thresh=st["ang"], smooth_coeff=st["smooth"],
                    len_min=st["len_min"], wire=st["wire"],
                    trk_sink=self.checkpath if checked else os.devnull)
            if i >= 0:
                self.counters["writer_stall_s"] += writer_times.stall
        else:
            with span("maps"):
                self.maps = [m.vol for m in gqi.peak + gqi.qa]
        if checked:
            self.kept = (i, dti, gqi)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def release(self):
        """After the window: the checked subject's outputs to host rows
        (in mask order), and every other device tensor of the program
        dropped."""
        i, dti, gqi = self.kept
        idx = np.flatnonzero(self.mask_np)
        ev = [dti.eigval1.vol, dti.eigval2.vol, dti.eigval3.vol]
        vv = [dti.eigvec1.vol, dti.eigvec2.vol, dti.eigvec3.vol]
        lam = np.stack([v.reshape(-1)[idx] for v in ev], 1)
        vec = np.stack([v.reshape(-1, 3)[idx] for v in vv], 2)  # [N,3,k]
        self.out_host = dict(
            lam=lam, vec=vec, fa=dti.fa.vol.reshape(-1)[idx],
            odf=gqi.odf.vol.reshape(-1, gqi.odf.vol.shape[-1])[idx],
            vecs=np.stack([p.vol.reshape(-1, 3)[idx] for p in gqi.peak], 1),
            qa=np.stack([q.vol.reshape(-1)[idx] for q in gqi.qa], 1))
        self.checked_subject = i
        self.kept = None
        del dti, gqi
        torch.cuda.empty_cache()

    def signals(self, k):
        """The masked rows [N, nvol] of input subject k, on the card."""
        vol = self.subjects[k][1]
        rows = vol.reshape(-1, vol.shape[-1])[
            torch.from_numpy(np.flatnonzero(self.mask_np))]
        return rows.to(self.dev)

    def check(self):
        """The numbers compared, each with its limit: [(name, value,
        limit)]."""
        h = self.out_host
        d = self.dev
        lam = torch.from_numpy(h["lam"]).to(d, torch.float64)
        vec = torch.from_numpy(h["vec"]).to(d, torch.float64)
        out = dict(tensor=torch.einsum("nik,nk,njk->nij", vec, lam, vec),
                   fa=torch.from_numpy(h["fa"]).to(d),
                   odf=torch.from_numpy(h["odf"]).to(d),
                   vecs=torch.from_numpy(h["vecs"]).to(d),
                   qa=torch.from_numpy(h["qa"]).to(d))
        self.out_host = None
        k = self.checked_subject % len(self.subjects)
        sig = self.signals(k)
        ref = reference_outputs(sig, self.cfg["scan"], self.cfg["fit"],
                                "ref")
        del sig
        lines = None
        if self.trk:
            pts, npts, _ = ref_tract.read_trk(self.checkpath)
            os.remove(self.checkpath)
            lines = (torch.from_numpy(pts).to(d), npts)
        got = compare(out, ref, self.cfg, getattr(self, "seed_vol", None),
                      self.mask_np, lines=lines)
        counts = got.pop("_counts", None)
        if counts is not None:
            self.facts.update(streams_seeded=counts["streams"],
                              points=counts["points"],
                              visited=counts["visited"],
                              nvec=self.cfg["stream"]["npeaks"],
                              wire=self.cfg["stream"]["wire"])
        self.numbers = got
        limits = self.cfg["limits"]
        return [(name, got[name], limits[name]) for name in limits
                if name in got]

    def control(self):
        """The numbers compared when the plain reference itself, one
        precision below the configuration's, stands in the program's
        place on the checked subject's input: its fits with TF32
        products, and its own tracking in bfloat16 from its own peaks."""
        k = int(self.traffic["checked"]) % len(self.subjects)
        sig = self.signals(k)
        scan, fit = self.cfg["scan"], self.cfg["fit"]
        ref = reference_outputs(sig, scan, fit, "ref")
        out = reference_outputs(sig, scan, fit, "tf32")
        del sig
        got = compare(out, ref, self.cfg, getattr(self, "seed_vol", None),
                      self.mask_np,
                      tract_dtype=torch.bfloat16 if self.trk else None)
        got.pop("_counts", None)
        return got
