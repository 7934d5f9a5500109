"""The DSI subject pipeline of `fibers_tpu_torch`.

A subject is one DWI volume on a Cartesian q-space lattice in host
memory (`portbench/lattice.py`) taken through the public API: `dsi_rec`
with its own upload (the configuration's `wire`), then, with the
traffic's `output` "maps", its three peak and three QA volumes brought
to host memory.  The PDF and ODF stay on the card, as a tracking or
group-analysis user leaves them.  Traced runs pass `timings=` and sum
its stages into the counters.

The check compares what the timed path produced for the traffic's
`checked` window subject with the float64 plain reference
(`portbench/reference/dsi.py`): the PDF and ODF (largest gap over the
largest reference value), the first peak's vertex and its QA.  The
control is that reference computed one precision down: the FFT's input
and the radial integral's PDF operand rounded to TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import lattice
from ..reference import dsi as ref_dsi
from ..reference.gqi import sphere
from .dti_gqi import Cell as _DtiCell

__all__ = ["Cell", "compare"]

# dsi_rec's `timings=` stages the counters sum (a build that lacks one
# leaves its counter out)
_STAGES = ("tables", "upload", "chunks", "finalize")


def compare(out, ref):
    """{number: value} of `out` (a program's or a control's outputs, rows
    in mask order) against `ref`, the float64 reference's."""
    pdf_r, odf_r = ref["pdf"], ref["odf"]
    same = (out["vecs"][:, 0].float() == ref["vecs"][:, 0].float()).all(-1)
    qa_gap = (out["qa"][:, 0].double() - ref["qa"][:, 0]).abs()
    return {
        "dsi_pdf_gap": float((out["pdf"].double() - pdf_r).abs().max()
                             / pdf_r.abs().max()),
        "dsi_odf_gap": float((out["odf"].double() - odf_r).abs().max()
                             / odf_r.abs().max()),
        "dsi_peak_flips": float((~same).double().mean()),
        "dsi_qa_gap": float(qa_gap[same].max()) if bool(same.any())
        else float("inf"),
    }


class Cell(_DtiCell):
    """One run's subjects of the DSI pipeline (the MRI wrapping and the
    host rows of the DTI + GQI pipeline's cell)."""

    def __init__(self, cfg, traffic, seed, checkdir, device="cuda"):
        import fibers_tpu_torch as tt
        self.tt, self.cfg, self.traffic = tt, cfg, traffic
        self.dev = torch.device(device)
        scan, fit = cfg["scan"], cfg["fit"]
        if traffic["output"] != "maps":
            raise ValueError("the DSI pipeline takes the maps traffic")
        self.bval, self.bvec = lattice.btable(scan)
        self.subjects = []
        for k in range(int(traffic["subjects"])):
            vol, mask = lattice.make_subject(scan, seed, k, self.dev)
            self.subjects.append((self._mri(vol.numpy(), self.bval,
                                            self.bvec), vol))
        self.mask_np = mask
        self.mask = tt.MRI.like(self.subjects[0][0], 1, np.float32)
        self.mask.vol = mask.astype(np.float32)
        self.sphere = getattr(tt, fit["sphere"])
        self.kept = None
        nfft, _, _ = ref_dsi.grid(self.bval, self.bvec, fit["hann_width"])
        self.facts = dict(n_voxels=int(mask.sum()), nvol=len(self.bval),
                          nvert=len(sphere(fit["sphere"])[0]) // 2,
                          nfft=nfft, nradii=len(ref_dsi.radii(nfft)[0]))
        self.counters = {}

    def subject(self, i, span):
        """Window subject `i` (-1: the warm-up), through the API."""
        fit = self.cfg["fit"]
        dwi = self.subjects[i % len(self.subjects)][0]
        timings = {} if getattr(span, "traced", False) else None
        with span("dsi"):
            out = self.tt.dsi_rec(dwi, self.mask, self.sphere,
                                  hann_width=fit["hann_width"],
                                  wire=fit["wire"], device=self.dev,
                                  timings=timings)
        if timings is not None and i >= 0:
            for k in _STAGES:
                if k in timings:
                    key = k + "_s"
                    self.counters[key] = self.counters.get(key, 0.0) \
                        + timings[k]
        with span("maps"):
            self.maps = [m.vol for m in out.peak + out.qa]
        if i == int(self.traffic["checked"]):
            self.kept = (i, out)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def release(self):
        """After the window: the checked subject's outputs to host rows
        (in mask order), and every other device tensor of the program
        dropped."""
        i, out = self.kept
        idx = np.flatnonzero(self.mask_np)

        def rows(v):
            v = v.vol
            return v.reshape(-1, v.shape[-1])[idx] if v.ndim == 4 \
                else v.reshape(-1)[idx]
        self.out_host = dict(
            pdf=rows(out.pdf), odf=rows(out.odf),
            vecs=np.stack([rows(p) for p in out.peak], 1),
            qa=np.stack([rows(q) for q in out.qa], 1))
        self.checked_subject = i
        self.kept = self.maps = None
        del out
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, k, prec):
        fit = self.cfg["fit"]
        return ref_dsi.fit(self.signals(k), self.bval, self.bvec,
                           fit["sphere"], fit["hann_width"], prec)

    def check(self):
        """The numbers compared, each with its limit: [(name, value,
        limit)]."""
        out = {k: torch.from_numpy(v).to(self.dev)
               for k, v in self.out_host.items()}
        self.out_host = None
        got = compare(out, self._reference(
            self.checked_subject % len(self.subjects), "ref"))
        self.numbers = got
        limits = self.cfg["limits"]
        return [(name, got[name], limits[name]) for name in limits
                if name in got]

    def control(self):
        """The numbers compared when the plain reference one precision
        down (TF32-rounded FFT input and PDF operand) stands in the
        program's place on the checked subject's input."""
        k = int(self.traffic["checked"]) % len(self.subjects)
        return compare(self._reference(k, "tf32"),
                       self._reference(k, "ref"))
