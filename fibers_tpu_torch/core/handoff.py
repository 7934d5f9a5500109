"""Device-resident fit->tract handoff.

Counterpart of fibers_tpu/core/handoff.py: a reconstruction's peak batch
stays on the device as a `DevicePeaks`, and `stream` builds its
orientation field from it with one scatter on the device, with no fetch
and no re-upload.  The peaks of a fit over a sharded batch stay sharded
(parallel/mesh.py:ShardedRows); `stream` gathers their rows onto the
device that builds the field.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve

__all__ = ["DevicePeaks", "split_unit_amp"]


@dataclass
class DevicePeaks:
    """Peak orientations of a fit, kept on the device.

    vecs: [N, npeak, 3] unit directions (zero rows = no peak).
    amp:  [N, npeak] per-peak amplitudes (GQI qa) — `stream` thresholds
          these at f_thresh.
    Both are tensors, or ShardedRows of a sharded fit.
    idx:  flat voxel indices (C order) of the N batch rows.
    ref:  an MRI carrying the geometry (shape, volres, vox2ras).
    """

    vecs: object
    amp: object
    idx: np.ndarray
    ref: object

    @property
    def shape3(self):
        return tuple(int(s) for s in self.ref.vol.shape[:3])

    @property
    def volres(self):
        return np.asarray(self.ref.volres)

    @property
    def nvec(self) -> int:
        return int(self.vecs.shape[1])

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    def first(self, k: int = 1) -> "DevicePeaks":
        """Restrict to the k strongest peaks (a view on the device)."""
        return DevicePeaks(vecs=self.vecs[:, :k], amp=self.amp[:, :k],
                           idx=self.idx, ref=self.ref)

    @classmethod
    def from_numpy(cls, vecs, amp, idx, ref, device=None) -> "DevicePeaks":
        """Peaks from host arrays, e.g. the JAX package's `DevicePeaks`
        fetched with np.asarray."""
        dev = resolve(device)
        return cls(vecs=torch.from_numpy(np.array(vecs, np.float32)).to(dev),
                   amp=torch.from_numpy(np.array(amp, np.float32)).to(dev),
                   idx=np.asarray(idx), ref=ref)


def split_unit_amp(vecs):
    """[N, npeak, 3] vectors with amplitude-scaled magnitude (RUMBA
    convention, reference src/rusd.jl:602-633) -> (unit vectors,
    amplitudes)."""
    a = torch.sqrt((vecs * vecs).sum(dim=-1))
    u = torch.where(a[..., None] > 0,
                    vecs / torch.clamp_min(a[..., None], 1e-30),
                    torch.zeros((), dtype=vecs.dtype, device=vecs.device))
    return u, a
