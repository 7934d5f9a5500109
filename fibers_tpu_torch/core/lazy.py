"""Lazily-materialized volumes and arrays backed by torch tensors.

`MRI.vol` recognises lazy volumes with `isinstance(v, LazyVolume)`
against fibers_tpu.core.lazy.LazyVolume (fibers_tpu/core/mri.py:232-256),
so these classes subclass the host ones.  Only the fetch changes: the
base classes go through the JAX package's transfer path; here the
tensor is copied to the host (a volume's real rows, scattered with the
shared `scatter_frames`).
"""

from __future__ import annotations

import numpy as np
import torch

from fibers_tpu.core.lazy import LazyArray as _HostLazyArray
from fibers_tpu.core.lazy import LazyVolume as _HostLazyVolume
from fibers_tpu.ops.masked import scatter_frames

__all__ = ["LazyArray", "LazyVolume"]


class LazyVolume(_HostLazyVolume):
    """values: [n_pad, nframes] (or [n_pad]) torch tensor on any device,
    rows beyond len(idx) are padding; idx, shape3, nframes as in the base
    class."""

    def materialize(self) -> np.ndarray:
        if self._host is None:
            vals = self._values[:len(self._idx)].cpu().numpy()
            self._host = scatter_frames(vals, self._idx, self._shape3)
            self._values = None      # release device memory
        return self._host


class LazyArray(_HostLazyArray):
    """A torch tensor on any device that copies to the host on first
    access (`np.asarray`, indexing or `materialize`).  `.device` is the
    tensor itself until then, for consumers that stay on the device."""

    @property
    def dtype(self):
        if self._host is None:
            return torch.empty(0, dtype=self._values.dtype).numpy().dtype
        return self._host.dtype

    def materialize(self) -> np.ndarray:
        if self._host is None:
            self._host = self._values.cpu().numpy()
            self._values = None      # release device memory
        return self._host
