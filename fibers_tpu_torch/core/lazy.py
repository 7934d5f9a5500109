"""Lazily-materialized MRI volumes backed by torch tensors.

`MRI.vol` recognises lazy volumes with `isinstance(v, LazyVolume)`
against fibers_tpu.core.lazy.LazyVolume (fibers_tpu/core/mri.py:232-256),
so this class subclasses it.  Only `materialize` changes: the base class
fetches through the JAX package's transfer path; here the tensor's real
rows are copied to the host and scattered with the shared
`scatter_frames`.
"""

from __future__ import annotations

import numpy as np

from fibers_tpu.core.lazy import LazyVolume as _HostLazyVolume
from fibers_tpu.ops.masked import scatter_frames

__all__ = ["LazyVolume"]


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
