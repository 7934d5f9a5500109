"""Device resolution for the port's public entry points.

Every entry point takes `device=`.  `None` resolves once per process, to
`cuda` when `torch.cuda.is_available()` and to `cpu` otherwise; the
choice is recorded in `resolved` so a run can report where it ran.
Nothing here changes global state.

Precision: the reference runs its GEMMs at `Precision.HIGHEST`
(fibers_tpu/models/dti.py:95-105, fibers_tpu/models/gqi.py:87-88), so
`torch.backends.cuda.matmul.allow_tf32` must stay False (PyTorch's
default).  TF32 keeps ~10 mantissa bits and moves DTI fits by ~1e-2
relative.  The port never sets the flag; `chip_smoke.py` asserts it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve", "resolved"]

resolved = None     # the device `resolve(None)` chose, once it has run


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None -> cuda if available, else cpu."""
    global resolved
    if device is not None:
        return torch.device(device)
    if resolved is None:
        resolved = torch.device("cuda" if torch.cuda.is_available()
                                else "cpu")
    return resolved
