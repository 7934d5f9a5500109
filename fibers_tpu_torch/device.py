"""Device resolution for the port's public entry points.

Every entry point takes `device=`.  None means the card: `cuda`, and a
`RuntimeError` when `torch.cuda.is_available()` is false.  The CPU runs
only when the caller asks for it with `device="cpu"` (`--device cpu` on
the command line).  An entry point handed tensors that already lie on a
device (a `VoxelBatch`, `DevicePeaks`) follows them instead.  Nothing
here changes global state.

Precision: the reference runs its GEMMs at `Precision.HIGHEST`
(fibers_tpu/models/dti.py:95-105, fibers_tpu/models/gqi.py:87-88), so
`torch.backends.cuda.matmul.allow_tf32` must stay False (PyTorch's
default).  TF32 keeps ~10 mantissa bits and moves DTI fits by ~1e-2
relative.  The port never sets the flag; `chip_smoke.py` asserts it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None -> cuda, or raise without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fibers_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" (--device cpu on the command "
            "line) to run on the CPU")
    return torch.device("cuda")
