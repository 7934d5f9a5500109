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

import numpy as np
import torch

from .utils.profiling import count

__all__ = ["resolve", "upload", "fetch"]


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


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`.  To a CUDA device it goes through pinned
    memory as an asynchronous copy on the current stream, so the host
    does not wait for the card (a copy from pageable memory would)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def fetch(t) -> np.ndarray:
    """A tensor, or the rows of a `ShardedRows`, as a host array
    (`t.cpu().numpy()`: a copy from a CUDA device waits for the work
    queued before it).  The bytes copied from CUDA devices are added to
    the counter `transfer.d2h_bytes` (utils/profiling.py)."""
    for s in getattr(t, "shards", (t,)):
        if s is not None and s.is_cuda:
            count("transfer.d2h_bytes", s.nbytes)
    return t.cpu().numpy()
