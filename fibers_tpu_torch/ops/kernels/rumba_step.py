"""RUMBA-SD's row passes around the Richardson-Lucy products: the
hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of the elementwise work that XLA fuses inside the reference's
iteration program, `fibers_tpu/models/rumba.py:_rumba_step_core` (the
body of `_rumba_block`'s `lax.fori_loop`).  One iteration runs

    num, den = x @ kernel, dodf @ kernel            (rl_gemm, one launch)
    fodf     = rumba_update(fodf, num, den, tv)
    dodf     = fodf @ kernel.T                      (rl_gemm)
    dodf_sig, sig2, x = rumba_refit(signal, dodf_sig, n_order, dodf, sig2)

where `x = signal * besseli_ratio(n_order, dodf_sig)` is the next
iteration's numerator operand.  The kernels are
`fibers_tpu_torch/csrc/rumba_step.cu`.

A CUDA tensor always goes to the kernel, or raises.  A CPU tensor goes to
the plain version, the torch expression the port ran before the kernels
(unchanged, so CPU results are what they were).  On the card every output
equals the plain version bit for bit, except `sig2`, whose row sum the
kernel takes in double in another order than torch (held to rtol 1e-6).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["besseli_ratio", "rumba_refit", "rumba_refit_plain",
           "rumba_update", "rumba_update_plain"]

# the noise variance's clamp (reference: src/rusd.jl:314-323)
SIG2_MIN = (1.0 / 80) ** 2
SIG2_MAX = (1.0 / 8) ** 2
_INT32_MAX = 2 ** 31 - 1


def besseli_ratio(nu, z):
    """I_nu(z) / I_{nu-1}(z) by Perron's continued fraction; z a number,
    numpy array or tensor.  (reference: src/rusd.jl:170-177)"""
    return z / ((2 * nu + z)
                - ((2 * nu + 1) * z
                   / (2 * z + (2 * nu + 1)
                      - ((2 * nu + 3) * z
                         / ((2 * nu + 2) + 2 * z
                            - ((2 * nu + 5) * z
                               / ((2 * nu + 3) + 2 * z)))))))


def rumba_update_plain(fodf, num, den, tv=None, out=None):
    """Plain PyTorch version of `rumba_update`.  Same arguments and
    result."""
    rl = num / (den + 1e-7)
    f = fodf * rl * tv if tv is not None else fodf * rl
    return torch.clamp_min(f, 0.0, out=out)


def rumba_refit_plain(signal, dodf_sig, n_order, dodf=None, sig2=None,
                      out=None):
    """Plain PyTorch version of `rumba_refit`.  Same arguments and
    results."""
    if dodf is not None:
        iratio = besseli_ratio(n_order, dodf_sig)
        dodf_sig = (signal * dodf) / sig2
        resid = ((signal ** 2 + dodf ** 2) / 2
                 - (sig2 * dodf_sig) * iratio)
        ndir = signal.shape[1]
        sig2 = resid.sum(dim=1, keepdim=True) / (n_order * ndir)
        sig2 = torch.clamp(sig2, SIG2_MIN, SIG2_MAX)
    return dodf_sig, sig2, torch.mul(signal, besseli_ratio(n_order,
                                                            dodf_sig),
                                     out=out)


def _rows(name, what, t, shape=None, strided=False):
    """Check a float32 [rows, cols] argument: of `shape` when given,
    contiguous unless `strided`."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
            or t.dim() != 2:
        raise TypeError(f"{name}: {what} must be a 2-D float32 tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not strided and not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _device(name, *ts):
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: arguments on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts if t is not None)


def rumba_update(fodf, num, den, tv=None, out=None):
    """The fODF update of one RUMBA-SD iteration over [N, C] f32 rows:
    max(fodf * (num / (den + 1e-7)) * tv, 0), NaN kept, with
    num = x @ kernel and den = dodf @ kernel (reference:
    src/rusd.jl:266-303).

    `tv` is the TV multiplier rows ([N, >= C] f32 whose rows are
    contiguous; None without TV).  The result goes into `out` ([N, C]
    f32, contiguous; a new tensor when None), which may be `fodf` or
    `num` itself: the port's iteration writes it over `num`'s buffer, in
    place, where the JAX version is pure.  Returns `out`."""
    name = "rumba_update"
    _rows(name, "fodf", fodf)
    shape = tuple(fodf.shape)
    _rows(name, "num", num, shape)
    _rows(name, "den", den, shape)
    if out is not None:
        _rows(name, "out", out, shape)
    ld = shape[1]
    if tv is not None:
        _rows(name, "tv", tv, strided=True)
        if tv.shape[0] != shape[0] or tv.shape[1] < shape[1] \
                or tv.stride(1) != 1:
            raise ValueError(f"{name}: tv {tuple(tv.shape)} (strides "
                             f"{tv.stride()}) does not hold rows of "
                             f"{shape}")
        ld = tv.stride(0)
    if shape[0] * max(shape[1], ld) > _INT32_MAX:
        raise ValueError(f"{name}: {shape} rows exceed the kernel's 32-bit "
                         "indices")
    dev = _device(name, fodf, num, den, tv, out)
    if dev.type == "cpu":
        return rumba_update_plain(fodf, num, den, tv, out)
    if out is None:
        out = torch.empty_like(fodf)
    vec = shape[1] % 4 == 0 and ld % 4 == 0 and _aligned(fodf, num, den, tv,
                                                          out)
    from ._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rumba_update_launch(
            fodf.data_ptr(), num.data_ptr(), den.data_ptr(),
            None if tv is None else tv.data_ptr(), ld, out.data_ptr(),
            shape[0], shape[1], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (rows {shape})")
    rumba_update.launches += 1
    return out


rumba_update.launches = 0


def rumba_refit(signal, dodf_sig, n_order, dodf=None, sig2=None, out=None):
    """The refit of one RUMBA-SD iteration over [N, ndir] f32 rows, after
    the product dodf = fodf @ kernel.T (reference: src/rusd.jl:305-323),
    and the next iteration's numerator operand.

    `dodf_sig` is the old ratio, from which this iteration's Bessel ratio
    ir = besseli_ratio(n_order, dodf_sig) is taken; `sig2` [N, 1] the old
    noise variance.  Returns (dodf_sig', sig2', x'):

        dodf_sig' = (signal * dodf) / sig2
        sig2'     = clamp(sum((signal^2 + dodf^2) / 2
                              - (sig2 * dodf_sig') * ir) / (n_order * ndir),
                          (1/80)^2, (1/8)^2)
        x'        = signal * besseli_ratio(n_order, dodf_sig')

    Without `dodf` (the first iteration, or a resumed checkpoint) it
    computes x' from the given `dodf_sig` alone and returns
    (dodf_sig, sig2, x') with the first two as given.  x' goes into `out`
    ([N, ndir] f32, contiguous, none of the inputs; the iteration passes
    its own x, dead by then), else a new tensor; the others are new
    tensors."""
    name = "rumba_refit"
    _rows(name, "signal", signal)
    shape = tuple(signal.shape)
    _rows(name, "dodf_sig", dodf_sig, shape)
    if dodf is not None:
        _rows(name, "dodf", dodf, shape)
        _rows(name, "sig2", sig2, (shape[0], 1))
    elif sig2 is not None:
        raise ValueError(f"{name}: sig2 without dodf")
    if out is not None:
        _rows(name, "out", out, shape)
        if any(t is not None and t.data_ptr() == out.data_ptr()
               for t in (signal, dodf_sig, dodf)):
            raise ValueError(f"{name}: out must not be an input")
    if shape[0] * shape[1] > _INT32_MAX:
        raise ValueError(f"{name}: {shape} rows exceed the kernel's 32-bit "
                         "indices")
    if int(n_order) != n_order or not 1 <= n_order < 2 ** 20:
        raise ValueError(f"{name}: n_order must be a positive integer, got "
                         f"{n_order!r}")
    dev = _device(name, signal, dodf_sig, dodf, sig2, out)
    if dev.type == "cpu":
        return rumba_refit_plain(signal, dodf_sig, n_order, dodf, sig2, out)
    x = torch.empty_like(signal) if out is None else out
    ds_new = s2_new = None
    if dodf is not None:
        ds_new = torch.empty_like(signal)
        s2_new = torch.empty_like(sig2)
    vec = _aligned(signal, dodf_sig, dodf, ds_new, x)
    ptr = (lambda t: None if t is None else t.data_ptr())
    # torch divides by a Python number as a multiply by its float
    # reciprocal on the card; the clamp bounds are rounded to float
    inv = float(np.float32(1.0) / np.float32(n_order * shape[1]))
    from ._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rumba_refit_launch(
            signal.data_ptr(), ptr(dodf), dodf_sig.data_ptr(), ptr(sig2),
            ptr(ds_new), ptr(s2_new), x.data_ptr(), shape[0], shape[1],
            int(n_order), inv, SIG2_MIN, SIG2_MAX, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (rows {shape})")
    rumba_refit.launches += 1
    if dodf is None:
        return dodf_sig, sig2, x
    return ds_new, s2_new, x


rumba_refit.launches = 0
