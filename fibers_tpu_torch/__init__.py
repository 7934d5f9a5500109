"""fibers_tpu_torch — the fibers_tpu diffusion-MRI pipeline in PyTorch,
for NVIDIA Hopper GPUs.

The JAX package `fibers_tpu` is the reference; this package mirrors its
layout and public names.  It imports nothing of it: the host code (I/O,
MRI volumes, geometry, sphere tables, mask gather/scatter, the native C
helpers, the viewers) is this package's own copy, at the reference's
relative paths.  Importing this package never imports jax.  Entry points
run on the card unless the caller passes `device="cpu"` (device.py).

Every public name of `fibers_tpu` resolves here: the headline pipeline
(`prepare_batch`, `dti_fit`, `gqi_rec` with its hand-written CUDA kernel,
the device peak handoff and `stream`), RUMBA-SD (`rumba_rec`, with its
two hand-written TV kernels), DSI, the structure tensor, the LCM and
microscopy tractography modes, the single-line and single-step stream
API, and `python -m fibers_tpu_torch`.  Every `mesh=` shards the work
over a device mesh (`parallel/`: `make_mesh`, several shards on one card
or on the CPU, and `torch.distributed` across processes), and the
quantized wires: the u16/u12/u8 uploads (`prepare_batch`, `dsi_rec`,
RUMBA's `signal_wire`) and the i8/i6 point wires of `stream`.  Their
"auto" policies stay exact (float32) on the card, where the reference
quantizes on its accelerators; every named codec does what the
reference's does.
"""

from .core.geometry import (vox2ras_0to1, vox2ras_tkreg, vox2ras_to_orient,
                            vox2ras_to_qform)
from .core.mri import MRI, NIfTIHeader
from .core.odf import ODF, half_sphere
from .core.xform import (Xform, xfm_apply, xfm_compose, xfm_inv, xfm_read,
                         xfm_read_mat, xfm_rotate)
from .io.bruker import load_bruker
from .io.btables import (mri_read_bfiles, mri_read_bfiles_into,
                         normalize_bvecs)
from .io.dispatch import (mri_read, mri_read_struct, mri_write,
                          mri_write_struct)
from .io.filename import get_tmp_path, mri_filename
from .io.mgh import load_mgh, save_mgh
from .io.nifti import load_nifti, load_nifti_hdr, save_nifti
from .io.trk import Tract, str_add, str_merge, str_xform, trk_read, trk_write
from .utils.coords import (ang2rot, cart2pol, cart2sph, isinmask, pol2cart,
                           sph2cart)

# Reference-spelling alias (Fibers.jl exports `NIfTIheader`)
NIfTIheader = NIfTIHeader


def _settle_cpu_math():
    """PyTorch's CPU kernels of sqrt, exp, log and the other elementary
    functions on float tensors hand their work to MKL's vector math, in
    chunks on several threads.  The first call of such a function in a
    process, made from several threads at once, now and then computes one
    thread's chunk at about half the float's precision (~3e-4 relative;
    1-4% of fresh processes for sqrt, exp and log; never a later call).
    One call on one element, on this thread alone, settles it, so that a
    process's first CPU result is the one every later call gives: here
    for each such function the package calls."""
    import torch

    ops = (torch.sqrt, torch.exp, torch.log, torch.cos, torch.arccos)
    for dtype in (torch.float32, torch.float64):
        x = torch.full((1,), 0.5, dtype=dtype)
        for op in ops:
            op(x)


_settle_cpu_math()

_PORTED = {
    "fibers_tpu_torch.models.dti": ("DTI", "adc_fit", "dti_fit",
                                    "dti_fit_ls", "dti_maps", "dti_write"),
    "fibers_tpu_torch.models.gqi": ("GQI", "gqi_rec", "gqi_write",
                                    "find_peaks"),
    "fibers_tpu_torch.models.rumba": ("RUMBASD", "rumba_rec", "rumba_write",
                                      "rumba_peaks", "tensor_model",
                                      "besseli_ratio"),
    "fibers_tpu_torch.models.dsi": ("DSI", "dsi_rec", "dsi_write"),
    "fibers_tpu_torch.models.structens": ("st_recon", "st_eigen"),
    "fibers_tpu_torch.tract.stream": ("stream", "StreamConfig",
                                      "StreamWork", "stream_new_line",
                                      "stream_new_point",
                                      "stream_micro_new_point",
                                      "peaks_to_ovecs"),
    "fibers_tpu_torch.core.batch": ("VoxelBatch", "prepare_batch"),
    "fibers_tpu_torch.core.odf": ("sphere_362", "sphere_642", "sphere_724"),
    "fibers_tpu_torch.viz.show": ("LUT", "color_lut", "info", "disp",
                                  "show_slice", "vol_to_rgb", "view_axes"),
}

def __getattr__(name):
    import importlib

    for mod, names in _PORTED.items():
        if name in names:
            return getattr(importlib.import_module(mod), name)
    if name == "show":
        # the reference overloads Base.show for slice views
        from .viz.show import show_slice
        return show_slice
    if name == "view":
        from .viz.view import view
        return view
    raise AttributeError(name)


__version__ = "0.1.0"
