"""Build and load the port's hand-written CUDA kernels.

Every `.cu` source under `fibers_tpu_torch/csrc/` compiles in its own
`nvcc` process, all started together, and the objects link into one
shared library with a plain C interface, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds, not minutes).  The
library lands in `build/kernels/` at the repository root, named by a hash
of the sources and the flags, so an unchanged tree never rebuilds.  The
kernels build only from a checkout of the repository (or an editable
install of one): an installed copy of the package has no repository root
to build into, and raises.

There is no fallback: a missing `nvcc` or a failed build raises with the
compiler's output.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load_library", "build_dir"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_ROOT = os.path.dirname(_PKG)           # the checkout holding the package
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_log = ""          # the compiler's output of the build this process ran


def build_dir() -> str:
    """`build/kernels/` at the root of the checkout the package lies in."""
    if not os.path.isfile(os.path.join(_ROOT, "pyproject.toml")):
        raise RuntimeError(
            f"fibers_tpu_torch at {_PKG} is not inside a checkout of the "
            "repository: its CUDA kernels build only from a checkout or an "
            "editable install")
    return os.path.join(_ROOT, "build", "kernels")


def _sources(csrc):
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu"))
                  + glob.glob(os.path.join(csrc, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    return srcs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _build(csrc=_CSRC, out_dir=None) -> str:
    """The library built from the sources under `csrc` into `out_dir`
    (default `build_dir()`); its path."""
    global build_log
    srcs = _sources(csrc)
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    out_dir = out_dir or build_dir()
    so = os.path.join(out_dir, f"fibers_kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in srcs if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], None
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, out)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed is None:
            cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (proc.returncode, cmd, logs[-1])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_log = "".join(logs)
    if failed is not None:
        rc, cmd, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, so)
    return so


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gqi_fused_launch.argtypes = [vp] * 10 + [ci, ci, ci, ci, vp]
    lib.gqi_fused_launch.restype = ci
    lib.gqi_fused_smem_bytes.argtypes = [ci, ci, ci]
    lib.gqi_fused_smem_bytes.restype = ctypes.c_long
    lib.gqi_fused_rows_per_block.argtypes = [ci, ci, ci]
    lib.gqi_fused_rows_per_block.restype = ci
    lib.gqi_fused_scratch_bytes.argtypes = [ci, ci]
    lib.gqi_fused_scratch_bytes.restype = ctypes.c_long
    lib.tv_multiplier_launch.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, vp]
    lib.tv_multiplier_launch.restype = ci
    for name in ("tv_dimsem_launch", "tv_2slice_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    lib.tv_fused_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.tv_fused_launch.restype = ci
    u64 = ctypes.c_ulonglong
    for name in ("tv_rn_selfcheck", "tv_div_selfcheck"):
        fn = getattr(lib, name)
        fn.argtypes = [u64, u64, vp, vp]
        fn.restype = ci
    lib.tv_sweep_blocks_per_sm.argtypes = [ci]
    lib.tv_sweep_blocks_per_sm.restype = ci
    cf = ctypes.c_float
    lib.propagate_launch.argtypes = ([vp] * 4 + [ci] * 6 + [cf] * 4
                                     + [ci] * 3 + [cf] * 3 + [vp] * 7
                                     + [ci, ci, vp])
    lib.propagate_launch.restype = ci
    lib.propagate_resident_threads.argtypes = [ci, ci, ci]
    lib.propagate_resident_threads.restype = ci
    lib.propagate_sum3_selfcheck.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.propagate_sum3_selfcheck.restype = ci
    lib.propagate_micro_launch.argtypes = ([vp] * 7 + [ci] * 6 + [cf] * 5
                                           + [ci] * 3 + [cf] * 3 + [vp] * 5
                                           + [ci, vp])
    lib.propagate_micro_launch.restype = ci
    ll, cu = ctypes.c_longlong, ctypes.c_uint
    lib.propagate_micro_window_selfcheck.argtypes = [vp] * 3 + [ll] * 3 + [vp]
    lib.propagate_micro_window_selfcheck.restype = ci
    lib.propagate_lcm_launch.argtypes = ([vp] * 9 + [ci] * 8 + [cu] * 2
                                         + [cf] * 3 + [ci] * 3 + [cf] * 3
                                         + [vp] * 6 + [ci, vp])
    lib.propagate_lcm_launch.restype = ci
    lib.propagate_lcm_resident_threads.argtypes = [ci]
    lib.propagate_lcm_resident_threads.restype = ci
    lib.propagate_lcm_selfcheck.argtypes = [ci, vp, vp, ll, cu, cu, ci, vp]
    lib.propagate_lcm_selfcheck.restype = ci
    lib.rumba_update_launch.argtypes = [vp] * 4 + [ci, vp] + [ci] * 3 + [vp]
    lib.rumba_update_launch.restype = ci
    lib.rumba_refit_launch.argtypes = ([vp] * 7 + [ci] * 3 + [cf] * 3
                                       + [ci, vp])
    lib.rumba_refit_launch.restype = ci
    lib.rl_gemm_plane_words.argtypes = [ci, ci]
    lib.rl_gemm_plane_words.restype = ll
    lib.rl_pack_launch.argtypes = [vp] * 3 + [ci, ci, vp]
    lib.rl_pack_launch.restype = ci
    lib.rl_gemm_launch.argtypes = [vp] * 6 + [ll, ci, ci, ci, vp]
    lib.rl_gemm_launch.restype = ci


def load_library():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            _declare(lib)
            _lib = lib
    return _lib
