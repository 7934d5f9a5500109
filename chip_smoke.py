#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
`fibers_tpu_torch/csrc/` and drives every ported path on the card:

- GQI: the kernel against its plain PyTorch version at the main path's
  shapes, with NaN rows, its top-3 and its ODF error against a float64
  product, timed beside the product alone; the headline pipeline
  (prepare_batch -> dti_fit -> gqi_rec -> device peaks -> 1M-seed stream
  -> .trk) on the HCP-scale phantom, with the GQI stage's split; the
  card's slice against the CPU's on a small phantom.  Before the timed
  pipeline, the step loops of the three tractography engines run with
  CUDA's sync debug mode set to "error": a step that makes the host wait
  for the card fails the run.
- RUMBA-SD: the four TV kernels (all instances of one x-sweep) against
  their plain versions, bit for bit, at RUMBA's shapes, the TV
  experiment's and ragged ones, after the self-check of their branch-free
  sqrt, 1/x and a/b against the IEEE intrinsics; the two row kernels of
  the iteration (`rumba_update`, `rumba_refit`) against their plain
  versions at config 4's shapes, bit for bit but for the noise variance,
  timed with their bounds, and one iteration split by operator
  (`[rumba-step]`); the Richardson-Lucy product kernel (`rl_gemm`, the
  reference's "high" 3-pass and "default" 1-pass bf16 routes on the
  tensor cores) against its plain version on the same state, all three
  products, a ragged slice with a NaN row, timed beside the f32 and bf16
  library products (`[rl-gemm]`); config 4 (600 iterations at full
  width, its signal on the u12 wire, each kernel's exact launch count)
  chained into ~1M streams and a .trk; a tv_bf16 run; 50 iterations
  through the kernels against the same fit through their plain versions
  (swapped in here: the row kernels alone at precision "highest", then
  all three at "high"), and against the same
  fit at "highest" (f32 products; "default" printed beside it), the
  last two held to the fit's rounding floor (the "highest" fit against
  itself with its products summed in another order); the card's slice
  against the CPU's on the small config-4 phantom.
- DSI (config 3 at full width, chained into ~1M streams), the structure
  tensor on config 4's volume and the CLI (`python -m fibers_tpu_torch
  dsi`/`structens`), with their card-against-CPU checks on small inputs.
  The DSI fit and the structure tensor launch none of the hand-written
  kernels (their counts must stay 0); the DSI chain's stream launches
  `propagate_pair` once a chunk.
- The LCM and microscopy modes (`[modes]` lines): the self-checks of
  their kernels' arithmetic against torch (the window sums of three;
  logf, the Gumbel transform of every uniform, the sum of ten, the
  argmax and the Philox uniforms); the first chunk of each mode's run
  (micro: its first 5,698 streams, the plain loop's own chunk, of the
  kernel's 131,072-stream chunk), kernel against plain step loop on both
  directions, bit for bit, one direction timed beside the plain loop
  with the bound, and the micro kernel alone on its whole first chunk;
  stream + write of LCM on a 256^2 slice (3 jitters a voxel) and
  microscopy on 256^2 x 2 through the kernels and through the plain
  loops, .trk byte for byte; microscopy on a 1024^2 x 2 slice through
  its kernel.  Each kernel launches twice a chunk; every launch of the
  LCM 256^2 and micro 1024^2 x 2 runs is timed with CUDA events.  The LCM
  kernel is also held to its plain loop at a budget that cuts most lines
  and timed on the first 32,768 and 65,536 streams of its chunk.  Then
  microscopy on a 3-D block, as the cell `micro_trk` runs it (the cell's
  phantom at 160 x 160 x 128, the primary eigenvectors of `st_recon`,
  search_dist 15 on 3-D vectors: 15,514 window cells, 8 of the kernel's
  tiles): in chunks of 6,144 streams every chunk's kernel outputs bit
  for bit against the plain loop, then at the card's chunk its launches
  counted and timed beside that run's bound, the two .trk files byte for
  byte.
- Wires (`[wire]` lines): the headline pipeline as bench.py:240-261
  writes it (the batch on the u12 upload wire, the points on the i6
  point wire) against the f32 run, and its i6 stream against f32 points
  of the same peaks, with each stage's time and the launches per
  propagation step of both point wires; the 600-iteration RUMBA fit's
  default u12 signal rows against the exact host signal, its signal
  stage beside an f32 one (the raw rows normalised on the card, held to
  the exact signal too), and its chain streamed on the i6 wire against
  f32 points.
- Tractography (`[propagate]` lines): the self-check of the propagation
  kernel's sum of three products against torch's on the card; one
  131,072-seed chunk of the main path's device peaks (1 vector a voxel)
  and of the RUMBA chain's (5), f32 and i6: the two-direction kernel
  (`propagate_pair`) and the one-direction kernel (`propagate_dir`, each
  direction) against the plain step loop, bit for bit on every output,
  also at a budget that cuts most lines; both directions timed beside the
  one-direction kernel launched for each, the plain loop and a CUDA-graph
  replay of it (a yardstick only this script builds), with the byte bound,
  the forward direction alone too, and on the main path the two-direction
  kernel at 32,768 to 262,144 seeds; and the
  stream + write of the main path, the RUMBA chain and DSI's chain
  through the kernel beside the plain loop (patched in here), their
  .trk files byte for byte.
- Mesh (`[mesh]` lines): on two cards when the host has them, else on
  two shards of card 0, the headline pipeline (its stream's chunks under
  the sync debug mode), RUMBA config 4 (20 iterations), DSI config 3,
  the structure tensor and one `full_recon_step`, each sharded against
  the unsharded run of the same call, with each kernel's launches on
  those paths (`gqi_fused` once per shard, `tv_multiplier` once per
  device and iteration, `tv_fused` never, `propagate_pair` once per shard
  and chunk, `propagate_dir` once per shard in `full_recon_step`).

Every phase raises on failure.  It imports no jax and nothing of the JAX
package `fibers_tpu`; without a CUDA device it fails.

Output: one line per phase with its wall time (the build's lines also
give each kernel's registers and the tractography kernels' resident
threads an SM); then a JSON line with the kernel records (launches on
the path and on the mesh paths, error against the plain version, kernel,
plain and bound times), the `nvidia-smi` name and power limit, and as
the last line `{"ok": true, "device": {...}}`.
"""

import contextlib
import filecmp
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# name, source, the Pallas call it replaces, and whether a fit's path
# launches it (the two TV-variant experiments are on no path)
KERNELS = [
    ("gqi_fused", "fibers_tpu_torch/csrc/gqi_fused.cu",
     "fibers_tpu/ops/pallas/gqi_fused.py:87", True),
    ("tv_fused", "fibers_tpu_torch/csrc/tv_fused.cu",
     "fibers_tpu/ops/pallas/tv_fused.py:320", True),
    ("tv_multiplier", "fibers_tpu_torch/csrc/tv_stencil.cu",
     "fibers_tpu/ops/pallas/tv_stencil.py:108", True),
    ("tv_dimsem", "fibers_tpu_torch/csrc/tv_stencil.cu",
     "benchmarks/exp_tv_variants.py:40", False),
    ("tv_2slice", "fibers_tpu_torch/csrc/tv_stencil.cu",
     "benchmarks/exp_tv_variants.py:99", False),
    ("propagate_pair", "fibers_tpu_torch/csrc/propagate.cu",
     "fibers_tpu/tract/stream.py:149 _propagate (lax.scan, XLA), both "
     "directions of a chunk", True),
    ("propagate_dir", "fibers_tpu_torch/csrc/propagate.cu",
     "fibers_tpu/tract/stream.py:149 _propagate (lax.scan, XLA), one "
     "direction (full_recon_step)", True),
    ("propagate_lcm_dir", "fibers_tpu_torch/csrc/propagate_lcm.cu",
     "fibers_tpu/tract/modes.py:47 _propagate_lcm (lax.scan, XLA)", True),
    ("propagate_micro_dir", "fibers_tpu_torch/csrc/propagate_micro.cu",
     "fibers_tpu/tract/modes.py:301 _propagate_micro (lax.scan, XLA)",
     True),
    ("rumba_update", "fibers_tpu_torch/csrc/rumba_step.cu",
     "fibers_tpu/models/rumba.py:343 _rumba_step_core (XLA, the body of "
     "_rumba_block's lax.fori_loop, :420): the fODF update", True),
    ("rumba_refit", "fibers_tpu_torch/csrc/rumba_step.cu",
     "fibers_tpu/models/rumba.py:343 _rumba_step_core (XLA, the body of "
     "_rumba_block's lax.fori_loop, :420): the noise-variance refit and "
     "the next Bessel ratio", True),
    ("rl_gemm", "fibers_tpu_torch/csrc/rl_gemm.cu",
     "fibers_tpu/models/rumba.py:343 _rumba_step_core (XLA): the R-L "
     "products at precision high/default", True),
]
# the GQI kernel's shapes: the main path's N, and a ragged N at maxdeg 6
# and 7 (sphere, rows); the first is timed
GQI_SHAPES = (("sphere_642", 720_896), ("sphere_642", 1_000),
              ("sphere_724", 1_000))
# the card's peaks for the bounds (H100 SXM data sheet): HBM bytes/s,
# FP32 FLOP/s outside the tensor cores, dense TF32 and bf16 tensor-core
# FLOP/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
BF16_FLOP_S = 989e12
# rl_gemm against its plain version, and against the float64 product of
# the bf16 parts both take, over sum_k |a_ik| |b_kj|: the two versions
# take the same products, add them to the f32 accumulator in the same
# chunks of K (rl_gemm.STEP) and differ only in the rounding of their sums
# (tests/test_torch_rl_gemm.py:F32_SUM)
RL_REL = 2e-6
# floating-point operations of one TV multiplier element, counting sqrt and
# divide as one each: the gradient (3 differences, 3 squares, 3 adds, sqrt,
# 1/norm, 3 products) and the output (3 differences, 2 adds, product,
# subtraction, abs, add, divide)
TV_FLOPS = 14 + 10
# floating-point operations of one element of RUMBA's row kernels
# (csrc/rumba_step.cu), a divide as one: Perron's fraction is 15 (5
# products, 6 sums, 4 divides); the refit takes it twice, with the ratio's
# product and divide, the residual's 7 and the row sum's add, and x's
# product; the first-iteration mode one fraction and x; the update an add,
# a divide, two products and the max
REFIT_FLOPS = 2 * 15 + 2 + 7 + 1 + 1
FIRST_FLOPS = 15 + 1
UPDATE_FLOPS = 5
# a fit through the kernels against the same fit through their plain
# versions (tests/test_torch_rumba.py:FIT), and the noise variance of one
# refit, which the kernel sums in another order (rtol 1e-6, ~8 ulps)
FIT = dict(rtol=1e-4, atol=1e-7)
SIG2_RTOL = 1e-6
# GFA is a std over an rms of near-uniform fODF rows (0.05-0.06 on config
# 4), so a relative fODF change moves it ~20x as much: FIT's rtol / 0.05
GFA_FIT = dict(rtol=2e-3, atol=1e-6)
# a config-4 fit's own sensitivity to rounding: after 50 iterations the
# f32 fit and the same fit with its products' sums over K taken in two
# halves differ by up to ~1.2e-6 on the fODF, past FIT on ~70 of its 259M
# values (PERF.md §6).  Two fits whose products differ by rounding
# alone are held to FLOOR_MARGIN times that distance, measured in the
# same run (`rounding_floor`)
FLOOR_MARGIN = 2
# shapes that cut the TV sweep kernels' 8 x 8 (y, z) tiles and 32-wide
# component chunks raggedly (tests/test_torch_tv.py:RAGGED); the last two
# (X = 2; X = 4 with Z < 8) are all prologue and epilogue of the two-slice
# ring
TV_RAGGED = [(1, 9, 11, 7), (2, 17, 10, 33), (5, 12, 19, 364), (3, 8, 8, 33),
             (2, 3, 5, 7), (4, 20, 9, 364), (2, 11, 4, 40), (4, 13, 5, 36)]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` back-to-back calls."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _wrappers():
    from fibers_tpu_torch.ops.kernels.gqi_fused import gqi_fused
    from fibers_tpu_torch.ops.kernels.tv_fused import tv_fused
    from fibers_tpu_torch.ops.kernels.tv_stencil import tv_multiplier
    from fibers_tpu_torch.ops.kernels.tv_variants import tv_2slice, tv_dimsem
    from fibers_tpu_torch.ops.kernels.propagate import (propagate_dir,
                                                        propagate_pair)
    from fibers_tpu_torch.ops.kernels.propagate_lcm import propagate_lcm_dir
    from fibers_tpu_torch.ops.kernels.propagate_micro import \
        propagate_micro_dir
    from fibers_tpu_torch.ops.kernels.rumba_step import (rumba_refit,
                                                         rumba_update)
    from fibers_tpu_torch.ops.kernels.rl_gemm import rl_gemm
    return dict(gqi_fused=gqi_fused, tv_fused=tv_fused,
                tv_multiplier=tv_multiplier, tv_dimsem=tv_dimsem,
                tv_2slice=tv_2slice, propagate_pair=propagate_pair,
                propagate_dir=propagate_dir,
                propagate_lcm_dir=propagate_lcm_dir,
                propagate_micro_dir=propagate_micro_dir,
                rumba_update=rumba_update, rumba_refit=rumba_refit,
                rl_gemm=rl_gemm)


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def device_values(mri):
    """The device tensor behind a port result volume that no host code
    has read yet (rows in mask order)."""
    return mri.__dict__["vol"]._values


def phase_device():
    import torch
    check(torch.cuda.is_available(),
          "no CUDA device; this script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 must stay False")
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    return smi


def phase_build():
    from fibers_tpu_torch.ops.kernels import _build
    t0 = time.time()
    _build.load_library()
    log(f"[build] {time.time() - t0:.2f} s (nvcc into {_build.build_dir()})")
    # ptxas -v: each kernel's registers, shared memory and spills
    for line in _build.build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry function" in line):
            log(f"[build]   {line.strip()}")
    # the tractography kernels' resident threads an SM (occupancy API)
    lib = _build.load_library()
    log("[build] resident threads an SM, points / deltas: " + ", ".join(
        f"propagate_{'pair' if pair else 'dir'} nvec {nvec} "
        + " / ".join(str(lib.propagate_resident_threads(pair, nvec, d))
                     for d in (0, 1))
        for pair in (1, 0) for nvec in (1, 3, 5, 2))
        + ", propagate_lcm_dir " + " / ".join(
            str(lib.propagate_lcm_resident_threads(d)) for d in (0, 1)))


def _tables(sphere):
    from fibers_tpu_torch.core.odf import half_sphere
    from fibers_tpu_torch.ops.peaks import build_neighbors
    _, _, faces0 = half_sphere(sphere)
    return build_neighbors(faces0, sphere.nvert_half)


def phase_kernel():
    """Kernel vs its plain version at the main path's shapes, a ragged N
    and maxdeg = 7, each with rows of no signal and rows with a NaN
    sample.  Returns the record of the main-path shape."""
    import numpy as np
    import torch
    from fibers_tpu_torch.core import odf as spheres
    from fibers_tpu_torch.models.gqi import gqi_design
    from fibers_tpu_torch.ops.kernels._build import load_library
    from fibers_tpu_torch.ops.kernels.gqi_fused import (gqi_fused,
                                                        gqi_fused_plain)
    from fibers_tpu_torch.ops.peaks import peak_mask
    from fibers_tpu_torch.utils.phantom import make_brain

    t0 = time.time()
    lib = load_library()
    probe, _, _ = make_brain(shape=(2, 2, 2))          # the 198-volume table
    rng = np.random.default_rng(1234)
    record = None
    for name, n in GQI_SHAPES:
        sphere = getattr(spheres, name)
        nbr, ok = _tables(sphere)
        nvol, nvert, maxdeg = len(probe.bval), sphere.nvert_half, nbr.shape[1]
        A_t = np.ascontiguousarray(
            gqi_design(probe.bval, probe.bvec, sphere).T)
        s = rng.uniform(-5.0, 100.0, (n, nvol)).astype(np.float32)
        s[::251] = -1.0                          # rows with no signal
        s[5::509, 7] = np.nan                    # rows with a NaN sample
        dev = [torch.from_numpy(x).cuda() for x in (s, A_t, nbr, ok)]
        odf, pm, st, vals, idx = gqi_fused(*dev)
        torch.cuda.synchronize()
        odf_p, _, st_p, _, _ = gqi_fused_plain(*dev)
        nan_rows = torch.isnan(dev[0]).any(dim=1)
        fin = ~nan_rows
        err = float((odf[fin] - odf_p[fin]).abs().max())
        torch.testing.assert_close(odf, odf_p, rtol=1e-5, atol=1e-4,
                                   equal_nan=True)
        torch.testing.assert_close(st, st_p, rtol=1e-5, atol=1e-4,
                                   equal_nan=True)
        check(torch.equal(st[:, 2], st_p[:, 2]), "valid flags differ")
        check(not bool(st[nan_rows, 2].any()) and bool(
            torch.isnan(odf[nan_rows]).all()),
              "a row with a NaN sample is valid or has a finite ODF")
        check(torch.equal(pm, peak_mask(odf, dev[2], dev[3])),
              "peak mask differs from the plain rule on the kernel's ODF")
        masked = torch.where(pm, odf, torch.zeros((), device=odf.device))
        top_v, top_i = torch.sort(masked, dim=1, descending=True,
                                  stable=True)
        check(torch.equal(vals, top_v[:, :3])
              and torch.equal(idx, top_i[:, :3]),
              "top-3 differs from a stable sort of the kernel's own ODF "
              "and mask")
        del masked, top_v, top_i
        # both ODFs against a float64 product, rows without NaN
        ref = torch.matmul(dev[0][fin].clamp_min(0.0).double(),
                           dev[1].double())
        e_k = float((odf[fin].double() - ref).abs().max())
        e_p = float((odf_p[fin].double() - ref).abs().max())
        del ref
        check(e_k <= 2 * e_p, f"the kernel's ODF error against float64 "
              f"{e_k:.3g} exceeds twice the plain f32 product's {e_p:.3g}")
        line = (f"[kernel] N={n} nvol={nvol} nvert={nvert} maxdeg={maxdeg} "
                f"({int(nan_rows.sum())} NaN rows; "
                f"{lib.gqi_fused_rows_per_block(nvol, nvert, maxdeg)} rows "
                f"and {lib.gqi_fused_smem_bytes(nvol, nvert, maxdeg)} B of "
                f"shared memory per block): max|odf-plain|={err:.3g}; "
                f"max|odf-f64| kernel {e_k:.3g}, plain f32 {e_p:.3g}; ok")
        if record is None:
            # s, the table and the neighbours in; ODF, mask, stats and
            # the top-3 out
            nbytes = sum(x.nbytes for x in (*dev, odf, pm, st, vals, idx))
            flops = 2 * n * nvol * nvert                          # s @ A_t
            del odf, pm, st, vals, idx, odf_p, st_p
            library = lambda: torch.matmul(dev[0].clamp_min(0.0), dev[1])
            gqi_fused(*dev)
            gqi_fused_plain(*dev)
            library()
            torch.cuda.synchronize()
            order = (gqi_fused_plain, gqi_fused, library, library, gqi_fused,
                     gqi_fused_plain)
            turns = [cuda_ms((lambda f=fn: f()) if fn is library
                             else (lambda f=fn: f(*dev)), 5)
                     for fn in order]
            ms = (turns[1] + turns[4]) / 2
            plain_ms = (turns[0] + turns[5]) / 2
            library_ms = (turns[2] + turns[3]) / 2
            bound = bound_ms(nbytes, 3 * flops, TF32_FLOP_S)
            fp32 = bound_ms(nbytes, flops)
            share = bound["bound_ms"] / ms
            line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                     f"product alone (torch.matmul, TF32 off) "
                     f"{library_ms:.3f} ms (turns plain, kernel, product, "
                     f"product, kernel, plain: "
                     f"{', '.join(f'{t:.3f}' for t in turns)}); bound "
                     f"3xTF32 {bound['bound_ms']:.3f} ms by "
                     f"{bound['bound_by']} ({nbytes / 1e9:.3f} GB, "
                     f"{3 * flops / 1e9:.1f} GFLOP), share {100 * share:.1f}"
                     f"%; FP32-FMA bound {fp32['bound_ms']:.3f} ms")
            check(share <= 1.0, f"the kernel beat its bound ({share:.3f})")
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms,
                          library_call="torch.matmul(s.clamp_min(0), A_t), "
                                       "TF32 off: the product alone",
                          **bound)
        log(line)
        del dev
        torch.cuda.empty_cache()
    log(f"[kernel] phase {time.time() - t0:.1f} s")
    return record


def _seed_mask(mask, target_seeds):
    """Seed voxels subsampled so nsub=3 jitters give ~target_seeds streams
    (as bench.py)."""
    import numpy as np
    from fibers_tpu_torch.core.mri import MRI
    seed = MRI.like(mask, 1, np.float32)
    idx = np.flatnonzero(mask.vol > 0)
    pick = idx[np.linspace(0, len(idx) - 1,
                           min(max(1, target_seeds // 3), len(idx)),
                           dtype=np.int64)]
    sv = np.zeros(mask.vol.size, np.float32)
    sv[pick] = 1
    seed.vol = sv.reshape(mask.vol.shape)
    return seed


def smoke_mesh():
    """The `[mesh]` phase's mesh: `make_mesh(2)` over two cards when the
    host has them, else two shards on card 0 (a device may repeat)."""
    import numpy as np
    import torch
    from fibers_tpu_torch.parallel.mesh import Mesh, make_mesh
    if torch.cuda.device_count() >= 2:
        return make_mesh(2), "make_mesh(2): cuda:0 and cuda:1"
    cuda0 = torch.device("cuda", 0)
    return (Mesh(np.array([cuda0, cuda0], dtype=object), ("data",)),
            "Mesh([cuda:0, cuda:0], ('data',)): two shards on one card")


def sync_all(mesh=None):
    """Wait for every card (those of `mesh`, else the current one)."""
    import torch
    for d in (mesh.distinct_devices() if mesh is not None else [None]):
        torch.cuda.synchronize(d)


def pipeline(dwi, mask, seed, device, trk, mesh=None, wire="f32",
             point_wire="f32"):
    """The bench.py:233-275 sequence on the port, sharded over `mesh`
    when given, with the batch's upload wire `wire` and the stream's
    point wire `point_wire` (bench.py's own: "u12" and "i6"); returns
    results and per-stage wall times (each stage ends in a
    synchronize)."""
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.tract.stream import writer_times

    def sync():
        if mesh is not None or torch.device(device).type == "cuda":
            sync_all(mesh)

    t = {}
    t0 = time.time()
    batch = tt.prepare_batch(dwi, mask, wire=wire, device=device,
                             mesh=mesh)
    sync()
    t["batch"] = time.time() - t0
    t1 = time.time()
    dti = tt.dti_fit(dwi, mask, batch=batch)
    t["dti"] = time.time() - t1
    t1 = time.time()
    gqi = tt.gqi_rec(dwi, mask, tt.sphere_642, batch=batch)
    sync()
    t["gqi"] = time.time() - t1
    t["fit"] = time.time() - t0
    t1 = time.time()
    pk1 = tt.peaks_to_ovecs(gqi, device=True).first(1)
    writer_times.reset()
    tract = tt.stream(pk1, fa=dti.fa, mask=mask, seed=seed, nsub=3,
                      f_thresh=0.0, wire=point_wire, trk_sink=trk, mesh=mesh)
    t["stream+write"] = time.time() - t1
    t["total"] = time.time() - t0
    # the .trk writer thread's seconds, and the stream loop's wait on it
    t["writer busy"], t["writer stall"] = writer_times.busy, \
        writer_times.stall
    return dti, gqi, tract, t


def gqi_split(dwi, mask):
    """The GQI stage of the main path replayed piece by piece on a batch
    of its own, each piece ending in a synchronize: host set-up
    (`gqi_design`, `half_sphere`, `build_neighbors`, the table uploads),
    the kernel (also on CUDA events), the finish (peak vectors, QA,
    odfmax), and `gqi_rec` whole on the same batch."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.core.odf import half_sphere
    from fibers_tpu_torch.models.gqi import _finish, gqi_design
    from fibers_tpu_torch.ops.kernels.gqi_fused import gqi_fused
    from fibers_tpu_torch.ops.peaks import build_neighbors

    batch = tt.prepare_batch(dwi, mask, wire="f32")
    torch.cuda.synchronize()
    sphere, cuda = tt.sphere_642, torch.device("cuda")
    split = {}
    for _ in range(2):                       # the second pass is reported
        t0 = time.perf_counter()
        A = gqi_design(np.asarray(dwi.bval, np.float32),
                       np.asarray(dwi.bvec, np.float32), sphere)
        _, vf, faces0 = half_sphere(sphere)
        nbr, ok = build_neighbors(faces0, sphere.nvert_half)
        vf = torch.from_numpy(np.ascontiguousarray(vf)).to(cuda)
        nb, okd = torch.from_numpy(nbr).to(cuda), torch.from_numpy(ok).to(cuda)
        A_t = torch.from_numpy(np.ascontiguousarray(A.T)).to(cuda)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        odf, _, st, vals, idx = gqi_fused(batch.signals, A_t, nb, okd)
        e1.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _finish(odf, vals, idx, vals > 0, st[:, 0], st[:, 1], st[:, 2] > 0,
                vf)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del odf, st, vals, idx
        tt.gqi_rec(dwi, mask, sphere, batch=batch)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        split = {"set-up": t1 - t0, "kernel": t2 - t1,
                 "kernel (events)": e0.elapsed_time(e1) / 1e3,
                 "finish": t3 - t2, "gqi_rec": t4 - t3}
    return split


class launches_must_not_sync:
    """Inside the block, every chunk's propagation (the `launch` that the
    stream's chunk loop calls) runs with CUDA's sync debug mode set to
    "error":
    a blocking copy or an `.item()` between two steps raises.  The
    compaction and the fetch around a launch wait for the card by design
    and run as they are.  `made` counts the guarded launches."""

    def __enter__(self):
        import torch
        from fibers_tpu_torch.tract import modes, stream as stream_mod
        self._mods, self._real, self.made = (stream_mod, modes), \
            stream_mod._drive, 0

        def drive(launch, *args, **kwargs):
            def guarded(lo):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = launch(lo)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                self.made += 1
                return out
            return self._real(guarded, *args, **kwargs)

        for mod in self._mods:
            mod._drive = drive
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod._drive = self._real


def phase_nosync():
    """The deterministic engine on a small cut of the main path (device
    peaks of a GQI fit), the LCM and the microscopy engine, every chunk's
    propagation under `launches_must_not_sync`: each engine's kernel
    launches, one a chunk (deterministic, both directions) or two (LCM,
    micro)."""
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.utils.phantom import (make_brain, make_lcm_field,
                                                make_micro_field)

    t0 = time.time()
    dwi, mask, _ = make_brain(shape=(24, 24, 16), ndir=34)
    gqi = tt.gqi_rec(dwi, mask, tt.sphere_642)
    ovecs, lcm, lmask = make_lcm_field((48, 48))
    mov, mmask = make_micro_field((40, 36, 2))
    reset_counts()
    with launches_must_not_sync() as guard:
        det = tt.stream(tt.peaks_to_ovecs(gqi, device=True).first(1),
                        mask=mask, nsub=3, f_thresh=0.0, wire="f32",
                        chunk=4096)
        n_det = guard.made
        lcm_t = tt.stream(ovecs, mask=lmask, lcms=lcm)
        mic = tt.stream(mov, mask=mmask, search_dist=15, **MICRO)
        # the guard does trip on a blocking copy
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.ones(3, device="cuda").cpu()
            tripped = False
        except RuntimeError:
            tripped = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts = read_counts()
    log(f"[nosync] chunk propagation under set_sync_debug_mode('error'): "
        f"{guard.made} chunks ({n_det} deterministic, then LCM and micro) "
        f"without a host sync; streams {det.n_count} / {lcm_t.n_count} / "
        f"{mic.n_count}; kernel launches {counts}; "
        f"{time.time() - t0:.1f} s")
    check(tripped, "the sync debug mode did not trip on a blocking copy")
    check(n_det >= 2 and guard.made >= n_det + 2, "a step loop did not run")
    check(counts["propagate_pair"] == n_det
          and counts["propagate_lcm_dir"] >= 2
          and counts["propagate_micro_dir"] >= 2
          and counts["propagate_lcm_dir"] + counts["propagate_micro_dir"]
          == 2 * (guard.made - n_det),
          f"the engines did not launch their kernels once (deterministic) "
          f"or twice (LCM, micro) a chunk: {counts}")
    check(min(det.n_count, lcm_t.n_count, mic.n_count) > 0,
          "an engine gave no streamlines under the sync check")


def phase_mesh_main(dwi, mask, seed, mesh, ref, back_ref, t_ref, d):
    """[mesh] The headline pipeline sharded over `mesh` (the stream's step
    loop under `launches_must_not_sync`), against the unsharded run 2 of
    the same call (`ref` = its dti, gqi and tract, `back_ref` its .trk
    read back).  Tolerances: FA within 1e-4 (C6's), the GQI ODF and QA
    bit-equal or within rtol 1e-4 / atol 2e-5 (tests/test_parallel.py's),
    peaks the same; the stream's npts equal and its points within 1e-6.
    Returns the kernels' launches on this path: gqi_fused once per shard,
    propagate_pair once per shard of each chunk."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt

    dti_r, gqi_r, tract_r = ref
    trk = os.path.join(d, "mesh.trk")
    reset_counts()
    with launches_must_not_sync() as guard:
        dti, gqi, tract, t = pipeline(dwi, mask, seed, "cuda", trk,
                                      mesh=mesh)
    counts = read_counts()
    log(f"[mesh] pipeline sharded over {mesh.ndata} shards: " + ", ".join(
        f"{k}={v:.3f} s" for k, v in t.items()) + "; unsharded run 2: "
        + ", ".join(f"{k}={v:.3f} s" for k, v in t_ref.items())
        + f"; launches {counts}; {guard.made} stream chunk launches under "
        "set_sync_debug_mode('error')")
    nprop = stream_chunks(3 * int((seed.vol > 0).sum()), mesh.ndata)
    check(counts["gqi_fused"] == mesh.ndata
          and counts["propagate_pair"] == nprop
          and sum(counts.values()) == mesh.ndata + nprop,
          f"the sharded pipeline launched {counts}, not gqi_fused once per "
          f"shard and propagate_pair {nprop} times")
    check(guard.made >= 1, "the sharded stream ran no guarded launch")

    m = mask.vol > 0
    fa, fa_r = dti.fa.vol, dti_r.fa.vol
    check(np.array_equal(np.isfinite(fa), np.isfinite(fa_r)),
          "FA finite on one run and not on the other")
    fin = m & np.isfinite(fa)
    dfa = float(np.abs(fa - fa_r)[fin].max())
    n = int(m.sum())
    odf = device_values(gqi.odf).gather()[:n]
    odf_r = device_values(gqi_r.odf)[:n]
    odf_eq = torch.equal(odf, odf_r)
    dodf = float((odf - odf_r).abs().max())
    torch.testing.assert_close(odf, odf_r, rtol=1e-4, atol=2e-5)
    del odf, odf_r
    qa_eq = all(np.array_equal(a.vol, b.vol)
                for a, b in zip(gqi.qa, gqi_r.qa))
    dqa = max(float(np.abs(a.vol - b.vol).max())
              for a, b in zip(gqi.qa, gqi_r.qa))
    pk_eq = all(np.array_equal(a.vol, b.vol)
                for a, b in zip(gqi.peak, gqi_r.peak))
    for a, b in zip(gqi.qa + gqi.peak, gqi_r.qa + gqi_r.peak):
        np.testing.assert_allclose(a.vol, b.vol, rtol=1e-4, atol=2e-5)
    back = tt.trk_read(trk)
    same_n = np.array_equal(np.asarray(back.npts), np.asarray(back_ref.npts))
    dpts = float(np.abs(back.packed_xyz - back_ref.packed_xyz).max()) \
        if same_n and back.packed_xyz.shape == back_ref.packed_xyz.shape \
        else float("inf")
    log(f"[mesh] pipeline against unsharded: max|dFA|={dfa:.3g}; ODF "
        f"{'bit-equal' if odf_eq else f'max|d|={dodf:.3g}'}; QA "
        f"{'bit-equal' if qa_eq else f'max|d|={dqa:.3g}'}; peaks "
        f"{'bit-equal' if pk_eq else 'within rtol 1e-4 / atol 2e-5'}; "
        f"streams {tract.n_count} / {tract_r.n_count}, npts "
        f"{'equal' if same_n else 'differ'}, max|dpts| in the .trk "
        f"{dpts:.3g}")
    check(dfa <= 1e-4, f"sharded FA differs by {dfa}")
    check(tract.n_count == tract_r.n_count and same_n,
          "the sharded stream's line lengths differ from the unsharded")
    check(dpts <= 1e-6, f"the sharded stream's points differ by {dpts}")
    return counts


# the i6 point wire's bound at bench.py's 0.5-voxel step: 2 * step / 31
I6_BOUND = 2 * 0.5 / 31


class sink_seconds:
    """Host seconds spent in the .trk sink's appends while the block runs:
    the float32 records' packing (`TrkSink.append`) or the delta wires'
    fused native decode into records (`append_deltas`, `append_deltas6`),
    file writes included; they run on the stream's writer thread.
    `fused` counts the fused calls; `busy` and `stall` are the writer
    thread's seconds (decode, packing, write) and the stream loop's wait
    on it (`tract/stream.py:writer_times`)."""

    NAMES = ("append", "append_deltas", "append_deltas6")

    def __enter__(self):
        from fibers_tpu_torch.io.trk import TrkSink
        from fibers_tpu_torch.tract.stream import writer_times
        writer_times.reset()
        self.seconds, self.fused = 0.0, 0
        self._saved = {n: getattr(TrkSink, n) for n in self.NAMES}

        def timed(name, fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.seconds += time.perf_counter() - t0
                    self.fused += name != "append"
            return wrapper

        for name, fn in self._saved.items():
            setattr(TrkSink, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        from fibers_tpu_torch.io.trk import TrkSink
        from fibers_tpu_torch.tract.stream import writer_times
        self.busy, self.stall = writer_times.busy, writer_times.stall
        for name, fn in self._saved.items():
            setattr(TrkSink, name, fn)


# the stream's chunk, and the floating-point operations of one active
# step of a stream in the propagation kernel, counting sqrt and divide as
# one each: the next position (6), one candidate (3 products, 2 sums,
# abs, compare: 7 each), the sign flip (3), the angle (5), the smoothing
# (6 products, 3 sums, the squares' 5, sqrt, clamp, 3 divides: 19); the
# delta quantizer adds 3 differences, 3 products, 3 roundings, 6 clamps
# and 3 double sums (18)
CHUNK = 131_072
PROP_FLOPS_STEP, PROP_FLOPS_CAND, PROP_FLOPS_DELTA = 33, 7, 18


def stream_chunks(nseeds, shards=1):
    """propagate_pair's launches for a stream of `nseeds` seeds: both
    directions of each chunk in one launch per shard."""
    return shards * -(-nseeds // CHUNK)


class plain_loop:
    """Inside the block, the three engines' propagation runs the plain
    step loops (`propagate_pair_plain`, `propagate_lcm_dir_plain`,
    `propagate_micro_dir_plain`) on the card, as the port did before its
    kernels, and the micro mode at the plain loop's chunk (the
    reference's rule, which sizes its [S, W, 3] window tensors): for
    timing beside the kernels, never in the port."""

    def __enter__(self):
        from fibers_tpu_torch.ops.kernels import (propagate,
                                                  propagate_lcm,
                                                  propagate_micro)
        from fibers_tpu_torch.tract import modes, stream as stream_mod
        self._slots = [(stream_mod, "propagate_pair"),
                       (modes, "propagate_lcm_dir"),
                       (modes, "propagate_micro_dir"),
                       (modes, "_micro_chunk")]
        self._real = [getattr(mod, name) for mod, name in self._slots]
        plains = [propagate.propagate_pair_plain,
                  propagate_lcm.propagate_lcm_dir_plain,
                  propagate_micro.propagate_micro_dir_plain,
                  lambda cfg, nwin, device: modes._reference_chunk(cfg,
                                                                   nwin)]
        for (mod, name), plain in zip(self._slots, plains):
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for (mod, name), real in zip(self._slots, self._real):
            setattr(mod, name, real)


def step_launches(work, seeds):
    """Device launches and copies of one chunk of `seeds` voxels, each
    point wire: through the kernel, per chunk (the profiler's CUDA events
    of one `propagate_chunk`); through the plain loop (`plain_loop`), per
    step: the events at 2 steps less those at 1, over the 2 x 1 steps of
    the two directions."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fibers_tpu_torch.tract.stream import propagate_chunk

    subs = np.zeros_like(seeds)
    cos45 = float(np.cos(np.radians(45.0)))

    def events(nsteps, emit, qscale, dmax):
        def run():
            return propagate_chunk(seeds, subs, work.ovec_flat, work.shape3,
                                   nsteps, 0.5, cos45, 0.2, 1000, emit,
                                   qscale, dmax)

        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    out = {}
    for wire, emit, qscale, dmax in (("f32", "points", 254.0, 127),
                                     ("i6", "deltas", 31 / 0.5, 31)):
        kernel = events(2, emit, qscale, dmax)
        with plain_loop():
            per_step = (events(2, emit, qscale, dmax)
                        - events(1, emit, qscale, dmax)) / 2
        out[wire] = dict(kernel_chunk=kernel, plain_step=per_step)
    return out


def graph_ms(fn, reps):
    """Device time of a CUDA-graph replay of `fn()` (captured once after
    a warm call on a side stream), and the captured outputs after one
    replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    return cuda_ms(g.replay, reps), out, g


def _same_bits(a, b):
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _max_err(outs, refs):
    return max(float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(outs, refs))


def stream_seeds(work, seed):
    """The seeds of `stream()` on `work`: each voxel of `seed` with the
    nsub jitters of `seed_rng` (tract/stream.py:stream)."""
    import numpy as np
    from fibers_tpu_torch.tract.stream import _seed_voxels
    from fibers_tpu_torch.utils.prng import prng_key, uniform
    vox = _seed_voxels(work.mask_array, seed).astype(np.float32)
    subs = uniform(prng_key(work.cfg.seed_rng), (work.nsub, 3),
                   -0.5 + 1e-6, 0.5 - 1e-6)
    return np.repeat(vox, len(subs), axis=0), np.tile(subs, (len(vox), 1))


def propagate_args(work, wire):
    """propagate_dir's arguments after the field as `stream()` passes
    them on `work` with the point wire `wire`."""
    import numpy as np
    from fibers_tpu_torch.tract.stream import _wire_mode
    work.cfg.wire = wire
    _, emit, qscale, dmax = _wire_mode(work.cfg, work.step_size)
    return (int(work.len_max) + 2, work.shape3, float(work.step_size),
            float(np.cos(np.radians(work.ang_thresh))),
            float(work.smooth_coeff), int(work.len_max), emit, qscale, dmax)


def phase_sum3():
    """[propagate] The propagation kernel's sum of three products against
    torch's `Tensor.sum` on the card, and torch's sum against the three
    orders of a sum of three terms."""
    import torch
    from fibers_tpu_torch.ops.kernels.propagate import sum3_selfcheck
    t0 = time.time()
    mism = sum3_selfcheck()
    n = 1 << 22
    g = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn((n, 3), generator=g, device="cuda") * torch.exp2(
        torch.randint(-20, 21, (n, 3), generator=g, device="cuda").float())
    p0, p1, p2 = p.unbind(-1)
    total = p.sum(dim=-1)
    orders = {"(p0 + p2) + p1": (p0 + p2) + p1,
              "(p0 + p1) + p2": (p0 + p1) + p2,
              "p0 + (p1 + p2)": p0 + (p1 + p2)}
    log(f"[propagate] self-check of the kernel's sum of three products "
        f"((0 + p0) + (0 + p2)) + (0 + p1) against torch's (a * b).sum(-1) "
        f"on the card, 2^22 [3] rows and [2^20, 4, 3] candidates: {mism} "
        f"mismatches; torch's sum of 2^22 [3] rows against the orders: "
        + ", ".join(f"{k} {int((total != v).sum())} differ"
                    for k, v in orders.items())
        + f" ({time.time() - t0:.2f} s)")
    check(mism == 0, "the propagation kernel sums three products in "
          "another order than torch on the card")


class visited_voxels:
    """Inside the block, the plain loop of the kernel module `module`
    (default `ops/kernels/propagate.py`) counts in `hits` [nvox] the
    in-bounds voxels it gathers (its `_flat_index`).  A stopped stream
    keeps its position and direction, so it gathers again the voxel of
    its last active step: the voxels hit are those the kernel reads."""

    def __init__(self, nvox, device, module=None):
        import torch
        from fibers_tpu_torch.ops.kernels import propagate
        self.hits = torch.zeros(nvox, dtype=torch.int32, device=device)
        self.module = module or propagate

    def __enter__(self):
        import torch
        prop_mod = self.module
        self._real = real = prop_mod._flat_index
        hits = self.hits

        def counted(ipos, shape3):
            flat, inb = real(ipos, shape3)
            hits.index_add_(0, flat.reshape(-1),
                            inb.reshape(-1).to(torch.int32))
            return flat, inb

        prop_mod._flat_index = counted
        return self

    def __exit__(self, *exc):
        self.module._flat_index = self._real


# the main path's budget-binding case: a budget of this many points cuts
# most lines of the first chunk
BUDGET = 24
# stream counts of the two-direction kernel's scaling line
SCALING = (32_768, 65_536, 131_072, 262_144)


def phase_propagate(name, work, seed, scaling=False):
    """[propagate] The first chunk (CHUNK seeds) of `work`'s stream from
    `seed`, f32 and i6: the two-direction kernel (`propagate_pair`) and
    the one-direction kernel on each direction against the plain loop,
    bit for bit on every output, and the two-direction kernel again at a
    budget of BUDGET points, which cuts most lines; then the two
    directions timed with CUDA events in turns plain / kernel / kernel /
    plain, beside the one-direction kernel launched for each, a
    CUDA-graph replay of the plain loop's two directions (its outputs
    checked too) and the bound of the directions' bytes and operations;
    the forward direction alone the same way.  The bytes count the
    field's voxels each direction visits (`visited_voxels`), not the whole
    field; the operations its active stream-steps.  With `scaling`, the
    two-direction kernel's time at SCALING streams of the same run.
    Returns {wire: {"pair": record, "dir": record}}."""
    import torch
    from fibers_tpu_torch.ops.kernels.propagate import (
        propagate_dir, propagate_dir_plain, propagate_pair,
        propagate_pair_plain)
    from fibers_tpu_torch.tract.stream import _seed_state

    t0 = time.time()
    seeds, subs = stream_seeds(work, seed)
    ov = work.ovec_flat
    n = SCALING[-1] if scaling else CHUNK
    pos_all, v_all = _seed_state(seeds[:n], subs[:n], ov, work.shape3)
    pos0, v0 = pos_all[:CHUNK], v_all[:CHUNK]
    neg = -v0
    zero = torch.zeros(len(pos0), dtype=torch.int32, device=pos0.device)
    nvec = ov.shape[1]
    records = {}
    for wire in ("f32", "i6"):
        args = propagate_args(work, wire)
        nsteps = args[0]
        pair = propagate_pair(pos0, v0, zero, ov, *args)
        fwd = propagate_dir(pos0, v0, zero, ov, *args)
        torch.cuda.synchronize()
        hits = []
        with visited_voxels(ov.shape[0], ov.device) as seen:
            fwd_p = propagate_dir_plain(pos0, v0, zero, ov, *args)
        hits.append(seen.hits)
        with visited_voxels(ov.shape[0], ov.device) as seen:
            bwd_p = propagate_dir_plain(pos0, neg, fwd_p[2], ov, *args)
        hits.append(seen.hits)
        bwd = propagate_dir(pos0, neg, fwd_p[2], ov, *args)
        want = fwd_p + bwd_p[:3]
        same = [_same_bits(a, b) for a, b in zip(pair, want)]
        same_one = [_same_bits(a, b) for a, b in zip(fwd + bwd,
                                                     fwd_p + bwd_p)]
        err = _max_err(pair + fwd + bwd, want + fwd_p + bwd_p)
        check(all(same) and all(same_one),
              f"{name} {wire}: a kernel differs from the plain loop "
              f"(two-direction outputs equal: {same}; one-direction: "
              f"{same_one}; max|d| {err})")
        # the budget-binding case, both directions
        cut = args[:5] + (BUDGET,) + args[6:]
        got, ref = (propagate_pair(pos0, v0, zero, ov, *cut),
                    propagate_pair_plain(pos0, v0, zero, ov, *cut))
        same_cut = [_same_bits(a, b) for a, b in zip(got, ref)]
        ncut = int((ref[6] > BUDGET).sum())
        check(all(same_cut) and ncut > len(pos0) // 10,
              f"{name} {wire}: at a budget of {BUDGET} points the "
              f"two-direction kernel differs from the plain loop "
              f"({same_cut}) or the budget cut only {ncut} lines")
        del got, ref
        # the quantizer does not steer: both wires visit the same voxels
        # in the same steps.  A stream is active at step t + 1 exactly
        # when it advanced at step t.
        if wire == "f32":
            nvisit = [int((h > 0).sum()) for h in hits]
            nvisit_pair = int(((hits[0] + hits[1]) > 0).sum())
            steps = []
            for out in (fwd_p[0], bwd_p[0]):
                moved = (out[1:] != out[:-1]).any(dim=-1)
                steps.append(len(pos0) + int(moved.sum()))
                del moved
        del hits, seen, bwd, fwd_p, bwd_p, want

        def kern():
            return propagate_pair(pos0, v0, zero, ov, *args)

        def plain():
            return propagate_pair_plain(pos0, v0, zero, ov, *args)

        def one():
            nf = propagate_dir(pos0, v0, zero, ov, *args)[2]
            return propagate_dir(pos0, neg, nf, ov, *args)

        def kern_fwd():
            return propagate_dir(pos0, v0, zero, ov, *args)

        def plain_fwd():
            return propagate_dir_plain(pos0, v0, zero, ov, *args)

        kern()
        one()
        plain()
        torch.cuda.synchronize()
        turns = [cuda_ms(plain, 3), cuda_ms(kern, 20), cuda_ms(kern, 20),
                 cuda_ms(plain, 3)]
        one_ms = (cuda_ms(one, 20) + cuda_ms(one, 20)) / 2
        turns_fwd = [cuda_ms(plain_fwd, 3), cuda_ms(kern_fwd, 20),
                     cuda_ms(kern_fwd, 20), cuda_ms(plain_fwd, 3)]
        g_ms, g_out, graph = graph_ms(plain, 10)
        g_same = all(_same_bits(a, b) for a, b in zip(g_out, pair))
        del graph, g_out
        check(g_same, f"{name} {wire}: the graph replay of the plain loop "
              "differs from the kernel")
        state = pos0.nbytes + v0.nbytes + zero.nbytes
        vox = ov.shape[1] * 3 * ov.element_size()
        per_step = PROP_FLOPS_STEP + nvec * PROP_FLOPS_CAND + (
            PROP_FLOPS_DELTA if wire == "i6" else 0)
        nbytes = state + nvisit_pair * vox + sum(t.nbytes for t in pair)
        flops = (steps[0] + steps[1]) * per_step
        whole = bound_ms(nbytes - nvisit_pair * vox + ov.nbytes, flops)
        rec = dict(max_abs_err=err, ms=(turns[1] + turns[2]) / 2,
                   plain_ms=(turns[0] + turns[3]) / 2, graph_ms=g_ms,
                   two_launches_ms=one_ms, streams=len(pos0), nsteps=nsteps,
                   nvec=nvec, active_steps=steps, voxels_visited=nvisit_pair,
                   voxels=ov.shape[0], nbytes=nbytes, flops=flops,
                   bound_ms_whole_field=whole["bound_ms"],
                   budget_case=dict(len_max=BUDGET, lines_cut=ncut),
                   **bound_ms(nbytes, flops))
        nbytes_f = state + nvisit[0] * vox + sum(t.nbytes for t in fwd)
        rec_f = dict(max_abs_err=err, ms=(turns_fwd[1] + turns_fwd[2]) / 2,
                     plain_ms=(turns_fwd[0] + turns_fwd[3]) / 2,
                     streams=len(pos0), nsteps=nsteps, nvec=nvec,
                     active_steps=steps[0], voxels_visited=nvisit[0],
                     nbytes=nbytes_f, flops=steps[0] * per_step,
                     **bound_ms(nbytes_f, steps[0] * per_step))
        records[wire] = dict(pair=rec, dir=rec_f)
        log(f"[propagate] {name} {wire}: {len(pos0)} streams x {nsteps} "
            f"steps, nvec {nvec}: the two-direction kernel and the "
            f"one-direction kernel on each direction bit-equal to the plain "
            f"loop, and the two-direction kernel at a budget of {BUDGET} "
            f"points ({ncut} lines cut); both directions: kernel "
            f"{rec['ms']:.3f} ms in one launch ({rec['ms'] / 2:.4f} ms a "
            f"direction), the one-direction kernel launched for each "
            f"{one_ms:.3f} ms, plain loop {rec['plain_ms']:.3f} ms, its "
            f"CUDA-graph replay {g_ms:.3f} ms (turns plain, kernel, kernel, "
            f"plain: {', '.join(f'{t:.3f}' for t in turns)}); bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({nbytes / 1e6:.1f} MB with {nvisit_pair} of the field's "
            f"{ov.shape[0]} voxels visited; {flops / 1e9:.3f} GFLOP over "
            f"{steps[0]} + {steps[1]} active stream-steps), share "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}%; reading the whole "
            f"field {whole['bound_ms']:.4f} ms, share "
            f"{100 * whole['bound_ms'] / rec['ms']:.1f}%")
        log(f"[propagate] {name} {wire}: the forward direction alone: "
            f"kernel {rec_f['ms']:.3f} ms, plain loop "
            f"{rec_f['plain_ms']:.3f} ms (turns "
            f"{', '.join(f'{t:.3f}' for t in turns_fwd)}); bound "
            f"{rec_f['bound_ms']:.4f} ms by {rec_f['bound_by']} "
            f"({nbytes_f / 1e6:.1f} MB, {nvisit[0]} voxels visited), share "
            f"{100 * rec_f['bound_ms'] / rec_f['ms']:.1f}%")
        if scaling:
            zs = torch.zeros(len(pos_all), dtype=torch.int32,
                             device=pos0.device)
            ms = [cuda_ms(lambda k=k: propagate_pair(
                pos_all[:k], v_all[:k], zs[:k], ov, *args), 10)
                for k in SCALING if k <= len(pos_all)]
            rec["scaling_ms"] = dict(zip(SCALING, ms))
            log(f"[propagate] {name} {wire}: the two-direction kernel at "
                + ", ".join(f"{k} streams {t:.4f} ms" for k, t
                            in rec["scaling_ms"].items()))
        del fwd, pair
        torch.cuda.empty_cache()
    log(f"[propagate] {name}: phase {time.time() - t0:.1f} s")
    return records


def kernel_vs_plain(name, run, d, tag="[propagate]"):
    """stream + write of `run(trk)` through the kernel, through the plain
    loop (`plain_loop`), and through the kernel again, each ending in a
    synchronize; the plain and second kernel .trk files against the
    first, byte for byte.  Returns (kernel seconds, both runs; plain
    seconds; the kernels' launches in the first run)."""
    import torch
    from fibers_tpu_torch.tract.stream import writer_times
    times, paths, writer = [], [], []
    for i, plain in enumerate((False, True, False)):
        trk = os.path.join(d, f"{name}_{i}.trk")
        reset_counts()
        writer_times.reset()
        t0 = time.time()
        with plain_loop() if plain else contextlib.nullcontext():
            run(trk)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        writer.append(f"{writer_times.busy:.3f} / {writer_times.stall:.3f}")
        if i == 0:
            counts = read_counts()
        paths.append(trk)
    equal = [filecmp.cmp(paths[0], p, shallow=False) for p in paths[1:]]
    for p in paths:
        os.remove(p)
    log(f"{tag} {name} stream+write: kernel {times[0]:.3f} / "
        f"{times[2]:.3f} s, plain loop {times[1]:.3f} s; .trk of the plain "
        f"loop {'byte-equal' if equal[0] else 'DIFFERS'}, of the kernel's "
        f"second run {'byte-equal' if equal[1] else 'DIFFERS'}; .trk writer "
        f"thread busy / the loop's stall on it: kernel {writer[0]} s, "
        f"{writer[2]} s, plain loop {writer[1]} s; launches {counts}")
    check(all(equal), f"{name}: the .trk through the kernel differs from "
          "the plain loop's")
    return (times[0], times[2]), times[1], counts


def phase_wire_main(dwi, mask, seed, ref, t_ref, sink_ref, d):
    """[wire] The headline pipeline as bench.py:240-261 writes it: the
    batch on the u12 wire, the stream on the i6 wire into a .trk, its
    step loops under `launches_must_not_sync`.  Held against run 2 of the
    f32 pipeline of the same call (`ref`, its stage times `t_ref`, its
    sink's `sink_seconds` `sink_ref`): the GQI ODF within rtol 1e-3 / atol
    1e-5 (tests/test_transfer.py:98-116), FA within 1e-3 on 90% of the
    mask (on this phantom's near-zero DWI samples along the fibres a
    grid step of max/4095 moves the log-linear fit: the JAX package's
    u12 batch is the same bit for bit, tests/test_torch_wire.py), the
    stream count within 0.5% (a u12 fit may move a peak or an FA
    threshold); and its i6 stream against an f32 stream of the same
    peaks: equal stream count and npts, .trk points within 2 * step / 31.
    gqi_fused launches once, propagate_pair once a chunk.  Returns the
    kernels' launches."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.tract.stream import StreamWork

    dti_r, gqi_r, tract_r = ref
    trk = os.path.join(d, "wire.trk")
    # warm run: the decode's and the quantizer's first launches
    pipeline(dwi, mask, seed, "cuda", trk, wire="u12", point_wire="i6")
    reset_counts()
    with launches_must_not_sync() as guard, sink_seconds() as sk:
        dti, gqi, tract, t = pipeline(dwi, mask, seed, "cuda", trk,
                                      wire="u12", point_wire="i6")
    counts = read_counts()
    nprop = stream_chunks(3 * int((seed.vol > 0).sum()))
    check(counts["gqi_fused"] == 1 and counts["propagate_pair"] == nprop
          and sum(counts.values()) == 1 + nprop,
          f"the u12/i6 pipeline launched {counts}, not gqi_fused once and "
          f"propagate_pair {nprop} times")
    check(guard.made >= 1, "the i6 stream ran no guarded launch")
    check(sk.fused >= 1, "the i6 stream did not take the fused .trk decode")

    m = mask.vol > 0
    fa, fa_r = dti.fa.vol, dti_r.fa.vol
    fin = m & np.isfinite(fa) & np.isfinite(fa_r)
    dfa_all = np.abs(fa - fa_r)[fin]
    dfa, (dfa50, dfa90, dfa99) = float(dfa_all.max()), np.percentile(
        dfa_all, [50, 90, 99])
    n = int(m.sum())
    odf, odf_r = device_values(gqi.odf)[:n], device_values(gqi_r.odf)[:n]
    dodf = float(((odf - odf_r).abs() / odf_r.abs().clamp_min(1e-5)).max())
    torch.testing.assert_close(odf, odf_r, rtol=1e-3, atol=1e-5)
    del odf, odf_r

    # the f32 stream of the same peaks and FA
    trk_f = os.path.join(d, "wire_f32.trk")
    pk1 = tt.peaks_to_ovecs(gqi, device=True).first(1)
    t1 = time.time()
    with sink_seconds() as sk_f:
        tract_f = tt.stream(pk1, fa=dti.fa, mask=mask, seed=seed, nsub=3,
                            f_thresh=0.0, wire="f32", trk_sink=trk_f)
    t_f = time.time() - t1
    back, back_f = tt.trk_read(trk), tt.trk_read(trk_f)
    same_n = np.array_equal(np.asarray(back.npts), np.asarray(back_f.npts))
    dpts = float(np.abs(back.packed_xyz - back_f.packed_xyz).max()) \
        if same_n else float("inf")
    del back, back_f

    work = StreamWork(pk1, fa=dti.fa, mask=mask, nsub=3, f_thresh=0.0)
    vox = np.argwhere(work.mask_array)
    per_step = step_launches(work, vox[::max(1, len(vox) // CHUNK)]
                             [:CHUNK].astype(np.float32))

    log("[wire] pipeline u12 + i6 (bench.py:240-261): " + ", ".join(
        f"{k}={v:.3f} s" for k, v in t.items()) + "; f32 run 2: "
        + ", ".join(f"{k}={v:.3f} s" for k, v in t_ref.items()))
    log(f"[wire] batch u12 {t['batch']:.3f} s against f32 "
        f"{t_ref['batch']:.3f} s; stream+write i6 {t['stream+write']:.3f} s "
        f"against f32 {t_ref['stream+write']:.3f} s (run 2) and "
        f"{t_f:.3f} s (the same peaks); .trk sink host time (i6: fused "
        f"decode into records, {sk.fused} calls; f32: record packing) i6 "
        f"{sk.seconds:.3f} s against f32 {sink_ref.seconds:.3f} s (run 2) "
        f"and {sk_f.seconds:.3f} s (the same peaks); the writer thread "
        f"busy / the loop's stall on it i6 {sk.busy:.3f} / {sk.stall:.3f} "
        f"s, f32 {sink_ref.busy:.3f} / {sink_ref.stall:.3f} s (run 2) and "
        f"{sk_f.busy:.3f} / {sk_f.stall:.3f} s (the same peaks)")
    log(f"[wire] device launches and copies of a {min(len(vox), CHUNK)}-"
        f"seed chunk's propagation: through the kernel f32 "
        f"{per_step['f32']['kernel_chunk']} and i6 "
        f"{per_step['i6']['kernel_chunk']} a chunk; through the plain loop "
        f"f32 {per_step['f32']['plain_step']:.2f} and i6 "
        f"{per_step['i6']['plain_step']:.2f} a step")
    log(f"[wire] u12 against f32: |dFA| median {dfa50:.3g}, 90th "
        f"percentile {dfa90:.3g}, 99th {dfa99:.3g}, max {dfa:.3g} "
        f"({100 * float((dfa_all > 1e-3).mean()):.2f}% of voxels over "
        f"1e-3); max ODF relative difference {dodf:.3g}; streams "
        f"{tract.n_count} (f32 run 2: {tract_r.n_count}); i6 against f32 on the same peaks: streams "
        f"{tract.n_count} / {tract_f.n_count}, npts "
        f"{'equal' if same_n else 'differ'}, max|dpts| in the .trk "
        f"{dpts:.4g} (bound {I6_BOUND:.4g}); launches {counts}; "
        f"{guard.made} stream chunk launches under "
        "set_sync_debug_mode('error')")
    check(dfa90 <= 1e-3, f"u12 FA differs by over 1e-3 on more than 10% "
          f"of the mask (90th percentile {dfa90})")
    check(abs(tract.n_count - tract_r.n_count) <= 0.005 * tract_r.n_count,
          f"u12/i6 streams {tract.n_count} against f32 {tract_r.n_count}")
    check(tract.n_count == tract_f.n_count and same_n,
          "the i6 stream's line lengths differ from the f32 stream's")
    check(dpts <= I6_BOUND, f"i6 points differ by {dpts} > {I6_BOUND}")
    return counts, per_step


def phase_main(mesh):
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.tract.stream import StreamWork
    from fibers_tpu_torch.utils.phantom import make_brain

    phase_nosync()
    t0 = time.time()
    dwi, mask, ax = make_brain()
    seed = _seed_mask(mask, 1_000_000)
    m = mask.vol > 0
    log(f"[main] set-up: phantom {dwi.vol.shape} built in "
        f"{time.time() - t0:.1f} s; {int(m.sum())} masked voxels, "
        f"{int((seed.vol > 0).sum())} seed voxels")

    with tempfile.TemporaryDirectory() as d:
        trk = os.path.join(d, "main.trk")
        # run 1 warms the allocator and the library loads; run 2 is the one
        # counted, timed and checked
        *_, t_warm = pipeline(dwi, mask, seed, "cuda", trk)
        reset_counts()
        with sink_seconds() as sk:
            dti, gqi, tract, t = pipeline(dwi, mask, seed, "cuda", trk)
        counts = read_counts()
        back = tt.trk_read(trk)
        phase_sum3()
        pk1 = tt.peaks_to_ovecs(gqi, device=True).first(1)
        work = StreamWork(pk1, fa=dti.fa, mask=mask, nsub=3, f_thresh=0.0)
        prop = phase_propagate("main path", work, seed, scaling=True)
        del work
        prop["stream_write"] = kernel_vs_plain(
            "main path", lambda trk_: tt.stream(
                pk1, fa=dti.fa, mask=mask, seed=seed, nsub=3, f_thresh=0.0,
                wire="f32", trk_sink=trk_), d)
        mesh_launches = phase_mesh_main(dwi, mask, seed, mesh,
                                        (dti, gqi, tract), back, t, d)
        wire_launches = phase_wire_main(dwi, mask, seed, (dti, gqi, tract),
                                        t, sk, d)
    launches = counts["gqi_fused"]
    nprop = stream_chunks(3 * int((seed.vol > 0).sum()))
    npts = int(np.sum(tract.npts))
    for name, tt_ in (("run 1", t_warm), ("run 2", t)):
        log(f"[main] {name}: " + ", ".join(f"{k}={v:.3f} s"
                                           for k, v in tt_.items()))
    split = gqi_split(dwi, mask)
    log("[main] GQI stage replayed: " + ", ".join(
        f"{k} {1e3 * v:.3f} ms" for k, v in split.items()))
    log(f"[main] streams={tract.n_count} points={npts} launches {counts} "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB")

    check(launches == 1, "the GQI stage did not launch its kernel once")
    check(counts["propagate_pair"] == nprop,
          f"the stream launched propagate_pair {counts['propagate_pair']} "
          f"times, not once for each of its chunks ({nprop})")
    check(sum(counts.values()) == launches + nprop,
          f"the main path launched other kernels: {counts}")
    fa = dti.fa.vol[m]
    check(np.isfinite(fa).all(), "FA is not finite inside the mask")
    check(tract.n_count > 0, "no streamlines")
    check(back.n_count == tract.n_count and int(np.sum(back.npts)) == npts,
          f".trk holds {back.n_count} lines, the Tract {tract.n_count}")
    nx, ny, nz = mask.vol.shape
    _, y, z = np.meshgrid(np.linspace(-1, 1, nx), np.linspace(-1, 1, ny),
                          np.linspace(-1, 1, nz), indexing="ij")
    single = m & ~((np.abs(y) < 0.25) & (np.abs(z) < 0.4))
    cos = np.abs((gqi.peak[0].vol[single] * ax[single]).sum(-1))
    log(f"[main] peak 1 vs true axis outside the crossing slab: median "
        f"|cos|={np.median(cos):.4f} over {int(single.sum())} voxels")
    check(np.median(cos) > 0.9, "GQI peak 1 does not follow the true axis")
    return counts, mesh_launches, wire_launches, prop


def phase_small():
    """The whole slice on the card and on the CPU, small phantom."""
    import numpy as np
    from fibers_tpu_torch.utils.phantom import make_brain

    t0 = time.time()
    dwi, mask, _ = make_brain(shape=(48, 48, 32), ndir=34)
    seed = _seed_mask(mask, 20_000)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for dev in ("cuda", "cpu"):
            dti, gqi, tract, t = pipeline(dwi, mask, seed, dev,
                                          os.path.join(d, f"{dev}.trk"))
            out[dev] = (dti.fa.vol, gqi.qa[0].vol, gqi.peak[0].vol,
                        tract.n_count, t["total"])
    m = mask.vol > 0
    (fa_g, qa_g, pk_g, n_g, t_g), (fa_c, qa_c, pk_c, n_c, t_c) = \
        out["cuda"], out["cpu"]
    fin = m & np.isfinite(fa_g) & np.isfinite(fa_c)
    dfa = float(np.abs(fa_g - fa_c)[fin].max())
    dqa = float(np.abs(qa_g - qa_c).max())
    valid = (qa_g > 0) & (qa_c > 0)
    same = float(np.all(pk_g == pk_c, axis=-1)[valid].mean())
    log(f"[small] 48x48x32x34: card {t_g:.2f} s, cpu {t_c:.2f} s; "
        f"max|dFA|={dfa:.3g} max|dQA|={dqa:.3g} peak-1 equal on "
        f"{100 * same:.3f}% of {int(valid.sum())} voxels; streams card "
        f"{n_g} cpu {n_c}; phase {time.time() - t0:.1f} s")
    check(np.array_equal(np.isfinite(fa_g), np.isfinite(fa_c)),
          "FA finite on one device and not on the other")
    check(dfa <= 1e-4, f"FA differs by {dfa} between card and CPU")
    check(dqa <= 1e-4, f"QA differs by {dqa} between card and CPU")
    check(same >= 0.995, f"peak 1 equal on only {same:.4f} of voxels")
    check(n_c > 0 and abs(n_g - n_c) <= 0.005 * n_c,
          f"stream counts card {n_g} vs cpu {n_c}")


def bound_ms(nbytes, flops, flop_s=FP32_FLOP_S):
    """The least time of a function on the card: its bytes (each input
    read once, each output written once) over the HBM rate, or its
    operations over the peak of the unit its route runs them on (FP32
    outside the tensor cores unless `flop_s` says otherwise), whichever
    is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def copy_ms(nbytes, reps):
    """Device time of `out.copy_(src)` moving `nbytes` in all (half read,
    half written): the bandwidth the card reaches, as a yardstick for a
    kernel that moves as many bytes.  Not the same function."""
    import torch
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    out = torch.empty_like(src)
    out.copy_(src)
    ms = cuda_ms(lambda: out.copy_(src), reps)
    del src, out
    return ms


def hold(name, fn, plain, reps, nbytes=0):
    """Kernel `fn()` against `plain()` on the card: bit-equal
    (`torch.equal`).  With `reps`, also time both in turns plain / kernel
    / kernel / plain, and a copy of the kernel's `nbytes`.  Returns
    {max_abs_err, ms, plain_ms, copy_ms} (times None without reps)."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    ref = plain()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref),
          f"{name}: kernel differs from its plain version by {err}")
    del out, ref
    rec = dict(max_abs_err=err, ms=None, plain_ms=None, copy_ms=None)
    line = f"[tv] {name}: bit-equal to plain"
    if reps:
        fn()
        plain()
        torch.cuda.synchronize()
        turns = [cuda_ms(f, reps) for f in (plain, fn, fn, plain)]
        rec["ms"] = (turns[1] + turns[2]) / 2
        rec["plain_ms"] = (turns[0] + turns[3]) / 2
        rec["copy_ms"] = copy_ms(nbytes, reps)
        line += (f"; kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f}"
                 f" ms (turns {', '.join(f'{t:.3f}' for t in turns)}); "
                 f"copy of its {nbytes / 1e9:.3f} GB {rec['copy_ms']:.3f} "
                 "ms (not the same function)")
    log(line)
    torch.cuda.empty_cache()
    return rec


def _ragged_cells(shape3, rng):
    """Mask cells of a crop with an empty x-slice, a whole 8 x 8 tile
    outside the mask in every slice, and a random rest
    (tests/test_torch_tv.py:ragged_mask)."""
    import numpy as np
    m = rng.random(shape3) < 0.6
    if shape3[0] > 2:
        m[1] = False
    m[:, :8, 8:16] = False
    return np.flatnonzero(m)


def phase_tv(mask):
    """The four TV kernels against their plain versions: at RUMBA's shapes
    (config-4 crop 128x128x90, C = 364, the 715,200-row fODF table), at
    the TV experiment's (128x130x90x128), and at ragged ones.  Returns the
    records at RUMBA's shapes, each as its path gives it the kernel, with
    its bound."""
    import numpy as np
    import torch
    from fibers_tpu_torch.models.rumba import _tv_bbox, mesh_tv_width
    from fibers_tpu_torch.ops.kernels.tv_fused import (build_tables,
                                                       tv_fused,
                                                       tv_fused_plain)
    from fibers_tpu_torch.ops.kernels.tv_stencil import (rn_selfcheck,
                                                         sweep_blocks_per_sm,
                                                         tv_multiplier,
                                                         tv_multiplier_plain)
    from fibers_tpu_torch.ops.kernels.tv_variants import (tv_2slice,
                                                          tv_2slice_plain,
                                                          tv_dimsem,
                                                          tv_dimsem_plain)
    from fibers_tpu_torch.ops.masked import mask_indices
    dense_kernels = (("tv_multiplier", tv_multiplier, tv_multiplier_plain),
                     ("tv_dimsem", tv_dimsem, tv_dimsem_plain),
                     ("tv_2slice", tv_2slice, tv_2slice_plain))
    t0 = time.time()
    bad = rn_selfcheck()
    log(f"[tv] the sweep kernels' branch-free sqrt, 1/x and a/b against "
        f"__fsqrt_rn and __fdiv_rn (all 2^32 floats as the argument and as "
        f"the denominator under 13 numerators, and 2^31 random pairs): "
        f"{bad} mismatches ({time.time() - t0:.2f} s)")
    check(bad == 0, "the sweep kernels' rounding differs from IEEE's")
    occupancy = sweep_blocks_per_sm()
    log("[tv] blocks per SM (occupancy API): " + ", ".join(
        f"{k} {v}" for k, v in occupancy.items()))
    check(min(occupancy.values()) >= 1, f"a sweep instance fits no SM: "
          f"{occupancy}")
    cuda = torch.device("cuda")
    idx = mask_indices(mask.vol)
    shape3, nxyz, idx_tv, _ = _tv_bbox(idx, mask.vol.shape[:3])
    C = 364
    rows = torch.from_numpy(np.random.default_rng(7).random(
        (len(idx), C), dtype=np.float32)).to(cuda)
    lam = torch.full(shape3, 0.0044, dtype=torch.float32, device=cuda)
    tabs = build_tables(idx_tv, shape3, cuda)
    out = torch.ones_like(rows)
    log(f"[tv] RUMBA shapes: crop {shape3}, C={C}, {len(idx)} rows")
    # rows in, multiplier rows out, lam and the cell -> row table in
    nbytes = 2 * rows.nbytes + lam.nbytes + tabs.cellrow.nbytes
    records = {"tv_fused": dict(hold(
        f"tv_fused rows {tuple(rows.shape)}",
        lambda: tv_fused(rows, lam, tabs, out),
        lambda: tv_fused_plain(rows, lam, tabs), 5, nbytes),
        **bound_ms(nbytes, TV_FLOPS * rows.numel()))}
    dense = torch.zeros((nxyz, C), dtype=torch.float32, device=cuda)
    dense[torch.from_numpy(idx_tv).to(cuda)] = rows
    dense = dense.reshape(shape3 + (C,))
    del rows, out
    b16 = dense.to(torch.bfloat16)
    nbytes = b16.nbytes + lam.nbytes + dense.nbytes      # f32 output
    records["tv_multiplier"] = dict(hold(
        f"tv_multiplier bf16 {tuple(b16.shape)}",
        lambda: tv_multiplier(b16, lam),
        lambda: tv_multiplier_plain(b16, lam), 3, nbytes),
        **bound_ms(nbytes, TV_FLOPS * b16.numel()))
    del b16
    nbytes = 2 * dense.nbytes + lam.nbytes
    f32 = {}
    for name, fn, plain in dense_kernels:
        rec = hold(f"{name} f32 {tuple(dense.shape)}",
                   lambda: fn(dense, lam), lambda: plain(dense, lam), 3,
                   nbytes)
        f32[name] = rec["ms"]
        records.setdefault(name, dict(
            rec, **bound_ms(nbytes, TV_FLOPS * dense.numel())))
    # the three f32 sweeps side by side; tv_multiplier's own record is its
    # bf16 path's, so its f32 time rides along
    records["tv_multiplier"]["f32_ms"] = f32["tv_multiplier"]
    # the mesh path's f32 stack: one device's share of the components on
    # the 2-device mesh, padded to 16-byte rows (mesh_tv_width), beside
    # the unpadded half, whose 728-byte rows take the narrow copies
    for w in (mesh_tv_width(C, 2), C // 2):
        half = dense[..., :w].contiguous()
        nb_half = 2 * half.nbytes + lam.nbytes
        rec = hold(f"tv_multiplier f32 {tuple(half.shape)} (one device's "
                   f"stack on the 2-device mesh{', unpadded' if w % 4 else ''}"
                   ")", lambda: tv_multiplier(half, lam),
                   lambda: tv_multiplier_plain(half, lam), 3, nb_half)
        if w % 4:
            records["tv_multiplier"]["mesh_f32"]["unpadded_ms"] = rec["ms"]
        else:
            records["tv_multiplier"]["mesh_f32"] = dict(
                rec, shape=list(half.shape),
                **bound_ms(nb_half, TV_FLOPS * half.numel()))
        del half
    bound = records["tv_dimsem"]["bound_ms"]
    log(f"[tv] f32 {tuple(dense.shape)} side by side: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * bound / v:.1f}% of the {bound:.3f} ms "
        f"bound)" for k, v in f32.items()))
    del dense

    # the TV experiment's shape (exp_tv_variants.py:119-123)
    v = torch.from_numpy(np.random.default_rng(0).random(
        (128, 130, 90, 128), dtype=np.float32)).to(cuda)
    lam_e = torch.full((128, 130, 90), 0.004, dtype=torch.float32,
                       device=cuda)
    for name, fn, plain in dense_kernels:
        hold(f"{name} f32 {tuple(v.shape)}", lambda: fn(v, lam_e),
             lambda: plain(v, lam_e), 3, 2 * v.nbytes + lam_e.nbytes)
    del v, lam_e

    # ragged tiles and component chunks, empty slices and tiles of the mask
    rng = np.random.default_rng(3)
    for shape in TV_RAGGED:
        v = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda)
        lm = torch.from_numpy(rng.uniform(0.001, 0.01, shape[:3]).astype(
            np.float32)).to(cuda)
        for name, fn, plain in dense_kernels:
            if name != "tv_2slice" or shape[0] % 2 == 0:
                hold(f"{name} f32 {shape}", lambda: fn(v, lm),
                     lambda: plain(v, lm), 0)
        vb = v.to(torch.bfloat16)
        hold(f"tv_multiplier bf16 {shape}", lambda: tv_multiplier(vb, lm),
             lambda: tv_multiplier_plain(vb, lm), 0)
        cells = _ragged_cells(shape[:3], rng)
        r = torch.from_numpy(rng.random((len(cells) + 5, shape[3]),
                                        dtype=np.float32)).to(cuda)
        tb = build_tables(cells, shape[:3], cuda)
        hold(f"tv_fused rows {tuple(r.shape)} crop {shape[:3]}",
             lambda: tv_fused(r, lm, tb), lambda: tv_fused_plain(r, lm, tb),
             0)
    log(f"[tv] phase {time.time() - t0:.1f} s")
    return records


def turns(fn, plain, reps):
    """fn() against plain() by CUDA events in turns plain / kernel /
    kernel / plain, `reps` calls each: (kernel ms, plain ms, the turns)."""
    import torch
    fn()
    plain()
    torch.cuda.synchronize()
    t = [cuda_ms(f, reps) for f in (plain, fn, fn, plain)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def _bits(a, b):
    """Bit for bit, NaN where NaN."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_rumba_step(dwi, mask, warm=5, reps=10):
    """[rumba-step] RUMBA's two row kernels against their plain versions at
    config 4's shapes (715,200 rows, 253 signal and 364 fODF columns), on
    the fit's state after `warm` iterations: bit for bit but for the
    noise variance (rtol SIG2_RTOL), timed in turns with CUDA events
    beside a copy of the same bytes and the bound; the product kernel
    `rl_gemm` on the same state (`phase_rl_gemm`).  Then one iteration
    split by operator (rl_gemm's two launches, the TV kernel, the two row
    kernels, the rest) and the device kernels of a profiled iteration.
    Returns the three kernels' records."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fibers_tpu_torch.models import rumba as rm
    from fibers_tpu_torch.ops.kernels.rumba_step import (rumba_refit,
                                                         rumba_refit_plain,
                                                         rumba_update,
                                                         rumba_update_plain)
    from fibers_tpu_torch.ops.kernels.rl_gemm import rl_gemm
    from fibers_tpu_torch.ops.kernels.tv_fused import build_tables, tv_fused
    from fibers_tpu_torch.ops.masked import mask_indices

    t0 = time.time()
    cuda = torch.device("cuda")
    # the fit's initial state, as rumba_rec builds it
    idx = mask_indices(mask.vol)
    kernel, ib0 = rm._build_kernel(
        np.asarray(dwi.bval, np.float32), np.asarray(dwi.bvec, np.float32),
        tt.sphere_724, 1.7e-3, 0.2e-3, 3.0e-3, 0.8e-4)
    vol = np.asarray(dwi.vol)
    signal = rm._signal_f32(vol.reshape(-1, vol.shape[3]), idx, ib0, cuda)
    n, ndir = signal.shape
    ncomp = kernel.shape[1]
    shape3, nxyz, idx_tv, _ = rm._tv_bbox(idx, mask.vol.shape[:3])
    k = torch.from_numpy(kernel).to(cuda)
    fodf0 = np.full(ncomp, 1.0 / ncomp, np.float32)
    lam0 = (1.0 / 15) ** 2
    fodf = torch.from_numpy(fodf0).to(cuda).expand(n, ncomp).clone()
    dodf = torch.from_numpy(kernel @ fodf0).to(cuda).expand(n, ndir).clone()
    sig2 = torch.full((n, 1), lam0, device=cuda)
    st = (fodf, dodf, (signal * dodf) / sig2, sig2,
          torch.full((nxyz,), lam0, device=cuda))
    idx_d = torch.from_numpy(idx_tv).to(cuda)
    tabs = build_tables(idx_tv, shape3, cuda)
    tv_buf = torch.ones((n, ncomp), device=cuda)

    packs = rm._pack_products(k, "high")
    tv_term = rm._row_tv(tabs, shape3, False, tv_buf)

    def step(st, x):
        return rm._rumba_step(*st, signal, k, idx_d, 1, 1, True, shape3,
                              "high", False, x=x, packs=packs, tv=tv_term)

    x = None
    for _ in range(warm):
        out = step(st, x)
        st, x = out[:5], out[6]
    del out
    fodf, dodf, dodf_sig, sig2, lam = st
    lam3 = lam.reshape(shape3)
    num, den = rm._mm(x, k, "high", packs[0]), rm._mm(dodf, k, "high",
                                                      packs[0])
    tv = tv_fused(fodf, lam3, tabs, tv_buf)
    records = {}
    none = "none: no PyTorch call computes it"

    # rumba_update: fodf, num, den, tv in, the new fODF out
    new = rumba_update(fodf, num, den, tv)
    torch.cuda.synchronize()
    ref = rumba_update_plain(fodf, num, den, tv)
    err = float((new - ref).abs().max())
    check(_bits(new, ref), f"rumba_update differs from its plain version "
          f"by {err}")
    del ref
    nbytes = 5 * fodf.nbytes
    ms, plain_ms, t = turns(lambda: rumba_update(fodf, num, den, tv),
                            lambda: rumba_update_plain(fodf, num, den, tv),
                            reps)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               copy_ms=copy_ms(nbytes, reps), library_call=none,
               shape=[n, ncomp],
               **bound_ms(nbytes, UPDATE_FLOPS * fodf.numel()))
    records["rumba_update"] = rec
    log(f"[rumba-step] rumba_update [{n}, {ncomp}]: bit-equal to plain; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (turns "
        f"{', '.join(f'{v:.3f}' for v in t)}); copy of its "
        f"{nbytes / 1e9:.3f} GB {rec['copy_ms']:.3f} ms; bound "
        f"{rec['bound_ms']:.3f} ms by {rec['bound_by']} "
        f"({100 * rec['bound_ms'] / ms:.1f}%)")

    # rumba_refit: signal, dodf_sig, dodf, sig2 in; dodf_sig, x, sig2 out
    dodf_new = rm._mm(new, k.T, "high", packs[1])
    args = (signal, dodf_sig, 1, dodf_new, sig2)
    got = rumba_refit(*args)
    torch.cuda.synchronize()
    ref = rumba_refit_plain(*args)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    ulps = int((got[1].view(torch.int32) - ref[1].view(torch.int32)).abs()
               .max())
    check(_bits(got[0], ref[0]) and _bits(got[2], ref[2]),
          "rumba_refit's dodf_sig or x differs from its plain version")
    torch.testing.assert_close(got[1], ref[1], rtol=SIG2_RTOL, atol=0,
                               equal_nan=True)
    first = rumba_refit(signal, dodf_sig, 1)[2]
    check(_bits(first, rumba_refit_plain(signal, dodf_sig, 1)[2]),
          "rumba_refit's first-iteration x differs from its plain version")
    del got, ref, first
    nbytes = 5 * signal.nbytes + 2 * sig2.nbytes
    ms, plain_ms, t = turns(lambda: rumba_refit(*args),
                            lambda: rumba_refit_plain(*args), reps)
    nb_first = 3 * signal.nbytes
    f_ms, f_plain, _ = turns(
        lambda: rumba_refit(signal, dodf_sig, 1),
        lambda: rumba_refit_plain(signal, dodf_sig, 1), reps)
    rec = dict(max_abs_err=err, sig2_max_ulps=ulps, ms=ms,
               plain_ms=plain_ms, copy_ms=copy_ms(nbytes, reps),
               library_call=none, shape=[n, ndir],
               **bound_ms(nbytes, REFIT_FLOPS * signal.numel()))
    rec["first_iteration"] = dict(
        ms=f_ms, plain_ms=f_plain,
        **bound_ms(nb_first, FIRST_FLOPS * signal.numel()))
    records["rumba_refit"] = rec
    log(f"[rumba-step] rumba_refit [{n}, {ndir}]: dodf_sig and x bit-equal "
        f"to plain, sig2 within {ulps} ulps (max|d| {err:.3g}); kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms (turns "
        f"{', '.join(f'{v:.3f}' for v in t)}); copy of its "
        f"{nbytes / 1e9:.3f} GB {rec['copy_ms']:.3f} ms; bound "
        f"{rec['bound_ms']:.3f} ms by {rec['bound_by']} "
        f"({100 * rec['bound_ms'] / ms:.1f}%); first-iteration mode "
        f"{f_ms:.3f} ms, plain {f_plain:.3f} ms, bound "
        f"{rec['first_iteration']['bound_ms']:.3f} ms")

    records["rl_gemm"] = phase_rl_gemm(x, dodf, new, k, packs, reps)

    # one iteration (on the same state each time; the step overwrites x
    # with the next, which changes no work) by CUDA events, whole and by
    # operator, each part alone (the rest: the iteration less the parts);
    # then the device kernels of `prof_iters` profiled iterations
    parts = dict(
        rl_gemm=lambda: (rl_gemm(x, packs[0], 3, a2=dodf),
                         rl_gemm(new, packs[1], 3)),
        tv_fused=lambda: tv_fused(fodf, lam3, tabs, tv_buf),
        rumba_update=lambda: rumba_update(fodf, num, den, tv),
        rumba_refit=lambda: rumba_refit(*args))
    split = {}
    for name, fn in parts.items():
        fn()                # a warm call: the allocator caches its outputs
        torch.cuda.synchronize()
        split[name] = cuda_ms(fn, reps)
    it_ms = cuda_ms(lambda: step(st, x), reps)
    split["rest"] = it_ms - sum(split.values())
    prof_iters = 3
    keep = ({"acc_events": True} if "acc_events" in
            inspect.signature(profile).parameters else {})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **keep) as prof:
        for _ in range(prof_iters):
            step(st, x)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / prof_iters
    log(f"[rumba-step] one iteration {it_ms:.3f} ms by CUDA events: "
        + ", ".join(f"{g} {v:.3f}" for g, v in split.items())
        + f" ms; a profiled iteration's device time {dev_ms:.3f} ms (idle "
        f"{100 * (1 - dev_ms / it_ms):.1f}% of the unprofiled iteration) "
        f"in {sum(e.count for e in events) / prof_iters:g} device events: "
        + "; ".join(f"{e.key[:48]} x{e.count / prof_iters:g} "
                    f"{e.self_device_time_total / 1e3 / e.count:.3f} ms"
                    for e in events))
    records["rumba_refit"]["iteration_split_ms"] = dict(
        split, iteration=it_ms, profiled_device=dev_ms)
    log(f"[rumba-step] phase {time.time() - t0:.1f} s")
    del st, x, num, den, tv, new, dodf_new, args, signal, tv_buf
    torch.cuda.empty_cache()
    return records


def phase_rl_gemm(x, dodf, fodf, k, packs, reps, ragged=100_003):
    """[rl-gemm] The Richardson-Lucy product kernel against its plain
    version at config 4's shapes on the fit's state: `x` and `dodf`
    [N, 253] against the kernel matrix `k` [253, 364] (num and den, one
    launch), `fodf` [N, 364] against k.T (dodf), `packs` the planes of k
    and k.T.  For both routes (passes 3, "high"; 1, "default") every
    output NaN where the plain version's is, and within RL_REL of
    sum_k |a_ik| |b_kj| of the plain version's and of the float64 product
    of the bf16 parts both versions take (the plain version's own
    distance from it printed).  Then the first `ragged` rows (a ragged M)
    with a NaN in one row of each operand: that row NaN, every other row
    finite and held the same way.
    Times by CUDA events, the kernel's two launches in turns with the
    plain version, beside the f32 torch.matmul of the three products (the
    route the kernel replaces) and, for passes 1, the bf16 library
    product; the bound of the three products (bytes, or their bf16
    operations).  Returns the record: its top-level numbers are the main
    path's route, "high"."""
    import torch
    from fibers_tpu_torch.ops.kernels.rl_gemm import (rl_gemm, rl_gemm_plain,
                                                      split_bf16)

    t0 = time.time()
    pk, pkt = packs
    kt = pkt.b
    n = x.shape[0]

    def launches(a0, a1, a2, passes):
        num, den = rl_gemm(a0, pk, passes, a2=a1)
        return num, den, rl_gemm(a2, pkt, passes)

    def plain(a0, a1, a2, passes):
        return tuple(rl_gemm_plain(a, b, passes)
                     for a, b in ((a0, k), (a1, k), (a2, kt)))

    def exact(a, b, passes):
        """The float64 product of the bf16 parts of `a` and `b` that the
        kernel and the plain version take."""
        if passes == 1:
            return a.bfloat16().double() @ b.bfloat16().double()
        ah, al = (t_.double() for t_ in split_bf16(a))
        bh, bl = (t_.double() for t_ in split_bf16(b))
        return (al @ bh + ah @ bl) + ah @ bh

    def held(outs, ops, passes):
        """Each product: NaN where the plain version has NaN; the kernel's
        distance from the float64 product of the parts and from the plain
        version (both held to RL_REL), and the plain version's own, each
        the max over sum|a||b|; and the kernel's max |d| from the plain
        version."""
        rel = {"exact": [], "plain": [], "plain_exact": []}
        ab = []
        for got, (a, b) in zip(outs, ops):
            ref = rl_gemm_plain(a, b, passes)
            nan = torch.isnan(ref)
            check(torch.equal(torch.isnan(got), nan),
                  "rl_gemm's NaN rows differ from its plain version's")
            scale = torch.where(nan, 1.0,
                                a.abs().double() @ b.abs().double())
            e64 = exact(a, b, passes)
            for key, v, w in (("exact", got, e64), ("plain", got, ref),
                              ("plain_exact", ref, e64)):
                r_ = torch.where(nan, 0.0, (v.double() - w).abs() / scale)
                rel[key].append(float(r_.max()))
                del r_
            ab.append(float(torch.where(nan, 0.0, got - ref).abs().max()))
            del ref, nan, scale, e64
            check(max(rel["exact"][-1], rel["plain"][-1]) <= RL_REL,
                  f"rl_gemm passes={passes} is {rel['plain'][-1]:.3g} of "
                  f"sum|a||b| from its plain version and "
                  f"{rel['exact'][-1]:.3g} from the float64 product of its "
                  f"parts (bound {RL_REL})")
        return rel, ab

    ops = ((x, k), (dodf, k), (fodf, kt))
    a_bytes = 4 * (x.numel() + dodf.numel() + fodf.numel())
    c_bytes = 4 * n * (2 * k.shape[1] + kt.shape[1])
    flops = 3 * 2 * n * k.shape[0] * k.shape[1]      # one pass of three
    f32_ms = cuda_ms(lambda: (x @ k, dodf @ k, fodf @ kt), reps)
    routes = {}
    for passes, route in ((3, "high"), (1, "default")):
        outs = launches(x, dodf, fodf, passes)
        torch.cuda.synchronize()
        rel, ab = held(outs, ops, passes)
        del outs
        # a ragged M, a NaN in one row of each operand
        r = ragged
        xa, da, fa = x[:r].clone(), dodf[:r].clone(), fodf[:r].clone()
        rows = (r // 2, r - 1, 7)
        xa[rows[0], 17] = da[rows[1], 0] = fa[rows[2], 363] = float("nan")
        outs = launches(xa, da, fa, passes)
        torch.cuda.synchronize()
        every = torch.arange(r, device=x.device)
        for got, row in zip(outs, rows):
            check(bool(torch.isnan(got[row]).all())
                  and bool(torch.isfinite(got[every != row]).all()),
                  f"rl_gemm passes={passes}: the NaN row {row} of {r} is "
                  "not NaN alone")
        rel_r, _ = held(outs, ((xa, k), (da, k), (fa, kt)), passes)
        rel_r = rel_r["plain"]
        del outs, xa, da, fa, every
        ms, plain_ms, t = turns(lambda: launches(x, dodf, fodf, passes),
                                lambda: plain(x, dodf, fodf, passes), reps)
        nd_ms = cuda_ms(lambda: rl_gemm(x, pk, passes, a2=dodf), reps)
        dd_ms = cuda_ms(lambda: rl_gemm(fodf, pkt, passes), reps)
        planes = (pk.hi.numel() + pkt.hi.numel()) * (2 if passes == 3 else 1)
        rec = dict(passes=passes, max_abs_err=max(ab), max_rel_err=rel,
                   ragged_rows=r, ragged_max_rel_err=rel_r, ms=ms,
                   num_den_ms=nd_ms, dodf_ms=dd_ms, plain_ms=plain_ms,
                   f32_matmul_ms=f32_ms,
                   **bound_ms(a_bytes + c_bytes + planes, passes * flops,
                              BF16_FLOP_S))
        lib = ""
        if passes == 1:
            xb, db, fb, kb, ktb = (t_.bfloat16() for t_ in
                                   (x, dodf, fodf, k, kt))
            try:
                torch.mm(xb[:8], kb, out_dtype=torch.float32)
                call = "torch.mm(bf16, bf16, out_dtype=torch.float32)"
                rec["library_ms"] = cuda_ms(lambda: tuple(
                    torch.mm(a, b, out_dtype=torch.float32) for a, b in
                    ((xb, kb), (db, kb), (fb, ktb))), reps)
            except (TypeError, RuntimeError):
                call = "torch.matmul(bf16, bf16), a bf16 result"
                rec["library_ms"] = cuda_ms(
                    lambda: (xb @ kb, db @ kb, fb @ ktb), reps)
            rec["library_call"] = f"three {call} on bf16 copies"
            lib = f", library {call} x3 {rec['library_ms']:.3f} ms"
            del xb, db, fb, kb, ktb
        routes[route] = rec
        log(f"[rl-gemm] {route} ({passes} pass{'es' if passes > 1 else ''})"
            f": num, den [{n} x {k.shape[0]}] @ [{k.shape[0]} x "
            f"{k.shape[1]}] in one launch, dodf [{n} x {kt.shape[0]}] @ "
            f"[{kt.shape[0]} x {kt.shape[1]}]: max|d| / sum|a||b| from the "
            f"plain version {', '.join(f'{v:.3g}' for v in rel['plain'])} "
            f"(max|d| {max(ab):.3g}), from the float64 product of the bf16 "
            f"parts {', '.join(f'{v:.3g}' for v in rel['exact'])} (bound "
            f"{RL_REL} for both), the plain version's own "
            f"{', '.join(f'{v:.3g}' for v in rel['plain_exact'])}; ragged "
            f"{r} rows with a NaN row each: NaN rows NaN, the rest "
            f"{', '.join(f'{v:.3g}' for v in rel_r)}; kernel "
            f"{ms:.3f} ms "
            f"(num/den {nd_ms:.3f}, dodf {dd_ms:.3f}), plain "
            f"{plain_ms:.3f} ms (turns {', '.join(f'{v:.3f}' for v in t)}),"
            f" f32 torch.matmul x3 {f32_ms:.3f} ms{lib}; bound "
            f"{rec['bound_ms']:.3f} ms by {rec['bound_by']} "
            f"({100 * rec['bound_ms'] / ms:.1f}%)")
        torch.cuda.empty_cache()
    high = routes["high"]
    log(f"[rl-gemm] phase {time.time() - t0:.1f} s")
    return dict(
        {key: high[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by",
                                    "f32_matmul_ms")},
        library_call="none for passes 3: no PyTorch call takes the 3-pass "
        "bf16 product (routes.default.library_ms: the 1-pass one)",
        shape=[n, k.shape[0], k.shape[1]], routes=routes)


def phase_rumba(dwi, mask, ax, mesh):
    """Config 4 at full width on the card: RUMBA-SD, 600 iterations,
    chained into ~1M streams written to a .trk (i6, then f32 through the
    kernel beside the plain loop, and its `[propagate]` chunk); then a
    tv_bf16 run, the f32 run it is held to, the fit's rounding floor
    (`rounding_floor`), the f32 run against the same fit through the
    kernels' plain versions (`plain_fit`) and at the other precisions
    (`precision_fits`), and the mesh run (`phase_mesh_rumba`).  Each
    run's launches are exact (`rumba_launches`).  The warm run and the
    50- and 20-iteration runs take a prepared batch, which skips the host
    signal route the counted run times."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.tract.stream import StreamWork

    m = mask.vol > 0
    nmask = int(m.sum())
    t0 = time.time()
    batch = tt.prepare_batch(dwi, mask, wire="f32")
    tt.rumba_rec(dwi, mask, tt.sphere_724, niter=2, batch=batch)  # warm
    torch.cuda.synchronize()
    del batch
    t_warm = time.time() - t0

    niter = 600
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    t0 = time.time()
    with signal_spy() as spy:            # the default signal_wire="u12"
        rum = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=niter,
                           timings=stages)
    t_fit = time.time() - t0
    counts = read_counts()
    peak_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[rumba] config 4: {dwi.vol.shape}, {nmask} voxels, sphere_724; "
        f"warm run (2 iterations) {t_warm:.2f} s")
    log(f"[rumba] {niter} iterations: " + ", ".join(
        f"{k}={v:.3f} s" for k, v in stages.items())
        + f", total {t_fit:.3f} s; {1e3 * stages['iterate'] / niter:.3f} ms"
        f" per iteration; peak device memory {peak_mem:.1f} GiB; launches "
        f"{counts}; snr_mean={rum.snr_mean:.3f} snr_std={rum.snr_std:.3f}")
    rumba_launches(counts, "tv_fused", niter, 1, "the 600-iteration fit")

    sums = device_values(rum.fodf)[:nmask].sum(dim=1)
    dsum = float((sums - 1.0).abs().max())
    gfa = rum.gfa.vol[m]
    pk = rum.peak[0].vol[m]
    norm = np.linalg.norm(pk, axis=-1)
    cos = np.abs((pk * ax[m]).sum(-1)) / np.maximum(norm, 1e-30)
    log(f"[rumba] max |sum(fODF) - 1| = {dsum:.3g}; GFA in "
        f"[{gfa.min():.4f}, {gfa.max():.4f}]; peak 1 vs true axis median "
        f"|cos| = {np.median(cos):.4f} over {nmask} voxels")
    check(np.isfinite(gfa).all() and (gfa > 0).all()
          and (gfa <= 1.0 + 1e-6).all(), "GFA outside (0, 1] in the mask")
    check(8.0 <= rum.snr_mean <= 80.0, f"snr_mean {rum.snr_mean}")
    check(dsum <= 1e-3, f"fODF + isotropic fractions sum off 1 by {dsum}")
    check(np.median(cos) > 0.9, "RUMBA peak 1 does not follow the true axis")

    phase_wire_rumba(dwi, mask, spy, stages)

    # the chain as bench_models.py:258-261 writes it (i6 points), then the
    # f32 points of the same peaks
    seed = _seed_mask(mask, 1_000_000)
    pk = tt.peaks_to_ovecs(rum, device=True)
    with tempfile.TemporaryDirectory() as d:
        run, writer = {}, {}
        for pw in ("i6", "f32"):
            trk = os.path.join(d, f"rumba_{pw}.trk")
            reset_counts()
            with sink_seconds() as sk:
                t1 = time.time()
                tract = tt.stream(pk, mask=mask, seed=seed, nsub=3, wire=pw,
                                  trk_sink=trk)
                t_pw = time.time() - t1
            writer[pw] = f"{sk.busy:.3f} / {sk.stall:.3f}"
            run[pw] = (tract, t_pw, tt.trk_read(trk))
            if pw == "i6":
                chain_counts = read_counts()
            os.remove(trk)
        work = StreamWork(pk, mask=mask, nsub=3)
        prop = phase_propagate("RUMBA chain", work, seed)
        del work
        prop["stream_write"] = kernel_vs_plain(
            "RUMBA chain f32", lambda trk_: tt.stream(
                pk, mask=mask, seed=seed, nsub=3, wire="f32",
                trk_sink=trk_), d)
    nprop = stream_chunks(3 * int((seed.vol > 0).sum()))
    check(chain_counts["propagate_pair"] == nprop
          and sum(chain_counts.values()) == nprop,
          f"the RUMBA chain's stream launched {chain_counts}, not "
          f"propagate_pair {nprop} times")
    (tract, t_stream, back), (tract_f, t_f, back_f) = run["i6"], run["f32"]
    npts = int(np.sum(tract.npts))
    same_n = np.array_equal(np.asarray(back.npts), np.asarray(back_f.npts))
    dpts = float(np.abs(back.packed_xyz - back_f.packed_xyz).max()) \
        if same_n else float("inf")
    log(f"[rumba] chain: {int((seed.vol > 0).sum())} seed voxels, nsub=3, "
        f"{pk.nvec} peaks: stream+write i6 {t_stream:.3f} s, "
        f"{tract.n_count} streams, {npts} points; launches {chain_counts}")
    log(f"[wire] RUMBA chain stream+write i6 {t_stream:.3f} s against f32 "
        f"{t_f:.3f} s on the same peaks (.trk writer thread busy / the "
        f"loop's stall on it: i6 {writer['i6']} s, f32 {writer['f32']} s); "
        f"streams {tract.n_count} / "
        f"{tract_f.n_count}, npts {'equal' if same_n else 'differ'}, "
        f"max|dpts| in the .trk {dpts:.4g} (bound {I6_BOUND:.4g})")
    check(tract.n_count > 0, "no streamlines from the RUMBA peaks")
    check(back.n_count == tract.n_count and int(np.sum(back.npts)) == npts,
          f".trk holds {back.n_count} lines, the Tract {tract.n_count}")
    check(tract.n_count == tract_f.n_count and same_n,
          "the RUMBA chain's i6 line lengths differ from the f32 ones")
    check(dpts <= I6_BOUND, f"RUMBA chain i6 points differ by {dpts}")
    del rum, pk, tract, back, tract_f, back_f, run

    # tv_bf16: the dense stencil kernel on a bf16 stack, against f32
    nb = 50
    batch = tt.prepare_batch(dwi, mask, wire="f32")
    reset_counts()
    st_b16, st_f32 = {}, {}
    t1 = time.time()
    b16 = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=nb, tv_bf16=True,
                       timings=st_b16, batch=batch)
    torch.cuda.synchronize()
    t_b16 = time.time() - t1
    counts_b16 = read_counts()
    t1 = time.time()
    f32 = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=nb, timings=st_f32,
                       batch=batch)
    torch.cuda.synchronize()
    t_f32 = time.time() - t1
    fb, ff = device_values(b16.fodf)[:nmask], device_values(f32.fodf)[:nmask]
    dmax = float((fb - ff).abs().max())
    log(f"[rumba] tv_bf16 {nb} iterations {t_b16:.3f} s, "
        f"{1e3 * st_b16['iterate'] / nb:.3f} ms per iteration (launches "
        f"{counts_b16}); f32 {nb} iterations {t_f32:.3f} s, "
        f"{1e3 * st_f32['iterate'] / nb:.3f} ms per iteration; max |dfODF| "
        f"= {dmax:.3g}")
    rumba_launches(counts_b16, "tv_multiplier", nb, 1, "the tv_bf16 run")
    torch.testing.assert_close(fb, ff, rtol=0.05, atol=2e-3)
    del b16, fb
    floor, highest, highest_ms = rounding_floor(dwi, mask, batch, nb, nmask)
    plain_fit(dwi, mask, batch, f32, st_f32, nb, nmask, floor, highest,
              highest_ms)
    precision_fits(dwi, mask, batch, f32, st_f32, nb, nmask, floor, highest,
                   highest_ms)
    del highest
    del f32, ff
    counts_mesh = phase_mesh_rumba(dwi, mask, mesh, batch, nmask)
    return counts, counts_b16, counts_mesh, chain_counts, prop


def rumba_launches(counts, tv, niter, shards, what, tv_per_iter=None,
                   products=True):
    """A RUMBA fit of `niter` iterations over `shards` row shards launched
    its TV kernel `tv` (`tv_per_iter` times an iteration, else once a
    shard), `rumba_update` once a shard and iteration, `rumba_refit` once
    a shard and iteration plus each shard's first-iteration launch,
    `rl_gemm` twice a shard and iteration (num and den, then dodf; never
    without `products`, precision "highest"), and nothing else: no torch
    elementwise update is left in the loop."""
    want = {tv: niter * (tv_per_iter or shards),
            "rumba_update": niter * shards,
            "rumba_refit": (niter + 1) * shards}
    if products:
        want["rl_gemm"] = 2 * niter * shards
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{what} launched {got}, not {want}")


def rl_gemm_plain_call(a, packed, passes, out=None, a2=None, out2=None):
    """`rl_gemm`'s arguments and results through its plain version."""
    from fibers_tpu_torch.ops.kernels.rl_gemm import rl_gemm_plain
    c = rl_gemm_plain(a, packed.b, passes)
    if out is not None:
        c = out.copy_(c)
    if a2 is None:
        return c
    c2 = rl_gemm_plain(a2, packed.b, passes)
    return c, (c2 if out2 is None else out2.copy_(c2))


@contextlib.contextmanager
def plain_rumba_kernels(products=True):
    """rumba_rec with its two row kernels and, with `products`, its
    product kernel swapped for their plain versions while the block runs
    (the fit's own module names; the package has no switch)."""
    from fibers_tpu_torch.models import rumba
    from fibers_tpu_torch.ops.kernels import rumba_step
    real = rumba.rumba_update, rumba.rumba_refit, rumba.rl_gemm
    rumba.rumba_update = rumba_step.rumba_update_plain
    rumba.rumba_refit = rumba_step.rumba_refit_plain
    if products:
        rumba.rl_gemm = rl_gemm_plain_call
    try:
        yield
    finally:
        rumba.rumba_update, rumba.rumba_refit, rumba.rl_gemm = real


@contextlib.contextmanager
def split_k_products():
    """rumba_rec's f32 products (precision "highest") with their sums over
    K taken in two halves while the block runs: the same products, rounded
    otherwise."""
    import torch
    from fibers_tpu_torch.models import rumba
    real = rumba._mm

    def mm(a, b, precision, packed=None):
        if precision != "highest":
            return real(a, b, precision, packed)
        h = a.shape[1] // 2
        return torch.matmul(a[:, :h], b[:h]) + torch.matmul(a[:, h:], b[h:])
    rumba._mm = mm
    try:
        yield
    finally:
        rumba._mm = real


def fit_values(rec, nmask):
    """(fODF rows, GFA, snr_mean) of a RUMBA result on the card."""
    return (device_values(rec.fodf)[:nmask], device_values(rec.gfa)[:nmask],
            rec.snr_mean)


def fit_diff(a, b):
    """max|dfODF|, the fODF values past FIT, max|dGFA|, |dsnr_mean| of two
    fit_values."""
    d = (a[0] - b[0]).abs()
    past = int((d > FIT["atol"] + FIT["rtol"] * b[0].abs()).sum())
    return (float(d.max()), past, float((a[1] - b[1]).abs().max()),
            abs(a[2] - b[2]))


def fit_line(diff):
    return (f"max|dfODF|={diff[0]:.3g} ({diff[1]} values past FIT) "
            f"max|dGFA|={diff[2]:.3g} |dsnr_mean|={diff[3]:.3g}")


def held_to_floor(what, a, b, floor):
    """Two fits whose products differ only by rounding: fODF within
    FLOOR_MARGIN times the rounding floor, GFA within GFA_FIT, snr_mean
    within 1e-3."""
    import torch
    diff = fit_diff(a, b)
    check(diff[0] <= FLOOR_MARGIN * floor,
          f"{what}: max|dfODF| {diff[0]:.3g} past {FLOOR_MARGIN} x the "
          f"fit's rounding floor {floor:.3g}")
    torch.testing.assert_close(a[1], b[1], **GFA_FIT)
    check(diff[3] <= 1e-3, f"{what}: snr_mean differs by {diff[3]}")


def rounding_floor(dwi, mask, batch, niter, nmask):
    """[rumba] The fit's own sensitivity to rounding: the `niter`-iteration
    config-4 fit at precision "highest" (f32 torch.matmul, TF32 off)
    against the same fit with its products' sums over K taken in two
    halves (`split_k_products`).  Returns (the max |dfODF| between them,
    the "highest" fit's values, its ms per iteration); both fits launch no
    rl_gemm."""
    import fibers_tpu_torch as tt
    runs = []
    for split in (False, True):
        reset_counts()
        st = {}
        with split_k_products() if split else contextlib.nullcontext():
            rec = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=niter,
                               timings=st, batch=batch, precision="highest")
        rumba_launches(read_counts(), "tv_fused", niter, 1,
                       "the highest fit", products=False)
        runs.append((fit_values(rec, nmask), 1e3 * st["iterate"] / niter))
        del rec
    diff = fit_diff(runs[0][0], runs[1][0])
    log(f"[rumba] {niter} iterations at precision highest "
        f"{runs[0][1]:.3f} ms per iteration against the same fit with its "
        f"products summed over K in two halves {runs[1][1]:.3f} ms: "
        f"{fit_line(diff)} (the fit's rounding floor)")
    check(diff[0] > 0, "the rounding floor is 0: the two orders gave the "
          "same fit")
    return diff[0], runs[0][0], runs[0][1]


def plain_fit(dwi, mask, batch, fit, st_fit, niter, nmask, floor,
              highest, highest_ms):
    """[rumba] The `niter`-iteration config-4 fits through the kernels
    against the same fits through their plain versions (swapped in by
    `plain_rumba_kernels`): at precision "highest" (`highest`, f32
    products on both sides) with the two row kernels swapped, fODF
    within FIT, GFA within GFA_FIT, snr_mean within 1e-3, launching
    tv_fused alone; and `fit` ("high", stage times `st_fit`) with the row
    kernels and `rl_gemm` swapped, held to the rounding floor
    (`held_to_floor`), launching tv_fused alone."""
    import torch
    import fibers_tpu_torch as tt
    for products in (False, True):
        reset_counts()
        st = {}
        precision = "high" if products else "highest"
        with plain_rumba_kernels(products):
            ref = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=niter,
                               timings=st, batch=batch, precision=precision)
        counts = {k: v for k, v in read_counts().items() if v}
        fp = fit_values(ref, nmask)
        del ref
        fk = fit_values(fit, nmask) if products else highest
        ms = 1e3 * st_fit["iterate"] / niter if products else highest_ms
        diff = fit_diff(fk, fp)
        log(f"[rumba] {niter} iterations at precision {precision} through "
            f"the kernels {ms:.3f} ms per iteration against "
            + ("the row kernels and rl_gemm" if products else
               "the row kernels")
            + f" swapped for their plain versions "
            f"{1e3 * st['iterate'] / niter:.3f} ms (launches {counts}); "
            + fit_line(diff) + (f"; held to {FLOOR_MARGIN} x the rounding "
                                f"floor {floor:.3g}" if products else
                                "; held to FIT, GFA_FIT"))
        check(counts == {"tv_fused": niter},
              f"the plain fit launched {counts}")
        if products:
            held_to_floor("the plain products' fit", fk, fp, floor)
        else:
            torch.testing.assert_close(fk[0], fp[0], **FIT)
            torch.testing.assert_close(fk[1], fp[1], **GFA_FIT)
            check(diff[3] <= 1e-3, f"snr_mean differs by {diff[3]}")
        del fp


def precision_fits(dwi, mask, batch, fit, st_fit, niter, nmask, floor,
                   highest, highest_ms):
    """[rumba] The `niter`-iteration config-4 fit `fit` (precision "high":
    rl_gemm's 3-pass bf16 products; stage times `st_fit`) against the
    same fit at "highest" (`highest`: f32 torch.matmul, TF32 off), held
    to the rounding floor (`held_to_floor`); the "default" fit (1-pass,
    rl_gemm twice an iteration) against "highest" printed
    (tests/test_torch_rumba.py holds it to rtol 0.05, atol 2e-3 on the
    CPU)."""
    import fibers_tpu_torch as tt
    reset_counts()
    st = {}
    rec = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=niter, timings=st,
                       batch=batch, precision="default")
    rumba_launches(read_counts(), "tv_fused", niter, 1, "the default fit")
    dflt = fit_values(rec, nmask)
    del rec
    fh = fit_values(fit, nmask)
    d_high, d_dflt = fit_diff(fh, highest), fit_diff(dflt, highest)
    log(f"[rumba] {niter} iterations per precision: high (rl_gemm 3-pass) "
        f"{1e3 * st_fit['iterate'] / niter:.3f} ms per iteration, highest "
        f"(f32 torch.matmul) {highest_ms:.3f}, default (rl_gemm 1-pass) "
        f"{1e3 * st['iterate'] / niter:.3f}; high against highest "
        f"{fit_line(d_high)} (held to {FLOOR_MARGIN} x the rounding floor "
        f"{floor:.3g}, GFA_FIT); default against highest {fit_line(d_dflt)}")
    held_to_floor("high against highest", fh, highest, floor)


class signal_spy:
    """Keeps the signal rows that `rumba_rec` builds through its upload
    wire (`models/rumba.py:_signal_wire`, or `_signal_f32` with `name`)
    while the block runs; with `refuse`, a call of `refuse` (a function of
    the same module) fails the run."""

    def __init__(self, name="_signal_wire", refuse=None):
        self.name, self.refuse = name, refuse

    def __enter__(self):
        from fibers_tpu_torch.models import rumba
        self._real, self.rows = getattr(rumba, self.name), None
        self._refused = getattr(rumba, self.refuse) if self.refuse else None

        def spy(*args, **kwargs):
            self.rows = self._real(*args, **kwargs)
            return self.rows

        def refused(*args, **kwargs):
            raise RuntimeError(f"chip_smoke: rumba_rec called {self.refuse}")

        setattr(rumba, self.name, spy)
        if self.refuse:
            setattr(rumba, self.refuse, refused)
        return self

    def __exit__(self, *exc):
        from fibers_tpu_torch.models import rumba
        setattr(rumba, self.name, self._real)
        if self.refuse:
            setattr(rumba, self.refuse, self._refused)


def phase_wire_rumba(dwi, mask, spy, stages):
    """[wire] The signal rows of the 600-iteration fit, which took the
    default u12 wire (`spy`), against the exact host signal
    (`_signal_host`) on every 16th row: within half a grid step, 0.5 /
    4095, plus 1e-6 for the decode's float32 rounding.  Then a
    one-iteration fit with signal_wire="f32", for its signal stage beside
    the u12 stage's (`stages`): its rows, normalised on the card
    (`_signal_f32`; `_signal_host` must not run), against the exact
    signal within 1e-6 on the same rows, and its launches."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.models.rumba import _signal_host
    from fibers_tpu_torch.ops.masked import mask_indices

    check(spy.rows is not None, "the RUMBA fit did not take the u12 wire")
    vol = np.asarray(dwi.vol)
    bval = np.asarray(dwi.bval, np.float32)
    idx = mask_indices(mask.vol)
    rows = np.arange(0, len(idx), 16)
    exact = _signal_host(vol.reshape(-1, vol.shape[3]), idx[rows],
                         bval == bval.min())
    got = spy.rows[torch.from_numpy(rows).to(spy.rows.device)].cpu().numpy()
    spy.rows = None
    dsig = float(np.abs(got - exact).max())
    st_f = {}
    reset_counts()
    with signal_spy("_signal_f32", refuse="_signal_host") as f32:
        tt.rumba_rec(dwi, mask, tt.sphere_724, niter=1, signal_wire="f32",
                     timings=st_f)
    counts = read_counts()
    check(f32.rows is not None, "the f32 fit did not take the card's route")
    got_f = f32.rows[torch.from_numpy(rows).to(f32.rows.device)].cpu().numpy()
    f32.rows = None
    dsig_f = float(np.abs(got_f - exact).max())
    log(f"[wire] RUMBA signal u12 {stages['signal']:.3f} s against f32 "
        f"{st_f['signal']:.3f} s (a one-iteration fit; f32 normalised on "
        f"the card); rows against the exact signal on {len(rows)} rows: u12"
        f" max|d|={dsig:.3g} (bound 0.5/4095 + 1e-6 = "
        f"{0.5 / 4095 + 1e-6:.4g}), f32 max|d|={dsig_f:.3g} (bound 1e-6)")
    check(got.shape == exact.shape == got_f.shape,
          "signal rows of another shape")
    check(dsig <= 0.5 / 4095 + 1e-6, f"u12 signal rows differ by {dsig}")
    check(dsig_f <= 1e-6, f"f32 signal rows differ by {dsig_f}")
    rumba_launches(counts, "tv_fused", 1, 1, "the one-iteration f32 fit")


def phase_mesh_rumba(dwi, mask, mesh, batch, nmask, niter=20):
    """[mesh] Config 4 at full width, `niter` iterations on the mesh (the
    TV term resharded over components, `tv_multiplier` f32 on each
    device's [X, Y, Z, C / devices] stack) against `niter` unsharded
    iterations on `batch` (`tv_fused`): fODF and GFA within rtol 1e-4 /
    atol 1e-6 (tests/test_parallel.py's), snr_mean within 1e-2.  Returns
    the launches of the mesh run, which must be tv_multiplier = niter x
    devices and nothing else."""
    import torch
    import fibers_tpu_torch as tt

    st_ref, st_mesh = {}, {}
    ref = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=niter, batch=batch,
                       timings=st_ref)
    mbatch = tt.prepare_batch(dwi, mask, wire="f32", mesh=mesh)
    tt.rumba_rec(dwi, mask, tt.sphere_724, niter=2, batch=mbatch)  # warm
    sync_all(mesh)
    reset_counts()
    t0 = time.time()
    rum = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=niter, batch=mbatch,
                       timings=st_mesh)
    t_fit = time.time() - t0
    counts = read_counts()
    f_m = device_values(rum.fodf).gather()[:nmask]
    f_r = device_values(ref.fodf)[:nmask]
    dmax = float((f_m - f_r).abs().max())
    g_m = device_values(rum.gfa).gather()[:nmask]
    g_r = device_values(ref.gfa)[:nmask]
    dsnr = abs(rum.snr_mean - ref.snr_mean)
    log(f"[mesh] RUMBA config 4, {niter} iterations over {mesh.size} "
        f"devices: " + ", ".join(f"{k}={v:.3f} s" for k, v in
                                 st_mesh.items())
        + f", total {t_fit:.3f} s, {1e3 * st_mesh['iterate'] / niter:.3f} "
        f"ms per iteration; unsharded {1e3 * st_ref['iterate'] / niter:.3f}"
        f" ms per iteration; launches {counts}; max|dfODF|={dmax:.3g} "
        f"max|dGFA|={float((g_m - g_r).abs().max()):.3g} "
        f"|dsnr_mean|={dsnr:.3g}")
    rumba_launches(counts, "tv_multiplier", niter, mesh.ndata,
                   "the mesh RUMBA", tv_per_iter=mesh.size)
    torch.testing.assert_close(f_m, f_r, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(g_m, g_r, rtol=1e-4, atol=1e-6)
    check(dsnr <= 1e-2, f"snr_mean differs by {dsnr}")
    return counts


def phase_rumba_small():
    """The RUMBA slice on the card and on the CPU, on the small config-4
    phantom (32x32x20, 32 volumes, 30 iterations)."""
    import numpy as np
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.utils.phantom import make_rumba_brain

    t0 = time.time()
    dwi, mask, _ = make_rumba_brain(small=True)
    seed = _seed_mask(mask, 30_000)
    out = {}
    for dev in ("cuda", "cpu"):
        t1 = time.time()
        # the same exact signal on both devices (the card's default is
        # the u12 wire, which the CPU ignores)
        rum = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=30, device=dev,
                           signal_wire="f32")
        tract = tt.stream(tt.peaks_to_ovecs(rum, device=True), mask=mask,
                          seed=seed, nsub=3, wire="f32")
        out[dev] = (rum.fodf.vol, rum.gfa.vol, rum.snr_mean,
                    rum.peak[0].vol, tract.n_count, time.time() - t1)
    (f_g, g_g, s_g, p_g, n_g, t_g), (f_c, g_c, s_c, p_c, n_c, t_c) = \
        out["cuda"], out["cpu"]
    m = mask.vol > 0
    dfodf = float(np.abs(f_g - f_c).max())
    dgfa = float(np.abs(g_g - g_c).max())
    dsnr = abs(s_g - s_c)
    ng, nc = np.linalg.norm(p_g, axis=-1), np.linalg.norm(p_c, axis=-1)
    valid = m & (ng > 0) & (nc > 0)
    cos = np.abs((p_g * p_c).sum(-1))[valid] / (ng * nc)[valid]
    same = float((cos >= 1 - 1e-6).mean())
    log(f"[rumba-small] 32x32x20x32, 30 iterations: card {t_g:.2f} s, cpu "
        f"{t_c:.2f} s; max|dfODF|={dfodf:.3g} max|dGFA|={dgfa:.3g} "
        f"|dsnr_mean|={dsnr:.3g}; peak 1 equal on {100 * same:.3f}% of "
        f"{int(valid.sum())} voxels; streams card {n_g} cpu {n_c}; phase "
        f"{time.time() - t0:.1f} s")
    check(dfodf <= 1e-5, f"fODF differs by {dfodf} between card and CPU")
    check(dgfa <= 1e-4, f"GFA differs by {dgfa} between card and CPU")
    check(dsnr <= 1e-2, f"snr_mean differs by {dsnr} between card and CPU")
    check(same >= 0.995, f"peak 1 equal on only {same:.4f} of voxels")
    check(n_c > 0 and abs(n_g - n_c) <= 0.005 * n_c,
          f"stream counts card {n_g} vs cpu {n_c}")


def phase_mesh_step(mesh, n=131_072):
    """[mesh] One `full_recon_step` (DTI, GQI through `gqi_fused`, one
    RUMBA-SD update with its TV term, 8 streamline steps) on the mesh and
    on one device, from the same inputs: __graft_entry__.py's problem at
    n rows, with the main path's 198-volume table and sphere_642.  The
    row outputs within tests/test_parallel.py's tolerances (FA, ODF, QA,
    peaks rtol 1e-4 / atol 2e-5; fODF, sigma^2, lambda rtol 1e-4 / atol
    1e-6), npts equal, points within 1e-6.  Returns the mesh run's
    launches: gqi_fused once per shard, tv_multiplier once per device,
    propagate_dir once per shard (one direction)."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.parallel.mesh import ShardedRows
    from fibers_tpu_torch.parallel.pipeline import (build_constants,
                                                    full_recon_step)
    from fibers_tpu_torch.utils.phantom import make_brain

    probe, _, _ = make_brain(shape=(2, 2, 2))          # the 198-volume table
    bval = np.asarray(probe.bval, np.float32)
    c = build_constants(bval, np.asarray(probe.bvec, np.float32),
                        tt.sphere_642)
    rng = np.random.default_rng(0)
    signals = np.abs(rng.standard_normal((n, len(bval)))).astype(np.float32)
    ncomp = c["kernel"].shape[1]
    fodf = np.full((n, ncomp), 1.0 / ncomp, np.float32)
    sig2 = np.full((n, 1), (1.0 / 15) ** 2, np.float32)
    rsig = np.clip(np.abs(rng.standard_normal(
        (n, c["kernel"].shape[0]))), 0, 1).astype(np.float32)
    tv_shape3 = (64, 64, -(-n // 4096))
    lam = np.full(int(np.prod(tv_shape3)), (1.0 / 15) ** 2, np.float32)
    tv_idx = np.arange(n, dtype=np.int64)
    shape3 = (32, 32, 32)
    ovecs = rng.standard_normal((int(np.prod(shape3)), 1, 3)).astype(
        np.float32)
    ovecs /= np.linalg.norm(ovecs, axis=2, keepdims=True)
    seeds = rng.uniform(1, shape3[0] - 2, (n, 3)).astype(np.float32)
    seed_vecs = ovecs[np.ravel_multi_index(
        np.round(seeds).astype(int).T, shape3), 0]
    args = (signals, rsig, fodf, sig2, lam, tv_idx, seeds, seed_vecs,
            np.ones(len(ovecs), bool), ovecs, c["A_dti"], c["ib0"],
            c["A_gqi"], c["kernel"], c["verts_first"], c["nbr"],
            c["nbr_ok"], shape3, tv_shape3)
    runs = {}
    for name, kw in (("one device", dict(device="cuda")),
                     ("mesh", dict(mesh=mesh))):
        full_recon_step(*args, **kw)                          # warm run
        sync_all(mesh)
        reset_counts()
        t0 = time.time()
        out = full_recon_step(*args, **kw)
        sync_all(mesh)
        runs[name] = (out, time.time() - t0, read_counts())
    (one, t_one, c_one), (sh, t_sh, c_sh) = runs["one device"], runs["mesh"]
    names = ("fa", "odf", "peaks", "qa", "fodf", "sig2", "lam", "pts",
             "npts")
    errs = []
    for name, a, b in zip(names, one, sh):
        if isinstance(b, ShardedRows):
            b = b.gather(a.device)
        a, b = a.to(b.device), b
        errs.append(f"{name} " + ("bit-equal" if torch.equal(a, b) else
                                  f"max|d|={float((a - b).abs().max()):.3g}"))
        if name == "npts":
            check(torch.equal(a, b), "full_recon_step's npts differ")
        elif name == "pts":
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        elif name in ("fodf", "sig2", "lam"):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)
        else:
            torch.testing.assert_close(b, a, rtol=1e-4, atol=2e-5,
                                       equal_nan=True)
    log(f"[mesh] full_recon_step, {n} rows, {len(bval)} volumes, "
        f"sphere_642, TV grid {tv_shape3}: one device {1e3 * t_one:.1f} ms "
        f"(launches {c_one}), mesh {1e3 * t_sh:.1f} ms (launches {c_sh}); "
        + ", ".join(errs))
    check(c_one["gqi_fused"] == 1 and c_one["tv_fused"] == 1
          and c_one["propagate_dir"] == 1 and sum(c_one.values()) == 3,
          f"one-device step launched {c_one}")
    check(c_sh["gqi_fused"] == mesh.ndata
          and c_sh["tv_multiplier"] == mesh.size
          and c_sh["propagate_dir"] == mesh.ndata
          and sum(c_sh.values()) == 2 * mesh.ndata + mesh.size,
          f"the mesh step launched {c_sh}")
    return c_sh


def _check_no_kernel(counts, what):
    """The DSI fit and the structure tensor run none of the kernels: their
    launch counts stay 0."""
    check(not any(counts.values()), f"{what} launched kernels: {counts}")


def phase_mesh_dsi(dwi, mask, mesh, ref, st_ref):
    """[mesh] DSI config 3 with `mesh=` (each chunk's rows sharded, the QA
    normaliser a max over the shards) against the unsharded counted run
    `ref` of the same call: ODF and PDF within rtol 1e-4 / atol 1e-6 and
    QA1 within rtol 1e-3 / atol 1e-5 (tests/test_parallel.py's), peak 1
    equal on >= 99.5% of the valid voxels (the card-against-CPU rule)."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt

    nmask = int((mask.vol > 0).sum())
    tt.dsi_rec(dwi, mask, tt.sphere_642, mesh=mesh)          # warm run
    sync_all(mesh)
    reset_counts()
    stages = {}
    dsi = tt.dsi_rec(dwi, mask, tt.sphere_642, mesh=mesh, timings=stages)
    counts = read_counts()
    errs = {}
    for name in ("pdf", "odf"):
        a = device_values(getattr(dsi, name)).gather()[:nmask]
        b = device_values(getattr(ref, name))[:nmask]
        errs[name] = ("bit-equal" if torch.equal(a, b) else
                      f"max|d|={float((a - b).abs().max()):.3g}")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        del a, b
    qa, qa_r = dsi.qa[0].vol, ref.qa[0].vol
    np.testing.assert_allclose(qa, qa_r, rtol=1e-3, atol=1e-5)
    valid = (qa > 0) & (qa_r > 0)
    same = float(np.all(dsi.peak[0].vol == ref.peak[0].vol,
                        axis=-1)[valid].mean())
    log(f"[mesh] DSI config 3 over {mesh.ndata} shards: " + ", ".join(
        f"{k}={v:.3f} s" for k, v in stages.items()) + "; unsharded "
        + ", ".join(f"{k}={v:.3f} s" for k, v in st_ref.items())
        + f"; launches {counts}; PDF {errs['pdf']}, ODF {errs['odf']}, "
        f"max|dQA1|={float(np.abs(qa - qa_r).max()):.3g}, peak 1 equal on "
        f"{100 * same:.3f}% of {int(valid.sum())} voxels")
    _check_no_kernel(counts, "the mesh DSI path")
    check(same >= 0.995, f"mesh DSI peak 1 equal on only {same:.4f}")


def phase_dsi(mesh):
    """Config 3 at full width on the card (96^3, 515 q-samples,
    sphere_642): a warm run, then a counted run with its stage times and
    peak device memory; checks; the mesh run (`phase_mesh_dsi`); the DSI
    peaks chained into ~1M streams written to a .trk and read back."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.utils.phantom import make_dsi_brain

    t0 = time.time()
    dwi, mask, ax = make_dsi_brain()
    m = mask.vol > 0
    nmask = int(m.sum())
    log(f"[dsi] set-up: phantom {dwi.vol.shape} built in "
        f"{time.time() - t0:.1f} s; {nmask} masked voxels")
    t0 = time.time()
    tt.dsi_rec(dwi, mask, tt.sphere_642)                   # warm run
    torch.cuda.synchronize()
    t_warm = time.time() - t0

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    t0 = time.time()
    dsi = tt.dsi_rec(dwi, mask, tt.sphere_642, timings=stages)
    t_fit = time.time() - t0
    counts = read_counts()
    peak_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[dsi] config 3: warm run {t_warm:.3f} s; counted run "
        + ", ".join(f"{k}={v:.3f} s" for k, v in stages.items())
        + f", total {t_fit:.3f} s; peak device memory {peak_mem:.2f} GiB; "
        f"launches {counts}")
    _check_no_kernel(counts, "the DSI path")

    for name in ("pdf", "odf"):
        v = device_values(getattr(dsi, name))[:nmask]
        check(bool(torch.isfinite(v).all()), f"DSI {name} not finite")
    qa = dsi.qa[0].vol[m]
    pk = dsi.peak[0].vol[m]
    cos = np.abs((pk * ax[m]).sum(-1))
    log(f"[dsi] QA1 in [{qa.min():.4f}, {qa.max():.4f}]; peak 1 vs true "
        f"axis median |cos|={np.median(cos):.4f} over {nmask} voxels")
    check(np.isfinite(qa).all() and (qa > 0).all(), "QA1 not positive")
    check(np.median(cos) > 0.9, "DSI peak 1 does not follow the true axis")
    phase_mesh_dsi(dwi, mask, mesh, dsi, stages)

    seed = _seed_mask(mask, 1_000_000)
    with tempfile.TemporaryDirectory() as d:
        trk = os.path.join(d, "dsi.trk")
        reset_counts()
        t1 = time.time()
        pkd = tt.peaks_to_ovecs(dsi, device=True)
        tract = tt.stream(pkd, mask=mask, seed=seed, nsub=3, wire="f32",
                          trk_sink=trk)
        t_stream = time.time() - t1
        chain_counts = read_counts()
        back = tt.trk_read(trk)
        os.remove(trk)
        stream_write = kernel_vs_plain(
            "DSI chain", lambda trk_: tt.stream(
                pkd, mask=mask, seed=seed, nsub=3, wire="f32",
                trk_sink=trk_), d)
    npts = int(np.sum(tract.npts))
    nprop = stream_chunks(3 * int((seed.vol > 0).sum()))
    log(f"[dsi] chain: {int((seed.vol > 0).sum())} seed voxels, nsub=3, "
        f"{pkd.nvec} peaks: stream+write {t_stream:.3f} s, "
        f"{tract.n_count} streams, {npts} points; launches {chain_counts}")
    check(tract.n_count > 0, "no streamlines from the DSI peaks")
    check(back.n_count == tract.n_count and int(np.sum(back.npts)) == npts,
          f".trk holds {back.n_count} lines, the Tract {tract.n_count}")
    check(chain_counts["propagate_pair"] == nprop
          and sum(chain_counts.values()) == nprop,
          f"the DSI chain's stream launched {chain_counts}, not "
          f"propagate_pair {nprop} times")
    return chain_counts, stream_write


def phase_structens(vol, mesh):
    """st_recon on the mean DWI of config 4 (140x140x92), sigma 1, rho 2,
    lazy, as bench_models.py pairs it with RUMBA: a warm run, then a
    timed one."""
    import torch
    import fibers_tpu_torch as tt

    tt.st_recon(vol, sigma=1.0, rho=2.0, lazy=True)          # warm run
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    evecs, evals = tt.st_recon(vol, sigma=1.0, rho=2.0, lazy=True)
    torch.cuda.synchronize()
    t_st = time.time() - t0
    counts = read_counts()
    ev = evals.device
    log(f"[structens] {tuple(vol.shape)}: {1e3 * t_st:.2f} ms (upload, 30 "
        f"banded GEMMs, eigh3; lazy outputs stay on the card); "
        f"eigenvalues in [{float(ev.min()):.4g}, {float(ev.max()):.4g}]")
    _check_no_kernel(counts, "the structure tensor")
    check(tuple(ev.shape) == tuple(vol.shape) + (3,)
          and tuple(evecs.device.shape) == tuple(vol.shape) + (3, 3),
          "structure-tensor output shapes")
    check(bool(torch.isfinite(ev).all()), "eigenvalues not finite")
    check(bool((ev.diff(dim=-1) >= 0).all()), "eigenvalues not ascending")

    # [mesh] slabs along the first axis with their halos, one per shard,
    # against the unsharded run: eigenvalues within 1e-5 of the largest
    # (tests/test_torch_structens.py's)
    tt.st_recon(vol, sigma=1.0, rho=2.0, lazy=True, mesh=mesh)   # warm run
    sync_all(mesh)
    reset_counts()
    t0 = time.time()
    evm, elm = tt.st_recon(vol, sigma=1.0, rho=2.0, lazy=True, mesh=mesh)
    sync_all(mesh)
    t_mesh = time.time() - t0
    counts = read_counts()
    dl = float((elm.device - ev).abs().max() / ev.abs().max())
    dv = float((evm.device.abs() - evecs.device.abs()).abs().max())
    log(f"[mesh] st_recon over {mesh.ndata} slabs: {1e3 * t_mesh:.2f} ms "
        f"(unsharded {1e3 * t_st:.2f} ms); max|dλ|/max|λ|={dl:.3g}, "
        f"max||dv||={dv:.3g}")
    _check_no_kernel(counts, "the mesh structure tensor")
    check(dl <= 1e-5, f"mesh eigenvalues differ by {dl} (relative)")
    return t_st


def _micro_seed(mask):
    """Every other voxel in x and y of the mask."""
    import numpy as np
    from fibers_tpu_torch.core.mri import MRI
    seed = MRI.like(mask, 1, np.float32)
    sv = np.zeros(mask.vol.shape, np.float32)
    sv[::2, ::2] = mask.vol[::2, ::2]
    seed.vol = sv
    return seed


# the microscopy regime's own defaults (reference: src/stream.jl:83-92)
MICRO = dict(nsub=None, ang_thresh=None, step_size=None, smooth_coeff=None)


# floating-point operations of the mode kernels, counting a log, square
# root or divide as one: an active LCM stream-step needs at least its next
# position (6) and the angle pick over its nvec candidates (7 each; the
# draw and the jump's pick come only on entering a voxel, and the Philox
# draws are integer work, outside the FP32 peak); each window cell of a
# micro step inside the volume and the mask its cone test (3 products, 2
# sums, a compare), and each active micro stream-step its next position
# and angle test (11)
LCM_FLOPS_STEP, LCM_FLOPS_CAND = 6, 7
MICRO_FLOPS_CELL, MICRO_FLOPS_STEP = 6, 11
# the modes' runs: LCM on a 256 x 256 slice with 3 jitters a voxel (a
# 512 x 512 slice wrote a 6.29 GB .trk, past the 4 GB this script allows a
# run, so its side is halved), microscopy on 1024 x 1024 x 2 at 10 um with
# every 4th voxel seeded; both at 256 for the run through the plain loops
LCM_SIDE, MICRO_SIDE, PLAIN_SIDE = 256, 1024, 256


class _Captured(Exception):
    pass


def chunk_calls(name, run, last=False):
    """The arguments of the two calls of `tract/modes.py:<name>` for the
    first chunk of `run()` (its forward and backward direction; the run
    stops there), or with `last` for its last chunk (the run goes to its
    end).  The calls run, so each backward call gets its counts."""
    from fibers_tpu_torch.tract import modes
    real, calls = getattr(modes, name), []

    def record(*args):
        calls.append(args)
        if len(calls) == 2 and not last:
            raise _Captured
        return real(*args)

    setattr(modes, name, record)
    try:
        run()
    except _Captured:
        pass
    finally:
        setattr(modes, name, real)
    check(len(calls) >= 2 and len(calls) % 2 == 0,
          f"{name}: the run made {len(calls)} calls")
    return calls[-2:]


class window_cells:
    """Inside the block, the micro plain loop records, step by step, how
    many cells of each stream's window lie in the volume and the mask (the
    cells whose cone test the step needs; `steps`, one [S] tensor a step)
    and counts in `hits` [nvox] the voxels those cells are."""

    def __init__(self, mask_flat):
        import torch
        self.mask, self.steps = mask_flat, []
        self.hits = torch.zeros(mask_flat.shape[0], dtype=torch.int32,
                                device=mask_flat.device)

    def __enter__(self):
        import torch
        from fibers_tpu_torch.ops.kernels import propagate_micro as pm
        self._real = real = pm._flat_index

        def counted(ipos, shape3):
            flat, inb = real(ipos, shape3)
            if ipos.dim() == 3:                      # the window [S, W, 3]
                need = inb & self.mask[flat]
                self.steps.append(need.sum(dim=1, dtype=torch.int32))
                self.hits.index_add_(0, flat.reshape(-1),
                                     need.reshape(-1).to(torch.int32))
            return flat, inb

        pm._flat_index = counted
        return self

    def __exit__(self, *exc):
        from fibers_tpu_torch.ops.kernels import propagate_micro as pm
        pm._flat_index = self._real


def active_steps(npts, npts0, nsteps):
    """A direction's active stream-steps, on the device: a stream searches
    at its saved steps (npts - npts0) and at the one after, within the
    nsteps."""
    import torch
    return torch.clamp(npts - npts0 + 1, max=nsteps).sum()


class launch_events:
    """Inside the block, every call of `tract/modes.py:<name>` is
    bracketed by CUDA events on the current stream (nothing waits for
    them); after the block, `ms()` gives each call's device time.  With
    `ni` (npts0's place among the arguments and npts's among the
    results), `active` holds each call's active stream-steps and `nbytes`
    its outputs' bytes."""

    def __init__(self, name, ni=None):
        self.name, self.ni, self.pairs = name, ni, []
        self.active, self.nbytes = [], 0

    def __enter__(self):
        import torch
        from fibers_tpu_torch.tract import modes
        self._real = real = getattr(modes, self.name)

        def timed(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real(*args)
            ev[1].record()
            self.pairs.append(ev)
            if self.ni is not None:
                self.active.append(active_steps(out[self.ni], args[self.ni],
                                                out[1].shape[0]))
                self.nbytes += sum(t.nbytes for t in out)
            return out

        setattr(modes, self.name, timed)
        return self

    def __exit__(self, *exc):
        from fibers_tpu_torch.tract import modes
        setattr(modes, self.name, self._real)

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


def mode_chunk(name, calls, n=None):
    """[modes] The first chunk of a mode's run (`calls`: its forward and
    backward calls), or with `n` its first n streams (every stream's
    outputs depend only on its own start state): the kernel against the
    plain loop on both directions, bit for bit on every output; the
    forward direction timed with CUDA events in turns plain / kernel /
    kernel / plain, beside the bound of its bytes (start state, outputs,
    the field's voxels it visits) and its operations (the active
    stream-steps; for micro the in-volume, in-mask window cells of each).
    With `n`, also the kernel on the whole chunk, held to the plain loop
    in slices of n streams, and its forward direction timed beside a
    bound that estimates its window cells from the slice's cells per
    active step (`whole_chunk`).  Returns the record."""
    import torch
    from fibers_tpu_torch.ops.kernels import propagate_lcm, propagate_micro
    lcm = name == "lcm"
    kmod = propagate_lcm if lcm else propagate_micro
    kern = getattr(kmod, f"propagate_{name}_dir")
    plain = getattr(kmod, f"propagate_{name}_dir_plain")
    ni = 3 if lcm else 2                  # npts0 among the arguments
    whole = calls
    if n is not None:                     # the start states' first n rows
        calls = [tuple(a[:n] if ni - 2 <= i <= ni else a
                       for i, a in enumerate(c)) for c in calls]
    fwd_args, bwd_args = calls
    fwd, bwd = kern(*fwd_args), kern(*bwd_args)
    torch.cuda.synchronize()
    mask = fwd_args[ni + 1]
    if lcm:
        seen = visited_voxels(mask.shape[0], mask.device, propagate_lcm)
    else:
        seen = window_cells(mask)
    with seen:
        fwd_p = plain(*fwd_args)
    bwd_p = plain(*bwd_args[:ni], fwd_p[ni], *bwd_args[ni + 1:])
    same = [_same_bits(a, b) for a, b in zip(fwd + bwd, fwd_p + bwd_p)]
    err = _max_err(fwd + bwd, fwd_p + bwd_p)
    check(all(same), f"{name}: the kernel differs from the plain loop "
          f"(outputs of both directions equal: {same}; max|d| {err})")
    out, saved = fwd_p[0], fwd_p[1]
    nsteps, s = saved.shape
    del bwd, bwd_p
    torch.cuda.empty_cache()
    if lcm:
        extra_lcm = lcm_budget_and_scaling(kern, plain, fwd_args, bwd_args)

    def k():
        return kern(*fwd_args)

    def p():
        return plain(*fwd_args)

    k()
    torch.cuda.synchronize()
    turns = [cuda_ms(p, 1), cuda_ms(k, 5), cuda_ms(k, 5), cuda_ms(p, 1)]
    state = sum(t.nbytes for t in fwd_args[ni - 2:ni + 1])
    outputs = sum(t.nbytes for t in fwd)
    if lcm:
        ovecs, lcms = fwd_args[ni + 2], fwd_args[ni + 3]
        nvec = ovecs.shape[1]
        nvisit = int((seen.hits > 0).sum())
        field = nvisit * (nvec * 12 + lcms.shape[1] * 4 + 1)
        moved = (out[1:] != out[:-1]).any(dim=-1)
        steps = s + int(moved.sum())
        flops = steps * (LCM_FLOPS_STEP + nvec * LCM_FLOPS_CAND)
        extra = dict(nvec=nvec, **extra_lcm)
    else:
        # a stream searches at its saved steps and at the one after
        n_saved = saved.sum(dim=0)
        active = (torch.arange(nsteps, device=saved.device)[:, None]
                  <= n_saved[None])
        cells = int((torch.stack(seen.steps) * active).sum())
        steps = int(active.sum())
        nvisit = int((seen.hits > 0).sum())
        field = (nvisit * 13 + fwd_args[ni + 3].nbytes
                 + fwd_args[ni + 4].nbytes)
        flops = cells * MICRO_FLOPS_CELL + steps * MICRO_FLOPS_STEP
        extra = dict(window=int(fwd_args[ni + 3].shape[0]),
                     window_cells_tested=cells)
    nbytes = state + outputs + field
    rec = dict(max_abs_err=err, ms=(turns[1] + turns[2]) / 2,
               plain_ms=(turns[0] + turns[3]) / 2, streams=s, nsteps=nsteps,
               active_steps=steps, voxels_visited=nvisit, nbytes=nbytes,
               flops=flops, **extra, **bound_ms(nbytes, flops))
    log(f"[modes] {name} chunk: {s} streams x {nsteps} steps: kernel "
        f"bit-equal to the plain loop on both directions; one direction: "
        f"kernel {rec['ms']:.3f} ms, plain loop {rec['plain_ms']:.3f} ms "
        f"(turns plain, kernel, kernel, plain: "
        f"{', '.join(f'{t:.3f}' for t in turns)}); bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({nbytes / 1e6:.1f}"
        f" MB with {nvisit} voxels visited; {flops / 1e9:.3f} GFLOP over "
        f"{steps} active stream-steps"
        f"{'' if lcm else f', {cells} window cells'}), share "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f}%")
    if n is not None:
        rec["full_chunk"] = whole_chunk(kern, plain, whole, n,
                                        cells / steps, field)
        rec["cells_per_active_step"] = cells / steps
    return rec


def lcm_budget_and_scaling(kern, plain, fwd_args, bwd_args, budget=20):
    """[modes] The LCM kernel at a budget of `budget` points, which cuts
    most lines of the chunk, against the plain loop on both directions,
    bit for bit; and the forward direction's time at the chunk's first
    32,768 and 65,536 streams and all of it.  Returns the record's
    additions."""
    import torch
    li = 14                               # len_max among the arguments
    f_args = fwd_args[:li] + (budget,) + fwd_args[li + 1:]
    fwd, fwd_p = kern(*f_args), plain(*f_args)
    b_args = bwd_args[:3] + (fwd_p[3],) + bwd_args[4:li] + (budget,) \
        + bwd_args[li + 1:]
    bwd, bwd_p = kern(*b_args), plain(*b_args)
    same = [_same_bits(a, b) for a, b in zip(fwd + bwd, fwd_p + bwd_p)]
    ncut = int((bwd_p[3] > budget).sum())
    del fwd, bwd, fwd_p, bwd_p
    check(all(same) and ncut > len(fwd_args[1]) // 10,
          f"lcm: at a budget of {budget} points the kernel differs from "
          f"the plain loop ({same}) or the budget cut only {ncut} lines")
    s = len(fwd_args[1])
    sizes = [k for k in (32_768, 65_536) if k < s] + [s]
    ms = {}
    for k in sizes:
        a = tuple(x[:k] if 1 <= i <= 3 else x for i, x in enumerate(fwd_args))
        kern(*a)
        ms[k] = cuda_ms(lambda: kern(*a), 5)
    torch.cuda.empty_cache()
    log(f"[modes] lcm chunk: kernel bit-equal to the plain loop on both "
        f"directions at a budget of {budget} points ({ncut} lines cut); the "
        f"forward direction at " + ", ".join(f"{k} streams {t:.3f} ms"
                                             for k, t in ms.items()))
    return dict(budget_case=dict(len_max=budget, lines_cut=ncut),
                scaling_ms=ms)


def _rows(outs, sl):
    """The streams `sl` of a direction's outputs (out [nsteps, S, 3],
    saved [nsteps, S], npts [S], anchor [S, 3])."""
    return [o[:, sl] for o in outs[:2]] + [o[sl] for o in outs[2:]]


def held_in_slices(kern, plain, calls, n, what):
    """[modes] The micro kernel on a whole chunk of a run (`calls`: its
    forward and backward calls) against the plain loop over the same
    chunk in slices of `n` streams, bit for bit on every output of both
    directions; a stream's outputs depend only on its own start state
    (tests/test_torch_modes_kernels.py:
    test_micro_plain_rows_depend_only_on_their_own_stream).  Returns the
    kernel's forward outputs and the largest |difference|."""
    ni = 2                                # npts0 among the arguments
    fwd_args, bwd_args = calls
    fwd, bwd = kern(*fwd_args), kern(*bwd_args)
    s = fwd_args[0].shape[0]
    err, t0 = 0.0, time.time()
    for lo in range(0, s, n):
        sl = slice(lo, min(lo + n, s))
        fp, bp = ([a[sl] if i <= ni else a for i, a in enumerate(c)]
                  for c in calls)
        fwd_p = plain(*fp)
        bwd_p = plain(*bp[:ni], fwd_p[ni], *bp[ni + 1:])
        ours, refs = _rows(fwd, sl) + _rows(bwd, sl), fwd_p + bwd_p
        same = [_same_bits(a, b) for a, b in zip(ours, refs)]
        err = max(err, _max_err(ours, refs))
        check(all(same), f"micro {what}: the kernel differs from the plain "
              f"loop on streams {sl.start}-{sl.stop - 1} of {s} (outputs of "
              f"both directions equal: {same}; max|d| {err})")
    log(f"[modes] micro {what}: {s} streams: kernel bit-equal to the plain "
        f"loop on both directions, the plain loop in {-(-s // n)} slices "
        f"of {n} streams ({time.time() - t0:.1f} s)")
    return fwd, err


def whole_chunk(kern, plain, calls, n, per_step, field):
    """[modes] The micro kernel on a whole chunk (`calls`), held to the
    plain loop in slices of `n` streams (`held_in_slices`); then its
    forward direction timed, CUDA events over three launches after a
    warm one, beside a bound whose window cells are an estimate: the
    chunk's active stream-steps (from its counts) times `per_step`, the
    cells per active step of the slice the plain loop ran; its bytes: the
    start state, the outputs and the slice's `field` bytes.  Returns the
    record."""
    import torch
    ni, args = 2, calls[0]
    out, err = held_in_slices(kern, plain, calls, n, "whole chunk")
    steps = int(active_steps(out[ni], args[ni], out[1].shape[0]))
    nbytes = (sum(t.nbytes for t in args[:ni + 1])
              + sum(t.nbytes for t in out) + field)
    del out
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: kern(*args), 3)
    torch.cuda.empty_cache()
    cells = steps * per_step
    flops = cells * MICRO_FLOPS_CELL + steps * MICRO_FLOPS_STEP
    rec = dict(streams=int(args[0].shape[0]), ms=ms, max_abs_err=err,
               active_steps=steps, window_cells_estimate=cells,
               nbytes=nbytes, flops=flops, **bound_ms(nbytes, flops))
    log(f"[modes] micro whole chunk: {rec['streams']} streams: kernel "
        f"{ms:.3f} ms a direction; estimated bound {rec['bound_ms']:.4f} ms "
        f"by {rec['bound_by']} ({steps} active stream-steps x "
        f"{per_step:.1f} cells of the slice's, {flops / 1e9:.3f} GFLOP; "
        f"{nbytes / 1e6:.1f} MB), share "
        f"{100 * rec['bound_ms'] / ms:.1f}%")
    return rec


def run_estimate(ev, ms, rec):
    """[modes] The micro run's bound, an estimate: its active
    stream-steps (`ev.active`, from every launch's counts) times the
    slice's window cells per active step; its bytes the launches'
    outputs.  Against the sum `ms` of the launches' times."""
    steps = int(sum(int(a) for a in ev.active))
    cells = steps * rec["cells_per_active_step"]
    flops = cells * MICRO_FLOPS_CELL + steps * MICRO_FLOPS_STEP
    out = dict(active_steps=steps, window_cells_estimate=cells,
               nbytes=ev.nbytes, flops=flops,
               **bound_ms(ev.nbytes, flops))
    log(f"[modes] micro run: estimated bound {out['bound_ms']:.3f} ms by "
        f"{out['bound_by']} ({steps} active stream-steps x "
        f"{rec['cells_per_active_step']:.1f} cells, {flops / 1e9:.2f} "
        f"GFLOP; {ev.nbytes / 1e9:.3f} GB of outputs) against the "
        f"launches' sum {ms:.3f} ms, share {100 * out['bound_ms'] / ms:.1f}%")
    return out


def phase_modes():
    """[modes] The LCM and microscopy modes through their kernels: the
    self-checks of the kernels' arithmetic against torch on the card; the
    first chunk of each mode's run, kernel against plain loop
    (`mode_chunk`; micro on the plain loop's chunk, the first streams of
    the kernel's, then on the kernel's whole first and last chunks in
    slices of the plain loop's); stream + write on LCM_SIDE^2 (3 jitters a voxel) and
    PLAIN_SIDE^2 x 2 microscopy through the kernels and through the plain
    loops, their .trk files byte for byte; microscopy on MICRO_SIDE^2 x 2
    through the kernel, every launch of the LCM and micro runs timed
    (`launch_events`) and the micro run's bound estimated
    (`run_estimate`).  Each run's .trk is read back and checked; each
    kernel launches twice a chunk of the chunk the run took.  Returns
    ({mode: record}, {mode: launches of the kernels on its run through
    them})."""
    import numpy as np
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.ops.kernels.propagate_lcm import lcm_selfcheck
    from fibers_tpu_torch.ops.kernels.propagate_micro import window_selfcheck
    from fibers_tpu_torch.utils.phantom import make_lcm_field, make_micro_field

    t0 = time.time()
    win, arith = window_selfcheck(), lcm_selfcheck()
    log(f"[modes] self-checks on the card: the micro kernel's window sums "
        f"of three against torch's (4096 streams x 748 cells, both "
        f"layouts) {win} mismatches; the LCM kernel's arithmetic against "
        f"torch's (logf on 2^22 floats, the Gumbel transform of all 2^24 "
        f"uniforms, 2^19 sums of ten and argmaxes, 2^17 x 10 uniforms) "
        f"{arith} mismatches")
    check(win == 0 and not any(arith.values()),
          "a mode kernel's arithmetic differs from torch's on the card")

    ovecs, lcm, lmask = make_lcm_field((LCM_SIDE, LCM_SIDE))
    mov, mmask = make_micro_field((PLAIN_SIDE, PLAIN_SIDE, 2))
    mseed = _micro_seed(mmask)
    big, bmask = make_micro_field((MICRO_SIDE, MICRO_SIDE, 2))
    bseed = _micro_seed(bmask)
    nseeds = dict(lcm=3 * int((lmask.vol > 0).sum()),
                  micro=int((bseed.vol > 0).sum()))
    sizes = dict(lcm=f"{LCM_SIDE}^2", micro=f"{MICRO_SIDE}^2 x 2")
    # the micro kernel is held to the plain loop on the plain loop's own
    # chunk (the reference's rule: 5,698 streams at W = 748), the first
    # streams of the kernel's first chunk, then in slices of that size
    from fibers_tpu_torch.tract.modes import _reference_chunk, _search_window
    micro_slice = _reference_chunk(tt.StreamConfig(), len(_search_window(
        (15, 15, 0))[0]))
    runs = dict(
        lcm=lambda trk=None: tt.stream(ovecs, mask=lmask, lcms=lcm, nsub=3,
                                       trk_sink=trk),
        micro256=lambda trk=None: tt.stream(
            mov, mask=mmask, seed=mseed, search_dist=15, trk_sink=trk,
            **MICRO),
        micro=lambda trk=None: tt.stream(big, mask=bmask, seed=bseed,
                                         search_dist=15, trk_sink=trk,
                                         **MICRO))
    records = {
        "lcm": mode_chunk("lcm", chunk_calls("propagate_lcm_dir",
                                                   runs["lcm"])),
        "micro": mode_chunk("micro", chunk_calls(
            "propagate_micro_dir", runs["micro"]), micro_slice)}
    # and on the whole of the run's last (ragged) chunk
    from fibers_tpu_torch.ops.kernels import propagate_micro as pm
    micro = records["micro"]
    last = chunk_calls("propagate_micro_dir", runs["micro"], last=True)
    micro["last_chunk_streams"] = int(last[0][0].shape[0])
    _, err = held_in_slices(pm.propagate_micro_dir,
                            pm.propagate_micro_dir_plain, last, micro_slice,
                            "last chunk")
    del last
    micro["max_abs_err"] = max(micro["max_abs_err"],
                               micro["full_chunk"]["max_abs_err"], err)
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        for name in ("lcm", "micro256"):
            times, plain_s, counts = kernel_vs_plain(name, runs[name], d,
                                                     "[modes]")
            mode = name[:-3] if name.endswith("256") else name
            records[mode][f"stream_write_s_{PLAIN_SIDE}"] = dict(
                kernel=times, plain=plain_s)
            if name == "lcm":
                launches["lcm"] = counts
        for name in ("lcm", "micro"):
            trk = os.path.join(d, f"{name}.trk")
            reset_counts()
            t1 = time.time()
            with launch_events(f"propagate_{name}_dir",
                               None if name == "lcm" else 2) as ev, \
                    sink_seconds() as sk:
                tract = runs[name](trk)
            t = time.time() - t1
            counts = read_counts()
            per = ev.ms()
            size = os.path.getsize(trk)
            back = tt.trk_read(trk)
            npts = int(np.sum(tract.npts))
            kname = f"propagate_{name}_dir"
            chunk = records[name].get("full_chunk", records[name])["streams"]
            want = 2 * -(-nseeds[name] // chunk)
            log(f"[modes] {name} {sizes[name]}: {nseeds[name]} seeds, "
                f"{tract.n_count} streams, {npts} points, .trk "
                f"{size / 1e9:.3f} GB, stream+write {t:.3f} s (.trk writer "
                f"thread busy {sk.busy:.3f} s, the loop's stall on it "
                f"{sk.stall:.3f} s, appends {sk.seconds:.3f} s); launches "
                f"{counts}; the kernel's {len(per)} launches (CUDA events "
                f"each) sum {sum(per):.3f} ms, min {min(per):.3f}, max "
                f"{max(per):.3f}")
            check(tract.n_count > 0, f"no {name} streamlines")
            check(back.n_count == tract.n_count
                  and int(np.sum(back.npts)) == npts,
                  f"{name} .trk holds {back.n_count} lines, the Tract "
                  f"{tract.n_count}")
            check(all(np.isfinite(x).all() for x in back.xyz),
                  f"{name}: non-finite points in the .trk")
            if name == "lcm":
                check(back.n_scalars == 1, "the LCM .trk has no scalar")
            check(counts[kname] == want
                  and sum(counts.values()) == counts[kname],
                  f"the {name} run launched {counts}, not {kname} twice a "
                  f"chunk ({want})")
            del back, tract
            os.remove(trk)
            records[name]["stream_write_s"] = t
            records[name]["writer_s"] = dict(busy=sk.busy, stall=sk.stall)
            records[name]["run_launch_ms"] = dict(
                n=len(per), sum=sum(per), min=min(per), max=max(per))
            if name == "micro":
                records[name]["run_estimate"] = run_estimate(
                    ev, sum(per), records[name])
            records[name]["trk_bytes"] = size
            launches[name] = counts
    log(f"[modes] phase {time.time() - t0:.1f} s")
    return records, launches


# the 3-D block of the micro phase: the phantom and regime of the cell
# micro_trk (portbench/configs/micro_block_10um.json) on a 160 x 160 x 128
# block with every 5th voxel of its mask seeded, first in chunks of 6,144
# streams (three, the last ragged), held to the plain loop in slices of
# 2,048 streams; the kernel's window tile (csrc/propagate_micro.cu:kTile)
MICRO_BLOCK, MICRO_BLOCK_EVERY = (160, 160, 128), 5
MICRO_BLOCK_CHUNK, MICRO_BLOCK_SLICE, MICRO_TILE = 6144, 2048, 2048


class held_to_plain:
    """Inside the block, every call of `tract/modes.py:propagate_micro_dir`
    runs the kernel, then the plain loop on the same arguments in slices
    of `n` streams, and holds every output of the call to it bit for bit.
    From the plain loop: `cells` the in-volume, in-mask window cells of
    every active stream-step (`window_cells`), `steps` the active
    stream-steps, `seen.hits` the voxels the windows visit; `state_bytes`
    the calls' start states, `err` the largest |difference|."""

    def __init__(self, n):
        self.n, self.calls, self.cells, self.steps = n, 0, 0, 0
        self.state_bytes, self.err, self.seen = 0, 0.0, None

    def __enter__(self):
        import torch
        from fibers_tpu_torch.ops.kernels import propagate_micro as pm
        from fibers_tpu_torch.tract import modes
        self._real = real = modes.propagate_micro_dir

        def held(*args):
            out = real(*args)
            if self.seen is None:
                self.seen = window_cells(args[3])
            s = args[0].shape[0]
            for lo in range(0, s, self.n):
                sl = slice(lo, min(lo + self.n, s))
                self.seen.steps = []
                with self.seen:
                    ref = pm.propagate_micro_dir_plain(
                        *(a[sl] if i <= 2 else a for i, a in enumerate(args)))
                ours = _rows(out, sl)
                same = [_same_bits(a, b) for a, b in zip(ours, ref)]
                self.err = max(self.err, _max_err(ours, ref))
                check(all(same), f"micro 3-D block: call {self.calls}, "
                      f"streams {sl.start}-{sl.stop - 1} of {s}: the kernel "
                      f"differs from the plain loop (outputs equal: {same};"
                      f" max|d| {self.err})")
                nsteps = ref[1].shape[0]
                active = (torch.arange(nsteps, device=ref[1].device)[:, None]
                          <= ref[1].sum(dim=0)[None])
                self.cells += int((torch.stack(self.seen.steps)
                                   * active).sum())
                self.steps += int(active.sum())
            self.calls += 1
            self.state_bytes += sum(t.nbytes for t in args[:3])
            return out

        modes.propagate_micro_dir = held
        return self

    def __exit__(self, *exc):
        from fibers_tpu_torch.tract import modes
        modes.propagate_micro_dir = self._real


def _block_mri(vol, res):
    """An isotropic volume of voxel size `res` mm at the origin."""
    import numpy as np
    from fibers_tpu_torch.core.mri import MRI
    m = MRI(vol=vol)
    m.vox2ras0 = np.diag([res, res, res, 1.0]).astype(np.float32)
    m.volsize = np.asarray(vol.shape[:3])
    m.width, m.height, m.depth = vol.shape[:3]
    m.nframes = 1
    m.set_geometry()
    return m


def phase_micro_block():
    """[modes] Microscopy on a 3-D block, the regime the cell `micro_trk`
    runs: its phantom (`portbench/microscopy.py`) on MICRO_BLOCK, the
    primary eigenvectors of `st_recon` (sigma 1, rho 2) on the card as
    the field, `stream` with search_dist 15 on 3-D vectors: a window of
    15,514 cells, which the kernel scans in 8 tiles of MICRO_TILE.  First
    in chunks of MICRO_BLOCK_CHUNK streams, every chunk's kernel outputs
    on both directions held bit for bit to the plain loop
    (`held_to_plain`), which also counts the run's window cells; then at
    the card's chunk, its launches counted and each timed with CUDA
    events, beside the bound of that run: its operations the window cells
    of its active stream-steps (the plain loop's count: a line does not
    depend on the chunk) and the steps' own; its bytes the start states,
    the outputs, the window tables a launch and the voxels the windows
    visit.  The two .trk files byte for byte.  Returns (the record, the
    timed run's launches)."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.tract.modes import _search_window
    from portbench import microscopy

    t0 = time.time()
    with open(os.path.join(HERE, "portbench", "configs",
                           "micro_block_10um.json")) as f:
        cfg = json.load(f)
    blk = dict(cfg["block"], shape=list(MICRO_BLOCK))
    blk["tubes"] = dict(blk["tubes"], crossing_z=[MICRO_BLOCK[2] / 2, 6.0])
    res, st = float(blk["voxel_mm"]), cfg["stream"]
    img = microscopy.make_block(blk, 2 ** 33 + 7, 0, "cuda")
    mask = microscopy.tissue_mask(blk, "cuda")
    seed_vol = microscopy.seed_lattice(mask, MICRO_BLOCK_EVERY)
    ev, _ = tt.st_recon(img.numpy(), cfg["st"]["sigma"], cfg["st"]["rho"],
                        lazy=True)
    field = ev.device[..., :, 0]
    nseeds = int((seed_vol > 0).sum())
    w = len(_search_window([st["search_dist"]] * 3)[0])
    check(w > 7 * MICRO_TILE, f"the 3-D window has {w} cells, not 8 tiles")
    kw = dict(mask=_block_mri(mask.view(np.uint8), res),
              seed=_block_mri(seed_vol, res), search_dist=st["search_dist"],
              search_ang=st["search_ang"], wire=st["wire"], **MICRO)
    with tempfile.TemporaryDirectory() as d:
        trk = [os.path.join(d, f"{k}.trk") for k in ("chunks", "card")]
        reset_counts()
        t1 = time.time()
        with held_to_plain(MICRO_BLOCK_SLICE) as held:
            tt.stream(field, chunk=MICRO_BLOCK_CHUNK, trk_sink=trk[0], **kw)
        t_held = time.time() - t1
        counts = read_counts()
        want = 2 * -(-nseeds // MICRO_BLOCK_CHUNK)
        check(want >= 6 and held.calls == want
              and counts["propagate_micro_dir"] == want
              and sum(counts.values()) == want,
              f"micro 3-D block in chunks of {MICRO_BLOCK_CHUNK}: {held.calls}"
              f" calls held, launches {counts}, not {want}")
        log(f"[modes] micro 3-D block {MICRO_BLOCK}: {nseeds} seeds in "
            f"chunks of {MICRO_BLOCK_CHUNK}, window {w} cells: every chunk's"
            f" kernel outputs bit-equal to the plain loop on both directions "
            f"({held.calls} launches, the plain loop in slices of "
            f"{MICRO_BLOCK_SLICE}; {held.steps} active stream-steps, "
            f"{held.cells} window cells tested; {t_held:.1f} s)")

        reset_counts()
        t1 = time.time()
        with launch_events("propagate_micro_dir", 2) as evs, \
                sink_seconds() as sk:
            tract = tt.stream(field, trk_sink=trk[1], **kw)
        t = time.time() - t1
        counts = read_counts()
        per = evs.ms()
        want = 2 * -(-nseeds // tt.StreamConfig().chunk)
        check(counts["propagate_micro_dir"] == want
              and sum(counts.values()) == want,
              f"the micro 3-D block run launched {counts}, not "
              f"propagate_micro_dir twice a chunk ({want})")
        same = filecmp.cmp(trk[0], trk[1], shallow=False)
        size = os.path.getsize(trk[1])
    check(same, "micro 3-D block: the .trk differs between the card's "
          f"chunk and chunks of {MICRO_BLOCK_CHUNK}")
    steps = int(sum(int(a) for a in evs.active))
    check(steps == held.steps, f"micro 3-D block: {steps} active "
          f"stream-steps at the card's chunk, {held.steps} in chunks")
    nvisit = int((held.seen.hits > 0).sum())
    nbytes = (held.state_bytes + evs.nbytes + nvisit * 13
              + len(per) * w * 3 * (8 + 4))
    flops = held.cells * MICRO_FLOPS_CELL + steps * MICRO_FLOPS_STEP
    rec = dict(shape=list(MICRO_BLOCK), seeds=nseeds,
               streams=int(tract.n_count), window=w,
               chunks_held=held.calls // 2, max_abs_err=held.err,
               launches=counts["propagate_micro_dir"], ms=sum(per),
               stream_write_s=t, trk_bytes=size, active_steps=steps,
               window_cells_tested=held.cells, voxels_visited=nvisit,
               nbytes=nbytes, flops=flops, **bound_ms(nbytes, flops))
    log(f"[modes] micro 3-D block {MICRO_BLOCK} at the card's chunk: "
        f"{nseeds} seeds, {tract.n_count} streams, .trk {size / 1e6:.1f} MB"
        f" (byte-equal to the chunked run's), stream+write {t:.3f} s (.trk "
        f"writer busy {sk.busy:.3f} s, the loop's stall {sk.stall:.3f} s); "
        f"launches {counts}; the kernel's {len(per)} launches (CUDA events "
        f"each) sum {rec['ms']:.3f} ms; bound {rec['bound_ms']:.3f} ms by "
        f"{rec['bound_by']} ({steps} active stream-steps, {held.cells} "
        f"window cells, {flops / 1e9:.3f} GFLOP; {nbytes / 1e6:.1f} MB with "
        f"{nvisit} voxels visited), share "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f}%; phase "
        f"{time.time() - t0:.1f} s")
    del ev, field, tract
    torch.cuda.empty_cache()
    return rec, counts


def phase_new_small():
    """DSI, the structure tensor and the two modes on the card and on the
    CPU, on small inputs.  Tolerances: DSI ODF within 1e-5 and QA within
    1e-4 (the GQI card check's), peak 1 equal on >= 99.5% of valid
    voxels; eigenvalues within 1e-5 of the largest; micro lines
    identical; LCM line counts within 3% and mean lengths within 5%
    (tests/test_torch_modes.py's bounds)."""
    import numpy as np
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.utils.phantom import (make_dsi_brain,
                                                make_lcm_field,
                                                make_micro_field,
                                                make_rumba_brain)

    t0 = time.time()
    dwi, mask, _ = make_dsi_brain(small=True)
    g, c = (tt.dsi_rec(dwi, mask, tt.sphere_642, device=dev)
            for dev in ("cuda", "cpu"))
    dodf = float(np.abs(g.odf.vol - c.odf.vol).max())
    dqa = float(np.abs(g.qa[0].vol - c.qa[0].vol).max())
    valid = (g.qa[0].vol > 0) & (c.qa[0].vol > 0)
    same = float(np.all(g.peak[0].vol == c.peak[0].vol, -1)[valid].mean())
    log(f"[small] DSI 32x32x20x123: max|dODF|={dodf:.3g} max|dQA|={dqa:.3g}"
        f" peak-1 equal on {100 * same:.3f}% of {int(valid.sum())} voxels")
    check(dodf <= 1e-5, f"DSI ODF differs by {dodf} between card and CPU")
    check(dqa <= 1e-4, f"DSI QA differs by {dqa} between card and CPU")
    check(same >= 0.995, f"DSI peak 1 equal on only {same:.4f} of voxels")

    vol = make_rumba_brain(small=True)[0].vol.mean(axis=3)
    (eg, lg), (ec, lc) = (tt.st_recon(vol, 1.0, 2.0, device=dev)
                          for dev in ("cuda", "cpu"))
    dl = float(np.abs(lg - lc).max() / np.abs(lc).max())
    log(f"[small] st_recon 32x32x20: max|dλ|/max|λ|={dl:.3g}")
    check(dl <= 1e-5, f"eigenvalues differ by {dl} (relative)")

    mov, mmask = make_micro_field((40, 36, 2))
    a, b = (tt.stream(mov, mask=mmask, search_dist=15, device=dev, **MICRO)
            for dev in ("cuda", "cpu"))
    log(f"[small] micro 40x36x2: streams card {a.n_count} cpu {b.n_count}")
    check(a.n_count == b.n_count > 0 and np.array_equal(a.npts, b.npts)
          and np.array_equal(a.packed_xyz, b.packed_xyz),
          "micro lines differ between card and CPU")

    ovecs, lcm, lmask = make_lcm_field((64, 64))
    a, b = (tt.stream(ovecs, mask=lmask, lcms=lcm, device=dev)
            for dev in ("cuda", "cpu"))
    rl = float(np.mean(a.npts) / np.mean(b.npts))
    log(f"[small] LCM 64x64: streams card {a.n_count} cpu {b.n_count}, "
        f"mean length ratio {rl:.4f}; phase {time.time() - t0:.1f} s")
    check(b.n_count > 0 and abs(a.n_count / b.n_count - 1) < 0.03,
          f"LCM counts card {a.n_count} cpu {b.n_count}")
    check(abs(rl - 1) < 0.05, f"LCM mean length ratio {rl}")
    return g


def phase_cli(dsi_small):
    """`python -m fibers_tpu_torch dsi` and `structens` on the small DSI
    phantom, two processes on the card at once; each output read back."""
    import numpy as np
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.core.mri import MRI
    from fibers_tpu_torch.utils.phantom import make_dsi_brain

    t0 = time.time()
    dwi, mask, _ = make_dsi_brain(small=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as d:
        dp, mp, sp = (os.path.join(d, f) for f in ("dwi.nii.gz",
                                                   "mask.nii.gz",
                                                   "mean.nii.gz"))
        tt.mri_write(dwi, dp)
        tt.mri_write(mask, mp)
        mean = MRI.like(mask, 1, np.float32)
        mean.vol = dwi.vol.mean(axis=3)
        tt.mri_write(mean, sp)
        cmds = [[sys.executable, "-m", "fibers_tpu_torch", "dsi", dp, mp,
                 os.path.join(d, "dsi")],
                [sys.executable, "-m", "fibers_tpu_torch", "structens", sp,
                 os.path.join(d, "st")]]
        procs = [subprocess.Popen(c, cwd=HERE, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE) for c in cmds]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for c, p, (out, err) in zip(cmds, procs, outs):
            check(p.returncode == 0, f"{' '.join(c[2:4])} exited "
                  f"{p.returncode}: {err[-2000:]}")
        qa = tt.mri_read(os.path.join(d, "dsi_qa1.nii.gz")).vol
        odf = tt.mri_read(os.path.join(d, "dsi_odf.nii.gz")).vol
        ev = tt.mri_read(os.path.join(d, "st_eigval.nii.gz")).vol
        evec = tt.mri_read(os.path.join(d, "st_eigvec.nii.gz")).vol
    dqa = float(np.abs(qa - dsi_small.qa[0].vol).max())
    log(f"[cli] dsi + structens as two processes: {time.time() - t0:.1f} s;"
        f" dsi_qa1 vs the in-process card run max|d|={dqa:.3g}; odf "
        f"{odf.shape}, eigval {ev.shape}, eigvec {evec.shape}")
    check(odf.shape == mask.vol.shape + (321,), f"dsi_odf shape {odf.shape}")
    # the card's run is deterministic and a CPU run differs by ~1e-6, so
    # only a bit-equal QA1 shows that the CLI ran on the card
    check(dqa == 0, f"the CLI's QA1 differs by {dqa} from the card's run")
    check(ev.shape == mask.vol.shape + (3,) and evec.shape[-1] == 9
          and np.isfinite(ev).all() and (np.diff(ev, axis=-1) >= 0).all(),
          "the CLI's eigenvalues")


def main():
    check(os.path.isdir(os.path.join(HERE, "fibers_tpu_torch")),
          "run from a checkout of the repository: fibers_tpu_torch/ is not "
          "beside this script")
    sys.path.insert(0, HERE)
    import torch
    from fibers_tpu_torch.utils.phantom import make_rumba_brain

    t0 = time.time()
    smi = phase_device()
    phase_build()
    mesh, kind = smoke_mesh()
    log(f"[mesh] the mesh phases run on {kind}")
    records = {"gqi_fused": phase_kernel()}
    main_counts, mesh_main, (wire_main, per_step), prop = phase_main(mesh)
    launches = dict(main_counts)
    # launches of each kernel on the quantized-wire paths, by path
    wire_launches = {"pipeline_u12_i6": wire_main}
    # launches of each kernel on the mesh paths, by path
    mesh_launches = {"pipeline": mesh_main}
    # the propagation kernel's launches on each stream, by path
    stream_launches = {"pipeline": main_counts["propagate_pair"]}
    phase_small()

    t1 = time.time()
    dwi, mask, ax = make_rumba_brain()
    log(f"[rumba] set-up: phantom {dwi.vol.shape} built in "
        f"{time.time() - t1:.1f} s")
    records.update(phase_tv(mask))
    records.update(phase_rumba_step(dwi, mask))
    counts, counts_b16, counts_mesh, chain, prop_r = phase_rumba(
        dwi, mask, ax, mesh)
    stream_launches["rumba_chain_i6"] = chain["propagate_pair"]
    mesh_launches["rumba"] = counts_mesh
    # the 600-iteration fit builds its signal on the default u12 wire
    wire_launches["rumba_u12"] = counts
    mean_dwi = dwi.vol.mean(axis=3)
    del dwi, mask, ax
    for name in ("tv_fused", "rumba_update", "rumba_refit", "rl_gemm"):
        launches[name] = counts[name]
    launches["tv_multiplier"] = counts_b16["tv_multiplier"]
    phase_rumba_small()

    # DSI and the structure tensor (no hand-written kernel but the DSI
    # chain's propagation), the LCM and micro modes (their own kernels),
    # the CLI
    t1 = time.time()
    phase_structens(mean_dwi, mesh)
    del mean_dwi
    dsi_chain, dsi_sw = phase_dsi(mesh)
    stream_launches["dsi_chain"] = dsi_chain["propagate_pair"]
    mode_records, mode_launches = phase_modes()
    block_rec, mode_launches["micro_block_3d"] = phase_micro_block()
    mode_records["micro"]["block_3d"] = block_rec
    dsi_small = phase_new_small()
    phase_cli(dsi_small)
    log(f"[new phases] {time.time() - t1:.1f} s")
    t1 = time.time()
    mesh_launches["full_recon_step"] = phase_mesh_step(mesh)
    log(f"[mesh] full_recon_step phase {time.time() - t1:.1f} s")
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "fibers_tpu" or m.startswith("fibers_tpu.")
                  for m in sys.modules), "the JAX package was imported")
    log(f"[done] {time.time() - t0:.1f} s")
    # the propagation kernels' records: the main path's f32 chunk, its i6
    # chunk, the RUMBA chain's chunks (both directions in one launch, and
    # the forward direction alone), stream + write of the three chains
    # (kernel runs, plain loop) and the launches per chunk and step.  The
    # one-direction kernel's path is full_recon_step.
    main_sw = prop.pop("stream_write")
    rumba_sw = prop_r.pop("stream_write")
    none = "none: no PyTorch call integrates streamlines"
    records["propagate_pair"] = dict(
        prop["f32"]["pair"], i6=prop["i6"]["pair"],
        rumba_chain={w: r["pair"] for w, r in prop_r.items()},
        library_call=none, stream_launches_by_path=stream_launches,
        launches_per_chunk_and_step=per_step,
        stream_write_s={"pipeline": main_sw[:2], "rumba_chain_f32":
                        rumba_sw[:2], "dsi_chain": dsi_sw[:2]})
    records["propagate_dir"] = dict(
        prop["f32"]["dir"], i6=prop["i6"]["dir"],
        rumba_chain={w: r["dir"] for w, r in prop_r.items()},
        library_call=none, launches_path="full_recon_step on the mesh")
    launches["propagate_dir"] = mesh_launches["full_recon_step"][
        "propagate_dir"]
    # the mode kernels' records: the first chunk of each mode's run, its
    # stream + write, and the launches on that run (LCM on LCM_SIDE^2,
    # micro on MICRO_SIDE^2 x 2); micro's also the 3-D block's run
    for mode in ("lcm", "micro"):
        name = f"propagate_{mode}_dir"
        launches[name] = mode_launches[mode][name]
        records[name] = dict(
            mode_records[mode], launches_by_path=mode_launches,
            library_call="none: no PyTorch call integrates streamlines")
    # no single PyTorch call computes any of the nine functions; gqi_fused
    # carries the product alone as its partial yardstick
    kernels = []
    for name, src, site, on_path in KERNELS:
        by_path = {p: c.get(name, 0) for p, c in mesh_launches.items()}
        rec = dict(name=name, route="cuda", source=src, replaces=site,
                   launches=launches.get(name, 0), on_path=on_path,
                   mesh_launches=sum(by_path.values()),
                   mesh_launches_by_path=by_path,
                   wire_launches_by_path={p: c.get(name, 0) for p, c
                                          in wire_launches.items()},
                   library_ms=None)
        rec.update(records[name])
        kernels.append(rec)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
