#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
`fibers_tpu_torch/csrc/` and drives every ported path on the card:

- GQI: the kernel against its plain PyTorch version at the main path's
  shapes; the headline pipeline (prepare_batch -> dti_fit -> gqi_rec ->
  device peaks -> 1M-seed stream -> .trk) on the HCP-scale phantom; the
  card's slice against the CPU's on a small phantom.
- RUMBA-SD: the four TV kernels against their plain versions at RUMBA's
  shapes and the TV experiment's; config 4 (600 iterations at full
  width) chained into ~1M streams and a .trk; a tv_bf16 run; the card's
  slice against the CPU's on the small config-4 phantom.
- DSI (config 3 at full width, chained into ~1M streams), the structure
  tensor on config 4's volume, the LCM and microscopy tractography modes
  and the CLI (`python -m fibers_tpu_torch dsi`/`structens`), with their
  card-against-CPU checks on small inputs.  These paths run none of the
  hand-written kernels; their launch counts must stay 0.

Every phase raises on failure.  It imports no jax and nothing of the JAX
package `fibers_tpu`; without a CUDA device it fails.

Output: one line per phase with its wall time; then a JSON line with the
kernel records (launches on the path, error against the plain version,
kernel, plain and bound times), the `nvidia-smi` name and power limit,
and as the last line `{"ok": true, "device": {...}}`.
"""

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
]
# the card's peaks for the bounds (H100 SXM data sheet): HBM bytes/s and
# FP32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# floating-point operations of one TV multiplier element, counting sqrt and
# divide as one each: the gradient (3 differences, 3 squares, 3 adds, sqrt,
# 1/norm, 3 products) and the output (3 differences, 2 adds, product,
# subtraction, abs, add, divide)
TV_FLOPS = 14 + 10
# shapes that cut the TV sweep kernels' 8 x 8 (y, z) tiles and 32-wide
# component chunks raggedly (tests/test_torch_tv.py:RAGGED)
TV_RAGGED = [(1, 9, 11, 7), (2, 17, 10, 33), (5, 12, 19, 364), (3, 8, 8, 33),
             (2, 3, 5, 7), (4, 20, 9, 364)]


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
    return dict(gqi_fused=gqi_fused, tv_fused=tv_fused,
                tv_multiplier=tv_multiplier, tv_dimsem=tv_dimsem,
                tv_2slice=tv_2slice)


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


def _tables(sphere):
    from fibers_tpu_torch.core.odf import half_sphere
    from fibers_tpu_torch.ops.peaks import build_neighbors
    _, _, faces0 = half_sphere(sphere)
    return build_neighbors(faces0, sphere.nvert_half)


def phase_kernel():
    """Kernel vs its plain version at the main path's shapes, a ragged N
    and maxdeg = 7.  Returns the record of the main-path shape."""
    import numpy as np
    import torch
    from fibers_tpu_torch.core.odf import sphere_642, sphere_724
    from fibers_tpu_torch.models.gqi import gqi_design
    from fibers_tpu_torch.ops.kernels.gqi_fused import (gqi_fused,
                                                        gqi_fused_plain)
    from fibers_tpu_torch.ops.peaks import peak_mask
    from fibers_tpu_torch.utils.phantom import make_brain

    t0 = time.time()
    probe, _, _ = make_brain(shape=(2, 2, 2))          # the 198-volume table
    rng = np.random.default_rng(1234)
    record = None
    for sphere, n in ((sphere_642, 720_896), (sphere_642, 1_000),
                      (sphere_724, 1_000)):
        nbr, ok = _tables(sphere)
        A_t = np.ascontiguousarray(
            gqi_design(probe.bval, probe.bvec, sphere).T)
        s = rng.uniform(-5.0, 100.0, (n, len(probe.bval))).astype(np.float32)
        s[::251] = -1.0                          # rows with no signal
        dev = [torch.from_numpy(x).cuda() for x in (s, A_t, nbr, ok)]
        odf, pm, st = gqi_fused(*dev)
        torch.cuda.synchronize()
        odf_p, _, st_p = gqi_fused_plain(*dev)
        err = float((odf - odf_p).abs().max())
        torch.testing.assert_close(odf, odf_p, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(st, st_p, rtol=1e-5, atol=1e-4)
        check(torch.equal(st[:, 2], st_p[:, 2]), "valid flags differ")
        check(torch.equal(pm, peak_mask(odf, dev[2], dev[3])),
              "peak mask differs from the plain rule on the kernel's ODF")
        line = (f"[kernel] N={n} nvol={s.shape[1]} nvert={sphere.nvert_half}"
                f" maxdeg={nbr.shape[1]}: max|odf-plain|={err:.3g} ok")
        if record is None:
            # s, the table and the neighbours in; ODF, peak mask, stats out
            nbytes = sum(x.nbytes for x in (*dev, odf, pm, st))
            flops = 2 * n * s.shape[1] * sphere.nvert_half       # s @ A_t
            del odf, pm, st, odf_p, st_p
            gqi_fused(*dev)
            gqi_fused_plain(*dev)
            torch.cuda.synchronize()
            turns = []                       # plain, kernel, kernel, plain
            for fn in (gqi_fused_plain, gqi_fused, gqi_fused,
                       gqi_fused_plain):
                turns.append(cuda_ms(lambda: fn(*dev), 5))
            ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            line += (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                     f"(turns {', '.join(f'{t:.3f}' for t in turns)})")
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          **bound_ms(nbytes, flops))
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


def pipeline(dwi, mask, seed, device, trk):
    """The bench.py:233-275 sequence on the port; returns results and
    per-stage wall times (each stage ends in a synchronize)."""
    import torch
    import fibers_tpu_torch as tt

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t = {}
    t0 = time.time()
    batch = tt.prepare_batch(dwi, mask, wire="f32", device=device)
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
    tract = tt.stream(pk1, fa=dti.fa, mask=mask, seed=seed, nsub=3,
                      f_thresh=0.0, wire="f32", trk_sink=trk)
    t["stream+write"] = time.time() - t1
    t["total"] = time.time() - t0
    return dti, gqi, tract, t


def phase_main():
    import numpy as np
    import torch
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.utils.phantom import make_brain

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
        dti, gqi, tract, t = pipeline(dwi, mask, seed, "cuda", trk)
        counts = read_counts()
        back = tt.trk_read(trk)
    launches = counts["gqi_fused"]
    npts = int(np.sum(tract.npts))
    for name, tt_ in (("run 1", t_warm), ("run 2", t)):
        log(f"[main] {name}: " + ", ".join(f"{k}={v:.3f} s"
                                           for k, v in tt_.items()))
    log(f"[main] streams={tract.n_count} points={npts} "
        f"gqi_fused.launches={launches} "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB")

    check(launches >= 1, "the GQI stage did not launch the CUDA kernel")
    check(sum(counts.values()) == launches,
          f"the GQI path launched other kernels: {counts}")
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
    return launches, t, tract.n_count, npts


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


def bound_ms(nbytes, flops):
    """The least time of a function on the card: its bytes (each input
    read once, each output written once) over the HBM rate, or its FP32
    operations over the FP32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
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
    from fibers_tpu_torch.models.rumba import _tv_bbox
    from fibers_tpu_torch.ops.kernels.tv_fused import (build_tables,
                                                       tv_fused,
                                                       tv_fused_plain)
    from fibers_tpu_torch.ops.kernels.tv_stencil import (rn_selfcheck,
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
    log(f"[tv] the sweep kernels' branch-free sqrt and 1/x against "
        f"__fsqrt_rn and __fdiv_rn over all 2^32 floats: {bad} mismatches "
        f"({time.time() - t0:.2f} s)")
    check(bad == 0, "the sweep kernels' rounding differs from IEEE's")
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
    for name, fn, plain in dense_kernels:
        rec = hold(f"{name} f32 {tuple(dense.shape)}",
                   lambda: fn(dense, lam), lambda: plain(dense, lam), 3,
                   nbytes)
        records.setdefault(name, dict(
            rec, **bound_ms(nbytes, TV_FLOPS * dense.numel())))
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


def phase_rumba(dwi, mask, ax):
    """Config 4 at full width on the card: RUMBA-SD, 600 iterations,
    chained into ~1M streams written to a .trk; then a tv_bf16 run.  The
    warm run and the two 50-iteration runs take a prepared batch, which
    skips the host signal route the counted run times."""
    import numpy as np
    import torch
    import fibers_tpu_torch as tt

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
    check(counts["tv_fused"] == niter,
          f"tv_fused launched {counts['tv_fused']} times in {niter} "
          "iterations")
    check(sum(counts.values()) == niter,
          f"the RUMBA path launched other kernels: {counts}")

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

    seed = _seed_mask(mask, 1_000_000)
    with tempfile.TemporaryDirectory() as d:
        trk = os.path.join(d, "rumba.trk")
        t1 = time.time()
        pk = tt.peaks_to_ovecs(rum, device=True)
        tract = tt.stream(pk, mask=mask, seed=seed, nsub=3, wire="f32",
                          trk_sink=trk)
        t_stream = time.time() - t1
        back = tt.trk_read(trk)
    npts = int(np.sum(tract.npts))
    log(f"[rumba] chain: {int((seed.vol > 0).sum())} seed voxels, nsub=3, "
        f"{pk.nvec} peaks: stream+write {t_stream:.3f} s, "
        f"{tract.n_count} streams, {npts} points")
    check(tract.n_count > 0, "no streamlines from the RUMBA peaks")
    check(back.n_count == tract.n_count and int(np.sum(back.npts)) == npts,
          f".trk holds {back.n_count} lines, the Tract {tract.n_count}")
    del rum, pk, tract, back

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
    check(counts_b16["tv_multiplier"] == nb and counts_b16["tv_fused"] == 0,
          f"the tv_bf16 run launched {counts_b16}")
    torch.testing.assert_close(fb, ff, rtol=0.05, atol=2e-3)
    return counts, counts_b16, stages, t_stream


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
        rum = tt.rumba_rec(dwi, mask, tt.sphere_724, niter=30, device=dev)
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


def _check_no_kernel(counts, what):
    """The DSI, structure-tensor and LCM/micro paths run none of the five
    kernels: their launch counts stay 0."""
    check(not any(counts.values()), f"{what} launched kernels: {counts}")


def phase_dsi():
    """Config 3 at full width on the card (96^3, 515 q-samples,
    sphere_642): a warm run, then a counted run with its stage times and
    peak device memory; checks; the DSI peaks chained into ~1M streams
    written to a .trk and read back."""
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

    seed = _seed_mask(mask, 1_000_000)
    with tempfile.TemporaryDirectory() as d:
        trk = os.path.join(d, "dsi.trk")
        t1 = time.time()
        pkd = tt.peaks_to_ovecs(dsi, device=True)
        tract = tt.stream(pkd, mask=mask, seed=seed, nsub=3, wire="f32",
                          trk_sink=trk)
        t_stream = time.time() - t1
        back = tt.trk_read(trk)
    npts = int(np.sum(tract.npts))
    log(f"[dsi] chain: {int((seed.vol > 0).sum())} seed voxels, nsub=3, "
        f"{pkd.nvec} peaks: stream+write {t_stream:.3f} s, "
        f"{tract.n_count} streams, {npts} points")
    check(tract.n_count > 0, "no streamlines from the DSI peaks")
    check(back.n_count == tract.n_count and int(np.sum(back.npts)) == npts,
          f".trk holds {back.n_count} lines, the Tract {tract.n_count}")


def phase_structens(vol):
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


def phase_modes():
    """LCM on a 256x256 slice (3 jitters per voxel) and microscopy on a
    256x256x2 field at 10 um (every 4th voxel seeded), each written to a
    .trk and read back."""
    import numpy as np
    import fibers_tpu_torch as tt
    from fibers_tpu_torch.utils.phantom import make_lcm_field, make_micro_field

    ovecs, lcm, lmask = make_lcm_field((256, 256))
    mov, mmask = make_micro_field()
    mseed = _micro_seed(mmask)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        for name, run in (
                ("lcm", lambda trk: tt.stream(ovecs, mask=lmask, lcms=lcm,
                                              nsub=3, trk_sink=trk)),
                ("micro", lambda trk: tt.stream(mov, mask=mmask, seed=mseed,
                                                search_dist=15, trk_sink=trk,
                                                **MICRO))):
            trk = os.path.join(d, f"{name}.trk")
            t0 = time.time()
            tract = run(trk)
            t = time.time() - t0
            back = tt.trk_read(trk)
            npts = int(np.sum(tract.npts))
            log(f"[modes] {name}: {tract.n_count} streams, {npts} points, "
                f"stream+write {t:.3f} s")
            check(tract.n_count > 0, f"no {name} streamlines")
            check(back.n_count == tract.n_count
                  and int(np.sum(back.npts)) == npts,
                  f"{name} .trk holds {back.n_count} lines, the Tract "
                  f"{tract.n_count}")
            if name == "lcm":
                check(back.n_scalars == 1, "the LCM .trk has no scalar")
            out[name] = t
        _check_no_kernel(read_counts(), "the LCM and micro modes")
    return out


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
    records = {"gqi_fused": phase_kernel()}
    launches = {"gqi_fused": phase_main()[0]}
    phase_small()

    t1 = time.time()
    dwi, mask, ax = make_rumba_brain()
    log(f"[rumba] set-up: phantom {dwi.vol.shape} built in "
        f"{time.time() - t1:.1f} s")
    records.update(phase_tv(mask))
    counts, counts_b16, _, _ = phase_rumba(dwi, mask, ax)
    mean_dwi = dwi.vol.mean(axis=3)
    del dwi, mask, ax
    launches["tv_fused"] = counts["tv_fused"]
    launches["tv_multiplier"] = counts_b16["tv_multiplier"]
    phase_rumba_small()

    # the paths with no hand-written kernel: DSI, the structure tensor,
    # the LCM and micro modes, the CLI
    t1 = time.time()
    phase_structens(mean_dwi)
    del mean_dwi
    phase_dsi()
    phase_modes()
    dsi_small = phase_new_small()
    phase_cli(dsi_small)
    log(f"[new phases] {time.time() - t1:.1f} s")
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "fibers_tpu" or m.startswith("fibers_tpu.")
                  for m in sys.modules), "the JAX package was imported")
    log(f"[done] {time.time() - t0:.1f} s")
    # no single PyTorch call computes any of the five functions
    log(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=site,
        launches=launches.get(name, 0), on_path=on_path, library_ms=None,
        **records[name])
        for name, src, site, on_path in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
