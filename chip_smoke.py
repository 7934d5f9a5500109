#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernel from
`fibers_tpu_torch/csrc/`, holds the kernel against its plain PyTorch
version at the main path's shapes, drives the headline pipeline
(prepare_batch -> dti_fit -> gqi_rec -> device peaks -> 1M-seed stream ->
.trk) on the HCP-scale phantom, and checks the card's slice against the
CPU's on a small phantom.  Every phase raises on failure.  It imports no
jax; without a CUDA device it fails.

Output: one line per phase with its wall time; then a JSON line with the
kernel record, the `nvidia-smi` name and power limit, and as the last
line `{"ok": true, "device": {...}}`.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def _tables(sphere):
    from fibers_tpu.core.odf import half_sphere
    from fibers_tpu_torch.ops.peaks import build_neighbors
    _, _, faces0 = half_sphere(sphere)
    return build_neighbors(faces0, sphere.nvert_half)


def phase_kernel():
    """Kernel vs its plain version at the main path's shapes, a ragged N
    and maxdeg = 7.  Returns the record of the main-path shape."""
    import numpy as np
    import torch
    from fibers_tpu.core.odf import sphere_642, sphere_724
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
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log(line)
        del dev
        torch.cuda.empty_cache()
    log(f"[kernel] phase {time.time() - t0:.1f} s")
    return record


def _seed_mask(mask, target_seeds):
    """Seed voxels subsampled so nsub=3 jitters give ~target_seeds streams
    (as bench.py)."""
    import numpy as np
    from fibers_tpu.core.mri import MRI
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
    from fibers_tpu_torch.ops.kernels.gqi_fused import gqi_fused
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
        gqi_fused.launches = 0
        dti, gqi, tract, t = pipeline(dwi, mask, seed, "cuda", trk)
        launches = gqi_fused.launches
        back = tt.trk_read(trk)
    npts = int(np.sum(tract.npts))
    for name, tt_ in (("run 1", t_warm), ("run 2", t)):
        log(f"[main] {name}: " + ", ".join(f"{k}={v:.3f} s"
                                           for k, v in tt_.items()))
    log(f"[main] streams={tract.n_count} points={npts} "
        f"gqi_fused.launches={launches} "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB")

    check(launches >= 1, "the GQI stage did not launch the CUDA kernel")
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


def main():
    check(os.path.isdir(os.path.join(HERE, "fibers_tpu_torch")),
          "run from a checkout of the repository: fibers_tpu_torch/ is not "
          "beside this script")
    sys.path.insert(0, HERE)
    import torch

    t0 = time.time()
    smi = phase_device()
    phase_build()
    record = phase_kernel()
    launches, _, _, _ = phase_main()
    phase_small()
    check("jax" not in sys.modules, "jax was imported")
    log(f"[done] {time.time() - t0:.1f} s")
    log(json.dumps({"kernels": [dict(
        name="gqi_fused", route="cuda",
        source="fibers_tpu_torch/csrc/gqi_fused.cu",
        replaces="fibers_tpu/ops/pallas/gqi_fused.py:87",
        launches=launches, **record)]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
