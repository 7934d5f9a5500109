"""Command-line pipeline runner: `python -m fibers_tpu_torch <command> ...`.

The counterpart of `python -m fibers_tpu` (fibers_tpu/__main__.py): it
parses with that module's `build_parser`, so the subcommands, positionals,
options and defaults are the same, and runs them over the PyTorch port.
Every fit runs on cuda when `torch.cuda.is_available()`, else on
the CPU.  `--mesh N` with N > 0 raises (multi-device runs are ROADMAP
A13); the reference's default wires (`dsi --wire auto8`,
`rumba --wire u12`) are accepted and upload exact float32.

    python -m fibers_tpu_torch info dwi.nii.gz
    python -m fibers_tpu_torch dti dwi.nii.gz mask.nii.gz out/dti
    python -m fibers_tpu_torch gqi dwi.nii.gz mask.nii.gz out/gqi --sphere 362
    python -m fibers_tpu_torch dsi dwi.nii.gz mask.nii.gz out/dsi
    python -m fibers_tpu_torch stream out/gqi GQI --fa out/dti_fa.nii.gz \\
        --mask mask.nii.gz -o out/tracts.trk
    python -m fibers_tpu_torch pipeline dwi.nii.gz mask.nii.gz out/
"""

from __future__ import annotations

import os
import sys

import numpy as np

from fibers_tpu.__main__ import build_parser


def _sphere(name: str):
    import fibers_tpu_torch as tt

    try:
        return {"362": tt.sphere_362, "642": tt.sphere_642,
                "724": tt.sphere_724}[str(name)]
    except KeyError:
        raise SystemExit(f"unknown sphere {name!r} (choose 362/642/724)")


def _mesh(n):
    if n:
        raise NotImplementedError(
            f"--mesh {n}: multi-device runs are not ported yet (ROADMAP "
            "A13)")
    return None


def _read_pair(dwi_path: str, mask_path: str):
    import fibers_tpu_torch as tt

    return tt.mri_read(dwi_path), tt.mri_read(mask_path)


def _batch(dwi, mask, mesh, wire):
    """Shared gather/upload for fits that take `batch=`."""
    import fibers_tpu_torch as tt

    return tt.prepare_batch(dwi, mask, mesh=mesh, wire=wire)


def _outdir(base: str) -> None:
    d = os.path.dirname(base)
    if d:
        os.makedirs(d, exist_ok=True)


def cmd_info(args) -> int:
    import fibers_tpu_torch as tt

    tt.info(tt.mri_read(args.vol, headeronly=args.headeronly))
    return 0


def cmd_disp(args) -> int:
    import fibers_tpu_torch as tt

    mri = tt.mri_read(args.vol)
    mod = tt.mri_read(args.mod) if args.mod else None
    tt.disp(mri, mod)
    return 0


def cmd_adc(args) -> int:
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire)
    adc, s0 = tt.adc_fit(dwi, mask, batch=batch)
    _outdir(args.outbase)
    tt.mri_write(adc, args.outbase + "_adc.nii.gz")
    tt.mri_write(s0, args.outbase + "_s0.nii.gz")
    print(f"wrote {args.outbase}_adc.nii.gz, {args.outbase}_s0.nii.gz")
    return 0


def cmd_dti(args) -> int:
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire)
    dti = tt.dti_fit(dwi, mask, batch=batch)
    _outdir(args.outbase)
    tt.dti_write(dti, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (DTI)")
    return 0


def cmd_gqi(args) -> int:
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire)
    gqi = tt.gqi_rec(dwi, mask, _sphere(args.sphere), sigma=args.sigma,
                     batch=batch)
    _outdir(args.outbase)
    tt.gqi_write(gqi, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (GQI)")
    return 0


def cmd_dsi(args) -> int:
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    dsi = tt.dsi_rec(dwi, mask, _sphere(args.sphere),
                     hann_width=args.hann_width, mesh=_mesh(args.mesh),
                     wire=args.wire)
    _outdir(args.outbase)
    tt.dsi_write(dsi, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (DSI)")
    return 0


def cmd_rumba(args) -> int:
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    rec = tt.rumba_rec(
        dwi, mask, _sphere(args.sphere), niter=args.niter,
        use_tv=not args.no_tv, verbose=args.verbose,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        on_mismatch=args.on_mismatch, signal_wire=args.wire,
        mesh=_mesh(args.mesh))
    _outdir(args.outbase)
    tt.rumba_write(rec, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (RUMBA-SD, snr_mean="
          f"{rec.snr_mean:.1f})")
    return 0


def cmd_structens(args) -> int:
    import fibers_tpu_torch as tt

    mri = tt.mri_read(args.vol)
    evec, evals = tt.st_recon(np.asarray(mri.vol), args.sigma, args.rho,
                              mesh=_mesh(args.mesh))
    _outdir(args.outbase)
    ev = tt.MRI.like(mri, 9, np.float32)
    ev.vol = evec.reshape(evec.shape[:3] + (9,)).astype(np.float32)
    el = tt.MRI.like(mri, 3, np.float32)
    el.vol = evals.astype(np.float32)
    tt.mri_write(ev, args.outbase + "_eigvec.nii.gz")
    tt.mri_write(el, args.outbase + "_eigval.nii.gz")
    print(f"wrote {args.outbase}_eigvec.nii.gz, {args.outbase}"
          "_eigval.nii.gz")
    return 0


_STRUCTS = {"GQI": "GQI", "DSI": "DSI", "RUMBASD": "RUMBASD"}


def cmd_stream(args) -> int:
    import fibers_tpu_torch as tt

    if args.struct:
        # peaks from a fit's field-per-file output: mri_read(base, Type)
        name = _STRUCTS.get(args.struct.upper())
        if name is None:
            raise SystemExit(f"unknown result struct {args.struct!r} "
                             "(choose GQI/DSI/RUMBASD)")
        rec = tt.mri_read(args.peaks, getattr(tt, name))
        ovec, f = tt.peaks_to_ovecs(rec)
    else:
        ovec = [tt.mri_read(p) for p in args.peaks.split(",")]
        f = [tt.mri_read(p) for p in args.f.split(",")] if args.f else None

    kw = {}
    if f is not None:
        kw["f"] = f
    if args.fa:
        kw["fa"] = tt.mri_read(args.fa)
    if args.mask:
        kw["mask"] = tt.mri_read(args.mask)
    if args.seed:
        kw["seed"] = tt.mri_read(args.seed)
    if args.lcm:
        kw["lcms"] = tt.mri_read(args.lcm)

    _outdir(args.output)
    tract = tt.stream(
        ovec, f_thresh=args.f_thresh, fa_thresh=args.fa_thresh,
        nsub=args.nsub, len_min=args.len_min,
        ang_thresh=args.ang_thresh, step_size=args.step_size,
        smooth_coeff=args.smooth_coeff, wire=args.wire,
        seed_rng=args.seed_rng, mesh=_mesh(args.mesh),
        trk_sink=args.output, **kw)
    print(f"wrote {args.output} ({tract.n_count} streamlines)")
    return 0


def cmd_pipeline(args) -> int:
    """DTI + GQI fits sharing one upload, then whole-brain deterministic
    tractography from the device-resident GQI peaks."""
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    os.makedirs(args.outdir, exist_ok=True)
    base = os.path.join(args.outdir, "")
    mesh = _mesh(args.mesh)
    batch = _batch(dwi, mask, mesh, args.wire)

    dti = tt.dti_fit(dwi, mask, batch=batch)
    tt.dti_write(dti, base + "dti")
    gqi = tt.gqi_rec(dwi, mask, _sphere(args.sphere), batch=batch)
    tt.gqi_write(gqi, base + "gqi")

    out = os.path.join(args.outdir, "tracts.trk")
    ov = tt.peaks_to_ovecs(gqi, device=True)
    tract = tt.stream(ov, fa=dti.fa, mask=mask, f_thresh=0.0,
                      nsub=args.nsub, mesh=mesh, trk_sink=out)
    print(f"pipeline done: {args.outdir} ({tract.n_count} streamlines)")
    return 0


CMDS = {"info": cmd_info, "disp": cmd_disp, "adc": cmd_adc, "dti": cmd_dti,
        "gqi": cmd_gqi, "dsi": cmd_dsi, "rumba": cmd_rumba,
        "structens": cmd_structens, "stream": cmd_stream,
        "pipeline": cmd_pipeline}


def main(argv=None) -> int:
    # The reference's parser (jax-free host code) gives the subcommands,
    # options and defaults; dispatch goes to this module's commands by
    # name, never to the reference's `fn` defaults.
    ap = build_parser()
    ap.prog = "python -m fibers_tpu_torch"
    ap.description = "Diffusion-MRI pipeline on PyTorch (Fibers.jl rebuild)"
    args = ap.parse_args(argv)
    return CMDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
