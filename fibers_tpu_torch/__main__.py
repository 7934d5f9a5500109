"""Command-line pipeline runner: `python -m fibers_tpu_torch <command> ...`.

The counterpart of `python -m fibers_tpu` (fibers_tpu/__main__.py).
`build_parser` is a copy of that module's, so the subcommands,
positionals, options and defaults are the same, plus one top-level
`--device {cuda,cpu}` (default cuda), this package's counterpart of
`JAX_PLATFORMS`: every fit runs on the card unless `--device cpu` asks
for the CPU.  `--mesh N` with N > 0 raises (multi-device runs are ROADMAP
A13); the reference's default wires (`dsi --wire auto8`,
`rumba --wire u12`) are accepted and upload exact float32.

    python -m fibers_tpu_torch info dwi.nii.gz
    python -m fibers_tpu_torch dti dwi.nii.gz mask.nii.gz out/dti
    python -m fibers_tpu_torch gqi dwi.nii.gz mask.nii.gz out/gqi --sphere 362
    python -m fibers_tpu_torch dsi dwi.nii.gz mask.nii.gz out/dsi
    python -m fibers_tpu_torch stream out/gqi GQI --fa out/dti_fa.nii.gz \\
        --mask mask.nii.gz -o out/tracts.trk
    python -m fibers_tpu_torch pipeline dwi.nii.gz mask.nii.gz out/
    python -m fibers_tpu_torch --device cpu dti dwi.nii.gz mask.nii.gz out/dti
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


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


def _batch(dwi, mask, mesh, wire, device):
    """Shared gather/upload for fits that take `batch=`."""
    import fibers_tpu_torch as tt

    return tt.prepare_batch(dwi, mask, mesh=mesh, wire=wire, device=device)


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
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire, args.device)
    adc, s0 = tt.adc_fit(dwi, mask, batch=batch)
    _outdir(args.outbase)
    tt.mri_write(adc, args.outbase + "_adc.nii.gz")
    tt.mri_write(s0, args.outbase + "_s0.nii.gz")
    print(f"wrote {args.outbase}_adc.nii.gz, {args.outbase}_s0.nii.gz")
    return 0


def cmd_dti(args) -> int:
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire, args.device)
    dti = tt.dti_fit(dwi, mask, batch=batch)
    _outdir(args.outbase)
    tt.dti_write(dti, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (DTI)")
    return 0


def cmd_gqi(args) -> int:
    import fibers_tpu_torch as tt

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire, args.device)
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
                     wire=args.wire, device=args.device)
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
        mesh=_mesh(args.mesh), device=args.device)
    _outdir(args.outbase)
    tt.rumba_write(rec, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (RUMBA-SD, snr_mean="
          f"{rec.snr_mean:.1f})")
    return 0


def cmd_structens(args) -> int:
    import fibers_tpu_torch as tt

    mri = tt.mri_read(args.vol)
    evec, evals = tt.st_recon(np.asarray(mri.vol), args.sigma, args.rho,
                              mesh=_mesh(args.mesh), device=args.device)
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
        trk_sink=args.output, device=args.device, **kw)
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
    batch = _batch(dwi, mask, mesh, args.wire, args.device)

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


def build_parser() -> argparse.ArgumentParser:
    """A copy of fibers_tpu/__main__.py:build_parser over this module's
    commands, plus the top-level `--device`."""
    ap = argparse.ArgumentParser(
        prog="python -m fibers_tpu_torch",
        description="Diffusion-MRI pipeline on PyTorch (Fibers.jl "
                    "rebuild)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run the fits on the card (default) or the CPU")
    sub = ap.add_subparsers(dest="command", required=True)

    def add(name, fn, help):
        p = sub.add_parser(name, help=help)
        p.set_defaults(fn=fn)
        return p

    p = add("info", cmd_info, "print a volume's header summary")
    p.add_argument("vol")
    p.add_argument("--full", dest="headeronly", action="store_false",
                   help="read the full payload, not just the header")

    p = add("disp", cmd_disp, "render the middle slice in the terminal")
    p.add_argument("vol")
    p.add_argument("--mod", help="intensity-modulation volume")

    def fit_parser(name, fn, help, wire_default="auto"):
        p = add(name, fn, help)
        p.add_argument("dwi")
        p.add_argument("mask")
        p.add_argument("outbase")
        p.add_argument("--mesh", type=int, default=0,
                       help="shard over N devices (0 = single device)")
        p.add_argument("--wire", default=wire_default,
                       help="host->device signal encoding "
                            "(auto/u16/u12/u8/f32)")
        return p

    fit_parser("adc", cmd_adc, "ADC log-linear fit")
    fit_parser("dti", cmd_dti, "DTI tensor fit + FA/MD/RD maps")

    p = fit_parser("gqi", cmd_gqi, "GQI ODF reconstruction + peaks")
    p.add_argument("--sphere", default="362")
    p.add_argument("--sigma", type=float, default=1.25)

    p = fit_parser("dsi", cmd_dsi, "DSI q-space reconstruction",
                   wire_default="auto8")
    p.add_argument("--sphere", default="642")
    p.add_argument("--hann-width", type=int, default=32)

    p = fit_parser("rumba", cmd_rumba, "RUMBA-SD spherical deconvolution",
                   wire_default="u12")
    p.add_argument("--sphere", default="724")
    p.add_argument("--niter", type=int, default=600)
    p.add_argument("--no-tv", action="store_true",
                   help="disable TV spatial regularization")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable fits")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--on-mismatch", default="raise",
                   choices=("raise", "fresh"))

    p = add("structens", cmd_structens, "structure-tensor reconstruction")
    p.add_argument("vol")
    p.add_argument("outbase")
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--rho", type=float, default=2.0)
    p.add_argument("--mesh", type=int, default=0)

    p = add("stream", cmd_stream, "streamline tractography -> .trk")
    p.add_argument("peaks",
                   help="result-struct basename (with a struct type as "
                        "the 2nd positional) or comma-separated "
                        "orientation volumes")
    p.add_argument("struct", nargs="?", default=None,
                   help="GQI/DSI/RUMBASD: read peaks via "
                        "mri_read(base, Type)")
    p.add_argument("-o", "--output", required=True, help=".trk path")
    p.add_argument("--f", help="comma-separated amplitude volumes")
    p.add_argument("--fa", help="FA volume for fa_thresh masking")
    p.add_argument("--mask")
    p.add_argument("--seed")
    p.add_argument("--lcm", help="LCM volume (probabilistic mode)")
    p.add_argument("--f-thresh", type=float, default=0.03)
    p.add_argument("--fa-thresh", type=float, default=0.1)
    p.add_argument("--nsub", type=int, default=3)
    p.add_argument("--len-min", type=int, default=3)
    p.add_argument("--ang-thresh", type=float, default=45.0)
    p.add_argument("--step-size", type=float, default=0.5)
    p.add_argument("--smooth-coeff", type=float, default=0.2)
    p.add_argument("--seed-rng", type=int, default=0)
    p.add_argument("--wire", default="auto",
                   help="point wire encoding (auto/i8/i6/f32)")
    p.add_argument("--mesh", type=int, default=0)

    p = add("pipeline", cmd_pipeline,
            "DTI+GQI fits + whole-brain tractography (the e2e flow)")
    p.add_argument("dwi")
    p.add_argument("mask")
    p.add_argument("outdir")
    p.add_argument("--sphere", default="362")
    p.add_argument("--nsub", type=int, default=3)
    p.add_argument("--mesh", type=int, default=0)
    p.add_argument("--wire", default="auto")

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
