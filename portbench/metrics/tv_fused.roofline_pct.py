"""tv_fused.roofline_pct: the share of its roofline that RUMBA-SD's TV
multiplier takes, in %.

The operation, per iteration: the TV multiplier rows of the fODF rows
[N, ncomp] over the mask's bounding box with a one-voxel halo (zero
outside the mask).  Bytes: the fODF rows read once and the multiplier
rows written once (4 bytes a value), and the box's TV weight and its
cell-to-row table read once (4 bytes each a cell).  Memory-bound: the
bound is those bytes over 3.35 TB/s (NVIDIA's H100 SXM data sheet at
700 W: `peaks.json`), times the iterations of the window's fits; the
time is the device time of the `sweep_kernel` launches (the x-sweep that
`tv_fused` launches) in the traced window.
"""

PATTERN = r"sweep_kernel"


def work(n, ncomp, cells):
    """Bytes of one iteration's multiplier."""
    return 2 * 4 * n * ncomp + 8 * cells


def bound_s(peaks, facts):
    x, y, z = facts["crop"]
    return facts["niter"] * work(facts["n_voxels"], facts["ncomp"],
                                 x * y * z) / peaks["hbm_bytes_s"]


def read(run):
    t, calls = run.trace.op_seconds(PATTERN)
    if calls == 0:
        return None
    return 100.0 * bound_s(run.peaks, run.facts) * run.n / t
