"""rumba_step.roofline_pct: the share of their rooflines that RUMBA-SD's
two row passes take together, in %: the sum of their bounds over the sum
of their device times.

- the fODF update, once an iteration: max(fODF * num / (den + 1e-7) *
  tv, 0) over [N, ncomp]; bytes: fODF, num, den, tv read once, the fODF
  written once (4 bytes a value); 5 operations a value;
- the refit, once an iteration: the Bessel ratio, the new dodf_sig, the
  noise variance's row sum and the next numerator operand over [N, ndir];
  bytes: signal, dodf_sig, dodf read, dodf_sig and x written, the
  variance read and written; 41 operations a value;
- the first iteration's x, once a fit: signal and dodf_sig read, x
  written; 16 operations a value.

Each bound is the larger of bytes over 3.35 TB/s and operations over 67
TFLOP/s of FP32 (NVIDIA's H100 SXM data sheet at 700 W: `peaks.json`);
the time is the device time of the `update_quads`, `update_elems` and
`refit_rows` launches in the traced window.
"""

PATTERN = r"update_quads|update_elems|refit_rows"


def work_update(n, ncomp):
    return 5 * 4 * n * ncomp, 5 * n * ncomp


def work_refit(n, ndir):
    return 5 * 4 * n * ndir + 2 * 4 * n, 41 * n * ndir


def work_first(n, ndir):
    return 3 * 4 * n * ndir, 16 * n * ndir


def bound_s(peaks, facts):
    """Seconds of one fit's row passes."""
    def t(w):
        return max(w[0] / peaks["hbm_bytes_s"], w[1] / peaks["fp32_flop_s"])
    n = facts["n_voxels"]
    per = t(work_update(n, facts["ncomp"])) + t(work_refit(n, facts["ndir"]))
    return facts["niter"] * per + t(work_first(n, facts["ndir"]))


def read(run):
    t, calls = run.trace.op_seconds(PATTERN)
    if calls == 0:
        return None
    return 100.0 * bound_s(run.peaks, run.facts) * run.n / t
