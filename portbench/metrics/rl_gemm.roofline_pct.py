"""rl_gemm.roofline_pct: the share of their roofline that RUMBA-SD's
Richardson-Lucy products take, in %.

The operation, per iteration: num = x K and den = dodf K ([N, ndir] x
[ndir, ncomp]) and dodf = fODF K^T.  Bytes: x, dodf and the fODF read
once, num, den and the new dodf written once, K read once in each
orientation, 4 bytes a value.  Operations: 2 N ndir ncomp a product, at
the fastest tensor-core route that keeps the precision the API promises
("high": three bf16 passes at 989 TFLOP/s; "default": one).  The bound
is the larger of bytes over 3.35 TB/s and operations over that rate
(NVIDIA's H100 SXM data sheet at 700 W: `peaks.json`), times the
iterations of the window's fits; the time is the device time of the
`rl_gemm_kernel` launches in the traced window.
"""

PATTERN = r"rl_gemm_kernel"


def work(n, ndir, ncomp, passes):
    """(bytes, bf16 tensor-core operations) of one iteration's products."""
    nbytes = 4 * n * (3 * ndir + 3 * ncomp) + 2 * 4 * ndir * ncomp
    return nbytes, passes * 3 * 2 * n * ndir * ncomp


def bound_s(peaks, facts):
    """Seconds of one fit's products."""
    b, f = work(facts["n_voxels"], facts["ndir"], facts["ncomp"],
                facts["passes"])
    return facts["niter"] * max(b / peaks["hbm_bytes_s"],
                                f / peaks["bf16_flop_s"])


def read(run):
    t, calls = run.trace.op_seconds(PATTERN)
    if calls == 0:
        return None
    return 100.0 * bound_s(run.peaks, run.facts) * run.n / t
