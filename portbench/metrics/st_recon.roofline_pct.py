"""st_recon.roofline_pct: the structure tensor's share of its roofline,
in %.

The work is fixed by the mathematics, whatever implements it.  Per
voxel of the block: bytes, the image read once (4) and the eigenvectors
and eigenvalues written once (48); operations, the separable filters'
taps as multiply-adds, 2 (3 Ks + 27 + 18 Kr), for the pre-smooth (3
axes of Ks taps), the gradients (3 gradients x 3 axes of 3 taps) and
the post-smooth of the six products (6 x 3 axes of Kr taps), the six
products, and the closed-form eigensolve of a symmetric 3 x 3 counted
as EIGEN operations (the trigonometric eigenvalues, two null vectors of
three cross products each, the third vector, the Rayleigh quotients and
their order).  Ks and Kr: the Gaussian lengths of sigma and rho
(2 max(2 ceil(s), ceil(2 s)) + 1).  The bound is the larger of bytes
over 3.35 TB/s and operations over 67 TFLOP/s of FP32 (`peaks.json`),
once a subject; the time is the device seconds of every operation but
the copies and memsets that starts inside a `micro_st` span of the
traced window (the program's own ranges on the device's row left out).
"""

import bisect
import math

EIGEN = 300


def taps(s):
    """The Gaussian's length at width s (0: no filter)."""
    if s <= 0:
        return 0
    return 2 * max(int(4 * math.ceil(s)) // 2, int(math.ceil(2 * s))) + 1


def work(n, sigma, rho):
    """(bytes, FP32 operations) of the structure tensor of n voxels."""
    ks, kr = taps(sigma), taps(rho)
    return n * 52, n * (2 * (3 * ks + 27 + 18 * kr) + 6 + EIGEN)


def bound_s(peaks, facts):
    b, f = work(facts["n_voxels"], facts["sigma"], facts["rho"])
    return max(b / peaks["hbm_bytes_s"], f / peaks["fp32_flop_s"])


def device_seconds(trace, span="micro_st"):
    """Device seconds, and their count, of the operations other than
    copies, memsets and the program's ranges that start inside `span`."""
    starts = [a for a, _, _ in trace.ops]
    t, calls = 0, 0
    for a, b, name in trace.spans:
        if name != span:
            continue
        lo = bisect.bisect_left(starts, a)
        hi = bisect.bisect_right(starts, b)
        for s, e, op in trace.ops[lo:hi]:
            if not op.startswith(("Memcpy", "Memset", "fibers.")):
                t += e - s
                calls += 1
    return t / 1e9, calls


def read(run):
    if run.facts.get("sigma") is None:
        return None
    t, calls = device_seconds(run.trace)
    if calls == 0:
        return None
    return 100.0 * bound_s(run.peaks, run.facts) * run.n / t
