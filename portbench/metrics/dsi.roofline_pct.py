"""dsi.roofline_pct: DSI's share of its roofline, in %.

The work is fixed by the mathematics, whatever implements it.  Per
voxel, bytes: the signals read once (4 nvol), the PDF (4 nvol), the ODF
(4 nvert), three peak vectors (36) and three QA values (12) written
once.  Operations: a real 3-D FFT of the G = nfft^3 grid at
2.5 G log2 G, and the radial integral, a trilinear stencil of 8 cells at
each of the nradii radii and nvert vertices, 2 * nradii * 8 * nvert.
The bound is the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s of FP32 (`peaks.json`), for N = the masked voxels, once a
subject; the time is the device seconds of every operation but the
copies that starts inside a `dsi` span of the traced window.
"""

import bisect
import math


def work(n, nvol, nvert, nfft, nradii):
    """(bytes, FP32 operations) of DSI on N = n voxels."""
    g = nfft ** 3
    nbytes = n * (4 * nvol + 4 * nvol + 4 * nvert + 4 * 3 * 3 + 4 * 3)
    flops = n * (2.5 * g * math.log2(g) + 2 * nradii * 8 * nvert)
    return nbytes, flops


def bound_s(peaks, facts):
    b, f = work(facts["n_voxels"], facts["nvol"], facts["nvert"],
                facts["nfft"], facts["nradii"])
    return max(b / peaks["hbm_bytes_s"], f / peaks["fp32_flop_s"])


def device_seconds(trace):
    """Device seconds, and their count, of the operations other than
    copies that start inside a `dsi` span."""
    starts = [a for a, _, _ in trace.ops]
    t, calls = 0, 0
    for a, b, name in trace.spans:
        if name != "dsi":
            continue
        lo = bisect.bisect_left(starts, a)
        hi = bisect.bisect_right(starts, b)
        for s, e, op in trace.ops[lo:hi]:
            if not op.startswith("Memcpy"):
                t += e - s
                calls += 1
    return t / 1e9, calls


def read(run):
    t, calls = device_seconds(run.trace)
    if calls == 0:
        return None
    return 100.0 * bound_s(run.peaks, run.facts) * run.n / t
