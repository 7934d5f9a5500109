"""gqi_fused.roofline_pct: the GQI kernel's share of its roofline, in %.

The bound is the least time the card could take for the operation the
kernel carries: the ODF product of the masked signal rows [N, nvol] with
the design [nvol, nvert], the face-neighbour peak mask, the per-voxel
stats and the top-3 peaks.  Bytes: each input read once (signals, the
design, the neighbour table and its flags) and each output written once
(ODF, peak mask, min/mean/valid, top-3 values and int64 vertices).
Operations: 2 N nvol nvert of the product, at the fastest tensor-core
route that keeps float32 accuracy (three TF32 passes, 495 TFLOP/s).
The bound is the larger of bytes over 3.35 TB/s and operations over
that rate (NVIDIA's H100 SXM data sheet at 700 W: `peaks.json`), for
N = the masked voxels, once a subject; the time is the device time of
the kernel and its table-packing launch (`gqi_fused_kernel`,
`gqi_pack_kernel`) in the traced window.
"""

PATTERN = r"gqi_(fused|pack)_kernel"


def work(n, nvol, nvert, maxdeg):
    """(bytes, tensor-core operations) of one call on N = n rows."""
    nbytes = (4 * n * nvol + 4 * nvol * nvert + 5 * nvert * maxdeg
              + 4 * n * nvert + n * nvert + 4 * 3 * n + 4 * 3 * n
              + 8 * 3 * n)
    return nbytes, 3 * 2 * n * nvol * nvert


def bound_s(peaks, facts):
    b, f = work(facts["n_voxels"], facts["nvol"], facts["nvert"],
                facts["maxdeg"])
    return max(b / peaks["hbm_bytes_s"], f / peaks["tf32_flop_s"])


def read(run):
    t, calls = run.trace.op_seconds(PATTERN)
    if calls == 0:
        return None
    return 100.0 * bound_s(run.peaks, run.facts) * run.n / t
