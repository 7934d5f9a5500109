"""propagate.roofline_pct: the tractography kernel's share of its
roofline, in %.

The operation: both directions of every stream of a subject, from its
start state to its saved points.  Bytes: the start state (position,
direction, count: 28 bytes a stream) read once, the saved points (both
directions, as the reference counts them on the same peaks; 12 bytes a
point on the float32 wire, 3 on the i8 wire's deltas, 2.25 on i6's, with
the delta wires' 12-byte anchor a stream) and two point counts a stream
written once, and the orientation
field read once in each voxel the streams visit (nvec vectors of 12
bytes; visits counted per chunk of 131,072 streams, as the reference
tracks them).  Memory-bound: the bound is those bytes over 3.35 TB/s
(NVIDIA's H100 SXM data sheet at 700 W: `peaks.json`).  The time is the
device time of the `propagate_pair_kernel` launches in the traced
window; the reference's counts are of the checked subject and stand for
every subject of the window (the subjects differ only in noise).
"""

PATTERN = r"propagate_pair_kernel"


POINT_BYTES = {"auto": 12, "f32": 12, "i8": 3, "i6": 2.25}


def work(streams, points, visited, nvec, wire="f32"):
    """Bytes of one subject's propagation."""
    anchors = 0 if POINT_BYTES[wire] == 12 else 12 * streams
    return (28 * streams + POINT_BYTES[wire] * points + 8 * streams
            + anchors + 12 * nvec * visited)


def bound_s(peaks, facts):
    return work(facts["streams_seeded"], facts["points"], facts["visited"],
                facts["nvec"], facts["wire"]) / peaks["hbm_bytes_s"]


def read(run):
    t, calls = run.trace.op_seconds(PATTERN)
    if calls == 0 or run.facts.get("visited") is None:
        return None
    return 100.0 * bound_s(run.peaks, run.facts) * run.n / t
