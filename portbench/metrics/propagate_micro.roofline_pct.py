"""propagate_micro.roofline_pct: the microscopy step-loop kernel's share
of its roofline, in %.

The work: every stream-step of the window's subjects tests each of the
search window's W cells against the cone and the best alignment (6
FP32 operations a cell: two sums of three products) and moves the stream
(11 a step), `chip_smoke.py`'s MICRO_FLOPS_CELL and MICRO_FLOPS_STEP.
The stream-steps are the pipeline's count of what the .trk sink
received, its points and one final search a direction of each line; W
is the reference's window (`reference/micro.py`).  Compute-bound: the
bound is those operations over 67 TFLOP/s of FP32 (`peaks.json`); the
time is the device time of the `micro_kernel` launches in the traced
window.
"""

PATTERN = r"\bmicro_kernel\b"
FLOPS_CELL, FLOPS_STEP = 6, 11


def bound_s(peaks, facts, steps):
    """Seconds of `steps` stream-steps at the FP32 peak."""
    w = facts["window_cells"]
    return steps * (FLOPS_CELL * w + FLOPS_STEP) / peaks["fp32_flop_s"]


def read(run):
    if run.facts.get("window_cells") is None:
        return None
    t, calls = run.trace.op_seconds(PATTERN)
    if calls == 0:
        return None
    return 100.0 * bound_s(run.peaks, run.facts,
                           run.counters["stream_steps"]) / t
