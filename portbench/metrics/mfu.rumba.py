"""mfu.rumba: the whole RUMBA-SD subject's share of the card's peak, in
%: the sum of the roofline bounds of its counted operations (the
products, the row passes and the TV multiplier of every iteration, and
the propagation of its streams: the work functions of
`rl_gemm.roofline_pct`, `rumba_step.roofline_pct`,
`tv_fused.roofline_pct` and `propagate.roofline_pct`) over the traced
window's seconds per subject.  A kernel taken off the path leaves its own
roofline silent; this share still bounds the subject."""

import importlib.util
import os

PARTS = ("rl_gemm.roofline_pct", "rumba_step.roofline_pct",
         "tv_fused.roofline_pct", "propagate.roofline_pct")


def _bound(name, run):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bound_s(run.peaks, run.facts)


def read(run):
    if run.facts.get("visited") is None:
        return None
    total = sum(_bound(name, run) for name in PARTS)
    return 100.0 * total * run.n / run.trace.window_s
