"""mfu.micro: the whole microscopy subject's share of the card's peak, in
%: the roofline bounds of its counted operations (the structure tensor's
of `st_recon.roofline_pct` once a subject, and the cone search's of
`propagate_micro.roofline_pct` over the window's stream-steps) over the
traced window's seconds."""

import importlib.util
import os


def _load(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(run):
    if run.facts.get("window_cells") is None:
        return None
    st = _load("st_recon.roofline_pct").bound_s(run.peaks, run.facts)
    micro = _load("propagate_micro.roofline_pct").bound_s(
        run.peaks, run.facts, run.counters["stream_steps"])
    return 100.0 * (st * run.n + micro) / run.trace.window_s
