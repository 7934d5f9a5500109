"""mfu.dti_gqi: the whole subject's share of the card's peak, in %: the
sum of the roofline bounds of the subject's counted operations (the GQI
kernel's, and with tractography the propagation's: the work functions
of `gqi_fused.roofline_pct` and `propagate.roofline_pct`) over the
traced window's seconds per subject.  A kernel taken off the path leaves
its own roofline silent; this share still bounds the subject."""

import importlib.util
import os


def _bound(name, run):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bound_s(run.peaks, run.facts)


def read(run):
    total = _bound("gqi_fused.roofline_pct", run)
    if run.facts.get("visited") is not None:
        total += _bound("propagate.roofline_pct", run)
    return 100.0 * total * run.n / run.trace.window_s
