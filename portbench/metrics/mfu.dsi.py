"""mfu.dsi: the whole subject's share of the card's peak, in %: DSI's
roofline bound (the work function of `dsi.roofline_pct`) over the traced
window's seconds per subject."""

import importlib.util
import os


def read(run):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dsi.roofline_pct.py")
    spec = importlib.util.spec_from_file_location("dsi_roofline_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return 100.0 * mod.bound_s(run.peaks, run.facts) * run.n \
        / run.trace.window_s
