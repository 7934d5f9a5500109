"""dsi.tables_s: seconds per window subject of `dsi_rec`'s host tables
(the q-space grid, the radial weight matrix, the half-spectrum fold, the
neighbours), the program's own stage time (`timings["tables"]`, inside
"upload").  None where the program has no such stage.  Traced run."""


def read(run):
    t = run.counters.get("tables_s")
    return None if t is None else t / run.n
