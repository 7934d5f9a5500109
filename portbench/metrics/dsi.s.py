"""dsi.s: mean seconds per window subject of the span around the
pipeline's `dsi_rec` call (the upload, the host tables, the chunks and
the QA normalisation), ended by a synchronize.  Host clock, traced
run."""


def read(run):
    return run.span_mean("dsi")
