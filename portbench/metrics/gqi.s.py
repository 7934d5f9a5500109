"""gqi.s: mean seconds per window subject of the span around the
pipeline's `gqi` call, ended by a synchronize.  Host clock, traced run."""


def read(run):
    return run.span_mean("gqi")
