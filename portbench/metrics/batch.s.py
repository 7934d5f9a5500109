"""batch.s: mean seconds per window subject of the span around the
pipeline's `batch` call, ended by a synchronize.  Host clock, traced run."""


def read(run):
    return run.span_mean("batch")
