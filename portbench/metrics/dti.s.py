"""dti.s: mean seconds per window subject of the span around the
pipeline's `dti` call, ended by a synchronize.  Host clock, traced run."""


def read(run):
    return run.span_mean("dti")
