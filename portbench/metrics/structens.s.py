"""structens.s: mean seconds per window subject of the span around
`st_recon` on the mean DWI (the host mean included), ended by a
synchronize.  Host clock, traced run."""


def read(run):
    return run.span_mean("structens")
