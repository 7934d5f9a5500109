"""micro.st_s: mean seconds per window subject of the span around
`st_recon` on the image block (slab by slab on the card, lazy outputs)
and the primary eigenvector taken on the card, ended by a synchronize.
Host clock, traced run."""


def read(run):
    return run.span_mean("micro_st")
