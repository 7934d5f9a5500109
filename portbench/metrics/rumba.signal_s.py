"""rumba.signal_s: seconds per window subject of the fit's signal stage
(the kernel matrix, the u12 signal rows built on the host and decoded on
the card), the program's own stage time (`rumba_rec(timings=)`'s
"signal", ended by a synchronize).  Traced run."""


def read(run):
    return run.counters["signal_s"] / run.n
