"""rumba.iter_ms: milliseconds per RUMBA-SD iteration: the program's own
"iterate" stage time (`rumba_rec(timings=)`, ended by a synchronize)
over the window's subjects and their iterations.  It reads the same
whatever kernels an iteration is made of.  Traced run."""


def read(run):
    return 1e3 * run.counters["iterate_s"] / (run.n * run.facts["niter"])
