"""subject_p90_s: the 90th percentile (linear interpolation) of every
window subject's wall time, from its first API call to its outputs in
host memory or on disk.  Host clock, untraced run."""


def read(run):
    return run.percentile(run.times, 90)
