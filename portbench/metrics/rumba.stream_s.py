"""rumba.stream_s: mean seconds per window subject of the span around the
chain's tractography (`peaks_to_ovecs(device=True)` and `stream` of ~1M
streams from five peaks on the i6 point wire, with its .trk writer),
ended by a synchronize.  Host clock, traced run."""


def read(run):
    return run.span_mean("stream")
