"""micro.stream_s: mean seconds per window subject of the span around
`stream` in the microscopy regime from the device-resident field, with
its .trk writer, ended by a synchronize.  Host clock, traced run."""


def read(run):
    return run.span_mean("micro_stream")
