"""stream.writer_stall_s: seconds per window subject that the stream's
chunk loop waited on its .trk writer thread, the program's own counter
(`fibers_tpu_torch.tract.stream.writer_times.stall`), summed over the
window's subjects.  Host clock, traced run."""


def read(run):
    return run.counters["writer_stall_s"] / run.n
