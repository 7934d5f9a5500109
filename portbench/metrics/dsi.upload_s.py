"""dsi.upload_s: seconds per window subject of `dsi_rec`'s "upload"
stage (the host tables, the masked rows' upload through `prepare_batch`
and the tables' uploads, ended by a synchronize), the program's own
stage time (`timings["upload"]`).  Traced run."""


def read(run):
    t = run.counters.get("upload_s")
    return None if t is None else t / run.n
