"""dsi.chunks_s: seconds per window subject of `dsi_rec`'s "chunks"
stage (every chunk's scatter onto the q-space grid, roll, FFT, radial
GEMM, peaks; ended by a synchronize), the program's own stage time
(`timings["chunks"]`).  Traced run."""


def read(run):
    t = run.counters.get("chunks_s")
    return None if t is None else t / run.n
