"""subject_s: the whole measured window over the subjects it completed:
the card's seconds paid per subject of the DTI + GQI pipeline, closed
loop, one worker.  Host clock, untraced run."""


def read(run):
    return run.window_s / run.n
