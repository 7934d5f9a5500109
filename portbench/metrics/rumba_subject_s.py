"""rumba_subject_s: the whole measured window over the subjects it
completed, for the RUMBA-SD chain (fit, structure tensor, tractography):
the card's seconds paid per subject.  Host clock, untraced run."""


def read(run):
    return run.window_s / run.n
