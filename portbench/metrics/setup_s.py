"""setup_s: seconds from the process's start to the first timed subject:
the imports, CUDA's start, the subjects made on the card, the kernel
library loaded (built, in a checkout's first run) and one warm subject.
Host clock."""


def read(run):
    return run.setup_s
