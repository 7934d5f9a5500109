"""The benchmark's own tests: small sizes on the CPU (the program's plain
versions), and on the card those marked `cuda`.  They import the
benchmark as the package `portbench` from the checkout's root."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small(cfg):
    """A configuration cut to a size the CPU tests hold: a 20 x 20 x 12
    grid, 3,000 streams and (RUMBA-SD) 8 iterations; every width, table
    and rule as the configuration states it."""
    cfg = copy.deepcopy(cfg)
    cfg["scan"]["shape"] = [20, 20, 12]
    cfg["stream"]["streams"] = 3000
    if "niter" in cfg["fit"]:
        cfg["fit"]["niter"] = 8
    return cfg


@pytest.fixture
def shrink():
    return small


@pytest.fixture
def bench():
    from portbench import harness
    return harness.load_benchmark()


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device when there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
