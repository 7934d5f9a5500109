#!/usr/bin/env python3
"""Run one cell of the benchmark of `fibers_tpu_torch` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU.  The cell
(`workloads` in BENCHMARK.json) names a configuration and a traffic mix;
everything else is found by name under `portbench/`:

- `configs/<config>.json` (the file BENCHMARK.json gives): the scan, the
  fit, the tractography, the limits of the check, and `pipeline`, the
  module `pipelines/<pipeline>.py` that runs a subject;
- `traffic/<traffic>.json`: the mix (`output`, the number of distinct
  subjects, the checked one);
- `metrics/<metric>.py`: one reader per metric, `read(run)`, which
  returns the value or None.

A run makes its subjects on the card from the seed, warms up on one
subject (set-up ends there), then takes subjects back to back, in turn,
until `--seconds` have passed; the subject running then completes and
counts (a closed loop of one worker).  Then it compares what the checked
window subject produced with the plain references, and prints one JSON
line: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones, from a run under
`torch.profiler`), `device` and, traced, `breakdown`, with `checks` (each
number compared and its limit) last.

It fails, and prints no result, without a CUDA device, or when jax,
jaxlib, flax or the JAX package `fibers_tpu` are loaded at the end.
Build caches stay in the checkout: `build/kernels/` (the port's CUDA
library) and `build/native/` (its native packer).
"""

import os
import sys
import time

T_START = time.time()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fibers_tpu")


def process_start():
    """The wall time this process started at (Linux), else import time."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f
                         if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_START


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    for var, sub in (("FIBERS_NATIVE_CACHE", "native"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        sys.exit(f"portbench: the cell needs {cell['chips']} CUDA "
                 f"device(s), found {found}; it never runs on the CPU")
    result, checks = harness.run_cell(bench, cell, args, process_start())
    bad = forbidden_modules()
    if bad:
        sys.exit(f"portbench: loaded after the window: {', '.join(bad)}")
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    import json
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
