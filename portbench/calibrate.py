#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from.

    python3 portbench/calibrate.py --config <name> --traffic <name>
                                   --seeds <n> --control <k>
                                   [--first-seed <s>] [--probe <precision>]

For each of `n` seeds (s, s + 1, ...): one subject of a configuration
under a traffic mix (BENCHMARK.json need not list the pair) through
the timed path (the pipeline's `subject`, as the window drives it), then
the numbers its check compares ("program").  For the first `k` seeds also
the control ("control"): the plain reference itself put in the program's
place and computed one precision below the configuration's (the
pipeline's `control`).  One JSON line per reading, then a summary: per
number, the largest program reading and the smallest control reading.

Runs on the card (the cell's sizes) or, for the tests, with `device`
"cpu" at a small size.  The benchmark's runs never run it.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cfg, traffic, pipeline, seeds, control, checkdir,
             device="cuda", probe=None):
    """[(seed, side, {number: value})] for the seeds, the control's for
    the first `control` of them; with `probe` (a precision of the
    program's own), also the program at that precision ("probe", a look
    at the numbers' floor, not a control)."""
    from portbench import harness
    from portbench.trace import Spans
    pipe = harness.load_pipeline(pipeline)
    out = []
    span = Spans(False, device != "cpu")
    for k, seed in enumerate(seeds):
        cell = pipe.Cell(cfg, traffic, seed, checkdir, device)
        cell.subject(int(traffic["checked"]), span)
        cell.release()
        t0 = time.time()
        cell.check()
        got = cell.numbers
        out.append((seed, "program", dict(got, check_s=time.time() - t0)))
        if k < control:
            out.append((seed, "control", cell.control()))
            if probe:
                out.append((seed, "probe", cell.control(probe)))
        del cell
    return out


def summary(rows):
    """{number: (largest program reading, smallest control reading)}."""
    names = {n for _, _, got in rows for n in got}
    s = {}
    for n in sorted(names):
        prog = [g[n] for _, side, g in rows if side == "program" and n in g]
        ctl = [g[n] for _, side, g in rows if side == "control" and n in g]
        s[n] = (max(prog) if prog else None, min(ctl) if ctl else None)
    return s


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--probe", default=None,
                    help="also run the program at this precision of its "
                    "own on the control's seeds")
    args = ap.parse_args(argv)
    os.environ["FIBERS_NATIVE_CACHE"] = os.path.join(ROOT, "build",
                                                     "native")
    sys.path.insert(0, ROOT)
    from portbench import harness
    bench = harness.load_benchmark()
    cfg = harness.load_config(bench, args.config)
    traffic = harness.load_traffic(args.traffic)
    checkdir = os.environ.get("TMPDIR") or os.path.join(ROOT, "build")
    os.makedirs(checkdir, exist_ok=True)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    rows = []
    for seed in seeds:
        got = readings(cfg, traffic, cfg["pipeline"], [seed],
                       args.control - len([r for r in rows
                                           if r[1] == "control"]),
                       checkdir, probe=args.probe)
        for row in got:
            print(json.dumps({"seed": row[0], "side": row[1], **row[2]}),
                  flush=True)
        rows += got
    for n, (p, c) in summary(rows).items():
        ratio = c / p if p and c is not None else None
        print(json.dumps({"number": n, "program_max": p, "control_min": c,
                          "control_over_program": ratio}), flush=True)


if __name__ == "__main__":
    main()
