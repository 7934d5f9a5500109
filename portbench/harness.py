"""The benchmark's loop: set-up, the measured window, the check, the
metrics and the result line.  Everything specific to a configuration,
a traffic mix or a metric is found by name (`run.py`'s docstring)."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import time

import torch

from . import trace as tracing

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

__all__ = ["load_benchmark", "find", "load_config", "load_traffic",
           "load_metric", "metric_names", "run_cell", "Run"]


def load_benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in "
                     f"BENCHMARK.json")


def load_config(bench, name):
    entry = find(bench["configs"], name, "config")
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def load_traffic(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


def load_pipeline(name):
    return importlib.import_module(f"portbench.pipelines.{name}")


def load_metric(name):
    """The reader module `metrics/<name>.py` (names hold dots, so it is
    loaded from its path)."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names(bench, workload, traced):
    """The metrics a run of `workload` reports: its end-to-end metrics,
    or traced its per-layer ones (those that list it, or that list no
    cells and move one of its end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


class Run:
    """What the metric readers read: the subjects' wall times, the set-up,
    the window, the spans (traced), the trace (traced), the pipeline's
    facts and counters, and the table of peaks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        with open(os.path.join(BENCH, "peaks.json")) as f:
            self.peaks = json.load(f)

    def span_mean(self, name):
        """Mean seconds of the span `name` per window subject."""
        t = self.spans.times.get(name)
        return sum(t) / self.n if t else None


def _percentile(xs, q):
    """Linear-interpolated q-th percentile (numpy's default)."""
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def power_limit():
    """The card's name and power limit as `nvidia-smi` reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(bench, cell, args, t_process, device="cuda", cfg=None):
    """One run of `cell`; returns (result dict, checks).  The tests pass
    `device` "cpu" (the program's plain versions) and a small `cfg`."""
    cfg = cfg or load_config(bench, cell["config"])
    traffic = load_traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"
    pipe = load_pipeline(cfg["pipeline"])
    traced = bool(args.trace)
    spans = tracing.Spans(traced, cuda)
    checkdir = os.environ.get("TMPDIR") or os.path.join(ROOT, "build")
    os.makedirs(checkdir, exist_ok=True)
    sub = pipe.Cell(cfg, traffic, args.seed, checkdir, device)
    quiet = tracing.Spans(False)
    sub.subject(-1, quiet)                 # warm-up: set-up ends here
    setup_s = time.time() - t_process

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times = []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + [ProfilerActivity.CUDA] * cuda)
        prof.start()
    with torch.profiler.record_function(tracing.PREFIX + "window") \
            if traced else contextlib.nullcontext():
        w0 = time.perf_counter()
        i = 0
        while time.perf_counter() - w0 < args.seconds:
            t0 = time.perf_counter()
            sub.subject(i, spans)
            times.append(time.perf_counter() - t0)
            i += 1
        window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = None
    if traced:
        prof.stop()
        tr = tracing.Trace(prof)
        del prof
    t_check = time.perf_counter()
    sub.release()
    checks = sub.check()
    check_s = time.perf_counter() - t_check
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)

    run = Run(n=len(times), times=times, window_s=window_s, setup_s=setup_s,
              spans=spans, trace=tr, facts=sub.facts,
              counters=sub.counters, percentile=_percentile)
    metrics = {}
    for m in metric_names(bench, cell["name"], traced):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    card = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        card["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": len(times), "failed": 0,
              "metrics": metrics, "device": card,
              "subject_times_s": times, "check_s": check_s}
    if traced:
        card["busy_s"] = tr.busy
        card["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_by_span()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks
