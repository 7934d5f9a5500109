"""Spans on the host's clock and the reduction of a `torch.profiler` trace.

A span (`spans(name)`) times one call into a layer of the program
from the benchmark's side.  Only a traced run (`--trace 1`) keeps spans:
each then ends in `torch.cuda.synchronize()`, so that its time holds the
device work it queued, and is also a `record_function` range named
`portbench.<name>`, which puts it in the profiler's trace beside the
device's operations.  An untraced run's spans do nothing.

`Trace` reduces the profiler's raw events (kernels, copies and memsets
on the device; the benchmark's ranges on the host) over the traced
window: the union of the device's busy intervals, the time of each
operation by name, and each idle gap named by the innermost span open
when it began.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import time

import torch

__all__ = ["Spans", "Trace"]

PREFIX = "portbench."


class Spans:
    """The spans of one run: per name, the list of durations (s)."""

    def __init__(self, traced: bool, cuda: bool = True):
        self.traced, self.cuda = traced, cuda
        self.times = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.traced:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            yield
            if self.cuda:
                torch.cuda.synchronize()
            self.times[name].append(time.perf_counter() - t0)


class Trace:
    """The device's activity in the traced window of a profiler run."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if name.startswith(PREFIX):
                if e.device_type() == DeviceType.CPU:
                    host.append((t0, t1, name[len(PREFIX):]))
            elif e.device_type() == DeviceType.CUDA:
                dev.append((t0, t1, name))
        win = [h for h in host if h[2] == "window"]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} window ranges")
        self.w0, self.w1 = win[0][0], win[0][1]
        self.ops = sorted((max(a, self.w0), min(b, self.w1), n)
                          for a, b, n in dev if b > self.w0 and a < self.w1)
        self.spans = sorted(h for h in host if h[2] != "window")
        self._starts = [a for a, _, _ in self.spans]
        self.busy, self.gaps = self._busy_and_gaps()

    @property
    def window_s(self):
        return (self.w1 - self.w0) / 1e9

    def _busy_and_gaps(self):
        busy, gaps, end = 0, [], self.w0
        for a, b, _ in self.ops:
            if a > end:
                gaps.append((end, a))
                end = a
            if b > end:
                busy += b - end
                end = b
        if self.w1 > end:
            gaps.append((end, self.w1))
        return busy / 1e9, gaps

    def op_seconds(self, pattern):
        """Device seconds of the operations whose name matches the regular
        expression `pattern` (searched), and their count."""
        rx = re.compile(pattern)
        hits = [b - a for a, b, n in self.ops if rx.search(n)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, k=10):
        total = collections.Counter()
        for a, b, n in self.ops:
            total[n[:120]] += b - a
        return [[n, t / 1e9] for n, t in total.most_common(k)]

    def _span_at(self, t):
        """The benchmark span open at time t (host); spans do not nest."""
        k = bisect.bisect_right(self._starts, t) - 1
        if k >= 0 and self.spans[k][1] >= t:
            return self.spans[k][2]
        return "between spans"

    def idle_by_span(self, k=10):
        """Idle seconds summed by the span open when each gap began,
        largest first."""
        total = collections.Counter()
        for a, b in self.gaps:
            total["idle in " + self._span_at(a)] += b - a
        return [[n, t / 1e9] for n, t in total.most_common(k)]
