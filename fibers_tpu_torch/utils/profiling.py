"""The port's tracer: named spans and counters at the host stages of the
fits, the tractography and the writer.

    from fibers_tpu_torch.utils import profiling
    with profiling.collect() as rec:
        ...                                   # any calls into the package
    rec.spans[name].self_s                    # seconds, summed over calls
    rec.counters[name]

Tracing is off unless `collect()` is open.  Off, `span(name)` is one
test of a module-level flag and returns a shared no-op context, and
`count` is one test: nothing is allocated and no clock is read.  On, for
every thread of the process, a span adds to its name's aggregate
(`SpanStats`: calls, total seconds, self seconds, the names of the spans
it ran inside) and a counter to its sum; memory stays bounded by the
number of names.  A span times the host, its blocking waits included,
and never synchronizes a device: a span that ends in a copy to the host
holds the host's wait for the work queued before it.

When a `torch.profiler` session records on the calling thread, each span
is also a `record_function` range named `fibers.<name>`, so it sits in
the profiler's trace on the same clock as the device's kernels and
copies.  With CUDA activity the profiler also draws each such range on
the device's timeline (a user annotation, under the same name): a reader
of device busy time skips `fibers.` events there.  The profiler does not
see the .trk writer thread: its spans go to the record only.

Each module names its own spans and counters where it opens them; the
list of every name, with the metric that reads it, is PERF.md section 3.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional, Set

import torch

__all__ = ["span", "count", "collect", "lap", "Record", "SpanStats"]

PREFIX = "fibers."

_on = False          # set by collect(): the one test an off call makes
_record: Optional["Record"] = None
_local = threading.local()


@dataclass
class SpanStats:
    """One span name's aggregate: calls, total and self seconds (total
    less the time of the spans that ran inside it on its thread), and the
    names of the spans it ran inside (None: none)."""

    calls: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    parents: Set[Optional[str]] = field(default_factory=set)


class Record:
    """What one `collect()` saw: `spans` {name: SpanStats} and `counters`
    {name: sum}."""

    def __init__(self):
        self.spans: Dict[str, SpanStats] = {}
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def _add_span(self, name, total, own, parent):
        with self._lock:
            s = self.spans.get(name)
            if s is None:
                s = self.spans[name] = SpanStats()
            s.calls += 1
            s.total_s += total
            s.self_s += own
            s.parents.add(parent)

    def _add_count(self, name, n):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "parent", "child_s", "range", "t0")

    def __init__(self, name, rec):
        self.name, self.rec = name, rec

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_s = 0.0
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_s += dt
        self.rec._add_span(self.name, dt, dt - self.child_s,
                           None if parent is None else parent.name)
        return False


def span(name: str):
    """A context that times the enclosed host work as `name` while
    `collect()` is open, and does nothing otherwise."""
    if not _on:
        return _OFF
    return _Span(name, _record)


def count(name: str, n) -> None:
    """Add `n` to the counter `name` while `collect()` is open."""
    if _on:
        _record._add_count(name, n)


@contextmanager
def collect():
    """Turn tracing on, process-wide and for every thread, and yield a
    fresh `Record` that the spans and counters fill until the block
    ends.  Collections do not nest."""
    global _on, _record
    if _on:
        raise RuntimeError("profiling.collect() is already open")
    rec = Record()
    _record, _on = rec, True
    try:
        yield rec
    finally:
        _on, _record = False, None


class _Lap:
    __slots__ = ("timings", "name", "devs", "_span", "_t0")

    def __init__(self, timings, name, devs):
        self.timings, self.name, self.devs = timings, name, devs

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None and self.timings is not None:
            for d in self.devs:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            self.timings[self.name.split(".", 1)[1]] = \
                time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


def lap(timings, name: str, devs=()):
    """A context around one stage of a fit: the span `name`
    ("<model>.<stage>") and, when `timings` is a dict, the stage's wall
    seconds stored under "<stage>", taken after synchronizing the CUDA
    devices in `devs` so that they hold the device work the stage queued.
    A stage that learns its devices as it runs sets `devs` on the context
    it gets from `with`."""
    return _Lap(timings, name, devs)
