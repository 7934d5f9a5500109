"""Lightweight stage profiling.

The reference's only instrumentation is ad-hoc @time prints inside the
RUMBA loop (reference: src/rusd.jl:282,542,545).  Here: a context-manager
stage timer with a summary table (fibers_tpu/utils/profiling.py without
its device-trace wrapper; device traces come from torch.profiler).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["StageTimer", "prof", "prof_enabled", "prof_summary",
           "prof_reset"]


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t("gather"): ...
    >>> with t("fit"): ...
    >>> print(t.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.flops: Dict[str, float] = {}
        self.order: List[str] = []

    @contextmanager
    def __call__(self, stage: str, flops: Optional[float] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if stage not in self.totals:
                self.totals[stage] = 0.0
                self.counts[stage] = 0
                self.order.append(stage)
            self.totals[stage] += dt
            self.counts[stage] += 1
            if flops:
                self.flops[stage] = self.flops.get(stage, 0.0) + flops

    def summary(self) -> str:
        total = sum(self.totals.values())
        has_flops = bool(self.flops)
        hdr = f"{'stage':<24}{'calls':>6}{'total s':>10}{'%':>7}"
        if has_flops:
            hdr += f"{'TFLOP/s':>10}"
        lines = [hdr]
        for s in self.order:
            pct = 100.0 * self.totals[s] / total if total else 0.0
            row = (f"{s:<24}{self.counts[s]:>6}"
                   f"{self.totals[s]:>10.3f}{pct:>6.1f}%")
            if has_flops:
                fl = self.flops.get(s)
                row += (f"{fl / self.totals[s] / 1e12:>10.2f}"
                        if fl and self.totals[s] > 0 else f"{'':>10}")
            lines.append(row)
        lines.append(f"{'TOTAL':<24}{'':>6}{total:>10.3f}")
        return "\n".join(lines)


# ------------------------------------------------------------------ #
# Global env-gated profiler: FIBERS_PROFILE=1 turns every `prof(...)`
# block across models/tract/io into an accumulating stage timer, so any
# bench tail is self-attributing.
# ------------------------------------------------------------------ #

_GLOBAL = StageTimer()


def prof_enabled() -> bool:
    return os.environ.get("FIBERS_PROFILE") == "1"


@contextmanager
def prof(stage: str, flops: Optional[float] = None):
    """Time a named stage into the global profiler (no-op unless
    FIBERS_PROFILE=1).  Callers should block_until_ready inside the block
    when attributing device work.  `flops` (raw FLOPs executed inside
    the block) adds an achieved-TFLOP/s column to the summary."""
    if not prof_enabled():
        yield
        return
    with _GLOBAL(stage, flops=flops):
        yield


def prof_summary() -> str:
    return _GLOBAL.summary()


def prof_reset() -> None:
    _GLOBAL.totals.clear()
    _GLOBAL.counts.clear()
    _GLOBAL.order.clear()
