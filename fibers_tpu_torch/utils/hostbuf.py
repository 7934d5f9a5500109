"""Reusable host scratch buffers for transient decode/pack stages.

On this class of host (single-core VM, no transparent huge pages,
measured 2026-08-18) first-touching freshly mmap'd pages runs at
~0.1 GB/s — 20x slower than warm memory — and numpy returns >128 KB
allocations to the OS on free, so every per-chunk `np.empty` in the
streamline decode path pays the full fault cost again.  At the 1M-seed
benchmark scale that was ~95% of the "decode+trk" stage (measured:
98M-point fused decode 7.1 s cold vs 0.4 s warm into the same buffer).

`scratch(tag, n, dtype)` keeps ONE buffer per (tag, dtype), grown
geometrically, and returns a length-n view — callers must treat the
contents as garbage on entry and must not hold the view across another
scratch() call with the same tag.  Use ONLY for buffers that die before
the next call (wire decode staging, record packing); never for arrays
that escape into results.
"""

from __future__ import annotations

import os
import threading

import numpy as np

__all__ = ["scratch"]

_pool: dict = {}        # (tag, dtype) -> [buf, last-use tick]
_tick = 0
# scratch() is called from the overlap-mode fetch worker concurrently
# with the main decode thread (distinct tags, but a shared dict + LRU
# eviction); the lock keeps insert/evict/tick bookkeeping coherent.
# Dropping an entry another thread still views is safe — numpy keeps
# the buffer alive through the view — and per the contract a tag is
# only ever produced/consumed by one thread at a time.
_lock = threading.Lock()
# total pooled bytes are bounded: past the cap the least-recently-used
# tags are evicted (heterogeneous workloads in one process — different
# wire modes, problem sizes — would otherwise pin one max-size buffer
# per tag forever).  The default covers the benchmark worst case
# (~2.7 GB of live pools) with headroom.
_CAP_BYTES = int(float(os.environ.get("FIBERS_HOSTBUF_CAP_GB", 6)) * 2**30)


def scratch(tag: str, n: int, dtype) -> np.ndarray:
    """A length-`n` 1-D array of `dtype`, reused across calls per
    (tag, dtype).  Contents are garbage; the view is only valid until
    the next scratch() call with the same key."""
    global _tick
    if n < 0:
        raise ValueError(f"scratch size must be >= 0, got {n}")
    dt = np.dtype(dtype)
    key = (tag, dt)
    with _lock:
        _tick += 1
        ent = _pool.get(key)
        if ent is None or ent[0].size < n:
            # grow with headroom so a slightly-larger next chunk doesn't
            # re-fault; the old buffer is dropped (its pages go back to
            # the OS) only on growth
            cap = max(n, int(1.25 * n) if ent is None else
                      max(int(1.25 * n), ent[0].size))
            ent = [np.empty(cap, dt), _tick]
            _pool[key] = ent
            _evict(keep=key)
        else:
            ent[1] = _tick
        return ent[0][:n]


def _evict(keep) -> None:
    """Drop least-recently-used pool entries until under the byte cap
    (never the entry just touched — its view is live in the caller)."""
    total = sum(e[0].nbytes for e in _pool.values())
    if total <= _CAP_BYTES:
        return
    for key, ent in sorted(_pool.items(), key=lambda kv: kv[1][1]):
        if key == keep:
            continue
        total -= ent[0].nbytes
        del _pool[key]
        if total <= _CAP_BYTES:
            return


def pool_upload_slabs() -> bool:
    """Whether host->device producer slabs should come from the pool.

    Only on <=2-core hosts: there ops.transfer.to_device_rows produces
    every slab up front and hedges re-UPLOAD the held buffer without
    re-producing, so a per-span pooled slab is never rewritten while a
    transfer might still read it.  On bigger hosts producers run
    concurrently and a stalled-upload hedge re-produces the same span in
    parallel with the original transfer — pooled reuse would corrupt the
    bytes on the wire."""
    import os

    return (os.cpu_count() or 1) <= 2


def _reset() -> None:
    """Test hook: drop every pooled buffer."""
    _pool.clear()
