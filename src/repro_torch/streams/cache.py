"""Cross-call result memoization and unified cache observability.

This is Tier 2 of the cache-first evaluation path (Tier 1, in-batch
request dedup, lives in :func:`repro_torch.streams.simulator.simulate_batch`;
Tier 3 is the memoized host-side structure building).  A
:class:`ResultCache` is a bounded, value-keyed LRU holding evaluation
results (:class:`~repro_torch.streams.simulator.SimResult` rows of the
simulator backend), so a control-loop step whose guards held, or a replan
re-scoring an unchanged candidate ladder, runs no tick on the device.

Keys are pure values: frozen ``Configuration`` / ``SimParams`` dataclasses,
the canonicalized offered load, the seed, the *resolved* tick-kernel
backend, the samples mode, the device type, and a caller-supplied
``cache_token``.  The token is the
invalidation rule — the engine layer passes the learner's monotonic
``ModelStore.version``, so every ``observe``/``retrain`` makes all earlier
entries unreachable (they age out of the LRU) without any explicit flush.

:func:`cache_stats` is the one observability entry point over every cache
on the evaluation path: the launch-shape registry, the host-side
structure/padding memo, the device-resident batch-staging cache, every
live :class:`ResultCache`, the Tier-1 dedup counters and the device→host
transfers.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

#: Every live ResultCache, so :func:`result_cache_info` / :func:`cache_stats`
#: aggregate without anyone registering explicitly.  Weak: a dropped
#: evaluator's cache disappears from the stats with it.
_RESULT_CACHES: "weakref.WeakSet[ResultCache]" = weakref.WeakSet()


class ResultCache:
    """Bounded, value-keyed LRU for evaluation results.

    Entries are bounded by count *and* by approximate resident bytes (the
    caller reports each value's footprint to :meth:`put`); eviction is
    least-recently-used.  Values are treated as immutable/shared — a hit
    returns the same object that was stored, exactly like the structure
    and resident caches it composes with.
    """

    def __init__(
        self,
        max_entries: int = 4096,
        max_bytes: int = 1 << 28,
        name: str = "result",
    ) -> None:
        self.name = name
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._data: "OrderedDict[object, tuple]" = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0, "bytes": 0}
        #: sticky BATCH_LADDER rung for the dedup path's executed subset:
        #: one cache spans one evaluator's trace, so pinning the rung here
        #: keeps cache hits from turning executed-batch sizes (and thus
        #: launch shapes) data-dependent.  Survives clear(): it is shape
        #: state, not result state.
        self.batch_floor = 0
        _RESULT_CACHES.add(self)

    def get(self, key):
        """The cached value, or ``None`` (counted as a miss)."""
        hit = self._data.get(key)
        if hit is None:
            self._stats["misses"] += 1
            return None
        self._stats["hits"] += 1
        self._data.move_to_end(key)
        return hit[0]

    def put(self, key, value, nbytes: int = 0) -> None:
        """Store ``value`` under ``key``; ``nbytes`` is its approximate
        resident footprint.  A value larger than the whole byte budget is
        not stored at all."""
        nbytes = int(nbytes)
        if nbytes > self.max_bytes:
            return
        old = self._data.pop(key, None)
        if old is not None:
            self._stats["bytes"] -= old[1]
        self._data[key] = (value, nbytes)
        self._stats["bytes"] += nbytes
        while self._data and (
            len(self._data) > self.max_entries
            or self._stats["bytes"] > self.max_bytes
        ):
            _, (_, evicted) = self._data.popitem(last=False)
            self._stats["bytes"] -= evicted
            self._stats["evictions"] += 1

    def info(self) -> dict:
        return {
            "name": self.name,
            "size": len(self._data),
            "max_entries": self.max_entries,
            "max_bytes": self.max_bytes,
            **self._stats,
        }

    def clear(self) -> None:
        self._data.clear()
        for k in self._stats:
            self._stats[k] = 0

    def __len__(self) -> int:
        return len(self._data)


def result_cache_info() -> dict:
    """Aggregate hits/misses/evictions/bytes across every live
    :class:`ResultCache` (plus the live-cache count)."""
    agg = {
        "caches": 0, "size": 0, "hits": 0, "misses": 0,
        "evictions": 0, "bytes": 0,
    }
    for c in list(_RESULT_CACHES):
        info = c.info()
        agg["caches"] += 1
        for k in ("size", "hits", "misses", "evictions", "bytes"):
            agg[k] += info[k]
    return agg


def clear_result_caches() -> None:
    """Empty every live :class:`ResultCache` and reset its statistics."""
    for c in list(_RESULT_CACHES):
        c.clear()


def cache_stats() -> dict:
    """Unified statistics for every cache on the evaluation path.

    One dict with one section per tier: ``kernel`` (launch shapes: a
    shape's first run is a ``miss``), ``structure`` (host-side
    structure/padding memo), ``resident`` (device-resident batch staging),
    ``result`` (aggregated Tier-2 result caches), ``dedup`` (Tier-1
    in-batch request collapse), and ``transfer`` (device→host bytes moved
    by the evaluation path, ``bytes_full`` trajectories and
    ``bytes_summary`` on-device reductions, plus lazy-trajectory
    ``refetches``).  Each section reports the counters that tier keeps:
    hits/misses everywhere, evictions/bytes where the cache is bounded by
    bytes.
    """
    from .simulator import (
        dedup_info,
        kernel_cache_info,
        resident_cache_info,
        structure_cache_info,
        transfer_info,
    )

    kernel = {
        k: v for k, v in kernel_cache_info().items() if k != "entries"
    }
    return {
        "kernel": kernel,
        "structure": structure_cache_info(),
        "resident": resident_cache_info(),
        "result": result_cache_info(),
        "dedup": dedup_info(),
        "transfer": transfer_info(),
    }
