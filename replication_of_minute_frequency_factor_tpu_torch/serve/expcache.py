"""Device-resident exposure cache: LRU under an explicit byte budget.

The port of the JAX package's ``serve/expcache.py``. A served
day-range's computed block (``[F, days, tickers]`` exposures plus the
daily close / validity planes the IC and decile queries derive from)
stays in device memory so a repeat query costs a cache lookup instead of
an encode + copy + block build. Device memory is the scarce resource:
entries are accounted by their tensors' ``nbytes`` and evicted
least-recently-used when the budget would overflow.

Torch has no call that frees a tensor's storage while references to it
live (the JAX package calls ``.delete()`` on the evicted buffers): an
eviction drops the cache's references, and the caching allocator takes
the memory back as soon as no other reference holds it. The request
loop is the only reader and keeps no block past its dispatch group, so
after an eviction ``torch.cuda.memory_allocated`` falls by the block's
bytes. Counters: ``serve.cache{outcome=hit|miss}``,
``serve.cache_evictions``, ``serve.cache_oversize``; gauges:
``serve.cache_bytes``, ``serve.cache_entries``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, Optional


def entry_nbytes(entry: Dict[str, object]) -> int:
    """Device bytes held by a block entry (sum over its tensors)."""
    return int(sum(int(getattr(v, "nbytes", 0) or 0)
                   for v in entry.values()))


class DeviceExposureCache:
    """LRU ``key -> {name: device array}`` map bounded by device bytes.

    ``byte_budget <= 0`` disables caching entirely (every ``get`` is a
    miss, ``put`` stores nothing) — the knob for a measurement run that
    wants every request to pay the dispatch.
    """

    def __init__(self, byte_budget: int, telemetry=None):
        self.byte_budget = int(byte_budget)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, tuple]" = OrderedDict()
        self._bytes = 0
        self._telemetry = telemetry

    def _tel(self):
        if self._telemetry is not None:
            return self._telemetry
        from ..telemetry import get_telemetry
        return get_telemetry()

    # --- stats ----------------------------------------------------------
    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _gauges(self) -> None:
        tel = self._tel()
        tel.gauge("serve.cache_bytes", self._bytes)
        tel.gauge("serve.cache_entries", len(self._entries))
        # budget + headroom ride along: with the
        # device.hbm_* watermarks they answer "is the LRU budget sized
        # to the memory actually available" from one scrape
        tel.gauge("serve.cache_budget_bytes", self.byte_budget)
        tel.gauge("serve.cache_headroom_bytes",
                  max(0, self.byte_budget - self._bytes))

    # --- read/write -----------------------------------------------------
    def get(self, key: Hashable) -> Optional[Dict[str, object]]:
        tel = self._tel()
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
        if hit is None:
            tel.counter("serve.cache", outcome="miss")
            return None
        tel.counter("serve.cache", outcome="hit")
        return hit[0]

    def put(self, key: Hashable,
            entry: Dict[str, object]) -> Dict[str, object]:
        """Insert (or refresh) ``entry``, evicting LRU entries until it
        fits. An entry larger than the whole budget is returned
        UNCACHED (``serve.cache_oversize``) — caching it would evict
        everything and still overflow."""
        tel = self._tel()
        nbytes = entry_nbytes(entry)
        evicted = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            if nbytes > self.byte_budget:
                tel.counter("serve.cache_oversize")
                self._gauges()
                return entry
            while self._entries and self._bytes + nbytes > self.byte_budget:
                _, (dead, dead_bytes) = self._entries.popitem(last=False)
                self._bytes -= dead_bytes
                evicted.append(dead)
            self._entries[key] = (entry, nbytes)
            self._bytes += nbytes
            self._gauges()
        for dead in evicted:
            tel.counter("serve.cache_evictions")
            _delete_entry(dead)
        return entry

    def clear(self) -> None:
        with self._lock:
            dead = [e for e, _ in self._entries.values()]
            self._entries.clear()
            self._bytes = 0
            self._gauges()
        for e in dead:
            _delete_entry(e)


def _delete_entry(entry: Dict[str, object]) -> None:
    """Drop an evicted block's tensors now: the LRU exists to bound
    device memory, so the entry dict must not keep them alive until the
    dict itself is collected."""
    entry.clear()
