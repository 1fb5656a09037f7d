"""Hot-block read cache: a bounded-bytes LRU of assembled plaintext
blocks, keyed by content hash.

Zipfian traffic means a small fraction of
blocks serves most GETs — with the block store content-addressed, a
cached block can never go stale (a different payload IS a different
hash), so there is no invalidation protocol at all.  A repeat GET of a
hot object becomes a memory read instead of k piece fetches + a join
(EC) or a disk read + hash verify (replica remote fetch).

The cache lives ON the BlockManager instance — one per node, NOT a
process-wide singleton.  In-process test clusters share the process,
and a shared cache would let node A "read" a block it never fetched
(the PhaseAggregator/flight-recorder singleton hazard from PRs 6/9,
this time corrupting read-path semantics rather than metrics).

Entries are inserted only for blocks whose assembly cost something
remote (EC piece gathers, replica fetches from peers) — a replica-mode
local disk read is already served from the page cache and caching it
again would just duplicate RAM.

Metric families (doc/monitoring.md): `block_cache_{hits,misses,
evictions}_total` counters (process-wide aggregates) and a
`block_cache_bytes{id}` gauge per instance (`id` is process-unique,
the codec-batcher gauge pattern); the gauge is registered at
construction and unregistered at `close()` (the resource rule: registered at creation, unregistered at close).
Sized by `[block] read_cache_bytes` (0 disables), live-tunable via
`worker set read-cache-bytes`.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict

from ..utils.metrics import registry

# gauge `id` source: process-wide (several in-process nodes share the
# registry; per-node ids would collide — utils/background.py pattern)
_cache_ids = itertools.count(1)


class BlockCache:
    """Bounded-bytes LRU of verified plaintext blocks (one per node)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max(0, int(max_bytes))
        self._map: OrderedDict[bytes, bytes] = OrderedDict()
        self._bytes = 0
        self._gauge_key = (
            "block_cache_bytes",
            (("id", str(next(_cache_ids))),),
        )
        registry.register_gauge(*self._gauge_key, lambda: float(self._bytes))

    def __len__(self) -> int:
        return len(self._map)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def get(self, hash32: bytes) -> bytes | None:
        """Cached plaintext for `hash32`, refreshing recency; None on a
        miss.  A disabled cache (max_bytes == 0) returns None without
        counting — it would poison every hit-ratio panel with misses it
        was configured never to convert."""
        if self.max_bytes <= 0:
            return None
        data = self._map.get(hash32)
        if data is None:
            registry.incr("block_cache_misses_total")
            return None
        self._map.move_to_end(hash32)
        registry.incr("block_cache_hits_total")
        return data

    def put(self, hash32: bytes, data: bytes) -> None:
        """Insert a VERIFIED plaintext block (callers hash-check before
        inserting — the cache must never launder a corrupt assembly into
        future reads).  Oversized blocks are skipped, not force-fitted."""
        if self.max_bytes <= 0 or len(data) > self.max_bytes:
            return
        if hash32 in self._map:
            self._map.move_to_end(hash32)  # same hash = same bytes
            return
        self._map[hash32] = data
        self._bytes += len(data)
        self._evict()

    def _evict(self) -> None:
        while self._bytes > self.max_bytes and self._map:
            _h, old = self._map.popitem(last=False)
            self._bytes -= len(old)
            registry.incr("block_cache_evictions_total")

    def set_max_bytes(self, n: int) -> None:
        """Live resize (`worker set read-cache-bytes`): shrinking evicts
        down immediately; 0 disables and empties."""
        self.max_bytes = max(0, int(n))
        if self.max_bytes == 0:
            self._map.clear()
            self._bytes = 0
        else:
            self._evict()

    def close(self) -> None:
        """Drop the per-instance gauge (registered at construction,
        unregistered here — the resource rule for transient owners)."""
        registry.unregister_gauge(*self._gauge_key)
        self._map.clear()
        self._bytes = 0
