"""Hot-chunk cache: spend *leftover* memory budget on pinning chunk batches.

The paper's §3.6 policy spends memory on dense columns first — caching the
sparse matrix is the worst use of a byte while any dense column is still on
the slow tier (E > M).  But a serving runtime routinely has budget left over
after the wave's columns are admitted (few tenants, narrow waves, tenants
converging mid-workload).  That remainder is exactly the memory an IM
executor would have used, so we pin the most frequently read chunk batches
in it, turning the executor into a tunable hybrid between SEM-SpMM (budget
exhausted by columns -> pure streaming) and IM-SpMM (budget covers the whole
matrix -> no I/O after warmup).

Eviction is LFU with persistent frequencies: access counts survive eviction,
so a batch that keeps getting re-read re-earns its pin even after a budget
squeeze (a tenant wave widening temporarily).  On power-law graphs chunk
batches are uniform in *bytes* but the runtime may scan subranges or shrink
budget mid-workload, which is where the frequency signal bites.

Duck-typed interface consumed by :meth:`repro_torch.io.storage.TileStore.stream`:
``get(key)`` -> batch-or-None, ``offer(key, batch, nbytes)``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

# (global_start_chunk, n_chunks, tile_row_offset, format_tag, enc_sig,
# generation, version) of a read batch — built in TileStore._fetch.
# tile_row_offset is load-bearing: a pinned batch's meta is rebased to the
# reading shard's frame, so views with different offsets must never share an
# entry.  enc_sig (the store's meta width + a digest of its per-chunk
# encoding tags) is equally load-bearing: a raw store's uint16 pin must
# never be served to a reader of the delta-packed re-encoding of the same
# matrix — replicas share a signature, so true copies still share pins.
# generation and version carry the mutable-graph story (the enc_sig
# rule, one axis further): a compaction install rewrites chunk bytes under the
# same path (generation), and the base-aligned read batches a future base
# rewrite will produce differ per logical version — a pin taken at version
# v must MISS after an update touches its chunk, never serve stale rows.
Key = Tuple


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    hit_bytes: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class HotChunkCache:
    """LFU-pinned chunk-batch cache with a resizable byte budget."""

    def __init__(self, budget_bytes: int = 0):
        self.budget_bytes = int(budget_bytes)
        self.stats = CacheStats()
        self._pinned: Dict[Key, tuple] = {}    # key -> batch tuple
        self._nbytes: Dict[Key, int] = {}      # key -> resident bytes pinned
        self._freq: Dict[Key, int] = {}        # persistent access counts
        self.pinned_bytes = 0
        # Sharded scans hit one cache from several prefetch threads at once.
        self._lock = threading.RLock()

    # -- read path -----------------------------------------------------------
    def get(self, key: Key):
        with self._lock:
            self._freq[key] = self._freq.get(key, 0) + 1
            batch = self._pinned.get(key)
            if batch is not None:
                self.stats.hits += 1
                self.stats.hit_bytes += self._nbytes[key]
            else:
                self.stats.misses += 1
            return batch

    def offer(self, key: Key, batch: tuple, nbytes: int) -> bool:
        """Called after a miss was read from the slow tier; pin it if the
        budget allows (evicting strictly colder entries if needed)."""
        with self._lock:
            return self._offer(key, batch, nbytes)

    def _offer(self, key: Key, batch: tuple, nbytes: int) -> bool:
        if key in self._pinned or nbytes > self.budget_bytes:
            return False
        if self.pinned_bytes + nbytes > self.budget_bytes:
            # Evict only if the strictly-colder entries free enough bytes —
            # decide before touching anything, so a doomed offer never
            # shrinks the cache (evict-then-bail would strip entries the
            # budget had already admitted).
            freq = self._freq.get(key, 0)
            victims = sorted((k for k in self._pinned
                              if self._freq.get(k, 0) < freq),
                             key=lambda k: self._freq.get(k, 0))
            freed, needed = 0, self.pinned_bytes + nbytes - self.budget_bytes
            chosen = []
            for v in victims:
                if freed >= needed:
                    break
                chosen.append(v)
                freed += self._nbytes[v]
            if freed < needed:
                return False
            for v in chosen:
                self._evict(v)
        self._pinned[key] = batch
        self._nbytes[key] = nbytes
        self.pinned_bytes += nbytes
        return True

    # -- budget control ------------------------------------------------------
    def set_budget(self, budget_bytes: int) -> None:
        """Resize (the scheduler calls this each pass with the leftover
        budget); evicts coldest-first until pinned bytes fit."""
        with self._lock:
            self.budget_bytes = max(0, int(budget_bytes))
            while self.pinned_bytes > self.budget_bytes:
                self._evict(self._coldest())

    def _coldest(self) -> Optional[Key]:
        if not self._pinned:
            return None
        # .get: entries pinned via offer() without a prior get() (pre-warm)
        # have no frequency record yet
        return min(self._pinned, key=lambda k: self._freq.get(k, 0))

    def _evict(self, key: Key) -> None:
        del self._pinned[key]
        self.pinned_bytes -= self._nbytes.pop(key)
        self.stats.evictions += 1

    def clear(self) -> None:
        self._pinned.clear()
        self._nbytes.clear()
        self.pinned_bytes = 0

    def __len__(self) -> int:
        return len(self._pinned)


class PartitionedHotChunkCache:
    """Shard-aware budget split: one child :class:`HotChunkCache` per slice,
    each owning its own portion of the total budget.

    A sharded scan hits the cache from every shard's prefetch thread at
    once; with one shared budget a fast shard (small byte range, quick
    passes) can monopolize the pins and evict a slow shard's hot batches —
    exactly the shard whose reads most need hiding.  Splitting the budget
    per shard makes eviction pressure local: shard i's offers compete only
    against shard i's pins.  The scheduler resizes the whole partition each
    pass (``set_budget``) and reads aggregated stats; executors read/write
    through their own ``shard(i)`` slice.

    The slices need not be equal: the serving fleet gives each wave one
    slice, which the wave's scheduler resizes every pass (``set_budget`` on
    its adopted shard) with its arbitrated share of the global leftover,
    and the fleet zeroes through ``set_slice_budget`` when a wave drains —
    so slices rebalance continuously (a retired wave's slice shrinks to
    zero and the freed bytes reappear in the survivors' shares).
    ``budget_bytes`` always reports the live sum of the slices."""

    def __init__(self, n_shards: int, budget_bytes: int = 0):
        if n_shards < 1:
            raise ValueError("need at least one shard")
        self.shards = [HotChunkCache(0) for _ in range(n_shards)]
        self.set_budget(budget_bytes)

    def shard(self, i: int) -> HotChunkCache:
        return self.shards[i]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def budget_bytes(self) -> int:
        """Total live budget: the sum of the (possibly unequal) slices."""
        return sum(c.budget_bytes for c in self.shards)

    def set_budget(self, budget_bytes: int) -> None:
        """Split the total budget equally; each child evicts down to its own
        slice (a squeeze on one shard never touches another's pins)."""
        per = max(0, int(budget_bytes)) // len(self.shards)
        for c in self.shards:
            c.set_budget(per)

    def set_slice_budget(self, i: int, budget_bytes: int) -> None:
        """Resize slice ``i`` alone (evicting it down if squeezed); the
        other slices' budgets and pins are untouched."""
        self.shards[i].set_budget(budget_bytes)

    @property
    def pinned_bytes(self) -> int:
        return sum(c.pinned_bytes for c in self.shards)

    @property
    def stats(self) -> CacheStats:
        agg = CacheStats()
        for c in self.shards:
            agg.hits += c.stats.hits
            agg.misses += c.stats.misses
            agg.hit_bytes += c.stats.hit_bytes
            agg.evictions += c.stats.evictions
        return agg

    def clear(self) -> None:
        for c in self.shards:
            c.clear()

    def __len__(self) -> int:
        return sum(len(c) for c in self.shards)
