"""Replica routing: scan bandwidth that scales with spindles.

One :class:`TileStore` caps wave throughput at a single device's scan
bandwidth.  A deployment that copies the (read-only) on-SSD matrix to N
paths — per-SSD, per-NUMA node, per-host — can stream N waves at once, or
fan the shards of one wave out across copies.  BigSparse (arXiv 1710.07736)
and the SSD eigensolver (arXiv 1602.01421) both win by keeping the scan
pipeline saturated; replicas are how a *serving* workload does that once a
single spindle is the bottleneck.

:class:`ReplicaSet` duck-types the executor surface the serving scheduler
consumes (``multiply`` — including the elastic ``boundary_hook`` —
``passes``, ``io_stats``, the §3.6 budget arithmetic) and routes every
multiply to one replica's :class:`~repro_torch.core.sem.SEMSpMM`:

* **routing** — least-estimated-finish-time: queue depth (in-flight scans)
  scaled by the replica's measured scan bandwidth (EWMA over completed
  passes), so a slow or busy copy is routed around, not merely rotated;
* **failure fallback** — an ``OSError`` from a replica's scan marks it
  unhealthy and the multiply retries on the next-ranked replica; results
  agree because every replica holds the same bytes and runs the same
  engine.  All replicas failing raises.

Thread-safe: concurrent schedulers (or one scheduler's shards) may call
``multiply`` from different threads; the router serializes only the
bookkeeping, never the scans.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.sem import _CACHE_UNSET, SEMConfig, SEMSpMM
from repro_torch.io.storage import (GraphHandle, IOStats, TileStore,
                                    UpdateBatch, validate_replicas)


@dataclasses.dataclass
class ReplicaState:
    """Router-visible health and load of one store replica."""
    replica_id: int
    path: str
    inflight: int = 0          # scans currently running on this replica
    healthy: bool = True
    ewma_bps: float = 0.0      # measured scan bandwidth, bytes/second
    scans: int = 0
    failures: int = 0
    last_error: Optional[str] = None


class ReplicaRouter:
    """Least-estimated-finish-time assignment over healthy replicas.

    Estimated finish of a new scan on replica r is
    ``(inflight_r + 1) / bandwidth_r``: queue depth in units of passes,
    scaled by how fast this copy actually streams.  A replica with no
    measurement yet ranks *first* (optimistic first touch — otherwise a
    serial caller would tie it against a measured copy and stable sort
    would starve it forever, leaving its speed unknown and its health
    untested until a failover emergency); among unmeasured replicas, queue
    depth breaks the tie."""

    def __init__(self, paths: Sequence[str], ewma: float = 0.3):
        self.states = [ReplicaState(i, p) for i, p in enumerate(paths)]
        self.ewma = ewma
        self._lock = threading.Lock()

    def ranked(self) -> List[int]:
        """Healthy replica ids, best-first (the multiply's fallback order)."""
        with self._lock:
            healthy = [s for s in self.states if s.healthy]

            def score(s: ReplicaState):
                est = ((s.inflight + 1) / s.ewma_bps if s.ewma_bps > 0
                       else 0.0)
                return (est, s.inflight)

            return [s.replica_id for s in sorted(healthy, key=score)]

    def begin(self, rid: int) -> None:
        with self._lock:
            self.states[rid].inflight += 1

    def end(self, rid: int) -> None:
        with self._lock:
            self.states[rid].inflight -= 1

    def complete(self, rid: int, nbytes: int, seconds: float) -> None:
        """Fold one finished scan into the replica's bandwidth estimate."""
        with self._lock:
            s = self.states[rid]
            s.scans += 1
            bps = nbytes / max(seconds, 1e-9)
            s.ewma_bps = (bps if s.ewma_bps == 0.0 else
                          (1 - self.ewma) * s.ewma_bps + self.ewma * bps)

    def fail(self, rid: int, exc: BaseException) -> None:
        with self._lock:
            s = self.states[rid]
            s.healthy = False
            s.failures += 1
            s.last_error = repr(exc)

    def restore(self, rid: int) -> None:
        """Bring a repaired replica back into rotation."""
        with self._lock:
            self.states[rid].healthy = True

    @property
    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for s in self.states if s.healthy)


class ReplicaSet:
    """N executors over N copies of one logical matrix, behind one
    ``multiply``.  Drop-in for :class:`SEMSpMM` in the serving scheduler.
    Copy i's executor runs on ``devices[i % len(devices)]``; with no
    devices named every copy runs on the card, as a lone :class:`SEMSpMM`
    does (``devices=["cpu"]`` runs them on the host)."""

    def __init__(self, stores: Sequence[Union[TileStore, str]],
                 config: Optional[SEMConfig] = None, cache=None,
                 devices: Optional[Sequence] = None):
        stores = [TileStore.open(s) if isinstance(s, str) else s
                  for s in stores]
        validate_replicas(stores)
        self.cfg = config or SEMConfig()
        self.execs: List[SEMSpMM] = [
            SEMSpMM(s, self.cfg, cache=cache,
                    device=devices[i % len(devices)] if devices else None)
            for i, s in enumerate(stores)]
        self.router = ReplicaRouter([s.path for s in stores])
        h = stores[0].header
        self.n_rows, self.n_cols, self.T = h["n_rows"], h["n_cols"], h["T"]
        self.mode = "sem"
        self._mut_lock = threading.Lock()

    # -- mutation surface (the Mutable protocol) ----------------------------
    @property
    def version(self) -> int:
        return self.store.version

    @property
    def delta_nnz(self) -> int:
        dl = self.store.delta_log
        return 0 if dl is None else dl.nnz

    @property
    def graph_handle(self) -> Optional[GraphHandle]:
        return self.store.handle

    @property
    def last_pass_version(self) -> int:
        return max(ex.last_pass_version for ex in self.execs)

    def apply_updates(self, batch: UpdateBatch) -> int:
        """Append an edge-update batch to ONE shared delta log spanning
        every replica (the copies hold the same logical bytes, so one
        overlay serves them all — routing and failover stay version-exact
        because whichever replica a pass lands on sees the same log)."""
        with self._mut_lock:
            if self.store.handle is None:
                GraphHandle([ex.store for ex in self.execs])
        return self.store.handle.apply_updates(batch)

    # -- executor surface (scheduler-facing) ---------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.execs)

    @property
    def store(self) -> TileStore:
        """The primary replica's store (layout queries: all replicas share
        one chunk layout, validated at construction)."""
        return self.execs[0].store

    @property
    def cache(self):
        return self.execs[0].cache

    @cache.setter
    def cache(self, value) -> None:
        for ex in self.execs:
            ex.cache = value

    @property
    def passes(self) -> int:
        return sum(ex.passes for ex in self.execs)

    @property
    def n_batches(self) -> int:
        return self.execs[0].n_batches

    @property
    def padded_cols(self) -> int:
        return self.execs[0].padded_cols

    def columns_that_fit(self, p_total: int) -> int:
        return self.execs[0].columns_that_fit(p_total)

    def leftover_budget(self, cols_in_use: int) -> int:
        return self.execs[0].leftover_budget(cols_in_use)

    def column_bytes(self) -> int:
        return self.execs[0].column_bytes()

    def stream_overhead_bytes(self) -> int:
        return self.execs[0].stream_overhead_bytes()

    @property
    def io_stats(self) -> IOStats:
        return IOStats.aggregate(ex.store.stats for ex in self.execs)

    def close(self) -> None:
        """Release every replica's persistent file mapping.  Safe on a live
        set (stores remap lazily on the next read) — this is the symmetric
        cleanup the scheduler/fleet context managers call, so an exception
        path never leaks N memmaps per serving run."""
        for ex in self.execs:
            ex.store.close()

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the routed scan -----------------------------------------------------
    def multiply(self, x: np.ndarray, *, boundary_hook=None,
                 cache=_CACHE_UNSET, semiring: str = "plus_times",
                 snapshot=None) -> np.ndarray:
        """A @ X on the best-ranked healthy replica, falling back in rank
        order on replica failure.  Replicas agree as two passes of one
        engine do (same bytes, same kernel): bit for bit on the CPU and on
        integer-valued operands, within float32 rounding of the sums'
        order for other operands on the card, where the kernel adds by
        atomics.  ``cache`` rides through to
        the chosen replica's pass (the fleet's per-wave budget slice);
        unset, each replica uses its own attached cache.  ``snapshot``
        pins the delta version for the pass — a failover retry then serves
        exactly the version the first attempt started with."""
        last_exc: Optional[BaseException] = None
        for rid in self.router.ranked():
            ex = self.execs[rid]
            self.router.begin(rid)
            t0 = time.perf_counter()
            try:
                y = ex.multiply(x, boundary_hook=boundary_hook, cache=cache,
                                semiring=semiring, snapshot=snapshot)
            except OSError as e:
                self.router.fail(rid, e)
                last_exc = e
                continue
            finally:
                self.router.end(rid)
            self.router.complete(rid, ex.store.nbytes,
                                 time.perf_counter() - t0)
            return y
        raise RuntimeError(
            "every replica failed or is marked unhealthy") from last_exc
