"""Concurrent-wave serving fleet: N shared-scan schedulers over one
:class:`~repro_torch.runtime.replica.ReplicaSet`.

One :class:`~repro_torch.runtime.scheduler.SharedScanScheduler` is the paper's
§3.6 executor inverted into a serving loop — but it runs ONE streaming pass
at a time, so a deployment with N replica spindles leaves N-1 of them idle
under a single wave, and every tenant rides the same head-of-line pass
cadence.  SAGE (arXiv 2308.13626) and BigSparse (arXiv 1710.07736) both
make the same point from opposite directions: storage-based SpMM throughput
is a function of how many spindles are busy.  When traffic outgrows one
wave, the fleet scales *out*:

* **waves** — each wave is a full elastic scheduler (mid-pass admission,
  stitched partial passes, replica failover) running
  on its own thread over the shared :class:`ReplicaSet`.  Concurrent waves'
  passes land on different replicas (the router's in-flight accounting is
  shared, so two simultaneous scans naturally spread over two copies) and
  their compute dispatches overlap on separate cores.
* **front-door dispatcher** — :meth:`ServingFleet.submit` routes each
  incoming session to the wave with the least estimated backlog:
  live columns (active + queued) x the wave's measured pass time (EWMA over
  completed passes — the replica router's least-estimated-finish-time idiom
  one level up).  An unmeasured wave ranks first (optimistic first touch,
  same reason as the router: a serial submitter must exercise every wave),
  ties broken by live columns.
* **cross-wave budget arbitration** — the §3.6 memory budget is global (all
  waves' packed X's are resident at once), so the fleet splits it: the
  column budget is sliced evenly per wave
  (``columns_that_fit`` seen by wave i is the global fit / n_waves), and
  the leftover hot-chunk budget is arbitrated continuously — each wave's
  per-pass ``leftover_budget`` call reports its live columns and receives
  ``global_leftover / busy_waves``, which it applies to its own slice of a
  :class:`~repro_torch.runtime.cache.PartitionedHotChunkCache` (one slice per
  wave).  A wave that drains zeroes its column claim, so the survivors' next
  passes see a larger leftover and their cache slices grow — the rebalance
  is emergent, not scheduled.
* **fleet accounting** — ``io_stats`` is the point-in-time
  :meth:`~repro_torch.io.storage.IOStats.aggregate` over every replica store (the
  per-store ``reads_inflight`` / ``max_reads_inflight`` gauges show whether
  waves really overlapped on the spindles), ``drain()`` blocks until every
  submitted session is served, and ``close()`` stops the wave threads
  cleanly even with a pass in flight (the in-flight pass completes; queued
  work is abandoned — drain first for a graceful end).

Correctness is inherited, not re-derived: every wave runs the same engine
over the same bytes, and column results are independent of how columns are
packed, so a fleet-of-N serves each tenant the same bits as a lone
scheduler (``tests/test_torch_fleet.py`` pins this down).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.sem import _CACHE_UNSET
from repro_torch.io.storage import IOStats
from repro_torch.runtime.api import SubmitterClosed, Ticket, spec_ticket
from repro_torch.runtime.cache import PartitionedHotChunkCache
from repro_torch.runtime.scheduler import SharedScanScheduler
from repro_torch.runtime.session import MultiplyRequest, Session, SessionSpec


class WaveError(RuntimeError):
    """A serving wave's thread died mid-serve.

    Carries the loss manifest a front door needs to resubmit *precisely*:
    ``session_ids`` names every tenant the dead wave still owed a result
    (its active set plus its queued backlog at the moment of death), and
    ``sessions`` holds the objects themselves.  The message embeds the ids
    so even a caller that only logs ``str(e)`` records who was lost."""

    def __init__(self, wave_id: int, error: BaseException,
                 sessions: List[Session]):
        self.wave_id = wave_id
        self.error = error
        self.sessions = sessions
        self.session_ids = [s.tenant_id for s in sessions]
        super().__init__(
            f"wave {wave_id} failed: {error!r} "
            f"(lost sessions: {self.session_ids})")


class _WaveExecutor:
    """The executor surface one wave's scheduler sees: the shared
    :class:`ReplicaSet` with this wave's arbitration spliced in.

    ``multiply`` rides the routed scan unchanged (boundary hooks and all)
    but reads through this wave's hot-chunk budget slice; the §3.6
    arithmetic (``columns_that_fit`` / ``leftover_budget``) is answered by
    the fleet's arbiter instead of the raw executor, so a scheduler written
    for sole ownership of the budget serves correctly as one wave of many.

    ``passes`` counts THIS wave's scans (so the scheduler's per-pass
    reports and ``total_scan_passes`` stay wave-accurate under a fleet);
    byte counters (``io_stats``) are necessarily fleet-global — waves share
    the replica spindles, so a wave's per-pass byte delta includes its
    neighbors' concurrent reads.  Fleet-level totals are the authoritative
    I/O accounting (:attr:`ServingFleet.io_stats`).
    """

    def __init__(self, fleet: "ServingFleet", wave_id: int, cache_slice):
        self._fleet = fleet
        self._rs = fleet.replicas
        self.wave_id = wave_id
        self._cache_slice = cache_slice
        self.mode = "sem"
        self.passes = 0     # this wave's scans, one per multiply (like
        #                     SEMSpMM: a vertical slice is its own pass)
        self.n_rows, self.n_cols, self.T = \
            self._rs.n_rows, self._rs.n_cols, self._rs.T

    # -- identity / layout (delegated) --------------------------------------
    @property
    def store(self):
        return self._rs.store

    @property
    def version(self) -> int:
        return self._rs.version

    @property
    def delta_nnz(self) -> int:
        return self._rs.delta_nnz

    @property
    def n_batches(self) -> int:
        return self._rs.n_batches

    @property
    def padded_cols(self) -> int:
        return self._rs.padded_cols

    @property
    def io_stats(self) -> IOStats:
        return self._rs.io_stats

    def column_bytes(self) -> int:
        return self._rs.column_bytes()

    def stream_overhead_bytes(self) -> int:
        return self._rs.stream_overhead_bytes()

    # -- the wave's cache slice ---------------------------------------------
    @property
    def cache(self):
        return self._cache_slice

    @cache.setter
    def cache(self, value) -> None:
        # the scheduler adopts-and-reattaches its executor's cache at
        # construction; for a wave that handshake must keep the slice
        self._cache_slice = value

    # -- arbitrated §3.6 arithmetic -----------------------------------------
    def columns_that_fit(self, p_total: int) -> int:
        return self._fleet._wave_columns_that_fit(p_total)

    def leftover_budget(self, cols_in_use: int) -> int:
        return self._fleet._wave_leftover(self.wave_id, cols_in_use)

    # -- the routed scan ----------------------------------------------------
    def multiply(self, x: np.ndarray, *, boundary_hook=None,
                 semiring: str = "plus_times", snapshot=None) -> np.ndarray:
        cache = (self._cache_slice if self._cache_slice is not None
                 else _CACHE_UNSET)
        y = self._rs.multiply(x, boundary_hook=boundary_hook, cache=cache,
                              semiring=semiring, snapshot=snapshot)
        self.passes += 1    # only this wave's thread multiplies through here
        return y


class FleetWave:
    """One serving wave: an elastic scheduler plus the thread that drives
    it and the pass-time EWMA the dispatcher routes on."""

    def __init__(self, fleet: "ServingFleet", wave_id: int, cache_slice,
                 *, use_cache: bool, elastic: bool, capacity: Optional[int],
                 reserve_cols: int, compact_ratio: Optional[float] = None):
        self.fleet = fleet
        self.wave_id = wave_id
        self.executor = _WaveExecutor(fleet, wave_id, cache_slice)
        self.scheduler = SharedScanScheduler(
            self.executor, use_cache=use_cache, elastic=elastic,
            capacity=capacity, reserve_cols=reserve_cols,
            compact_ratio=compact_ratio)
        self.ewma_pass_s = 0.0
        self.passes_served = 0
        self.in_pass = False
        self.error: Optional[BaseException] = None
        self._stop = False
        self.thread = threading.Thread(target=self._serve_loop, daemon=True,
                                       name=f"fleet-wave-{wave_id}")

    # -- dispatcher-facing ---------------------------------------------------
    def live_columns(self) -> int:
        """Active + queued columns (the backlog the dispatcher scores),
        ring-wave tenants included."""
        sched = self.scheduler
        active = sum(s.width for s in list(sched.active))
        ring = (sum(s.width for s in list(sched._ring_active))
                + sum(s.width for s in list(sched._ring_queue)))
        return active + ring + sched.batcher.pending_columns()

    def backlog_estimate(self):
        """(estimated seconds of queued work, live columns): columns times
        the measured pass time; an unmeasured wave estimates 0 so it is
        tried first — the router's optimistic-first-touch rule."""
        cols = self.live_columns()
        return (cols * self.ewma_pass_s, cols)

    def submit(self, session: Session) -> Session:
        session.wave_id = self.wave_id
        self.scheduler.submit(session)
        with self.fleet._cv:
            self.fleet._cv.notify_all()
        return session

    @property
    def busy(self) -> bool:
        return self.in_pass or not self.scheduler.idle

    def lost_sessions(self) -> List[Session]:
        """Every session this wave still owes a result: the scheduler's
        active set (including mid-pass partials) plus the queued backlog.
        Meaningful once the wave thread has stopped (error or close) — the
        front door resubmits exactly these on failover."""
        sched = self.scheduler
        owed = [s for s in (list(sched.active) + list(sched._ring_active)
                            + list(sched._ring_queue)) if not s.done]
        return owed + sched.batcher.pending_sessions()

    # -- the serving thread --------------------------------------------------
    def _serve_loop(self) -> None:
        fleet = self.fleet
        ewma = fleet.ewma
        while True:
            with fleet._cv:
                while not self._stop and self.scheduler.idle \
                        and not self.in_pass:
                    # drained: release this wave's column claim AND its
                    # cache slice — the arbiter hands both to the busy
                    # waves (whose next-pass leftover grows to match), so
                    # the fleet's total pinned bytes never exceed the
                    # global leftover
                    fleet._set_wave_cols(self.wave_id, 0)
                    if fleet.cache is not None:
                        fleet.cache.set_slice_budget(self.wave_id, 0)
                    fleet._cv.notify_all()
                    fleet._cv.wait(timeout=0.5)
                if self._stop:
                    fleet._set_wave_cols(self.wave_id, 0)
                    fleet._cv.notify_all()
                    return
                self.in_pass = True
            try:
                t0 = time.perf_counter()
                report = self.scheduler.run_pass()
                dt = time.perf_counter() - t0
                if report is not None:
                    self.passes_served += 1
                    self.ewma_pass_s = (dt if self.ewma_pass_s == 0.0 else
                                        (1 - ewma) * self.ewma_pass_s
                                        + ewma * dt)
            except BaseException as e:  # noqa: BLE001 — surfaced via drain()
                self.error = e
                with fleet._cv:
                    self.in_pass = False
                    # release the dead wave's claims like the drained path:
                    # survivors' shares grow to match, so its pins must go
                    fleet._set_wave_cols(self.wave_id, 0)
                    if fleet.cache is not None:
                        fleet.cache.set_slice_budget(self.wave_id, 0)
                    fleet._cv.notify_all()
                return
            with fleet._cv:
                self.in_pass = False
                fleet._cv.notify_all()


class ServingFleet:
    """N concurrent elastic serving waves over one shared
    :class:`~repro_torch.runtime.replica.ReplicaSet` (see module docstring).

    ``capacity`` fixes every wave's packed width (one accumulator shape per
    wave for the fleet's lifetime); left ``None``, each wave resolves its own from
    its first demand.  ``use_cache=True`` creates one
    :class:`PartitionedHotChunkCache` with a budget slice per wave,
    arbitrated each pass.  The fleet is a context manager; ``close()`` also
    releases the replica set's file mappings."""

    def __init__(self, replicas, n_waves: int = 2, *, use_cache: bool = True,
                 elastic: bool = True, capacity: Optional[int] = None,
                 reserve_cols: int = 4, ewma: float = 0.3,
                 compact_ratio: Optional[float] = None):
        if n_waves < 1:
            raise ValueError("a fleet needs at least one wave")
        self.replicas = replicas
        self.ewma = ewma
        self._cv = threading.Condition()
        self._arb_lock = threading.Lock()
        self._wave_cols = [0] * n_waves
        self._closed = False
        self._delivered: queue.Queue = queue.Queue()
        self.cache = (PartitionedHotChunkCache(n_waves) if use_cache
                      and getattr(replicas, "mode", "sem") == "sem" else None)
        self.waves: List[FleetWave] = [
            FleetWave(self, i,
                      self.cache.shard(i) if self.cache is not None else None,
                      use_cache=use_cache, elastic=elastic, capacity=capacity,
                      reserve_cols=reserve_cols, compact_ratio=compact_ratio)
            for i in range(n_waves)]
        for w in self.waves:
            w.thread.start()

    # -- budget arbitration --------------------------------------------------
    def _wave_columns_that_fit(self, p_total: int) -> int:
        """Wave's slice of the global column budget: the §3.6 fit divided
        evenly across waves (every wave's X is resident at once), floor 1."""
        fit_global = self.replicas.columns_that_fit(
            max(p_total, 1) * len(self.waves))
        return max(1, min(p_total, fit_global // len(self.waves)))

    def _wave_leftover(self, wave_id: int, cols_in_use: int) -> int:
        """Arbitrated hot-chunk budget for one wave's pass: the global
        leftover after EVERY wave's live columns, split across the waves
        currently holding columns.  Draining waves report 0 and drop out of
        the divisor, so the survivors' shares grow pass by pass."""
        with self._arb_lock:
            self._wave_cols[wave_id] = cols_in_use
            total_cols = sum(self._wave_cols)
            busy = sum(1 for c in self._wave_cols if c > 0)
        left = self.replicas.leftover_budget(total_cols)
        return left // max(1, busy)

    def _set_wave_cols(self, wave_id: int, cols: int) -> None:
        with self._arb_lock:
            self._wave_cols[wave_id] = cols

    # -- front door ----------------------------------------------------------
    def submit(self, session):
        """Route work to the wave with the least estimated backlog.  The
        unified form takes a :class:`~repro_torch.runtime.session.SessionSpec`
        and returns a :class:`~repro_torch.runtime.api.Ticket` (stream completions
        with :meth:`deliver`); passing a live :class:`Session` is the
        deprecated pre-protocol form and still returns the session."""
        if self._closed:
            raise SubmitterClosed("fleet is closed")
        self._raise_wave_errors()
        wave = min(self.waves, key=lambda w: w.backlog_estimate())
        if isinstance(session, SessionSpec):
            live, ticket = spec_ticket(session, self._delivered)
            wave.submit(live)
            return ticket
        return wave.submit(session)

    def deliver(self, timeout: Optional[float] = None) -> Optional[Ticket]:
        """Next completed spec-submitted ticket; blocks up to ``timeout``
        (None = wait indefinitely — the waves serve on their own threads).
        Returns None if nothing completes within the timeout."""
        try:
            return self._delivered.get(timeout=timeout)
        except queue.Empty:
            return None

    def query(self, x: np.ndarray, tenant_id: str = "") -> MultiplyRequest:
        """Convenience: enqueue a one-shot A @ x request."""
        return self.submit(MultiplyRequest(x, tenant_id=tenant_id))

    # -- mutation surface (the Mutable protocol) ------------------------------
    @property
    def version(self) -> int:
        return getattr(self.replicas, "version", 0)

    @property
    def delta_nnz(self) -> int:
        return getattr(self.replicas, "delta_nnz", 0)

    def apply_updates(self, batch) -> int:
        """Append an edge-update batch to the shared replica set's delta
        log.  Waves mid-pass keep the snapshot they started with; the new
        version is visible to every wave's next pass."""
        if self._closed:
            raise SubmitterClosed("fleet is closed")
        return self.replicas.apply_updates(batch)

    # -- lifecycle -----------------------------------------------------------
    def _raise_wave_errors(self) -> None:
        for w in self.waves:
            if w.error is not None:
                raise WaveError(w.wave_id, w.error,
                                w.lost_sessions()) from w.error

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted session has been served (all waves
        idle with empty queues).  Raises if a wave died, or TimeoutError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                self._raise_wave_errors()
                if all(not w.busy for w in self.waves):
                    return
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet did not drain within {timeout}s")
                self._cv.wait(timeout=0.2)

    def close(self) -> None:
        """Stop the wave threads (an in-flight pass completes; queued work
        is abandoned — call :meth:`drain` first for a graceful end), release
        the schedulers, and drop the replica file mappings.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        with self._cv:
            for w in self.waves:
                w._stop = True
            self._cv.notify_all()
        for w in self.waves:
            w.thread.join()
            w.scheduler.close()
        if hasattr(self.replicas, "close"):
            self.replicas.close()

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- fleet accounting ----------------------------------------------------
    @property
    def n_waves(self) -> int:
        return len(self.waves)

    @property
    def io_stats(self) -> IOStats:
        """Aggregate over every replica store (waves share the spindles, so
        per-wave byte attribution is meaningless — this is the truth)."""
        return self.replicas.io_stats

    def total_scan_passes(self) -> int:
        return sum(w.scheduler.total_scan_passes() for w in self.waves)

    def total_bytes_read(self) -> int:
        return self.io_stats.bytes_read

    def stats(self) -> dict:
        """JSON-safe fleet gauges — the heartbeat payload a HostServer
        reports so the cluster front door can route on the same signals the
        fleet's own dispatcher uses: live backlog columns, queued sessions,
        and the worst per-wave pass-time EWMA (the pair behind
        :meth:`FleetWave.backlog_estimate`), plus the serialized replica
        I/O counters for observability."""
        backlog_cols = sum(w.live_columns() for w in self.waves)
        pending = sum(w.scheduler.batcher.pending for w in self.waves)
        ewma = max((w.ewma_pass_s for w in self.waves), default=0.0)
        return {
            "n_waves": len(self.waves),
            "backlog_cols": backlog_cols,
            "pending_sessions": pending,
            "ewma_pass_s": ewma,
            "scan_passes": self.total_scan_passes(),
            "version": self.version,
            "delta_nnz": self.delta_nnz,
            "io_stats": self.io_stats.to_dict(),
        }
