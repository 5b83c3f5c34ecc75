"""Shared-scan scheduler: one streaming pass serves the whole wave.

The serving loop is the paper's executor inverted: instead of one caller
driving many passes, many tenants ride one pass.  Each ``run_pass``:

1. **admit** — queued sessions join the active wave while their columns fit
   the §3.6 memory-budget limit (``SEMSpMM.columns_that_fit``);
2. **pack** — active tenants' current columns become one shared ``X``;
3. **scan** — a single streaming pass over the :class:`TileStore` computes
   ``A @ X`` (vertical partitioning kicks in automatically if a lone tenant
   is wider than the budget — paper §3.3);
4. **scatter** — each tenant consumes its result columns and advances;
   converged tenants retire, freeing columns for the next admission;
5. **re-budget** — leftover memory (budget minus live columns) is handed to
   the hot-chunk cache, so a draining workload asymptotically becomes
   IM-SpMM while a saturated one stays pure streaming.

I/O amortization is the invariant the tests pin down: serving N single-vector
tenants costs ``ceil(total_cols / columns_that_fit)`` passes, not N.

**Elastic mode** (``elastic=True``) removes the last head-of-line blocking:
a request arriving just after a wave starts no longer waits out the whole
pass.  The wave is packed at a *fixed column capacity* (occupied tenants at
the front, slack zeros behind — one operand and accumulator shape for the
scheduler's whole lifetime, so the engine reuses one accumulator and each
batch is one kernel launch whatever the admissions), and the engine's
batch-boundary hook (:class:`repro_torch.core.sem.PassBoundary`) lets the
scheduler act inside an in-flight pass:

* **mid-pass admission** — a queued tenant's columns are written into free
  slack at a chunk-batch boundary.  Chunks are laid out in (tile_row,
  tile_col) order, so every tile row starting at or after the boundary
  accumulates the newcomer's contribution bit-exactly; the scheduler
  records that first partial pass's coverage (``tr_start``) per tenant.
* **partial-pass completion** — on the *next* pass the tenant's same
  operand rides from the start; as soon as the boundary clock passes the
  last chunk of tile row ``tr_start - 1``, rows ``[0, tr_start)`` are read
  from the live accumulator, stitched with the previous pass's suffix, and
  delivered — the same sums as between-pass admission (bit-identical on the
  CPU and on integer-valued operands; on the card the kernel adds by
  atomics, so float sums agree within rounding), roughly half a pass
  earlier.  An iterative tenant is immediately re-admitted at the same
  boundary with its next iterate (a rolling wavefront), and a finished
  tenant's slack is handed to the next queued request at the very next
  boundary.

The executor behind the scheduler may be a single :class:`SEMSpMM`, a
:class:`~repro_torch.distributed.shard_scan.ShardedSEMSpMM` (``sharded=``), or a
:class:`~repro_torch.runtime.replica.ReplicaSet` routing each pass across store
copies — elastic mode composes with replicas (the hook survives replica
failover) *and* with ``sharded=``: the sharded executor threads the hook
through its coordinator shard (shard 0, the lowest tile rows, whose chunk
space is the global prefix) and holds the remaining shards until the
coordinator finishes, so every mid-pass column write lands before any
non-coordinator chunk streams — the same sums as the unsharded elastic
stitch, at the cost of serializing the coordinator shard's scan ahead of
the rest (see ``ShardedSEMSpMM.multiply``).  A pure-bandwidth elastic wave
is still better served by a ReplicaSet.

Every executor the scheduler builds runs where the executor it was given
runs: the sharded scan's shards go on ``sem.device`` (for a ReplicaSet,
shard i on copy i's executor device), never on a default card.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sem import SEMSpMM
from repro_torch.runtime.api import SubmitterClosed, Ticket, spec_ticket
from repro_torch.runtime.batcher import Batcher, Wave
from repro_torch.runtime.cache import HotChunkCache, PartitionedHotChunkCache
from repro_torch.runtime.session import MultiplyRequest, Session, SessionSpec


@dataclasses.dataclass
class PassReport:
    """What one shared scan did (per-pass stats from the executor)."""
    wave_cols: int = 0
    tenants: int = 0
    retired: int = 0
    scan_passes: int = 0        # >1 only for an oversized (sliced) wave
    bytes_read: int = 0
    cache_hit_bytes: int = 0
    cache_budget: int = 0
    capacity: int = 0           # elastic: the fixed packed width
    admitted_midpass: int = 0   # elastic: tenants that joined inside the pass
    completed_midpass: int = 0  # elastic: stitched deliveries inside the pass
    version: int = 0            # graph version this pass served (0 = frozen)
    delta_nnz: int = 0          # overlay entries the pass's snapshot carried
    semiring: str = "plus_times"  # the ring the wave was scanned under


@dataclasses.dataclass
class MidPassState:
    """One tenant's partial-pass protocol state.

    ``tr_start`` is the accounting the stitch rests on: the first tile row
    whose chunks all lie at or after the admission boundary.  The admission
    pass yields bit-exact output rows ``[tr_start * T, n_rows)`` (the
    suffix); the following pass yields rows ``[0, tr_start * T)`` (the
    prefix) as soon as its boundary clock covers them."""
    session: Session
    col0: int
    width: int
    tr_start: int
    admit_cs: int        # chunk_start of the admission boundary
    admitted_pass: int   # scheduler pass number of the admission
    suffix: Optional[np.ndarray] = None


class SharedScanScheduler:
    """Multi-tenant serving runtime over one shared :class:`SEMSpMM`.

    ``sharded=N`` (N >= 2) fans every wave's pass out across N row shards of
    the store (:class:`repro_torch.distributed.shard_scan.ShardedSEMSpMM`):
    parallel partial scans + a row-block concatenation, the single-scan
    path's sums.  Admission control and budgets stay on the unsharded
    executor (the column budget is a property of the whole operator).
    Combined with ``elastic=True``, boundary hooks ride the coordinator
    shard's scan (see the module docstring).

    ``elastic=True`` turns on mid-pass admission (see module docstring);
    ``capacity`` fixes the packed wave width (default: first demand plus
    ``reserve_cols`` slack, clamped to the §3.6 budget).  ``boundary_probe``
    is a test/bench hook ``probe(scheduler, PassBoundary)`` invoked at every
    chunk-batch boundary — the deterministic way to inject mid-pass
    arrivals."""

    def __init__(self, sem: SEMSpMM, *, use_cache: bool = True,
                 sharded: int = 0, elastic: bool = False,
                 capacity: Optional[int] = None, reserve_cols: int = 4,
                 boundary_probe=None, compact_ratio: Optional[float] = None):
        self.sem = sem
        self.batcher = Batcher(sem.n_cols)
        self.active: List[Session] = []
        self.elastic = elastic
        self.capacity = capacity
        self.reserve_cols = reserve_cols
        self.pass_no = 0
        self.boundary_clock = 0      # chunk-batch boundaries seen, all passes
        self._probe = boundary_probe
        self._midpass: List[MidPassState] = []
        self._slots: Dict[Session, Tuple[int, int]] = {}
        self._row_first_chunk: Optional[np.ndarray] = None
        # -- versioned-graph serving state ---------------------------------
        # Background compaction: when the delta overlay grows past
        # ``compact_ratio`` × base nnz, kick GraphHandle.compact_async at a
        # pass boundary and adopt the rebuilt base (try_install) at the next
        # run_pass entry — the only instant no pass is streaming.  None
        # disables the trigger (updates still serve through the overlay).
        self.compact_ratio = compact_ratio
        self._base_nnz: Optional[int] = None     # cached per generation
        self._last_generation = getattr(sem.store, "generation", 0) \
            if hasattr(sem, "store") else 0
        self._last_pass_version = 0   # version the previous pass served
        self._pass_snapshot = None    # delta snapshot of the pass in flight
        # Ring-homogeneous waves: tenants whose sessions need a non-plus-
        # times semiring (SSSP: min-plus) cannot share the plus-times wave's
        # accumulator, so they queue separately and are served in their own
        # mini-waves, alternating with the main wave when both have work.
        self._ring_queue: List[Session] = []
        self._ring_active: List[Session] = []
        self._ring_turn = False
        want_shards = sharded if (sharded and sharded >= 2
                                  and sem.mode == "sem") else 0
        self.cache = None
        if use_cache and sem.mode == "sem":
            if sem.cache is not None:
                # adopt a cache already attached to the executor (e.g.
                # pre-warmed via SEMSpMM(cache=...)) rather than clobbering it
                self.cache = sem.cache
            elif want_shards:
                # per-shard budget slices: a fast shard's offers can never
                # evict a slow shard's pins
                self.cache = PartitionedHotChunkCache(want_shards)
            else:
                self.cache = HotChunkCache(0)
            if not want_shards:
                sem.cache = self.cache
        self.sharded = None
        if want_shards:
            from repro_torch.distributed.shard_scan import ShardedSEMSpMM
            # a ReplicaSet behind a sharded scheduler contributes its copies
            # as shard sources (shard i streams copy i mod N) — the scan
            # bandwidth the copies were provisioned for is not left idle
            extra = ([ex.store for ex in sem.execs[1:]]
                     if hasattr(sem, "execs") else None)
            # the shards run where the given executor runs: shard i streams
            # copy i mod N on that copy's device
            devices = ([ex.device for ex in sem.execs]
                       if hasattr(sem, "execs") else [sem.device])
            self.sharded = ShardedSEMSpMM(sem.store, n_shards=want_shards,
                                          config=sem.cfg, cache=self.cache,
                                          devices=devices, replicas=extra)
        self.reports: List[PassReport] = []
        self._closed = False
        self._delivered: queue.Queue = queue.Queue()

    def close(self) -> None:
        """Release the sharded executor's scan threads (no-op unsharded).
        Idempotent; further ``submit`` calls raise :class:`SubmitterClosed`."""
        self._closed = True
        if self.sharded is not None:
            self.sharded.close()

    def __enter__(self) -> "SharedScanScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ----------------------------------------------------------
    def submit(self, session):
        """Enqueue work.  The unified form takes a
        :class:`~repro_torch.runtime.session.SessionSpec` and returns a
        :class:`~repro_torch.runtime.api.Ticket`; passing a live :class:`Session`
        is the deprecated pre-protocol form (kept as a thin shim — it still
        returns the session itself)."""
        if self._closed:
            raise SubmitterClosed("scheduler is closed")
        if isinstance(session, SessionSpec):
            live, ticket = spec_ticket(session, self._delivered)
            self._submit_session(live)
            return ticket
        return self._submit_session(session)

    def _submit_session(self, session: Session) -> Session:
        session.t_submit = time.monotonic()
        session.submit_clock = self.boundary_clock
        if getattr(session, "needs_store", False):
            # store-consuming tenants (SpGEMM) get the executor's serving
            # store at submit time — specs stay portable across hosts
            session.bind_store(getattr(self.sem, "store", None))
        if session.semiring != "plus_times":
            self._ring_queue.append(session)
            return session
        return self.batcher.submit(session)

    def query(self, x: np.ndarray, tenant_id: str = "") -> MultiplyRequest:
        """Convenience: enqueue a one-shot A @ x request."""
        return self.submit(MultiplyRequest(x, tenant_id=tenant_id))

    @property
    def idle(self) -> bool:
        return (not self.active and self.batcher.pending == 0
                and not self._ring_active and not self._ring_queue)

    # -- the serving loop ----------------------------------------------------
    def run_pass(self) -> Optional[PassReport]:
        """Admit, pack, scan once, scatter, retire.  Returns None when there
        is no work."""
        self._pass_boundary_maintenance()
        demand = (sum(s.width for s in self.active)
                  + self.batcher.pending_columns())
        ring_work = bool(self._ring_active or self._ring_queue)
        if demand == 0 and not ring_work:
            return None
        if ring_work and (demand == 0 or self._ring_turn):
            # round-robin between the plus-times wave and ring mini-waves
            # when both have work; neither class can starve the other
            self._ring_turn = False
            self.pass_no += 1
            return self._run_pass_ring()
        self._ring_turn = ring_work
        self.pass_no += 1
        if self.elastic and not self._oversized_head_alone():
            return self._run_pass_elastic(demand)
        return self._run_pass_classic(demand)

    def _pass_boundary_maintenance(self) -> None:
        """Between-pass versioned-graph upkeep: adopt a finished background
        compaction (this is the only instant no pass streams the old
        layout), invalidate generation-derived row/chunk maps, and kick a
        new compaction when the overlay has outgrown ``compact_ratio``."""
        store = getattr(self.sem, "store", None)
        handle = store.handle if store is not None else None
        if handle is None:
            return
        if self.sharded is not None:
            # a live sharded engine's shard views are derived from the
            # current base layout; keep them pinned (installs refused) —
            # compaction under a sharded scheduler needs a quiesce/rebuild
            self.sharded.pin_layout()
            return
        # an install by THIS scheduler or by a sibling wave's (fleet) both
        # stale every chunk-layout derivation; carried mid-pass states
        # survive (tr_start is a tile-row index, layout-independent, and
        # the rebuilt base ⊕ truncated log is bit-identical at the version)
        if handle.try_install() or store.generation != self._last_generation:
            self._row_first_chunk = None
            self._base_nnz = None
        self._last_generation = store.generation
        if self.compact_ratio is not None and handle.delta_nnz > 0:
            if self._base_nnz is None:
                self._base_nnz = max(1, store.nnz())
            if handle.delta_nnz >= self.compact_ratio * self._base_nnz:
                handle.compact_async()

    def _oversized_head_alone(self) -> bool:
        """An idle elastic wave facing a tenant wider than any capacity falls
        back to the classic sliced path for that pass (paper §3.3)."""
        if self.active or self._midpass or not self.batcher.pending:
            return False
        cap = self.capacity or self.sem.columns_that_fit(
            self.batcher.peek().width)
        return self.batcher.peek().width > cap

    def _take_snapshot(self):
        """Snapshot the delta overlay once per scheduler pass: every scan of
        the pass (vertical slices, shard fan-outs, replica failover retries)
        serves exactly this version, and the report records it."""
        store = getattr(self.sem, "store", None)
        dl = store.delta_log if store is not None else None
        self._pass_snapshot = dl.snapshot() if dl is not None else None
        return self._pass_snapshot

    def _stamp_version(self, report: PassReport, snap) -> None:
        if snap is not None:
            report.version = int(snap[0])
            report.delta_nnz = int(snap[1].shape[0])

    def _run_pass_classic(self, demand: int) -> Optional[PassReport]:
        col_budget = self.sem.columns_that_fit(demand)
        self.batcher.admit(self.active, col_budget)
        wave = self.batcher.pack(self.active)
        if wave is None:
            return None

        # Leftover budget -> hot-chunk cache (shrink before the scan so the
        # cache never overdraws memory the wave's columns need).
        report = PassReport(wave_cols=wave.width, tenants=len(wave.entries))
        self._stamp_version(report, self._take_snapshot())
        if self.cache is not None:
            leftover = self.sem.leftover_budget(wave.width)
            self.cache.set_budget(leftover)
            report.cache_budget = leftover

        r0, h0, p0 = self._counters()
        y = self._scan(wave, col_budget)
        for e in wave.entries:
            self._deliver(e.session, y[:, e.col_offset:e.col_offset + e.width])

        still_active = [s for s in self.active if not s.done]
        report.retired = len(self.active) - len(still_active)
        for s in self.active:
            if s.done:  # a fallback pass may retire an elastic-slotted
                self._slots.pop(s, None)  # tenant: free its columns too
        self.active = still_active
        self._finish_report(report, r0, h0, p0)
        return report

    def _run_pass_ring(self) -> Optional[PassReport]:
        """One ring-homogeneous mini-wave: sessions sharing a non-plus-times
        semiring (SSSP's min-plus) pack into one X and ride one scan under
        that ring.  Classic-style — no elastic hooks: a tenant cannot enter
        mid-pass a wave whose accumulator is filled with a foreign ring's
        zero (min-plus starts at +inf, not 0)."""
        ring = (self._ring_active or self._ring_queue)[0].semiring
        # admit same-ring tenants FIFO while the §3.6 budget holds; a lone
        # oversized tenant is admitted alone and vertically sliced (§3.3)
        width = sum(s.width for s in self._ring_active)
        i = 0
        while i < len(self._ring_queue):
            head = self._ring_queue[i]
            if head.semiring != ring:
                i += 1
                continue
            want = width + head.width
            if width and self.sem.columns_that_fit(want) < want:
                break
            self._ring_active.append(self._ring_queue.pop(i))
            width += head.width
        if not self._ring_active:
            return None
        col_budget = self.sem.columns_that_fit(width)

        blocks, offs, off = [], [], 0
        for s in self._ring_active:
            c = s.x_columns()
            blocks.append(np.asarray(c[:, None] if c.ndim == 1 else c,
                                     np.float32))
            offs.append(off)
            off += s.width
        x = blocks[0] if len(blocks) == 1 else np.concatenate(blocks, axis=1)

        report = PassReport(wave_cols=width, tenants=len(self._ring_active),
                            semiring=ring)
        snap = self._take_snapshot()
        self._stamp_version(report, snap)
        if self.cache is not None:
            leftover = self.sem.leftover_budget(min(width, col_budget))
            self.cache.set_budget(leftover)
            report.cache_budget = leftover

        r0, h0, p0 = self._counters()
        op = self.sharded if self.sharded is not None else self.sem
        if width <= col_budget:
            y = op.multiply(x, semiring=ring, snapshot=snap)
        else:
            y = np.concatenate(
                [op.multiply(x[:, c0:c0 + col_budget], semiring=ring,
                             snapshot=snap)
                 for c0 in range(0, width, col_budget)], axis=1)
        for s, c0 in zip(list(self._ring_active), offs):
            self._deliver(s, y[:, c0:c0 + s.width])
        still = [s for s in self._ring_active if not s.done]
        report.retired = len(self._ring_active) - len(still)
        self._ring_active = still
        self._finish_report(report, r0, h0, p0)
        return report

    def _counters(self):
        """(bytes_read, cache_hit_bytes, passes) of whichever executor the
        scans run on — shard-aggregated when the pass fans out."""
        op = self.sharded if self.sharded is not None else self.sem
        st = op.io_stats
        return st.bytes_read, st.cache_hit_bytes, op.passes

    def _finish_report(self, report: PassReport, r0, h0, p0) -> None:
        r1, h1, p1 = self._counters()
        report.scan_passes = p1 - p0
        report.bytes_read = r1 - r0
        report.cache_hit_bytes = h1 - h0
        self._last_pass_version = report.version
        self._pass_snapshot = None
        self.reports.append(report)

    def _deliver(self, session: Session, y: np.ndarray) -> None:
        """Hand a tenant its product, stamping time-to-first-result.  The
        slice is materialized contiguous so a session's own host-side
        reductions (Rayleigh quotients, norms) see one memory layout
        regardless of how the columns were packed or stitched — delivery is
        bit-reproducible across admission modes.  A session that retires
        here fires its ``on_retire`` callback — the streaming-results hook
        the cross-host tier's HostServer hangs result delivery on."""
        if session.t_first_result is None:
            session.t_first_result = time.monotonic()
            session.first_result_clock = self.boundary_clock
        session.consume(np.ascontiguousarray(y))
        if session.done and session.on_retire is not None:
            session.on_retire(session)

    def _scan(self, wave: Wave, col_budget: int) -> np.ndarray:
        """One shared A @ X.  An oversized lone tenant is served by vertical
        partitioning: slice X to the column budget, one streaming pass per
        slice (paper §3.3 / §3.6: passes = ceil(p / p_fit)).  The probe
        hook rides every slice too, so the boundary clock keeps its meaning
        ("chunk-batch boundaries seen, all passes") across sliced scans."""
        op = self.sharded if self.sharded is not None else self.sem
        hook = self._probe_hook if self._probe is not None else None
        snap = self._pass_snapshot

        def mult(x: np.ndarray) -> np.ndarray:
            return op.multiply(x, boundary_hook=hook, snapshot=snap) if hook \
                else op.multiply(x, snapshot=snap)

        if wave.width <= col_budget:
            return mult(wave.x)
        slices = [mult(wave.x[:, c0:c0 + col_budget])
                  for c0 in range(0, wave.width, col_budget)]
        return np.concatenate(slices, axis=1)

    def _probe_hook(self, boundary) -> None:
        """Classic-path hook: just the clock and the probe (no admission) —
        the apples-to-apples baseline for elastic benchmarks."""
        self.boundary_clock += 1
        self._probe(self, boundary)

    def run(self, max_passes: int = 10_000) -> List[PassReport]:
        """Serve until every submitted session is done (or the pass cap)."""
        done: List[PassReport] = []
        for _ in range(max_passes):
            rep = self.run_pass()
            if rep is None:
                break
            done.append(rep)
        return done

    # -- Submitter protocol --------------------------------------------------
    def deliver(self, timeout: Optional[float] = None) -> Optional[Ticket]:
        """Next completed spec-submitted ticket.  A lone scheduler has no
        serving thread, so deliver() drives passes itself until a ticket
        retires; it returns None once the backlog is empty (or the deadline
        lapses with nothing retiring)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._delivered.get_nowait()
            except queue.Empty:
                pass
            if self.run_pass() is None:
                return None
            if deadline is not None and time.monotonic() > deadline:
                return None

    def drain(self, timeout: Optional[float] = None) -> None:
        """Serve passes until every submitted session has retired."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.idle:
            if self.run_pass() is None:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"scheduler backlog not drained within {timeout}s")

    def stats(self) -> dict:
        """Point-in-time serving gauges (the Submitter-protocol slice of the
        per-pass :class:`PassReport` accounting)."""
        op = self.sharded if self.sharded is not None else self.sem
        ring_cols = (sum(s.width for s in self._ring_active)
                     + sum(s.width for s in self._ring_queue))
        return {
            "backlog_cols": (sum(s.width for s in self.active)
                             + self.batcher.pending_columns() + ring_cols),
            "pending_sessions": (len(self.active) + self.batcher.pending
                                 + len(self._ring_active)
                                 + len(self._ring_queue)),
            "scan_passes": self.total_scan_passes(),
            "version": getattr(op, "version", 0),
            "delta_nnz": getattr(op, "delta_nnz", 0),
            "io_stats": op.io_stats.to_dict(),
        }

    # -- elastic mode --------------------------------------------------------
    def _resolve_capacity(self, demand: int) -> int:
        """Fix the packed wave width on first use: current demand plus slack
        for mid-pass arrivals, clamped to the §3.6 budget.  Stable for the
        scheduler's lifetime -> the whole serving run reuses one accumulator
        shape."""
        if self.capacity is None:
            want = max(1, demand) + self.reserve_cols
            self.capacity = self.sem.columns_that_fit(want)
        return self.capacity

    def _row_starts(self) -> np.ndarray:
        """First chunk index of every tile row (+ terminal n_chunks), from
        the store's chunk layout — the tr_start <-> chunk_start bridge."""
        if self._row_first_chunk is None:
            trow = self.sem.store.chunk_tile_rows()
            n_tile_rows = -(-self.sem.n_rows // self.sem.T)
            self._row_first_chunk = np.searchsorted(
                trow, np.arange(n_tile_rows + 1))
            self._trow = trow
        return self._row_first_chunk

    def _tr_of(self, chunk_start: int) -> int:
        """First tile row fully covered by chunks [chunk_start, n_chunks)."""
        if chunk_start <= 0:
            return 0
        if chunk_start >= len(self._trow):
            return -(-self.sem.n_rows // self.sem.T)
        return int(self._trow[chunk_start - 1]) + 1

    def _alloc_slot(self, width: int) -> Optional[int]:
        """First-fit column slot inside the fixed capacity."""
        pos = 0
        for c0, w in sorted(self._slots.values()):
            if c0 - pos >= width:
                return pos
            pos = c0 + w
        return pos if self.capacity - pos >= width else None

    def _admit_to_slot(self, session: Session) -> Optional[int]:
        c0 = self._alloc_slot(session.width)
        if c0 is None:
            return None
        self._slots[session] = (c0, session.width)
        return c0

    def _retire(self, session: Session, report: PassReport) -> None:
        self._slots.pop(session, None)
        if session in self.active:
            self.active.remove(session)
        report.retired += 1

    def _run_pass_elastic(self, demand: int) -> Optional[PassReport]:
        cap = self._resolve_capacity(demand)
        self._row_starts()
        # a slotless active tenant (admitted by a classic fallback pass, e.g.
        # oversized) that cannot fit the fixed capacity keeps the classic
        # path; _midpass is empty whenever this triggers (classic passes
        # never run while partial-pass states are in flight)
        for s in self.active:
            if s not in self._slots and (s.width > cap
                                         or self._admit_to_slot(s) is None):
                return self._run_pass_classic(demand)
        # between-pass admission: fill free slots FIFO, no overtaking
        while self.batcher.pending:
            head = self.batcher.peek()
            if head.width > cap or self._admit_to_slot(head) is None:
                break
            self.active.append(self.batcher.pop())
        if not self.active:
            return None

        x = np.zeros((self.sem.n_cols, cap), np.float32)
        for s in self.active:
            c0, w = self._slots[s]
            cols = s.x_columns()
            x[:, c0:c0 + w] = cols[:, None] if cols.ndim == 1 else cols

        report = PassReport(wave_cols=sum(w for _, w in self._slots.values()),
                            tenants=len(self.active), capacity=cap)
        snap = self._take_snapshot()
        self._stamp_version(report, snap)
        # Version flip under a carried partial pass: the suffix was computed
        # at the old version, and stitching it onto a new-version prefix
        # would mix graphs inside one delivered product.  Demote the carried
        # state to a whole-pass delivery — its operand is already packed, so
        # this pass serves it A_new @ x end to end (the flip is observable
        # only at this pass boundary, never inside a stitched result).
        if report.version != self._last_pass_version:
            for st in self._midpass:
                if st.admitted_pass < self.pass_no:
                    st.admitted_pass = self.pass_no
                    st.tr_start = 0
                    st.admit_cs = 0
                    st.suffix = None
        if self.cache is not None:
            # the packed X physically holds `cap` columns all pass
            leftover = self.sem.leftover_budget(cap)
            self.cache.set_budget(leftover)
            report.cache_budget = leftover

        r0, h0, p0 = self._counters()
        self._pass_report = report
        op = self.sharded if self.sharded is not None else self.sem
        y = op.multiply(x, boundary_hook=self._elastic_hook,
                        snapshot=snap)
        self._pass_end(y, report)
        self._finish_report(report, r0, h0, p0)
        return report

    def _elastic_hook(self, b) -> None:
        """The elastic wave's batch-boundary protocol: heal a replica-retry
        rewind, deliver completed partial passes, admit queued tenants."""
        self.boundary_clock += 1
        if self._probe is not None:
            self._probe(self, b)
        cs = b.chunk_start
        report = self._pass_report
        starts = self._row_first_chunk

        # A replica failover restarts the pass from chunk 0: states admitted
        # earlier in THIS pass lost their column writes with the dead
        # replica's staged operand — re-write them at the retry's boundaries.
        for st in self._midpass:
            if (st.admitted_pass == self.pass_no and st.suffix is None
                    and st.admit_cs >= cs):
                b.write_columns(st.col0, st.session.x_columns())
                st.admit_cs = cs
                st.tr_start = self._tr_of(cs)

        # completions: a carried tenant's prefix rows [0, tr_start) are all
        # applied once the boundary clock reaches tr_start's first chunk
        for st in list(self._midpass):
            if st.admitted_pass >= self.pass_no or cs < starts[st.tr_start]:
                continue
            prefix = b.read_output(st.tr_start, st.col0, st.col0 + st.width)
            self._midpass.remove(st)
            report.completed_midpass += 1
            self._deliver(st.session, np.concatenate([prefix, st.suffix]))
            if st.session.done:
                self._retire(st.session, report)
            else:
                # rolling wavefront: the next iterate enters right here
                self._midpass_admit(st.session, b, report, count=False)

        # admissions: queued tenants enter free slack at this boundary
        while self.batcher.pending:
            head = self.batcher.peek()
            if (head.width > self.capacity
                    or self._admit_to_slot(head) is None):
                break
            session = self.batcher.pop()
            self.active.append(session)
            self._midpass_admit(session, b, report)

    def _midpass_admit(self, session: Session, b, report: PassReport,
                       count: bool = True) -> None:
        c0, w = self._slots[session]
        b.write_columns(c0, session.x_columns())
        self._midpass.append(MidPassState(
            session, c0, w, self._tr_of(b.chunk_start), b.chunk_start,
            self.pass_no))
        if count:
            report.admitted_midpass += 1

    def _pass_end(self, y: np.ndarray, report: PassReport) -> None:
        """Scatter at pass end: record suffixes for tenants admitted inside
        this pass, complete carried tenants the boundary clock missed, and
        deliver everyone who rode the whole pass.  ``handled`` collects
        every session the partial-pass protocol touched — whether its state
        is still carried or was just resolved here — so the plain scatter
        below never delivers the same product a second time."""
        T = self.sem.T
        handled = set()
        for st in list(self._midpass):
            handled.add(st.session)
            c0, c1 = st.col0, st.col0 + st.width
            if st.admitted_pass == self.pass_no:
                if st.tr_start == 0:  # admitted at boundary 0 == whole pass
                    self._midpass.remove(st)
                    self._deliver(st.session, y[:, c0:c1])
                    if st.session.done:
                        self._retire(st.session, report)
                else:
                    st.suffix = y[st.tr_start * T:, c0:c1].copy()
            else:
                # carried but the last boundary fell short of tr_start's
                # first chunk: the finished pass covers the prefix anyway
                self._midpass.remove(st)
                report.completed_midpass += 1
                prefix = y[: st.tr_start * T, c0:c1]
                self._deliver(st.session,
                              np.concatenate([prefix, st.suffix]))
                if st.session.done:
                    self._retire(st.session, report)
        for s in list(self.active):
            if s in handled:
                continue
            c0, w = self._slots[s]
            self._deliver(s, y[:, c0:c0 + w])
            if s.done:
                self._retire(s, report)

    # -- accounting ----------------------------------------------------------
    def total_bytes_read(self) -> int:
        return sum(r.bytes_read for r in self.reports)

    def total_scan_passes(self) -> int:
        return sum(r.scan_passes for r in self.reports)
