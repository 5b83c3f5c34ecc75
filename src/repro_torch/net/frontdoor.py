"""ClusterFrontDoor: route tenants across hosts, survive a host dying.

The fleet dispatcher's three jobs — route to least backlog, arbitrate one
memory budget, surface failures — reappear one level up when N machines
each run a :class:`~repro_torch.runtime.fleet.ServingFleet`.  The front door is
that recurrence made explicit, over the wire instead of over threads:

* **routing** — every heartbeat reply carries the host's fleet gauges
  (live backlog columns, queued sessions, worst per-wave pass-time EWMA,
  serialized :class:`~repro_torch.io.storage.IOStats`).  ``submit`` scores each
  live host exactly like :meth:`FleetWave.backlog_estimate` scores a wave:
  estimated seconds of queued work (columns x EWMA pass time), unmeasured
  hosts first, ties broken by columns.  Columns submitted since the last
  beat are counted locally so a burst between beats spreads instead of
  piling onto one host.
* **budget arbitration** — given a cluster-wide ``memory_budget_bytes``,
  each host holding in-flight tenants receives an even share via the
  ``budget`` RPC (the §3.6 split the fleet does per wave, done per host);
  a host that drains drops out of the divisor and the survivors' shares
  grow on their next pass — the same emergent rebalance, pushed instead of
  polled.
* **failover** — a host is evicted on heartbeat loss
  (:class:`~repro_torch.net.wire.Heartbeater`, ``miss_limit`` consecutive
  misses) or on a connection error from its deliver stream.  Its in-flight
  tenants' :class:`~repro_torch.runtime.session.SessionSpec`s — which the front
  door kept, because a spec is the whole session as data — are resubmitted
  to the surviving hosts.  Sessions are deterministic functions of (spec,
  matrix bytes), so the replayed tenants retire with **bit-identical**
  results; the kill-a-host test asserts equality, not closeness.

The front door owns a private asyncio loop on a daemon thread and exposes
a synchronous facade (``add_host`` / ``submit`` / ``drain`` / ``close``),
so a calling script — or a bench harness timing two subprocess hosts —
uses it like a local fleet.  One :class:`ClusterTicket` per tenant carries
the spec (for replay), the delivery event, and the result.
"""
from __future__ import annotations

import asyncio
import itertools
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.io.storage import IOStats
from repro_torch.net.wire import Heartbeater, RemoteError, WireClient
from repro_torch.runtime.api import SubmitterClosed, Ticket
from repro_torch.runtime.session import SessionSpec


class ClusterError(RuntimeError):
    """No live host can serve a tenant (every host evicted)."""


class ClusterTicket(Ticket):
    """One tenant's claim on the cluster: the spec (kept for failover
    replay), where it currently runs, and the delivered result."""

    def __init__(self, spec: SessionSpec):
        super().__init__(spec=spec)
        self.host_key: Optional[str] = None
        self.resubmits = 0
        # set for partitioned queries: the slab -> host assignment
        self.plan: Optional["PartitionPlan"] = None


class PartitionPlan:
    """Slab -> host assignment for one partitioned query.

    Every live host registered at submit time gets one contiguous
    nnz-balanced tile-row slab: slab ``k`` is
    ``TileStore.partition_rows(n_slabs)[k]``, a pure function of the shared
    store header + chunk meta, so each host derives identical slab
    boundaries from its own copy of the matrix — the front door never ships
    row ranges, only ``(slab, n_slabs)``.  On host death only the lost slab
    is reassigned (to the least-backlogged survivor); completed slabs of
    the same pass are untouched."""

    def __init__(self, handles: List["HostHandle"]):
        if not handles:
            raise ClusterError("no live hosts to partition across")
        self.n_slabs = len(handles)
        self.assignment: Dict[int, HostHandle] = dict(enumerate(handles))
        self.reassignments = 0

    def host_for(self, slab: int) -> "HostHandle":
        return self.assignment[slab]

    def reassign(self, slab: int,
                 survivors: List["HostHandle"]) -> "HostHandle":
        live = [h for h in survivors if h.alive]
        if not live:
            raise ClusterError(
                f"no live host to reassign slab {slab} to")
        handle = min(live, key=HostHandle.backlog_estimate)
        self.assignment[slab] = handle
        self.reassignments += 1
        return handle


class HostHandle:
    """Front-door-side state for one registered host."""

    def __init__(self, key: str, host: str, port: int, client: WireClient):
        self.key = key
        self.host, self.port = host, port
        self.client = client
        self.alive = True
        self.gauges: dict = {}
        self.io_stats = IOStats()
        self.inflight: Dict[str, ClusterTicket] = {}
        self.local_cols = 0        # columns submitted since the last beat
        self.budget_share = 0
        self.heartbeat: Optional[Heartbeater] = None
        self.tasks: List[asyncio.Task] = []

    def backlog_estimate(self):
        """(estimated seconds of queued work, columns) — the wave router's
        scoring rule one level up, freshened by locally-submitted columns
        the next beat hasn't reported yet."""
        cols = int(self.gauges.get("backlog_cols", 0)) + self.local_cols
        return (cols * float(self.gauges.get("ewma_pass_s", 0.0)), cols)


class ClusterFrontDoor:
    """Register hosts, route tenant specs, arbitrate budget, fail over.

    ``memory_budget_bytes`` (optional) is the cluster-wide §3.6 budget to
    split across busy hosts; leave ``None`` to let every host keep its own
    local default.  ``heartbeat_interval`` / ``miss_limit`` set the
    eviction latency: a dead host is detected after roughly
    ``interval * miss_limit`` seconds."""

    def __init__(self, *, memory_budget_bytes: Optional[int] = None,
                 heartbeat_interval: float = 0.2, miss_limit: int = 3,
                 deadline: float = 5.0, retries: int = 2,
                 deliver_poll_s: float = 2.0, slab_deadline: float = 120.0,
                 auth_token: Optional[str] = None):
        self.memory_budget_bytes = memory_budget_bytes
        self.heartbeat_interval = heartbeat_interval
        self.miss_limit = miss_limit
        self.deadline = deadline
        self.retries = retries
        self.deliver_poll_s = deliver_poll_s
        self.slab_deadline = slab_deadline
        self.auth_token = auth_token
        self.hosts: Dict[str, HostHandle] = {}
        self.evicted: List[str] = []
        self.tickets: List[ClusterTicket] = []
        self._ids = itertools.count(1)
        self._closed = False
        self._delivered: queue.Queue = queue.Queue()
        self._ptasks: List[asyncio.Task] = []
        self._started = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name="front-door")
        self._thread.start()
        self._started.wait()

    # -- loop plumbing -------------------------------------------------------
    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._stop = asyncio.Event()
        self._started.set()
        loop.run_until_complete(self._stop.wait())
        # cancel host tasks and partitioned pass loops before the loop dies
        for h in self.hosts.values():
            for t in h.tasks:
                t.cancel()
        for t in self._ptasks:
            t.cancel()
        loop.run_until_complete(asyncio.gather(
            *(t for h in self.hosts.values() for t in h.tasks),
            *self._ptasks,
            return_exceptions=True))
        loop.run_until_complete(asyncio.gather(
            *(h.client.close() for h in self.hosts.values()),
            return_exceptions=True))
        loop.close()

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    # -- registration --------------------------------------------------------
    def add_host(self, host: str, port: int, key: Optional[str] = None
                 ) -> str:
        """Register a host and start its heartbeat + deliver stream.
        Returns the host key (default ``host:port``)."""
        key = key or f"{host}:{port}"
        return self._call(self._add_host(key, host, port))

    async def _add_host(self, key: str, host: str, port: int) -> str:
        client = WireClient(host, port, deadline=self.deadline,
                            retries=self.retries,
                            auth_token=self.auth_token)
        handle = HostHandle(key, host, port, client)
        # first contact synchronously: a dead address fails registration
        # instead of being silently evicted later
        header, _ = await client.call("ping")
        handle.gauges = header
        self.hosts[key] = handle
        handle.heartbeat = Heartbeater(
            client, interval=self.heartbeat_interval,
            miss_limit=self.miss_limit,
            on_beat=lambda h: self._on_beat(handle, h),
            on_loss=lambda e: self._on_loss(handle, e))
        handle.tasks.append(asyncio.ensure_future(handle.heartbeat.run()))
        handle.tasks.append(asyncio.ensure_future(self._deliver_loop(handle)))
        return key

    # -- heartbeat-fed gauges ------------------------------------------------
    def _on_beat(self, handle: HostHandle, header: dict) -> None:
        handle.gauges = header
        handle.local_cols = 0      # the beat's backlog includes them now
        stats = header.get("io_stats")
        if isinstance(stats, dict):
            handle.io_stats = IOStats.from_dict(stats)

    def cluster_io_stats(self) -> IOStats:
        """Cluster-wide I/O view: every live host's last-beat counters
        merged with :meth:`IOStats.merge` semantics."""
        agg = IOStats()
        for h in self.hosts.values():
            agg.merge(h.io_stats)
        return agg

    # -- the deliver stream --------------------------------------------------
    async def _deliver_loop(self, handle: HostHandle) -> None:
        poll = self.deliver_poll_s
        while handle.alive:
            try:
                header, planes = await handle.client.call(
                    "deliver", {"timeout": poll}, deadline=poll + self.deadline)
            except asyncio.CancelledError:
                raise
            except RemoteError:
                continue               # host-side handler bug; keep polling
            except Exception as e:  # noqa: BLE001 — connection-level loss
                if handle.alive:
                    self._on_loss(handle, e)
                return
            if header.get("empty"):
                continue
            ticket = handle.inflight.pop(header.get("tenant_id"), None)
            if ticket is None or ticket.done:
                continue               # replayed elsewhere already
            ticket.iterations = int(header.get("iterations", 0))
            ticket.result = planes[0] if planes else None
            ticket._complete()
            await self._push_budget()

    # -- eviction + failover -------------------------------------------------
    def _on_loss(self, handle: HostHandle, exc: BaseException) -> None:
        if not handle.alive:
            return
        handle.alive = False
        self.evicted.append(handle.key)
        for t in handle.tasks:
            t.cancel()
        orphans = list(handle.inflight.values())
        handle.inflight.clear()
        # kept, like the partitioned passes: the loop holds tasks weakly
        self._ptasks.append(asyncio.ensure_future(
            self._resubmit(orphans, handle.key, exc)))

    async def _resubmit(self, orphans: List[ClusterTicket], dead_key: str,
                        exc: BaseException) -> None:
        """Replay a dead host's in-flight specs on the survivors.  Specs are
        deterministic, so the replacements retire bit-identically."""
        for ticket in orphans:
            if ticket.done:
                continue
            try:
                ticket.resubmits += 1
                await self._submit(ticket)
            except ClusterError as e:
                ticket.error = e
                ticket._complete()
        if orphans:
            await self._push_budget()

    def _live_hosts(self) -> List[HostHandle]:
        return [h for h in self.hosts.values() if h.alive]

    # -- submission ----------------------------------------------------------
    def submit(self, spec: SessionSpec, *,
               partitioned: bool = False) -> ClusterTicket:
        """Route a session spec to the least-backlogged live host.

        ``partitioned=True`` instead spans the query across *every* live
        host: a :class:`PartitionPlan` assigns each one a contiguous
        nnz-balanced tile-row slab, each pass broadcasts the operand once
        per host (the ``slab`` RPC's ndarray planes), the slab scans run
        concurrently, and the front door concatenates the slab outputs in
        tile-row order — bit-identical to a single-host run, because slab
        outputs are disjoint row ranges.  Iterative sessions live *here*
        (the session consumes the stitched product and the next iterate is
        re-broadcast each pass); host death mid-slab reassigns only the
        lost slab to a survivor."""
        if self._closed:
            raise SubmitterClosed("front door is closed")
        if not spec.tenant_id:
            spec.tenant_id = f"tenant-{next(self._ids)}"
        ticket = ClusterTicket(spec)
        ticket.add_done_callback(self._delivered.put)
        self.tickets.append(ticket)
        if partitioned:
            self._call(self._start_partitioned(ticket))
        else:
            self._call(self._submit_and_budget(ticket))
        return ticket

    async def _submit_and_budget(self, ticket: ClusterTicket) -> None:
        await self._submit(ticket)
        await self._push_budget()

    # -- partitioned queries -------------------------------------------------
    async def _start_partitioned(self, ticket: ClusterTicket) -> None:
        ticket.plan = PartitionPlan(self._live_hosts())
        task = asyncio.ensure_future(self._run_partitioned(ticket))
        self._ptasks.append(task)

    async def _run_partitioned(self, ticket: ClusterTicket) -> None:
        """Drive one partitioned session to retirement: per pass, broadcast
        the current operand to every slab host concurrently, stitch the
        returned row blocks in slab (= tile-row) order, and advance the
        session.  The session object lives here at the front door — hosts
        only ever see stateless one-pass slab multiplies."""
        plan = ticket.plan
        try:
            session = ticket.spec.build()
            ticket.session = session
            pass_no = 0
            while not session.done:
                x = np.ascontiguousarray(
                    np.asarray(session.x_columns(), np.float32))
                if x.ndim == 1:
                    x = x[:, None]
                # version-consistency retry: each slab reply reports the
                # graph version its scan served; a cluster update landing
                # between slab scans would stitch rows from two graphs
                # into one product, so the pass re-runs until every slab
                # agrees (bounded — each retry sees a quiescent-er log)
                for attempt in range(4):
                    results = await asyncio.gather(*(
                        self._slab_scan(ticket, plan, slab, x, pass_no)
                        for slab in range(plan.n_slabs)))
                    versions = {v for _, v in results}
                    if len(versions) <= 1:
                        break
                else:
                    raise ClusterError(
                        f"partitioned tenant {ticket.tenant_id!r}: slab "
                        f"versions never converged ({sorted(versions)})")
                session.consume(np.concatenate([b for b, _ in results],
                                               axis=0))
                pass_no += 1
            ticket.iterations = session.iterations
            ticket.result = session.result
        except asyncio.CancelledError:
            ticket.error = ClusterError(
                f"front door closed before partitioned tenant "
                f"{ticket.tenant_id!r} finished")
            ticket._complete()
            raise
        except Exception as e:  # noqa: BLE001 — surfaced via ticket.wait()
            ticket.error = e
        ticket._complete()

    async def _slab_scan(self, ticket: ClusterTicket, plan: PartitionPlan,
                         slab: int, x: np.ndarray,
                         pass_no: int) -> np.ndarray:
        """One slab's share of one pass — returns ``(rows, version)``, the
        graph version the slab's scan served riding along for the pass's
        consistency check — with slab-level failover: a connection failure
        evicts the host (standard eviction path — its *whole-query* tenants
        resubmit too) and retries the same slab on the least-backlogged
        survivor.  A ``RemoteError`` is a rejection (the host parsed the
        spec and said no) and is not retried."""
        ring = getattr(ticket.session, "semiring", "plus_times")
        spec = SessionSpec.multiply(
            x, tenant_id=f"{ticket.tenant_id}/p{pass_no}", semiring=ring
        ).with_slab(slab, plan.n_slabs)
        header, planes = spec.to_wire()
        while True:
            handle = plan.host_for(slab)
            if not handle.alive:
                handle = plan.reassign(slab, self._live_hosts())
                ticket.resubmits += 1
            try:
                rheader, rplanes = await handle.client.call(
                    "slab", {"spec": header}, planes,
                    deadline=self.slab_deadline)
            except RemoteError:
                raise
            except Exception as e:  # noqa: BLE001 — connection-level loss
                self._on_loss(handle, e)
                continue
            if not rplanes:
                raise ClusterError(
                    f"slab {slab} reply from {handle.key} carried no plane")
            return rplanes[0], int(rheader.get("version", 0))

    async def _submit(self, ticket: ClusterTicket) -> None:
        spec = ticket.spec
        header, planes = spec.to_wire()
        width = sum(1 if p.ndim == 1 else p.shape[-1]
                    for n, p in spec.arrays.items() if n in ("x", "x0"))
        while True:
            live = self._live_hosts()
            if not live:
                raise ClusterError(
                    f"no live hosts for tenant {spec.tenant_id!r} "
                    f"(evicted: {self.evicted})")
            handle = min(live, key=HostHandle.backlog_estimate)
            # claim before the call: a crash inside submit must still count
            # this ticket among the host's orphans
            handle.inflight[spec.tenant_id] = ticket
            handle.local_cols += max(1, width)
            ticket.host_key = handle.key
            try:
                await handle.client.call("submit", {"spec": header}, planes)
                return
            except RemoteError:
                handle.inflight.pop(spec.tenant_id, None)
                raise              # the host rejected the spec; don't reroute
            except Exception as e:  # noqa: BLE001 — connection-level loss
                handle.inflight.pop(spec.tenant_id, None)
                self._on_loss(handle, e)

    # -- graph mutation ------------------------------------------------------
    def apply_updates(self, batch) -> int:
        """Fan one :class:`~repro_torch.io.storage.UpdateBatch` out to every live
        host and return the new cluster version.  Hosts apply updates in
        submission order over the same RPC stream, so replicas that acked
        the same sequence report the same version — routed queries then
        serve one version wherever they land, and partitioned passes
        version-check their slab replies.  A host that fails the RPC is
        evicted (standard loss path: its in-flight tenants replay on
        survivors); all hosts failing raises :class:`ClusterError`."""
        if self._closed:
            raise SubmitterClosed("front door is closed")
        return self._call(self._apply_updates(batch))

    async def _apply_updates(self, batch) -> int:
        header, planes = batch.to_wire()
        live = self._live_hosts()
        if not live:
            raise ClusterError(
                f"no live hosts to apply updates to (evicted: "
                f"{self.evicted})")

        async def one(h: HostHandle) -> Optional[int]:
            try:
                rh, _ = await h.client.call("update", {"update": header},
                                            planes)
                return int(rh["version"])
            except RemoteError:
                raise          # the host parsed the batch and said no
            except Exception as e:  # noqa: BLE001 — connection-level loss
                self._on_loss(h, e)
                return None

        versions = [v for v in await asyncio.gather(*(one(h) for h in live))
                    if v is not None]
        if not versions:
            raise ClusterError("every host failed while applying updates")
        return max(versions)

    # -- budget arbitration --------------------------------------------------
    async def _push_budget(self) -> None:
        """Even split of the cluster budget over busy live hosts (the
        fleet's per-wave leftover arithmetic, per host).  Only hosts whose
        share changed get the RPC."""
        if self.memory_budget_bytes is None:
            return
        live = self._live_hosts()
        busy = [h for h in live if h.inflight]
        share_of = {h.key: (self.memory_budget_bytes // max(1, len(busy))
                            if h in busy else h.budget_share)
                    for h in live}
        for h in live:
            share = share_of[h.key]
            if share and share != h.budget_share:
                h.budget_share = share
                try:
                    await h.client.call(
                        "budget", {"memory_budget_bytes": share})
                except Exception as e:  # noqa: BLE001
                    self._on_loss(h, e)

    # -- deliver / drain / close ---------------------------------------------
    def deliver(self, timeout: Optional[float] = None
                ) -> Optional[ClusterTicket]:
        """Next completed ticket (any tenant, any host, partitioned or
        not); blocks up to ``timeout`` (None = wait indefinitely).  Returns
        None if nothing completes within the timeout."""
        try:
            return self._delivered.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self, tickets=None,
              timeout: Optional[float] = None) -> Optional[List[np.ndarray]]:
        """Block until tickets are served (through however many failovers
        it takes).  The protocol form ``drain(timeout=...)`` waits on every
        ticket ever submitted and returns None; the legacy form
        ``drain([tickets], timeout)`` returns those tickets' results in
        order (a ticket that failed re-raises its error)."""
        if isinstance(tickets, (int, float)) and timeout is None:
            tickets, timeout = None, float(tickets)
        explicit = tickets is not None
        waitlist = list(self.tickets) if tickets is None else list(tickets)
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for t in waitlist:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            out.append(t.wait(left))
        return out if explicit else None

    def stats(self) -> dict:
        """Cluster gauges: live host count, summed last-beat backlog (plus
        columns submitted since), in-flight tenants, per-host graph
        versions with their spread (``version_skew`` > 0 means an update
        fan-out is mid-flight or a host missed one), and the merged
        cluster-wide I/O counters."""
        live = self._live_hosts()
        versions = {h.key: int(h.gauges.get("version", 0)) for h in live}
        skew = (max(versions.values()) - min(versions.values())
                if versions else 0)
        return {
            "hosts": len(live),
            "evicted": len(self.evicted),
            "backlog_cols": sum(int(h.gauges.get("backlog_cols", 0))
                                + h.local_cols for h in live),
            "pending_sessions": sum(len(h.inflight) for h in live),
            "partitioned_inflight": sum(
                1 for t in self.tickets
                if t.plan is not None and not t.done),
            "versions": versions,
            "version_skew": skew,
            "delta_nnz": sum(int(h.gauges.get("delta_nnz", 0))
                             for h in live),
            "io_stats": self.cluster_io_stats().to_dict(),
        }

    def close(self) -> None:
        """Stop heartbeats and deliver streams, close the connections, kill
        the loop.  Hosts keep running — shut them down via their own
        ``shutdown`` RPC or process lifecycle."""
        if self._closed:
            return
        self._closed = True
        self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout=10)

    def shutdown_hosts(self) -> None:
        """Best-effort ``shutdown`` RPC to every live host (for callers that
        own the host processes)."""
        async def _all():
            for h in self._live_hosts():
                try:
                    await h.client.call("shutdown")
                except Exception:  # noqa: BLE001 — racing the host's exit
                    pass
        self._call(_all())

    def __enter__(self) -> "ClusterFrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
