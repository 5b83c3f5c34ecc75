"""HostServer: one semi-external host's serving fleet behind an RPC door.

A host in the cross-host tier is exactly the single-machine serving
stack — a :class:`~repro_torch.runtime.fleet.ServingFleet` over its own
:class:`~repro_torch.runtime.replica.ReplicaSet` and its own SSD stores — wrapped
in the :mod:`repro_torch.net.wire` frame protocol so a
:class:`~repro_torch.net.frontdoor.ClusterFrontDoor` on another machine can drive
it.  The RPC surface is deliberately small:

* ``submit`` — a :class:`~repro_torch.runtime.session.SessionSpec` (header +
  operand planes) is rebuilt into a live session and routed through the
  fleet's own least-backlog dispatcher.  The ack carries the tenant id.
* ``deliver`` — a long-poll: the reply is the next *retired* session's
  result planes (tenant id, iteration count, result array).  Results
  stream back as sessions retire — the scheduler's delivery path fires
  ``Session.on_retire`` on the serving wave's thread, which enqueues the
  finished tenant onto the loop via ``call_soon_threadsafe``; no polling
  thread watches N tenants.
* ``drain`` — block until the fleet is empty.  A dead wave does not fail
  the RPC: the reply names the lost sessions
  (:class:`~repro_torch.runtime.fleet.WaveError`'s manifest) so the front door
  can resubmit precisely, to this host's surviving waves or elsewhere.
* ``ping`` / ``stats`` — the heartbeat carrier: fleet gauges (backlog
  columns, queued sessions, worst pass-time EWMA) plus the serialized
  replica :class:`~repro_torch.io.storage.IOStats` — the signals the front
  door's routing and budget arbitration feed on — and the process's
  kernel launch counts (``kernel_launches``).
* ``budget`` — the cluster's global-memory arbiter resets this host's
  §3.6 budget (``SEMConfig.memory_budget_bytes`` is shared by every
  executor of the ReplicaSet, so one write repartitions the next pass's
  column/cache split).
* ``shutdown`` — graceful stop (ack first, then close).

The server owns a private asyncio loop on a daemon thread; ``start()``
returns the bound port, so in-process tests can run a whole cluster in one
process while ``python -m repro_torch.net.host`` serves the same thing as a real
process for the two-process localhost bench (on the card unless
``--device cpu`` is given).  The CLI's
``--throttle-pass-seconds`` wraps every store in a spindle-emulating
TileStore (one lock + proportional sleep per spindle, the bench_runtime
idiom) so multi-host speedup measurements are I/O-bound, not CPU-bound.
"""
from __future__ import annotations

import argparse
import asyncio
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.io.storage import IOStats, TileStore, UpdateBatch
from repro_torch.kernels import sem_spmm
from repro_torch.net.wire import WireServer
from repro_torch.runtime.api import Ticket
from repro_torch.runtime.fleet import ServingFleet, WaveError
from repro_torch.runtime.replica import ReplicaSet
from repro_torch.runtime.session import SessionSpec


class HostServer:
    """RPC front over one :class:`ServingFleet` (see module docstring).

    The caller owns fleet construction (stores, waves, capacity); the
    server owns the loop thread, the wire endpoint, and the retire->deliver
    stream.  ``stop()`` closes the endpoint and the fleet; the context
    manager form pairs ``start``/``stop``.

    ``auth_token`` (optional) arms the wire handshake: every connection
    must open with the shared-secret preamble or it is dropped before any
    frame is parsed.  ``host`` is the bind address — ``127.0.0.1`` keeps
    the endpoint loopback-only; bind ``0.0.0.0`` (with a token) to serve a
    real network.

    The ``slab`` RPC serves one tile-row slab of a *partitioned* cross-host
    query: the spec arrives slab-scoped (``SessionSpec.with_slab``), the
    host lazily opens ``TileStore.partition_rows(n_slabs)[slab]`` over its
    own store copies (a ReplicaSet sharing the fleet's SEMConfig, so the
    cluster budget RPC governs slab scans too), runs the one-pass multiply
    off-loop, and returns the slab's output rows as a plane.  Slab scans
    hold no per-session state — iterative partitioned sessions advance at
    the front door, which re-broadcasts the next iterate each pass."""

    def __init__(self, fleet: ServingFleet, host: str = "127.0.0.1",
                 port: int = 0, *, auth_token: Optional[str] = None):
        self.fleet = fleet
        self._wire = WireServer(self._handle, host, port,
                                auth_token=auth_token)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._finished: Optional[asyncio.Queue] = None
        self._shutdown: Optional[asyncio.Event] = None
        self._started = threading.Event()
        self.port: Optional[int] = None
        self.submitted = 0
        self.delivered = 0
        self.slab_scans = 0
        self._slabs: dict = {}          # (n_slabs, slab) -> ReplicaSet
        self._slab_lock = threading.Lock()
        self._layout_pinned = False     # slab shard views pin the base

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> int:
        """Spin up the loop thread and bind the endpoint; returns the port."""
        if self._thread is not None:
            return self.port
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name="host-server")
        self._thread.start()
        self._started.wait()
        return self.port

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._finished = asyncio.Queue()
        self._shutdown = asyncio.Event()
        self.port = loop.run_until_complete(self._wire.start())
        self._started.set()
        loop.run_until_complete(self._shutdown.wait())
        loop.run_until_complete(self._wire.close())
        # reap stragglers — open connections and parked deliver long-polls —
        # so the loop closes without destroying pending tasks
        pending = [t for t in asyncio.all_tasks(loop)]
        for t in pending:
            t.cancel()
        loop.run_until_complete(
            asyncio.gather(*pending, return_exceptions=True))
        loop.close()

    def stop(self) -> None:
        """Graceful stop: close the endpoint, then the fleet (an in-flight
        pass completes; drain first for a clean end).  Idempotent.  Returns
        promptly with peers still connected: the endpoint's close ends
        their connections (:meth:`WireServer.close`)."""
        if self._loop is not None and not self._loop.is_closed():
            try:
                self._loop.call_soon_threadsafe(self._shutdown.set)
            except RuntimeError:
                pass                   # it closed since the check
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._slab_lock:
            if self._layout_pinned:
                h = self.fleet.replicas.store.handle
                if h is not None:
                    h.unpin_layout()
                self._layout_pinned = False
        self.fleet.close()
        with self._slab_lock:
            slabs, self._slabs = list(self._slabs.values()), {}
        for ex in slabs:
            ex.close()

    def __enter__(self) -> "HostServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the retire -> deliver stream ----------------------------------------
    def _on_ticket_done(self, ticket: Ticket) -> None:
        # wave thread -> loop thread; the queue is loop-owned.  A host whose
        # endpoint is gone keeps serving (its waves run on) but has no one
        # to deliver to: the front door replays its tenants elsewhere, so
        # the result is dropped rather than raised into the wave's thread.
        try:
            self._loop.call_soon_threadsafe(self._finished.put_nowait, ticket)
        except RuntimeError:
            pass                       # the loop is closed

    # -- partitioned slab executors ------------------------------------------
    def _slab_executor(self, n_slabs: int, slab: int) -> ReplicaSet:
        """Lazily open the slab's shard of every store copy as a ReplicaSet.
        The partition is a pure function of the shared header + meta, so
        slab ``k`` here covers exactly the tile rows the front door's plan
        assigned — regardless of which copy serves it.  Shares the fleet's
        SEMConfig (the cluster ``budget`` RPC repartitions slab scans too)
        and keeps a throttled store's read path (``partition_rows`` builds
        ``type(self)`` shards): a slab scan sleeps for the slab's bytes.
        Each slab executor runs on the device of the fleet executor over the
        same copy (a ReplicaSet left without devices would take the card)."""
        key = (int(n_slabs), int(slab))
        with self._slab_lock:
            ex = self._slabs.get(key)
            if ex is None:
                stores = [e.store for e in self.fleet.replicas.execs]
                shards = [s.partition_rows(key[0]) for s in stores]
                if key[1] >= len(shards[0]):
                    raise ValueError(
                        f"slab {key[1]} out of range: store partitions "
                        f"into {len(shards[0])} slabs (asked {key[0]})")
                ex = ReplicaSet([sh[key[1]] for sh in shards],
                                config=self.fleet.replicas.cfg,
                                devices=[e.device for e in
                                         self.fleet.replicas.execs])
                self._slabs[key] = ex
            self._pin_slabs_locked()
            return ex

    def _pin_slabs_locked(self) -> None:
        """Slab shard views hold chunk ranges derived from the current base
        generation; while any slab executor is alive, hold a layout pin on
        the graph handle so a compaction install cannot pull the base out
        from under them.  Caller holds ``_slab_lock``."""
        h = self.fleet.replicas.store.handle
        if h is not None and self._slabs and not self._layout_pinned:
            h.pin_layout()
            self._layout_pinned = True

    def _slab_multiply(self, spec: SessionSpec) -> Tuple[np.ndarray, int]:
        ex = self._slab_executor(spec.n_slabs, spec.slab)
        x = spec.arrays["x"]
        if x.ndim == 1:
            x = x[:, None]
        ring = str(spec.params.get("semiring", "plus_times"))
        y = ex.multiply(x, semiring=ring)
        return y, ex.last_pass_version

    # -- RPC dispatch --------------------------------------------------------
    async def _handle(self, op: str, header: dict,
                      planes: List[np.ndarray]
                      ) -> Tuple[dict, List[np.ndarray]]:
        # received planes are read-only views of the frame's bytes: the
        # sessions and the engine get their own writable copies
        planes = [np.array(p) for p in planes]
        if op == "ping" or op == "stats":
            stats = dict(self.fleet.stats())
            with self._slab_lock:
                slabs = list(self._slabs.values())
            if slabs:
                # fold slab-scan I/O into the heartbeat gauges: slab shards
                # are their own store views with their own counters
                agg = IOStats.from_dict(stats["io_stats"])
                for ex in slabs:
                    agg.merge(ex.io_stats)
                stats["io_stats"] = agg.to_dict()
            stats["slab_scans"] = self.slab_scans
            # the process's kernel launches (every host it runs counts):
            # a peer can check that the passes went through the kernel
            stats["kernel_launches"] = dict(sem_spmm.LAUNCHES)
            return stats, []
        if op == "submit":
            spec = SessionSpec.from_wire(header["spec"], planes)
            ticket = self.fleet.submit(spec)
            ticket.add_done_callback(self._on_ticket_done)
            self.submitted += 1
            return {"tenant_id": ticket.tenant_id}, []
        if op == "deliver":
            timeout = float(header.get("timeout", 30.0))
            try:
                ticket = await asyncio.wait_for(self._finished.get(),
                                                timeout)
            except asyncio.TimeoutError:
                return {"empty": True}, []
            self.delivered += 1
            return ({"tenant_id": ticket.tenant_id,
                     "iterations": ticket.iterations},
                    [np.ascontiguousarray(ticket.result)])
        if op == "slab":
            spec = SessionSpec.from_wire(header["spec"], planes)
            if spec.slab is None or spec.n_slabs is None:
                raise ValueError("slab op requires a slab-scoped spec")
            if spec.kind != "multiply":
                raise ValueError(
                    f"slab op serves one-pass multiplies, not "
                    f"{spec.kind!r} (iterative partitioned sessions "
                    f"advance at the front door)")
            # off-loop: a slab scan takes real I/O time and must not stall
            # this connection's heartbeats
            y, ver = await asyncio.get_running_loop().run_in_executor(
                None, self._slab_multiply, spec)
            self.slab_scans += 1
            return ({"tenant_id": spec.tenant_id, "slab": int(spec.slab),
                     "rows": int(y.shape[0]), "version": int(ver)},
                    [np.ascontiguousarray(y)])
        if op == "drain":
            timeout = header.get("timeout")
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, lambda: self.fleet.drain(timeout))
            except WaveError as e:
                # a dead wave is an app-level report, not an RPC failure:
                # the front door resubmits exactly these tenants
                return {"failed_sessions": e.session_ids,
                        "error": repr(e.error)}, []
            return {"failed_sessions": []}, []
        if op == "update":
            batch = UpdateBatch.from_wire(header["update"], planes)
            # off-loop: appending may spill the log to disk
            ver = await asyncio.get_running_loop().run_in_executor(
                None, self.fleet.apply_updates, batch)
            with self._slab_lock:
                self._pin_slabs_locked()
            return {"version": int(ver)}, []
        if op == "budget":
            budget = int(header["memory_budget_bytes"])
            # one shared SEMConfig behind every executor: the write
            # repartitions the §3.6 column/cache split for the next pass
            self.fleet.replicas.cfg.memory_budget_bytes = budget
            return {"memory_budget_bytes": budget}, []
        if op == "shutdown":
            self._loop.call_soon(self._shutdown.set)
            return {"bye": True}, []
        raise ValueError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# CLI: one host process (the two-process bench / example entry point)
# ---------------------------------------------------------------------------
class _SpindleStore(TileStore):
    """TileStore throttled like one SSD spindle (the bench_runtime idiom):
    reads sleep proportionally to bytes under a per-spindle lock, bracketed
    by the in-flight gauge.  Makes a localhost multi-host demo I/O-bound, so
    cluster speedup measures spindle ownership rather than CPU contention."""

    seconds_per_byte = 0.0
    spindle_lock = None

    def read_batch_raw(self, start, count):
        # actual on-disk bytes, not record*count: an optimized store's
        # packed chunks are smaller than the header's worst-case record
        delay = self.seconds_per_byte * self.range_nbytes(start, count)
        self.stats.begin_read()
        try:
            if self.spindle_lock is not None:
                with self.spindle_lock:
                    time.sleep(delay)
            else:
                time.sleep(delay)
        finally:
            self.stats.end_read()
        return super().read_batch_raw(start, count)

    def partition_rows(self, n_shards):
        shards = super().partition_rows(n_shards)
        for s in shards:
            s.seconds_per_byte = self.seconds_per_byte
            s.spindle_lock = self.spindle_lock
        return shards


def open_stores(paths: Sequence[str],
                throttle_pass_seconds: Optional[float] = None
                ) -> List[TileStore]:
    """Open the host's stores, optionally spindle-throttled (each path is
    its own spindle: own lock, own bandwidth)."""
    stores: List[TileStore] = []
    for p in paths:
        if throttle_pass_seconds:
            st = _SpindleStore(p, TileStore.open(p).header)
            st.seconds_per_byte = throttle_pass_seconds / st.nbytes
            st.spindle_lock = threading.Lock()
        else:
            st = TileStore.open(p)
        stores.append(st)
    return stores


def build_host(store_paths: Sequence[str], *, waves: int = 2,
               capacity: Optional[int] = None,
               throttle_pass_seconds: Optional[float] = None,
               use_cache: bool = True,
               host: str = "127.0.0.1", port: int = 0,
               auth_token: Optional[str] = None,
               devices: Optional[Sequence] = None) -> HostServer:
    """Stores -> ReplicaSet -> ServingFleet -> HostServer, unstarted.
    ``devices`` places the executors as :class:`ReplicaSet` does: left
    ``None``, every copy runs on the card (raising without one);
    ``["cpu"]`` runs them on the host."""
    stores = open_stores(store_paths, throttle_pass_seconds)
    fleet = ServingFleet(ReplicaSet(stores, devices=devices),
                         n_waves=waves, capacity=capacity,
                         use_cache=use_cache)
    return HostServer(fleet, host=host, port=port, auth_token=auth_token)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve one SEM host's fleet over the wire protocol")
    ap.add_argument("--store", action="append", required=True,
                    help="TileStore path (repeat for replica copies)")
    ap.add_argument("--bind", default="127.0.0.1",
                    help="bind address (default loopback-only; use 0.0.0.0 "
                         "to serve a real network — pair with --auth-token)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--throttle-pass-seconds", type=float, default=None,
                    help="emulate spindle bandwidth: seconds per full scan")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the hot-chunk cache (the spindle-bound "
                         "bench regime: every pass streams the slow tier)")
    ap.add_argument("--device", default=None,
                    help="torch device of the executors (default: the "
                         "card; 'cpu' runs the plain path on the host)")
    ap.add_argument("--auth-token", default=None,
                    help="shared secret: connections must open with the "
                         "matching wire-handshake preamble or are dropped "
                         "before any frame is parsed")
    args = ap.parse_args(argv)
    server = build_host(args.store, waves=args.waves, capacity=args.capacity,
                        throttle_pass_seconds=args.throttle_pass_seconds,
                        use_cache=not args.no_cache, host=args.bind,
                        port=args.port, auth_token=args.auth_token,
                        devices=None if args.device is None
                        else [args.device])
    port = server.start()
    # the parent process scrapes this line for the bound port
    print(f"LISTENING {port}", flush=True)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
