"""The port's cross-host tier on the CPU, mirroring ``tests/test_net.py``
case by case, then held against the JAX package's tier.

Every host's executors run on the CPU (``devices=["cpu"]``), where the
plain step is deterministic, so the reference's bit-identity claims (a
cluster, a failover and a partitioned query give a lone fleet's bits) hold
bit for bit on float operands.  The cases the reference fails or hangs on
here — heartbeat loss with the server closed first, a killed host, a
killed slab host — pass on the port: its ``WireServer.close`` ends live
connections before it waits (``asyncio.Server.wait_closed`` waits for
every open connection since Python 3.12.1).

Across packages: both write the same frame bytes for the same header and
planes (requests and replies, with and without the auth preamble) and
decode each other's; a reference front door serves tenants on port hosts
and a port front door on reference hosts, and a partitioned query spans
one host of each, all with the reference lone fleet's bits on integer
operands over a binary store.

Every wait is bounded (``asyncio.wait_for``, ticket and drain timeouts,
bounded joins).  A reference front door is closed before a reference host
is stopped: the reference's close waits for open connections.
"""
import asyncio
import os
import pathlib
import queue
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.net.wire as ref_wire
from repro.apps.pagerank import (build_operator as pr_operator,
                                 dangling_vertices)
from repro.core.formats import to_chunked as ref_to_chunked
from repro.io.storage import TileStore as RefTileStore
from repro.net.frontdoor import ClusterFrontDoor as RefFrontDoor
from repro.net.host import HostServer as RefHostServer
from repro.runtime import ReplicaSet as RefReplicaSet
from repro.runtime import ServingFleet as RefFleet
from repro.runtime import SessionSpec as RefSpec
from repro_torch.io.storage import IOStats, TileStore
from repro_torch.net import wire
from repro_torch.net.frontdoor import ClusterFrontDoor
from repro_torch.net.host import HostServer, build_host
from repro_torch.net.wire import (DeadlineExpired, Heartbeater, RemoteError,
                                  WireClient, WireServer, decode_frame,
                                  encode_frame)
from repro_torch.runtime import (MultiplyRequest, ReplicaSet, ServingFleet,
                                 Session, SessionSpec, WaveError)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BOUND = 30.0          # seconds: the bound on any one scenario


def run(coro, bound=BOUND):
    return asyncio.run(asyncio.wait_for(coro, bound))


@pytest.fixture(scope="module")
def store_path(small_graph, tmp_path_factory):
    """The PageRank operator of the small graph (column-stochastic, non-
    negative): one matrix serves every tenant kind of a mixed batch."""
    ct = ref_to_chunked(pr_operator(small_graph), T=512, C=128)
    path = str(tmp_path_factory.mktemp("tnet") / "g")
    RefTileStore.write(path, ct)
    return path


@pytest.fixture(scope="module")
def bin_path(small_graph, tmp_path_factory):
    """The small graph's pattern as a binary store: integer operands keep
    every sum exact, so both packages' engines give the same bits."""
    ct = ref_to_chunked(small_graph, T=512, C=128)
    path = str(tmp_path_factory.mktemp("tnet_bin") / "b")
    RefTileStore.write(path, ct, binary=True)
    return path


def cpu_fleet(stores, waves=1):
    stores = [TileStore.open(s) if isinstance(s, str) else s for s in stores]
    return ServingFleet(ReplicaSet(stores, devices=["cpu"] * len(stores)),
                        n_waves=waves)


def make_host(path, waves=1):
    return HostServer(cpu_fleet([path], waves))


def ref_host(path):
    return RefHostServer(RefFleet(RefReplicaSet([RefTileStore.open(path)]),
                                  n_waves=1))


def mixed_specs(small_graph, n_multiply=2):
    rng = np.random.default_rng(31)
    n = small_graph.n_rows
    specs = [SessionSpec.multiply(
        rng.standard_normal(n).astype(np.float32), tenant_id=f"mul{i}")
        for i in range(n_multiply)]
    specs.append(SessionSpec.power_iteration(
        rng.standard_normal(n).astype(np.float32), tol=0.0, max_iter=8,
        tenant_id="power"))
    specs.append(SessionSpec.pagerank(
        n, dangling_vertices(small_graph), max_iter=10, tenant_id="pr"))
    specs.append(SessionSpec.bfs(np.array([0]), n, tenant_id="bfs"))
    return specs


def lone_fleet_results(path, specs):
    """Ground truth: the same specs served by one local port fleet."""
    with cpu_fleet([path]) as fleet:
        tickets = [fleet.submit(s) for s in specs]
        fleet.drain(timeout=120)
    return tickets


# ---------------------------------------------------------------------------
# Wire framing
# ---------------------------------------------------------------------------
def test_frame_roundtrip_preserves_headers_and_planes():
    planes = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.array([1, -1, 7], np.int64),
              np.zeros((0, 5), np.float32)]
    buf = encode_frame({"op": "x", "k": [1, 2], "s": "αβ"}, planes)
    header, out = decode_frame(buf)
    assert header["op"] == "x" and header["k"] == [1, 2]
    assert header["s"] == "αβ" and "_planes" not in header
    assert [p.dtype for p in out] == [np.float32, np.int64, np.float32]
    for a, b in zip(planes, out):
        np.testing.assert_array_equal(a, b)


def test_truncated_and_malformed_frames_rejected():
    buf = encode_frame({"op": "x"}, [np.ones((4, 4), np.float32)])
    for cut in (3, 10, len(buf) - 17, len(buf) - 1):
        with pytest.raises(ConnectionError):
            decode_frame(buf[:cut])
    with pytest.raises(ConnectionError, match="magic"):
        decode_frame(b"\x00" * len(buf))
    with pytest.raises(ConnectionError):
        decode_frame(buf + b"\x00")
    bad = bytearray(buf)
    bad[16] = 0xFF
    with pytest.raises(ConnectionError):
        decode_frame(bytes(bad))
    short = encode_frame({"op": "x"}, [np.ones(4, np.float32)])
    grown = short.replace(b'["<f4",[4]]', b'["<f4",[9]]')
    assert grown != short
    with pytest.raises(ConnectionError, match="truncated|lengths"):
        decode_frame(grown)


def test_oversized_header_rejected():
    with pytest.raises(ConnectionError, match="large"):
        encode_frame({"blob": "x" * (wire.MAX_HEADER + 1)})


# ---------------------------------------------------------------------------
# Deadlines, retry, backoff, heartbeats
# ---------------------------------------------------------------------------
def test_deadline_expiry_then_backoff_then_retry_ordering():
    async def scenario():
        async def slow(op, header, planes):
            await asyncio.sleep(30)
            return {}, []
        server = WireServer(slow)
        port = await server.start()
        events = []
        client = WireClient("127.0.0.1", port, deadline=0.05, retries=2,
                            backoff0=0.05,
                            trace=lambda ev, d: events.append((ev, d)))
        with pytest.raises(DeadlineExpired):
            await client.call("work")
        await client.close()
        await server.close()
        return events

    events = run(scenario())
    assert [e for e, _ in events] == [
        "expired", "backoff", "retry",
        "expired", "backoff", "retry",
        "expired"]
    assert [d for e, d in events if e == "backoff"] == [0.05, 0.1]


def test_retry_succeeds_after_transient_slowness():
    async def scenario():
        calls = {"n": 0}

        async def flaky(op, header, planes):
            calls["n"] += 1
            if calls["n"] == 1:
                await asyncio.sleep(30)
            return {"answer": calls["n"]}, []
        server = WireServer(flaky)
        port = await server.start()
        events = []
        client = WireClient("127.0.0.1", port, deadline=0.2, retries=2,
                            backoff0=0.01,
                            trace=lambda ev, d: events.append(ev))
        header, _ = await client.call("work")
        await client.close()
        await server.close()
        return header, events

    header, events = run(scenario())
    assert header["answer"] == 2
    assert events == ["expired", "backoff", "retry"]


def test_remote_error_is_not_retried():
    async def scenario():
        async def reject(op, header, planes):
            raise ValueError("bad spec")
        server = WireServer(reject)
        port = await server.start()
        events = []
        client = WireClient("127.0.0.1", port, retries=3,
                            trace=lambda ev, d: events.append(ev))
        with pytest.raises(RemoteError, match="bad spec"):
            await client.call("work")
        await client.close()
        await server.close()
        return events

    assert run(scenario()) == []


def test_heartbeat_declares_loss_after_miss_limit():
    """The reference's order: the server closes first, its client still
    connected (the reference hangs in that close here)."""
    async def scenario():
        async def pong(op, header, planes):
            return {"beat": True}, []
        server = WireServer(pong)
        port = await server.start()
        client = WireClient("127.0.0.1", port)
        lost = []
        hb = Heartbeater(client, interval=0.02, miss_limit=3,
                         on_loss=lost.append)
        task = asyncio.ensure_future(hb.run())
        await asyncio.sleep(0.1)
        beats_before = hb.beats
        await asyncio.wait_for(server.close(), 5)
        await client.close()
        await asyncio.wait_for(task, timeout=5)
        return beats_before, hb.misses, lost

    beats, misses, lost = run(scenario())
    assert beats >= 2
    assert misses == 3 and len(lost) == 1


def test_server_close_returns_with_a_client_connected():
    """The port's deviation from the reference: ``close`` ends the live
    connections, then waits (under a bound) — within 2 s here, and the
    client sees its connection end."""
    async def scenario():
        async def pong(op, header, planes):
            return {"pong": True}, []
        server = WireServer(pong)
        port = await server.start()
        client = WireClient("127.0.0.1", port, retries=0, deadline=2.0)
        await client.call("ping")
        t0 = time.monotonic()
        await asyncio.wait_for(server.close(), 10)
        dt = time.monotonic() - t0
        with pytest.raises(ConnectionError):
            await client.call("ping")
        await client.close()
        return dt, server._writers, server._conn_tasks

    dt, writers, tasks = run(scenario())
    assert dt < 2.0
    assert not writers and not tasks


def test_host_stop_returns_with_a_front_door_connected(store_path):
    """``HostServer.stop`` with a front door's heartbeat and deliver
    connection still open: within 2 s, and the front door evicts it."""
    h = make_host(store_path)
    p = h.start()
    with ClusterFrontDoor(heartbeat_interval=0.05, miss_limit=2) as fd:
        key = fd.add_host("127.0.0.1", p)
        t0 = time.monotonic()
        h.stop()
        dt = time.monotonic() - t0
        deadline = time.monotonic() + 10
        while not fd.evicted and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fd.evicted == [key]
    assert dt < 2.0


# ---------------------------------------------------------------------------
# Serializable stats + portable specs
# ---------------------------------------------------------------------------
def test_iostats_dict_roundtrip_and_merge():
    a = IOStats(bytes_read=100, reads=3, max_reads_inflight=4)
    b = IOStats.from_dict(a.to_dict())
    assert b.bytes_read == 100 and b.reads == 3 and b.max_reads_inflight == 4
    b.merge({"bytes_read": 50, "max_reads_inflight": 2, "unknown_key": 9})
    assert b.bytes_read == 150
    assert b.max_reads_inflight == 4
    merged = IOStats().merge(a).merge(a)
    assert merged.reads == 6 and merged.max_reads_inflight == 4


def test_session_spec_wire_roundtrip():
    spec = SessionSpec.pagerank(64, np.zeros(64, np.uint8), damping=0.9,
                                tenant_id="t1")
    header, planes = spec.to_wire()
    rheader, rplanes = decode_frame(encode_frame({"spec": header}, planes))
    back = SessionSpec.from_wire(rheader["spec"], rplanes)
    assert back.kind == "pagerank" and back.tenant_id == "t1"
    assert back.params["damping"] == 0.9
    np.testing.assert_array_equal(back.arrays["dangling_mask"],
                                  spec.arrays["dangling_mask"])
    session = back.build()
    assert session.tenant_id == "t1" and session.width == 1


def test_spgemm_spec_wire_roundtrip(tmp_path):
    out = str(tmp_path / "prod")
    spec = SessionSpec.spgemm(out, b="/data/b-store", budget_bytes=1 << 20,
                              tile_rows_per_pass=4, tenant_id="g1")
    header, planes = spec.to_wire()
    assert planes == []
    rheader, rplanes = decode_frame(encode_frame({"spec": header}, planes))
    back = SessionSpec.from_wire(rheader["spec"], rplanes)
    assert back.kind == "spgemm" and back.tenant_id == "g1"
    assert back.params["out"] == out and back.params["b"] == "/data/b-store"
    assert back.params["budget_bytes"] == 1 << 20
    session = back.build()
    assert session.out_path == out and not session.done
    theader, tplanes = SessionSpec.triangle_count(tenant_id="g2").to_wire()
    rh, rp = decode_frame(encode_frame({"spec": theader}, tplanes))
    tri = SessionSpec.from_wire(rh["spec"], rp)
    assert tri.kind == "triangle_count" and tri.build().mode == "triangle"


def test_session_spec_rejects_unknown_kind_and_plane_mismatch():
    with pytest.raises(ValueError, match="unknown session kind"):
        SessionSpec("exec_arbitrary_code").build()
    with pytest.raises(ValueError, match="mismatch"):
        SessionSpec.from_wire({"kind": "multiply", "arrays": ["x"]}, [])


# ---------------------------------------------------------------------------
# Fleet loss manifest
# ---------------------------------------------------------------------------
class _PoisonSession(Session):
    """Consumes its first product by raising — kills the serving wave."""

    def __init__(self, n, tenant_id):
        super().__init__(tenant_id)
        self._x = np.ones((n, 1), np.float32)

    def x_columns(self):
        return self._x

    def consume(self, y):
        raise RuntimeError("poisoned tenant")


def test_wave_error_names_lost_sessions(store_path):
    fleet = cpu_fleet([store_path])
    n = fleet.replicas.n_cols
    fleet.submit(_PoisonSession(n, "poison"))
    fleet.submit(MultiplyRequest(np.ones(n, np.float32),
                                 tenant_id="bystander"))
    with pytest.raises(WaveError) as ei:
        fleet.drain(timeout=60)
    assert "poison" in ei.value.session_ids
    assert "poison" in str(ei.value)
    assert ei.value.wave_id == 0
    fleet.close()


def test_fleet_stats_gauges(store_path):
    with cpu_fleet([store_path], waves=2) as fleet:
        n = fleet.replicas.n_cols
        fleet.submit(MultiplyRequest(np.ones(n, np.float32), tenant_id="a"))
        fleet.drain(timeout=60)
        stats = fleet.stats()
    assert stats["n_waves"] == 2
    assert stats["backlog_cols"] == 0 and stats["pending_sessions"] == 0
    assert stats["scan_passes"] >= 1
    assert stats["io_stats"]["bytes_read"] > 0
    assert stats == __import__("json").loads(__import__("json").dumps(stats))


# ---------------------------------------------------------------------------
# The cluster
# ---------------------------------------------------------------------------
def _stop(*hosts):
    for h in hosts:
        h.stop()


def test_two_host_cluster_serves_mixed_batch_bit_identical(store_path,
                                                           small_graph):
    specs = mixed_specs(small_graph, n_multiply=3)
    want = lone_fleet_results(store_path, specs)
    h1, h2 = make_host(store_path), make_host(store_path)
    p1, p2 = h1.start(), h2.start()
    try:
        with ClusterFrontDoor(heartbeat_interval=0.1) as fd:
            fd.add_host("127.0.0.1", p1)
            fd.add_host("127.0.0.1", p2)
            tickets = [fd.submit(s) for s in specs]
            results = fd.drain(tickets, timeout=120)
            assert len({t.host_key for t in tickets}) == 2
            deadline = time.monotonic() + 10
            while (fd.cluster_io_stats().bytes_read == 0
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert fd.cluster_io_stats().bytes_read > 0
            fd.shutdown_hosts()
    finally:
        _stop(h1, h2)
    for got, exp in zip(results, want):
        np.testing.assert_array_equal(got, exp.result)


def test_kill_host_mid_pass_failover_bit_identical(store_path, small_graph):
    """The reference fails this one here (its killed host keeps answering
    heartbeats over open connections); the port evicts exactly the killed
    host and every tenant gets the lone fleet's bits."""
    specs = mixed_specs(small_graph, n_multiply=3)
    want = lone_fleet_results(store_path, specs)
    h1, h2 = make_host(store_path), make_host(store_path)
    p1, p2 = h1.start(), h2.start()
    try:
        with ClusterFrontDoor(heartbeat_interval=0.1, miss_limit=2) as fd:
            k1 = fd.add_host("127.0.0.1", p1)
            fd.add_host("127.0.0.1", p2)
            tickets = [fd.submit(s) for s in specs]
            h1._loop.call_soon_threadsafe(h1._shutdown.set)
            results = fd.drain(tickets, timeout=120)
            assert fd.evicted == [k1]
            assert sum(t.resubmits for t in tickets) >= 1
            assert all(t.host_key != k1 for t in tickets if t.resubmits)
            fd.shutdown_hosts()
    finally:
        _stop(h1, h2)
    for got, exp in zip(results, want):
        np.testing.assert_array_equal(got, exp.result)


def test_front_door_budget_arbitration(store_path, small_graph):
    budget = 64 * 1024 * 1024
    h1 = make_host(store_path)
    p1 = h1.start()
    try:
        with ClusterFrontDoor(memory_budget_bytes=budget,
                              heartbeat_interval=0.1) as fd:
            fd.add_host("127.0.0.1", p1)
            rng = np.random.default_rng(5)
            t = fd.submit(SessionSpec.multiply(
                rng.standard_normal(small_graph.n_rows).astype(np.float32),
                tenant_id="b0"))
            fd.drain([t], timeout=60)
            deadline = time.monotonic() + 10
            while (h1.fleet.replicas.cfg.memory_budget_bytes != budget
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert h1.fleet.replicas.cfg.memory_budget_bytes == budget
            fd.shutdown_hosts()
    finally:
        h1.stop()


# ---------------------------------------------------------------------------
# Partitioned cross-host queries
# ---------------------------------------------------------------------------
def test_slab_scoped_spec_wire_roundtrip():
    spec = SessionSpec.multiply(np.ones((8, 2), np.float32),
                                tenant_id="t").with_slab(1, 4)
    header, planes = spec.to_wire()
    rheader, rplanes = decode_frame(encode_frame({"spec": header}, planes))
    back = SessionSpec.from_wire(rheader["spec"], rplanes)
    assert (back.slab, back.n_slabs) == (1, 4)
    plain_header, _ = SessionSpec.multiply(np.ones(4, np.float32)).to_wire()
    assert "slab" not in plain_header and "n_slabs" not in plain_header


def partitioned_specs(small_graph):
    rng = np.random.default_rng(77)
    n = small_graph.n_rows
    return [
        SessionSpec.multiply(rng.standard_normal((n, 4)).astype(np.float32),
                             tenant_id="wide"),
        SessionSpec.power_iteration(
            rng.standard_normal(n).astype(np.float32), tol=0.0, max_iter=8,
            tenant_id="ppow"),
        SessionSpec.pagerank(n, dangling_vertices(small_graph), max_iter=10,
                             tenant_id="ppr"),
    ]


def test_partitioned_query_bit_identical_to_single_host(store_path,
                                                        small_graph):
    specs = partitioned_specs(small_graph)
    want = lone_fleet_results(store_path, specs)
    h1, h2 = make_host(store_path), make_host(store_path)
    p1, p2 = h1.start(), h2.start()
    try:
        with ClusterFrontDoor(heartbeat_interval=0.1) as fd:
            fd.add_host("127.0.0.1", p1)
            fd.add_host("127.0.0.1", p2)
            tickets = [fd.submit(s, partitioned=True) for s in specs]
            results = fd.drain(tickets, timeout=120)
            assert all(t.plan is not None and t.plan.n_slabs == 2
                       for t in tickets)
            assert fd.stats()["partitioned_inflight"] == 0
            # the slab executors run where the fleet's do
            assert [ex.device.type for h in (h1, h2)
                    for rs in h._slabs.values() for ex in rs.execs] == \
                ["cpu", "cpu"]
            fd.shutdown_hosts()
    finally:
        _stop(h1, h2)
    assert h1.slab_scans > 0 and h2.slab_scans > 0
    for got, t, exp in zip(results, tickets, want):
        np.testing.assert_array_equal(got, exp.result)
        assert t.iterations == exp.iterations


class _SlowStore(TileStore):
    """TileStore whose raw reads dawdle, so a mid-query host kill lands
    while slab scans are genuinely in flight."""

    delay_per_batch = 0.03

    def read_batch_raw(self, start, count):
        time.sleep(self.delay_per_batch)
        return super().read_batch_raw(start, count)


def test_partitioned_failover_reassigns_lost_slab(store_path, small_graph):
    """The reference fails this one here; on the port the killed slab host
    is evicted, only its slab is reassigned, and the query and the
    whole-query tenants it held finish with the lone fleet's bits."""
    rng = np.random.default_rng(99)
    n = small_graph.n_rows
    specs = [
        SessionSpec.pagerank(n, dangling_vertices(small_graph), max_iter=30,
                             tenant_id="ppr"),
        SessionSpec.multiply(rng.standard_normal(n).astype(np.float32),
                             tenant_id="whole0"),
        SessionSpec.multiply(rng.standard_normal(n).astype(np.float32),
                             tenant_id="whole1"),
    ]
    want = lone_fleet_results(store_path, specs)

    def slow_host():
        st = _SlowStore(store_path, TileStore.open(store_path).header)
        return HostServer(cpu_fleet([st]))

    h1, h2 = slow_host(), slow_host()
    p1, p2 = h1.start(), h2.start()
    try:
        with ClusterFrontDoor(heartbeat_interval=0.1, miss_limit=2) as fd:
            fd.add_host("127.0.0.1", p1)
            k2 = fd.add_host("127.0.0.1", p2)
            part = fd.submit(specs[0], partitioned=True)
            whole = [fd.submit(s) for s in specs[1:]]
            deadline = time.monotonic() + 30
            while h2.slab_scans < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert h2.slab_scans >= 2 and not part.done
            h2._loop.call_soon_threadsafe(h2._shutdown.set)
            results = fd.drain([part] + whole, timeout=120)
            assert fd.evicted == [k2]
            assert part.resubmits >= 1
            assert part.plan.reassignments >= 1
            assert all(t.host_key != k2 for t in whole if t.resubmits)
            fd.shutdown_hosts()
    finally:
        _stop(h1, h2)
    for got, exp in zip(results, want):
        np.testing.assert_array_equal(got, exp.result)


# ---------------------------------------------------------------------------
# Wire auth
# ---------------------------------------------------------------------------
def test_wire_auth_rejects_before_parsing_and_admits_matching_token():
    async def scenario():
        async def pong(op, header, planes):
            return {"pong": True}, []
        server = WireServer(pong, auth_token="sesame")
        port = await server.start()
        good = WireClient("127.0.0.1", port, auth_token="sesame", retries=0)
        header, _ = await good.call("ping")
        assert header["pong"]
        outcomes = []
        for token in (None, "wrong"):
            bad = WireClient("127.0.0.1", port, auth_token=token,
                             retries=0, deadline=2.0)
            with pytest.raises(ConnectionError):
                await bad.call("ping")
            outcomes.append(True)
            await bad.close()
        rejected = server.rejected_connections
        await good.close()
        await server.close()
        return outcomes, rejected

    outcomes, rejected = run(scenario())
    assert outcomes == [True, True] and rejected == 2


def test_cluster_auth_token_end_to_end(store_path, small_graph):
    h = HostServer(cpu_fleet([store_path]), auth_token="s3cret")
    p = h.start()
    try:
        with ClusterFrontDoor(heartbeat_interval=0.1, auth_token="s3cret") \
                as fd:
            fd.add_host("127.0.0.1", p)
            x = np.ones(small_graph.n_rows, np.float32)
            t = fd.submit(SessionSpec.multiply(x, tenant_id="a"))
            (res,) = fd.drain([t], timeout=60)
            assert res is not None and res.shape == x.shape
        with ClusterFrontDoor(heartbeat_interval=0.1, retries=0,
                              deadline=2.0) as fd2:
            with pytest.raises(ConnectionError):
                fd2.add_host("127.0.0.1", p)
        assert h._wire.rejected_connections >= 1
    finally:
        h.stop()


# ---------------------------------------------------------------------------
# Across packages: the same bytes on the wire
# ---------------------------------------------------------------------------
FRAMES = {
    "dtypes": ({"op": "x", "k": [1, 2], "s": "αβ", "f": 0.25},
               [np.arange(12, dtype=np.float32).reshape(3, 4),
                np.array([1, -1, 7], np.int64),
                np.arange(6, dtype=np.float64).reshape(2, 3) / 7,
                np.array([0, 1, 255], np.uint8),
                np.array([[1, -2]], np.int32),
                np.array([True, False]),
                np.arange(4, dtype=np.float16)]),
    "zero-d and empty": ({"op": "y", "nested": {"a": [None, True]}},
                         [np.array(3.5, np.float32),
                          np.zeros((0, 5), np.float32),
                          np.zeros(0, np.int64)]),
    "no planes": ({"op": "z"}, []),
    "strided": ({"op": "t"},
                [np.arange(20, dtype=np.float32).reshape(4, 5).T,
                 np.arange(10, dtype=np.int64)[::3]]),
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frames_byte_identical_and_decoded_both_ways(case):
    header, planes = FRAMES[case]
    mine = encode_frame(header, planes)
    theirs = ref_wire.encode_frame(header, planes)
    assert mine == theirs
    for buf, decode in ((theirs, decode_frame), (mine, ref_wire.decode_frame)):
        h, out = decode(buf)
        assert h == header
        assert [p.dtype for p in out] == [np.asarray(p).dtype
                                          for p in planes]
        for a, b in zip(planes, out):
            np.testing.assert_array_equal(a, b)
    assert wire.MAGIC == ref_wire.MAGIC and wire.AUTH_MAGIC == \
        ref_wire.AUTH_MAGIC


async def _client_bytes(wire_mod, token, header, planes):
    """The bytes ``wire_mod``'s client puts on the socket for one call
    (the auth preamble included), answered by a raw recorder."""
    got = bytearray()

    async def record(reader, writer):
        if token is not None:
            got.extend(await reader.readexactly(36))
        prefix = await reader.readexactly(16)
        body = await reader.readexactly(struct.unpack("<IIQ", prefix)[2])
        got.extend(prefix + body)
        rid = decode_frame(prefix + body)[0]["_id"]
        writer.write(encode_frame({"_id": rid, "ok": True}))
        await writer.drain()
        writer.close()

    server = await asyncio.start_server(record, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    client = wire_mod.WireClient("127.0.0.1", port, auth_token=token,
                                 retries=0, deadline=5.0)
    await client.call("submit", header, planes)
    await client.close()
    server.close()
    return bytes(got)


async def _server_bytes(wire_mod, token, request):
    """The bytes ``wire_mod``'s server answers ``request`` (one raw frame,
    after the preamble when ``token`` is set) with."""
    async def echo(op, header, planes):
        return ({"op": op, "seen": sorted(header)},
                [np.asarray(p) * 2 for p in planes])
    server = wire_mod.WireServer(echo, auth_token=token)
    port = await server.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    if token is not None:
        writer.write(wire._AUTH.pack(wire.AUTH_MAGIC,
                                     wire._token_digest(token)))
    writer.write(request)
    await writer.drain()
    prefix = await reader.readexactly(16)
    body = await reader.readexactly(struct.unpack("<IIQ", prefix)[2])
    writer.close()
    await asyncio.wait_for(server.close(), 5)
    return prefix + body


@pytest.mark.parametrize("token", [None, "s3cret"])
def test_requests_and_replies_byte_identical_with_and_without_auth(token):
    header, planes = FRAMES["dtypes"]
    ours = run(_client_bytes(wire, token, header, planes))
    theirs = run(_client_bytes(ref_wire, token, header, planes))
    assert ours == theirs
    if token is not None:
        assert ours[:36] == ref_wire._AUTH.pack(
            ref_wire.AUTH_MAGIC, ref_wire._token_digest(token))
    request = ours[36 if token is not None else 0:]
    replies = [run(_server_bytes(m, token, request))
               for m in (wire, ref_wire)]
    assert replies[0] == replies[1]
    h, out = ref_wire.decode_frame(replies[0])
    assert h["ok"] and h["op"] == "submit" and h["_id"] == 1
    np.testing.assert_array_equal(out[0], planes[0] * 2)


# ---------------------------------------------------------------------------
# Across packages: mixed clusters on integer data
# ---------------------------------------------------------------------------
def int_specs(spec_cls, n):
    """Integer operands (exact sums) and a BFS over the binary store."""
    r = np.random.default_rng(41)
    xs = [r.integers(-3, 4, n).astype(np.float32) for _ in range(3)]
    xs.append(r.integers(-3, 4, (n, 3)).astype(np.float32))
    specs = [spec_cls.multiply(x, tenant_id=f"m{i}")
             for i, x in enumerate(xs)]
    specs.append(spec_cls.bfs(np.array([0]), n, tenant_id="bfs"))
    return specs


def ref_lone_fleet(path, n):
    with RefFleet(RefReplicaSet([RefTileStore.open(path)]),
                  n_waves=1) as fleet:
        tickets = [fleet.submit(s) for s in int_specs(RefSpec, n)]
        fleet.drain(timeout=120)
    return [t.result for t in tickets]


@pytest.fixture(scope="module")
def ref_want(bin_path, small_graph):
    return ref_lone_fleet(bin_path, small_graph.n_rows)


def _hosts(kinds, path):
    return [make_host(path) if k == "port" else ref_host(path)
            for k in kinds]


@pytest.mark.parametrize("door,kinds", [("ref", ("port", "port")),
                                        ("port", ("ref", "ref")),
                                        ("port", ("ref", "port"))])
def test_mixed_cluster_serves_reference_bits(bin_path, small_graph, ref_want,
                                             door, kinds):
    hosts = _hosts(kinds, bin_path)
    ports = [h.start() for h in hosts]
    Door, Spec = ((RefFrontDoor, RefSpec) if door == "ref"
                  else (ClusterFrontDoor, SessionSpec))
    fd = Door(heartbeat_interval=0.1)
    try:
        keys = [fd.add_host("127.0.0.1", p) for p in ports]
        tickets = [fd.submit(s) for s in int_specs(Spec, small_graph.n_rows)]
        results = fd.drain(tickets, timeout=60)
        assert {t.host_key for t in tickets} == set(keys)
    finally:
        fd.close()                   # before a reference host stops
        _stop(*hosts)
    for got, exp in zip(results, ref_want):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("door", ["ref", "port"])
def test_partitioned_query_across_packages(bin_path, small_graph, ref_want,
                                           door):
    """One reference host and one port host each scan a slab; the stitched
    product (a one-shot multiply and an iterative BFS) has the reference
    lone fleet's bits."""
    hosts = _hosts(("ref", "port"), bin_path)
    ports = [h.start() for h in hosts]
    Door, Spec = ((RefFrontDoor, RefSpec) if door == "ref"
                  else (ClusterFrontDoor, SessionSpec))
    specs = int_specs(Spec, small_graph.n_rows)
    fd = Door(heartbeat_interval=0.1)
    try:
        for p in ports:
            fd.add_host("127.0.0.1", p)
        tickets = [fd.submit(specs[i], partitioned=True) for i in (3, 4)]
        results = fd.drain(tickets, timeout=60)
        assert all(t.plan.n_slabs == 2 for t in tickets)
    finally:
        fd.close()
        _stop(*hosts)
    assert all(h.slab_scans > 0 for h in hosts)
    for got, exp in zip(results, [ref_want[3], ref_want[4]]):
        np.testing.assert_array_equal(got, exp)


# ---------------------------------------------------------------------------
# The CLI and the device rule
# ---------------------------------------------------------------------------
def _first_line(stream, out: queue.Queue):
    out.put(stream.readline())


def test_host_cli_needs_a_card_unless_told_cpu(bin_path, small_graph,
                                               ref_want):
    """Without a card and without ``--device`` the CLI fails with
    ``resolve_device``'s error (no quiet move to the CPU); with
    ``--device cpu`` it serves a query over the wire and exits 0 on the
    ``shutdown`` RPC."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.net.host", "--store",
           bin_path, "--waves", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=60)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    proc = subprocess.Popen(cmd + ["--device", "cpu"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=_first_line, args=(proc.stdout, lines),
                         daemon=True).start()
        line = lines.get(timeout=60)
        assert line.startswith("LISTENING "), (line, proc.stderr)
        with ClusterFrontDoor(heartbeat_interval=0.1) as fd:
            fd.add_host("127.0.0.1", int(line.split()[1]))
            spec = int_specs(SessionSpec, small_graph.n_rows)[3]
            (got,) = fd.drain([fd.submit(spec)], timeout=60)
            np.testing.assert_array_equal(got, ref_want[3])
            fd.shutdown_hosts()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_build_host_places_executors(bin_path, monkeypatch):
    """``build_host`` puts the executors on the devices it is given; with
    none it takes the card, and raises where there is none."""
    h = build_host([bin_path, bin_path], waves=1, devices=["cpu"])
    try:
        assert [ex.device.type for ex in h.fleet.replicas.execs] == \
            ["cpu", "cpu"]
    finally:
        h.stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_host([bin_path], waves=1)
