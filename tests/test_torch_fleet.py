"""The port's serving fleet and the runtime's protocols on the CPU,
mirroring ``tests/test_fleet.py`` (a fleet of N waves against one
scheduler bit for bit, dispatcher routing, budget arbitration, shared
in-flight accounting, shutdown), the ``scheduler`` and ``fleet`` cases of
``tests/test_api.py`` (the Executor, Mutable and Submitter protocols,
tickets) and ``tests/test_mutable.py``'s fleet under churn.

Every executor runs on the CPU (``devices=["cpu", ...]``), where the plain
step is deterministic, so the reference's bit-identity claims hold bit for
bit on float operands; the waves are threads, as on the card.
``test_api.py``'s ``frontdoor`` cases run here too, over the port's
``net/``: a ``ClusterFrontDoor`` in front of one ``HostServer`` on the CPU
(the rest of the cross-host tier is in ``tests/test_torch_net.py``).
"""
import json
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import to_chunked as ref_to_chunked
from repro.io.storage import TileStore as RefTileStore
from repro.runtime import ServingFleet as RefFleet
from repro.runtime import ReplicaSet as RefReplicaSet
from repro.core.sem import SEMConfig as RefConfig
from repro.runtime import PowerIterationSession as RefPower
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.distributed.shard_scan import ShardedSEMSpMM
from repro_torch.io.storage import IOStats, TileStore, UpdateBatch
from repro_torch.net import ClusterFrontDoor, HostServer
from repro_torch.runtime import (Executor, MultiplyRequest, Mutable,
                                 PowerIterationSession, ReplicaSet,
                                 ServingFleet, SessionSpec,
                                 SharedScanScheduler, Submitter,
                                 SubmitterClosed, Ticket)

BATCH = 16


@pytest.fixture(scope="module")
def store_path(small_valued, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tfleet") / "g")
    RefTileStore.write(path, ref_to_chunked(small_valued, T=512, C=128))
    return path


@pytest.fixture(scope="module")
def replica_paths(store_path, tmp_path_factory):
    root = tmp_path_factory.mktemp("tfleet_replicas")
    paths = [store_path]
    for i in (1, 2):
        p = str(root / f"copy{i}")
        shutil.copy(store_path + ".bin", p + ".bin")
        shutil.copy(store_path + ".json", p + ".json")
        paths.append(p)
    return paths


def fresh_sem(store_path, batch=BATCH):
    return SEMSpMM(TileStore.open(store_path), SEMConfig(chunk_batch=batch),
                   device="cpu")


def replica_set(paths, n=2, stores=None, batch=BATCH):
    stores = stores or TileStore.open_replicas(paths[:n])
    return ReplicaSet(stores, SEMConfig(chunk_batch=batch),
                      devices=["cpu"] * len(stores))


def tenant_mix(n_cols, rng):
    xs = [rng.standard_normal(n_cols).astype(np.float32) for _ in range(6)]
    x0s = [rng.standard_normal(n_cols).astype(np.float32) for _ in range(3)]
    return xs, x0s


# ---------------------------------------------------------------------------
# Bit-identity: a fleet-of-N serves the same bits as one scheduler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_waves", [2, 3])
def test_fleet_bit_identical_to_single_scheduler(replica_paths, store_path,
                                                 small_valued, n_waves):
    rng = np.random.default_rng(3)
    xs, x0s = tenant_mix(small_valued.n_cols, rng)
    with SharedScanScheduler(fresh_sem(store_path), use_cache=False) as lone:
        lone_reqs = [lone.query(x, tenant_id=f"q{i}")
                     for i, x in enumerate(xs)]
        lone_pis = [lone.submit(PowerIterationSession(
            x0.copy(), tol=0.0, max_iter=4)) for x0 in x0s]
        lone.run()
    with ServingFleet(replica_set(replica_paths, n=3), n_waves=n_waves,
                      use_cache=False) as fleet:
        reqs = [fleet.query(x, tenant_id=f"q{i}") for i, x in enumerate(xs)]
        pis = [fleet.submit(PowerIterationSession(
            x0.copy(), tol=0.0, max_iter=4)) for x0 in x0s]
        fleet.drain(timeout=120)
        for lr, fr in zip(lone_reqs, reqs):
            assert fr.done
            np.testing.assert_array_equal(fr.result, lr.result)
        for lp, fp in zip(lone_pis, pis):
            assert fp.done and fp.iterations == lp.iterations
            assert fp.residuals == lp.residuals
            assert fp.eigenvalue == lp.eigenvalue
            np.testing.assert_array_equal(fp.result, lp.result)


def test_fleet_matches_reference_fleet_on_integer_operands(replica_paths,
                                                           small_graph,
                                                           tmp_path):
    """The port's fleet against the JAX package's fleet on an
    integer-valued store: the same one-shot bits, the same power-iteration
    passes (RTOL 1e-5 on its float iterate), the same bytes over the
    fleet."""
    vals = np.random.default_rng(31).integers(-3, 4, small_graph.nnz)
    path = str(tmp_path / "int")
    RefTileStore.write(path, ref_to_chunked(
        small_graph.with_values(vals.astype(np.float32)), T=512, C=128))
    n = small_graph.n_cols
    r = np.random.default_rng(4)
    xs = [r.integers(-3, 4, n).astype(np.float32) for _ in range(4)]
    x0 = r.integers(-3, 4, n).astype(np.float32)
    runs = []
    for fleet_cls, rs, power in (
            (ServingFleet, replica_set([path, path]), PowerIterationSession),
            (RefFleet, RefReplicaSet([path, path], RefConfig(
                chunk_batch=BATCH)), RefPower)):
        with fleet_cls(rs, n_waves=2, use_cache=False) as fleet:
            reqs = [fleet.query(x, tenant_id=f"q{i}")
                    for i, x in enumerate(xs)]
            pi = fleet.submit(power(x0, tol=0.0, max_iter=3))
            fleet.drain(timeout=120)
            runs.append((reqs, pi, fleet.total_scan_passes(),
                         fleet.io_stats.bytes_read))
    (reqs, pi, passes, nbytes), (rreqs, rpi, rpasses, rbytes) = runs
    for a, b in zip(reqs, rreqs):
        np.testing.assert_array_equal(a.result, b.result)
    assert pi.iterations == rpi.iterations == 3
    np.testing.assert_allclose(pi.result, rpi.result, rtol=1e-5, atol=1e-6)
    assert passes == rpasses and nbytes == rbytes


def test_fleet_with_cache_bit_identical(replica_paths, store_path,
                                        small_valued):
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    with SharedScanScheduler(fresh_sem(store_path), use_cache=False) as lone:
        want = lone.submit(PowerIterationSession(x0.copy(), tol=0.0,
                                                 max_iter=5))
        lone.run()
    with ServingFleet(replica_set(replica_paths), n_waves=2,
                      use_cache=True) as fleet:
        pis = [fleet.submit(PowerIterationSession(
            x0.copy(), tol=0.0, max_iter=5)) for _ in range(2)]
        fleet.drain(timeout=120)
        assert fleet.cache.stats.hits > 0
        for p in pis:
            assert p.done
            assert p.residuals == want.residuals
            np.testing.assert_array_equal(p.result, want.result)


# ---------------------------------------------------------------------------
# Dispatcher routing
# ---------------------------------------------------------------------------
def test_dispatcher_routes_around_skewed_load(replica_paths, small_valued):
    rng = np.random.default_rng(5)
    n = small_valued.n_cols
    with ServingFleet(replica_set(replica_paths), n_waves=2,
                      use_cache=False) as fleet:
        heavy = fleet.submit(PowerIterationSession(
            rng.standard_normal(n).astype(np.float32), tol=0.0, max_iter=30))
        deadline = time.monotonic() + 60
        while fleet.waves[heavy.wave_id].ewma_pass_s == 0.0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        burst = [fleet.query(rng.standard_normal(n).astype(np.float32),
                             tenant_id=f"b{i}") for i in range(3)]
        assert all(b.wave_id != heavy.wave_id for b in burst)
        fleet.drain(timeout=120)
        assert heavy.done and all(b.done for b in burst)


def test_dispatcher_spreads_a_cold_burst(replica_paths, small_valued):
    rng = np.random.default_rng(6)
    n = small_valued.n_cols
    with ServingFleet(replica_set(replica_paths), n_waves=2,
                      use_cache=False) as fleet:
        reqs = [fleet.query(rng.standard_normal(n).astype(np.float32))
                for _ in range(4)]
        assert sorted({r.wave_id for r in reqs}) == [0, 1]
        fleet.drain(timeout=120)


# ---------------------------------------------------------------------------
# Cross-wave budget arbitration
# ---------------------------------------------------------------------------
def test_column_budget_sliced_per_wave(replica_paths, small_valued):
    rs = replica_set(replica_paths)
    fit8 = (rs.stream_overhead_bytes() + rs.column_bytes() * 8
            + rs.column_bytes() // 2)
    rs.cfg.memory_budget_bytes = fit8
    with ServingFleet(rs, n_waves=2, use_cache=False) as fleet:
        assert rs.columns_that_fit(64) == 8
        for w in fleet.waves:
            assert w.executor.columns_that_fit(64) == 4


def test_cache_slices_rebalance_after_wave_drains(replica_paths,
                                                  small_valued):
    class SlowStore(TileStore):
        """Slow passes: both waves' early passes reliably overlap."""
        def read_batch_raw(self, start, count):
            time.sleep(0.003)
            return super().read_batch_raw(start, count)

    stores = [SlowStore(p, TileStore.open(p).header)
              for p in replica_paths[:2]]
    rs = replica_set(None, stores=stores)
    rng = np.random.default_rng(7)
    n = small_valued.n_cols
    with ServingFleet(rs, n_waves=2, use_cache=True, capacity=2) as fleet:
        long_s = fleet.submit(PowerIterationSession(
            rng.standard_normal(n).astype(np.float32), tol=0.0, max_iter=16))
        short_s = fleet.submit(PowerIterationSession(
            rng.standard_normal(n).astype(np.float32), tol=0.0, max_iter=2))
        assert long_s.wave_id != short_s.wave_id
        fleet.drain(timeout=120)
        assert long_s.done and short_s.done
        long_wave = fleet.waves[long_s.wave_id]
        budgets = [r.cache_budget for r in long_wave.scheduler.reports]
        assert budgets[-1] > min(budgets[:4]) * 1.5, budgets
        deadline = time.monotonic() + 5
        drained_slice = fleet.cache.shard(short_s.wave_id)
        while drained_slice.budget_bytes and time.monotonic() < deadline:
            time.sleep(0.02)
        assert drained_slice.budget_bytes == 0
        assert drained_slice.pinned_bytes == 0


def test_arbiter_splits_leftover_across_busy_waves(replica_paths):
    rs = replica_set(replica_paths)
    with ServingFleet(rs, n_waves=2, use_cache=False) as fleet:
        fleet._wave_leftover(0, 4)
        both = fleet._wave_leftover(1, 4)
        assert both == rs.leftover_budget(8) // 2
        fleet._set_wave_cols(0, 0)
        assert fleet._wave_leftover(1, 4) == rs.leftover_budget(4)


# ---------------------------------------------------------------------------
# Shared in-flight accounting, and one executor shared by two threads
# ---------------------------------------------------------------------------
def test_inflight_read_accounting_is_shared_and_thread_safe(store_path):
    class SlowStore(TileStore):
        def read_batch_raw(self, start, count):
            self.stats.begin_read()
            try:
                time.sleep(0.15)
            finally:
                self.stats.end_read()
            return super().read_batch_raw(start, count)

    st = SlowStore(store_path, TileStore.open(store_path).header)
    barrier = threading.Barrier(2)

    def scan():
        barrier.wait()
        st.read_batch_raw(0, 4)

    threads = [threading.Thread(target=scan) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert st.stats.max_reads_inflight == 2
    assert st.stats.reads_inflight == 0
    assert st.stats.reads == 2
    assert st.stats.bytes_read == 2 * 4 * st.header["record"]


def test_one_executor_serves_two_threads_in_turn(store_path, small_valued):
    """Waves routed to one replica share its executor: passes take turns
    on its accumulator and staging, and each gets its own product."""
    sem = fresh_sem(store_path)
    rng = np.random.default_rng(17)
    xs = [rng.standard_normal((small_valued.n_cols, 2)).astype(np.float32)
          for _ in range(8)]
    want = [fresh_sem(store_path).multiply(x) for x in xs]
    got = [None] * len(xs)

    def work(i):
        got[i] = sem.multiply(xs[i])
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sem.passes == len(xs)


def test_iostats_aggregate_maxes_highwater_and_sums_counters():
    a, b = IOStats(), IOStats()
    a.add_read(10), b.add_read(30)
    a.max_reads_inflight, b.max_reads_inflight = 3, 2
    a.reads_inflight, b.reads_inflight = 1, 1
    agg = IOStats.aggregate([a, b])
    assert agg.bytes_read == 40 and agg.reads == 2
    assert agg.max_reads_inflight == 3
    assert agg.reads_inflight == 2


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------
def test_clean_shutdown_with_wave_midpass(replica_paths, small_valued):
    class CrawlStore(TileStore):
        def read_batch_raw(self, start, count):
            time.sleep(0.02)
            return super().read_batch_raw(start, count)

    stores = [CrawlStore(p, TileStore.open(p).header)
              for p in replica_paths[:2]]
    rs = replica_set(None, stores=stores)
    rng = np.random.default_rng(8)
    n = small_valued.n_cols
    fleet = ServingFleet(rs, n_waves=2, use_cache=False)
    sessions = [fleet.submit(PowerIterationSession(
        rng.standard_normal(n).astype(np.float32), tol=0.0, max_iter=50))
        for _ in range(2)]
    deadline = time.monotonic() + 10
    while not any(w.in_pass for w in fleet.waves):
        assert time.monotonic() < deadline
        time.sleep(0.005)
    t0 = time.monotonic()
    fleet.close()
    assert time.monotonic() - t0 < 30
    assert all(not w.thread.is_alive() for w in fleet.waves)
    assert not all(s.done for s in sessions)
    fleet.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fleet.query(np.ones(n, np.float32))


def test_drain_surfaces_wave_failure(replica_paths, small_valued):
    rs = replica_set(replica_paths, n=2)
    for ex in rs.execs:
        ex.store.read_batch_raw = lambda s, c: (_ for _ in ()).throw(
            OSError("spindle gone"))
    fleet = ServingFleet(rs, n_waves=2, use_cache=False)
    try:
        fleet.submit(PowerIterationSession(
            np.ones(small_valued.n_cols, np.float32), tol=0.0, max_iter=3))
        with pytest.raises(RuntimeError, match="wave"):
            fleet.drain(timeout=60)
    finally:
        fleet.close()


def test_fleet_of_one_degenerates_to_single_scheduler(replica_paths,
                                                      store_path,
                                                      small_valued):
    rng = np.random.default_rng(9)
    x = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    want = fresh_sem(store_path).multiply(x[:, None])[:, 0]
    with ServingFleet(replica_set(replica_paths), n_waves=1,
                      use_cache=False) as fleet:
        r = fleet.query(x)
        fleet.drain(timeout=60)
        np.testing.assert_array_equal(r.result, want)
        assert r.wave_id == 0
    with pytest.raises(ValueError, match="at least one wave"):
        ServingFleet(replica_set(replica_paths), n_waves=0)


# ---------------------------------------------------------------------------
# The Executor protocol (tests/test_api.py)
# ---------------------------------------------------------------------------
EXECUTORS = ["sem", "sharded", "replica"]


def build_executor(kind, path):
    cfg = SEMConfig(chunk_batch=64)
    if kind == "sem":
        return SEMSpMM(TileStore.open(path), cfg, device="cpu")
    if kind == "sharded":
        return ShardedSEMSpMM(TileStore.open(path), n_shards=2, config=cfg,
                              devices=["cpu"])
    return ReplicaSet([TileStore.open(path), TileStore.open(path)],
                      config=cfg, devices=["cpu", "cpu"])


@pytest.fixture(params=EXECUTORS)
def executor(request, store_path):
    ex = build_executor(request.param, store_path)
    yield ex
    ex.close()


def test_executor_protocol_surface(executor, small_valued):
    assert isinstance(executor, Executor)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((small_valued.n_cols, 1)).astype(np.float32)
    y = np.asarray(executor.multiply(x))
    assert y.shape == (small_valued.n_rows, 1)
    np.testing.assert_array_equal(np.asarray(executor.multiply(x, cache=None)),
                                  y)
    assert executor.column_bytes() > 0
    assert executor.io_stats.bytes_read > 0


def test_executors_bit_identical(store_path, small_valued):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((small_valued.n_cols, 2)).astype(np.float32)
    outs = {}
    for kind in EXECUTORS:
        with build_executor(kind, store_path) as ex:
            outs[kind] = np.asarray(ex.multiply(x))
    for kind in EXECUTORS[1:]:
        np.testing.assert_array_equal(outs[kind], outs["sem"])


def test_executor_column_bytes_uniform(store_path):
    vals = set()
    for kind in EXECUTORS:
        with build_executor(kind, store_path) as ex:
            vals.add(ex.column_bytes())
    assert len(vals) == 1


def test_executor_mutable_protocol(executor):
    assert isinstance(executor, Mutable)
    assert executor.version == 0
    assert executor.apply_updates(
        UpdateBatch.insert(np.array([0]), np.array([0]))) == 1
    assert executor.version == 1


def test_executor_close_idempotent_and_context_managed(store_path):
    for kind in EXECUTORS:
        ex = build_executor(kind, store_path)
        with ex as entered:
            assert entered is ex
        ex.close()


def test_ticket_wait_timeout_callbacks_and_error():
    spec = SessionSpec.multiply(np.ones(4, np.float32), tenant_id="t")
    t = Ticket(spec=spec)
    assert t.tenant_id == "t" and not t.done
    with pytest.raises(TimeoutError):
        t.wait(timeout=0.01)
    seen = []
    t.add_done_callback(seen.append)
    t.result = np.arange(3)
    t._complete()
    t._complete()                           # completion is one-shot
    assert seen == [t] and t.done
    t.add_done_callback(seen.append)        # late callback fires immediately
    assert seen == [t, t]
    np.testing.assert_array_equal(t.wait(timeout=1), np.arange(3))
    bad = Ticket(spec=spec)
    bad.error = ValueError("rejected")
    bad._complete()
    with pytest.raises(ValueError, match="rejected"):
        bad.wait(timeout=1)


# ---------------------------------------------------------------------------
# The Submitter protocol (tests/test_api.py's scheduler and fleet cases)
# ---------------------------------------------------------------------------
SUBMITTERS = ["scheduler", "fleet", "frontdoor"]


def make_submitter(kind, path):
    if kind == "scheduler":
        sched = SharedScanScheduler(
            SEMSpMM(TileStore.open(path), SEMConfig(chunk_batch=64),
                    device="cpu"), use_cache=False)
        return sched, sched.close
    fleet = ServingFleet(replica_set([path], n=1, batch=64), n_waves=1)
    if kind == "fleet":
        return fleet, fleet.close
    host = HostServer(fleet)
    port = host.start()
    fd = ClusterFrontDoor(heartbeat_interval=0.1)
    fd.add_host("127.0.0.1", port)

    def cleanup():
        try:
            fd.close()
        finally:
            host.stop()
    return fd, cleanup


@pytest.fixture(params=SUBMITTERS)
def submitter(request, store_path):
    sub, cleanup = make_submitter(request.param, store_path)
    yield sub
    cleanup()


def test_submitter_protocol_spec_in_ticket_out(submitter, store_path,
                                               small_valued):
    assert isinstance(submitter, Submitter)
    rng = np.random.default_rng(11)
    n = small_valued.n_cols
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    tickets = [submitter.submit(SessionSpec.multiply(x, tenant_id=f"t{i}"))
               for i, x in enumerate(xs)]
    assert all(isinstance(t, Ticket) for t in tickets)
    submitter.drain(timeout=120)
    with fresh_sem(store_path, batch=64) as sem:
        for i, (t, x) in enumerate(zip(tickets, xs)):
            assert t.done and t.tenant_id == f"t{i}" and t.iterations == 1
            np.testing.assert_array_equal(t.result,
                                          sem.multiply(x[:, None])[:, 0])


def test_submitter_deliver_streams_completions(submitter, small_valued):
    rng = np.random.default_rng(12)
    n = small_valued.n_cols
    ids = {f"d{i}" for i in range(3)}
    for i in range(3):
        submitter.submit(SessionSpec.multiply(
            rng.standard_normal(n).astype(np.float32), tenant_id=f"d{i}"))
    got = set()
    while len(got) < 3:
        t = submitter.deliver(timeout=60)
        assert t is not None and t.done
        got.add(t.tenant_id)
    assert got == ids


def test_submitter_stats_json_safe_with_common_gauges(submitter,
                                                      small_valued):
    submitter.submit(SessionSpec.multiply(
        np.ones(small_valued.n_cols, np.float32), tenant_id="s"))
    submitter.drain(timeout=120)
    # the front door's gauges are heartbeat-fed, so the drained state may
    # trail the drain by a beat
    deadline = time.monotonic() + 10
    while True:
        stats = submitter.stats()
        if (stats["backlog_cols"] == 0 and stats["pending_sessions"] == 0) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert stats == json.loads(json.dumps(stats))
    assert stats["backlog_cols"] == 0
    assert stats["pending_sessions"] == 0
    assert stats["io_stats"]["bytes_read"] >= 0


def test_submitter_serves_spgemm_sessions(submitter, store_path, tmp_path):
    from repro_torch.core.spgemm import materialize_dense, spgemm
    out = str(tmp_path / "tenant-product")
    ticket = submitter.submit(SessionSpec.spgemm(
        out, budget_bytes=1 << 20, tenant_id="g0"))
    assert ticket.spec.params["out"] == out
    submitter.drain(timeout=120)
    assert ticket.done and ticket.error is None
    summary = np.asarray(ticket.result)
    with TileStore.open(store_path) as a:
        direct, stats = spgemm(a, None, str(tmp_path / "direct"),
                               partial_budget_bytes=1 << 20)
    assert int(summary[2]) == stats.product_nnz
    with TileStore.open(out) as got:
        np.testing.assert_array_equal(materialize_dense(got),
                                      materialize_dense(direct))
    direct.close()


def test_submitter_close_idempotent_then_submit_raises(store_path,
                                                       small_valued):
    spec = SessionSpec.multiply(np.ones(small_valued.n_cols, np.float32))
    for kind in SUBMITTERS:
        sub, cleanup = make_submitter(kind, store_path)
        try:
            sub.close()
            sub.close()
            with pytest.raises(SubmitterClosed):
                sub.submit(spec)
        finally:
            cleanup()


def test_legacy_session_submit_shims_still_work(store_path, small_valued):
    x = np.ones(small_valued.n_cols, np.float32)
    with fresh_sem(store_path, batch=64) as sem:
        want = sem.multiply(x[:, None])[:, 0]
    sched = SharedScanScheduler(fresh_sem(store_path, batch=64),
                                use_cache=False)
    req = sched.submit(MultiplyRequest(x, tenant_id="legacy"))
    assert isinstance(req, MultiplyRequest)
    sched.run()
    sched.close()
    np.testing.assert_array_equal(req.result, want)
    with ServingFleet(replica_set([store_path], n=1, batch=64),
                      n_waves=1) as fleet:
        sess = fleet.submit(MultiplyRequest(x, tenant_id="legacy2"))
        fleet.drain(timeout=60)
    np.testing.assert_array_equal(sess.result, want)


def test_partition_row_bounds_cover_and_match_shards(store_path):
    st = TileStore.open(store_path)
    n_tile_rows = -(-st.header["n_rows"] // st.header["T"])
    for k in (1, 2, 3, n_tile_rows + 5):
        bounds = st.partition_row_bounds(k)
        assert 1 <= len(bounds) <= min(k, n_tile_rows)
        assert bounds[0][0] == 0 and bounds[-1][1] == n_tile_rows
        for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
            assert a1 == b0 and a0 < a1
        shards = st.partition_rows(k)
        assert len(shards) == len(bounds)
        assert sum(s.n_chunks for s in shards) == st.n_chunks
    assert (TileStore.open(store_path).partition_row_bounds(3)
            == st.partition_row_bounds(3))


# ---------------------------------------------------------------------------
# Mutable graphs under the fleet (tests/test_mutable.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mut_path(tmp_path_factory):
    from repro.sparse.generate import rmat
    g = rmat(10, 8, seed=9)
    vals = np.random.default_rng(2).integers(1, 5, g.nnz).astype(np.float32)
    path = str(tmp_path_factory.mktemp("tfmut") / "g")
    RefTileStore.write(path, ref_to_chunked(g.with_values(vals), T=256,
                                            C=64))
    return path


def test_mutable_protocol_conformance(mut_path):
    st = TileStore.open(mut_path)
    sem = SEMSpMM(st, SEMConfig(chunk_batch=16), device="cpu")
    rs = replica_set([mut_path], n=1)
    fleet = ServingFleet(replica_set([mut_path], n=1), n_waves=1)
    try:
        for impl in (sem, rs, fleet):
            assert isinstance(impl, Mutable)
            assert impl.version == 0
    finally:
        fleet.close()
        rs.close()
        st.close()


def test_fleet_serves_under_churn_with_compaction(mut_path):
    rs = replica_set([mut_path], n=1)
    n = rs.n_rows
    x = np.round(np.random.default_rng(12).standard_normal((n, 1)) * 4
                 ).astype(np.float32)
    r = np.random.default_rng(100)
    with ServingFleet(rs, n_waves=2, compact_ratio=0.02) as fleet:
        base_nnz = rs.store.nnz()
        for i in range(5):
            m = max(1, base_nnz // 50)
            fleet.apply_updates(UpdateBatch.insert(
                r.integers(0, n, m), r.integers(0, n, m)))
            fleet.submit(SessionSpec.multiply(x, tenant_id=f"c{i}"))
        fleet.drain(timeout=120)
        y_overlay = fleet.submit(SessionSpec.multiply(
            x, tenant_id="last")).wait(timeout=60)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            fleet.submit(SessionSpec.multiply(x, tenant_id="p")).wait(60)
            h = rs.store.handle
            if rs.store.generation >= 1 and h.delta_nnz == 0 \
                    and not h.compacting:
                break
            time.sleep(0.02)
        assert rs.store.generation >= 1
        y_post = fleet.submit(SessionSpec.multiply(
            x, tenant_id="post")).wait(timeout=60)
        np.testing.assert_array_equal(y_overlay, y_post)
        gauges = fleet.stats()
        assert gauges["version"] == 5 and gauges["delta_nnz"] == 0
