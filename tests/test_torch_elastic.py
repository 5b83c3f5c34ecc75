"""The port's elastic waves and replica routing on the CPU, mirroring
``tests/test_elastic.py``: mid-pass admission (against between-pass
admission and a dedicated multiply), the accumulator kept across an
elastic run, the boundary clock, rolling iterative sessions, slack
readmission, exactly-once delivery, the elastic wave over a sharded scan
(threads, ``devices=["cpu"]``), replica sets, failover mid-run and
routing.

Every executor runs on the CPU, where the port's plain step is
deterministic: the reference's bit-identity claims hold bit for bit on
float operands.  ``test_midpass_admission_bit_identical_on_pallas`` runs
the reference's elastic wave over its Pallas gather kernel in interpret
mode against the port's default step on integer-valued data, bit for bit.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.sem import SEMConfig as RefConfig
from repro.core.sem import SEMSpMM as RefSEM
from repro.io.storage import TileStore as RefTileStore
from repro.runtime import PowerIterationSession as RefPower
from repro.runtime import SharedScanScheduler as RefScheduler
from repro_torch.core import sem as sem_mod
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.distributed.shard_scan import ShardedSEMSpMM
from repro_torch.io.storage import TileStore, validate_replicas
from repro_torch.runtime import (MultiplyRequest, PowerIterationSession,
                                 ReplicaSet, SharedScanScheduler)

BATCH = 16


@pytest.fixture(scope="module")
def store_path(small_valued, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("telastic") / "g")
    RefTileStore.write(path, ref_to_chunked(small_valued, T=512, C=128))
    return path


@pytest.fixture(scope="module")
def replica_paths(store_path, tmp_path_factory):
    """Three byte-identical copies of the store (per-SSD paths)."""
    root = tmp_path_factory.mktemp("treplicas")
    paths = [store_path]
    for i in (1, 2):
        p = str(root / f"copy{i}")
        shutil.copy(store_path + ".bin", p + ".bin")
        shutil.copy(store_path + ".json", p + ".json")
        paths.append(p)
    return paths


def fresh_sem(store_path, **cfg):
    return SEMSpMM(TileStore.open(store_path),
                   SEMConfig(chunk_batch=BATCH, **cfg), device="cpu")


def replica_set(paths):
    return ReplicaSet(TileStore.open_replicas(paths),
                      SEMConfig(chunk_batch=BATCH),
                      devices=["cpu"] * len(paths))


def one_shot_probe(x, at_clock):
    """A boundary probe that submits ``x`` once the global boundary clock
    reaches ``at_clock`` — the deterministic mid-pass arrival."""
    box = {"req": None}

    def probe(sched, boundary):
        if box["req"] is None and sched.boundary_clock >= at_clock:
            box["req"] = sched.query(x, tenant_id="midpass")
    return probe, box


def serve_midpass(store_path, x, *, elastic, at_clock=4, sem=None,
                  **sched_kw):
    """One long-running tenant keeps passes flowing; ``x`` arrives mid-pass
    via the probe.  Returns (request, scheduler)."""
    rng = np.random.default_rng(11)
    probe, box = one_shot_probe(x, at_clock)
    sem = sem or fresh_sem(store_path)
    sched = SharedScanScheduler(sem, use_cache=False, elastic=elastic,
                                boundary_probe=probe, **sched_kw)
    sched.submit(PowerIterationSession(
        rng.standard_normal(sem.n_cols).astype(np.float32), tol=0.0,
        max_iter=4))
    sched.run()
    return box["req"], sched


# ---------------------------------------------------------------------------
# Mid-pass admission
# ---------------------------------------------------------------------------
def test_midpass_admission_bit_identical(store_path, small_valued):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    want = fresh_sem(store_path).multiply(x[:, None])[:, 0]
    req, sched = serve_midpass(store_path, x, elastic=True)
    assert req is not None and req.done
    np.testing.assert_array_equal(req.result, want)
    assert sum(r.admitted_midpass for r in sched.reports) == 1
    assert sum(r.completed_midpass for r in sched.reports) == 1


def test_midpass_beats_between_pass_on_the_boundary_clock(store_path,
                                                          small_valued):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    req_e, _ = serve_midpass(store_path, x, elastic=True)
    req_c, _ = serve_midpass(store_path, x, elastic=False)
    assert req_e.submit_clock == req_c.submit_clock
    np.testing.assert_array_equal(req_e.result, req_c.result)
    assert req_e.first_result_clock < req_c.first_result_clock


def test_midpass_widening_reuses_accumulator_and_one_step_a_batch(
        store_path, small_valued, monkeypatch):
    """The reference asserts that a mid-pass widening compiles no second
    jit entry.  What the card cares about instead: the whole elastic run,
    mid-pass admission included, applies each batch in one step (one K1a
    launch on the card; here the wrapper's plain version), and every pass
    refills one accumulator in place: no allocation per pass or per
    admission."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    steps = {"n": 0}
    real = sem_mod.spmm_kernel_batch

    def counting(*a, **kw):
        steps["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(sem_mod, "spmm_kernel_batch", counting)
    sem = fresh_sem(store_path)
    accs = []
    real_multiply = sem._multiply

    def tracking(*a, **kw):
        out = real_multiply(*a, **kw)
        accs.append(out[1].data_ptr())
        return out
    sem._multiply = tracking
    req, sched = serve_midpass(store_path, x, elastic=True, capacity=7,
                               sem=sem)
    assert req.done
    assert sum(r.admitted_midpass for r in sched.reports) == 1
    passes = sched.total_scan_passes()
    assert passes == len(accs) == 4
    assert steps["n"] == passes * sem.n_batches
    assert len(set(accs)) == 1 and sem._acc.shape[2] == 7


def test_rolling_iterative_session_matches_plain_run(store_path,
                                                     small_valued):
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal(small_valued.n_cols).astype(np.float32)

    def run(elastic):
        box = {"s": None}

        def probe(sched, boundary):
            if box["s"] is None and sched.boundary_clock >= 5:
                box["s"] = sched.submit(PowerIterationSession(
                    x0.copy(), tol=0.0, max_iter=3, tenant_id="rolling"))
        sem = fresh_sem(store_path)
        sched = SharedScanScheduler(sem, use_cache=False, elastic=elastic,
                                    boundary_probe=probe)
        sched.submit(PowerIterationSession(
            np.ones(sem.n_cols, np.float32), tol=0.0, max_iter=6))
        sched.run()
        return box["s"]

    rolled, plain = run(True), run(False)
    assert rolled.done and plain.done
    assert rolled.iterations == plain.iterations
    assert rolled.residuals == plain.residuals
    assert rolled.eigenvalue == plain.eigenvalue
    np.testing.assert_array_equal(rolled.result, plain.result)


@pytest.fixture(scope="module")
def int_store_path(small_graph, tmp_path_factory):
    vals = np.random.default_rng(31).integers(-3, 4, small_graph.nnz)
    path = str(tmp_path_factory.mktemp("telastic_int") / "g")
    RefTileStore.write(path, ref_to_chunked(
        small_graph.with_values(vals.astype(np.float32)), T=512, C=128))
    return path


def test_midpass_admission_bit_identical_on_pallas(int_store_path,
                                                   small_graph):
    """The reference's elastic wave over its Pallas gather kernel (interpret
    mode) against the port's default step: a tenant admitted inside the
    in-flight pass gets the same bits on the same boundary clock, and the
    pass reports agree.  Integer-valued store and operand: every sum is
    exact in any order."""
    n = small_graph.n_cols
    x = np.random.default_rng(3).integers(-3, 4, n).astype(np.float32)
    x0 = np.random.default_rng(11).integers(-3, 4, n).astype(np.float32)

    def run(sched_cls, power_cls, sem):
        box = {"req": None}

        def probe(sched, boundary):
            if box["req"] is None and sched.boundary_clock >= 4:
                box["req"] = sched.query(x, tenant_id="midpass")
        sched = sched_cls(sem, use_cache=False, elastic=True,
                          boundary_probe=probe)
        sched.submit(power_cls(x0, tol=0.0, max_iter=2))
        sched.run()
        return box["req"], sched

    ref_req, ref_sched = run(RefScheduler, RefPower, RefSEM(
        RefTileStore.open(int_store_path), RefConfig(
            chunk_batch=BATCH, use_pallas=True, pallas_variant="gather")))
    req, sched = run(SharedScanScheduler, PowerIterationSession,
                     fresh_sem(int_store_path))
    want = fresh_sem(int_store_path).multiply(x[:, None])[:, 0]
    assert req.done and ref_req.done
    np.testing.assert_array_equal(req.result, want)
    np.testing.assert_array_equal(req.result, ref_req.result)
    assert req.first_result_clock == ref_req.first_result_clock
    for a, b in zip(sched.reports, ref_sched.reports):
        assert (a.admitted_midpass, a.completed_midpass, a.bytes_read,
                a.capacity, a.tenants) == (
            b.admitted_midpass, b.completed_midpass, b.bytes_read,
            b.capacity, b.tenants)
    assert sum(r.admitted_midpass for r in sched.reports) == 1
    assert sum(r.completed_midpass for r in sched.reports) == 1


def test_elastic_without_arrivals_matches_classic(store_path, small_valued):
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(small_valued.n_cols).astype(np.float32)
          for _ in range(5)]

    def run(elastic):
        sched = SharedScanScheduler(fresh_sem(store_path), use_cache=False,
                                    elastic=elastic)
        reqs = [sched.query(x, tenant_id=str(i)) for i, x in enumerate(xs)]
        sched.run()
        return reqs

    for a, b in zip(run(True), run(False)):
        assert a.done and b.done
        np.testing.assert_array_equal(a.result, b.result)


def test_elastic_freed_slack_readmits_next_request(store_path, small_valued):
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal(small_valued.n_cols).astype(np.float32)
          for _ in range(3)]
    box = {"i": 0, "reqs": []}

    def probe(sched, boundary):
        if box["i"] < len(xs) and sched.boundary_clock >= 6 * (box["i"] + 1):
            box["reqs"].append(sched.query(xs[box["i"]],
                                           tenant_id=f"q{box['i']}"))
            box["i"] += 1

    sem = fresh_sem(store_path)
    sched = SharedScanScheduler(sem, use_cache=False, elastic=True,
                                capacity=2, boundary_probe=probe)
    sched.submit(PowerIterationSession(np.ones(sem.n_cols, np.float32),
                                       tol=0.0, max_iter=8))
    sched.run()
    dedicated = fresh_sem(store_path)
    assert len(box["reqs"]) == 3
    for x, r in zip(xs, box["reqs"]):
        assert r.done
        np.testing.assert_array_equal(r.result,
                                      dedicated.multiply(x[:, None])[:, 0])
    assert sum(r.admitted_midpass for r in sched.reports) >= 2


@pytest.mark.parametrize("inject_clock_offset", [0, -1])
def test_pass_end_completion_delivers_exactly_once(store_path, small_valued,
                                                   inject_clock_offset):
    rng = np.random.default_rng(14)
    x0 = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    n_batches = fresh_sem(store_path).n_batches

    def run(elastic):
        at = n_batches + 1 if inject_clock_offset == 0 else n_batches
        box = {"s": None}

        def probe(sched, boundary):
            if box["s"] is None and sched.boundary_clock >= at:
                box["s"] = sched.submit(PowerIterationSession(
                    x0.copy(), tol=0.0, max_iter=3))
        sem = fresh_sem(store_path)
        sched = SharedScanScheduler(sem, use_cache=False, elastic=elastic,
                                    boundary_probe=probe)
        sched.submit(PowerIterationSession(
            np.ones(sem.n_cols, np.float32), tol=0.0, max_iter=6))
        sched.run()
        return box["s"]

    rolled, plain = run(True), run(False)
    assert rolled.done and plain.done
    assert rolled.iterations == plain.iterations == 3
    assert 0.0 not in rolled.residuals  # the double-consume fingerprint
    assert rolled.residuals == plain.residuals
    np.testing.assert_array_equal(rolled.result, plain.result)


def test_classic_fallback_pass_frees_elastic_slots(store_path, small_valued):
    n = small_valued.n_cols
    sem = fresh_sem(store_path)
    sched = SharedScanScheduler(sem, use_cache=False, elastic=True,
                                capacity=4)
    wide = sched.submit(MultiplyRequest(np.ones((n, 6), np.float32)))
    sched.run()          # oversized head alone -> classic sliced pass
    assert wide.done and not sched._slots
    reqs = [sched.query(np.ones(n, np.float32), tenant_id=str(i))
            for i in range(4)]
    sched.run()
    assert all(r.done for r in reqs)
    assert sched.reports[-1].wave_cols == 4 and not sched._slots


def test_elastic_composes_with_sharded(store_path, small_valued):
    """Mid-pass admission rides the coordinator shard of a sharded scan
    (two shards as threads on the CPU: they take the engine's device)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    want = fresh_sem(store_path).multiply(x[:, None])[:, 0]
    req_s, sched_s = serve_midpass(store_path, x, elastic=True, at_clock=2,
                                   sharded=2)
    req_u, _ = serve_midpass(store_path, x, elastic=True, at_clock=2)
    assert {ex.device.type for ex in sched_s.sharded.execs} == {"cpu"}
    sched_s.close()
    assert req_s is not None and req_s.done
    np.testing.assert_array_equal(req_s.result, want)
    np.testing.assert_array_equal(req_s.result, req_u.result)
    assert sum(r.admitted_midpass for r in sched_s.reports) == 1
    assert sum(r.completed_midpass for r in sched_s.reports) == 1


def test_elastic_sharded_rolling_iterative_session(store_path, small_valued):
    rng = np.random.default_rng(22)
    x0 = rng.standard_normal(small_valued.n_cols).astype(np.float32)

    def run(elastic, sharded):
        box = {"s": None}

        def probe(sched, boundary):
            if box["s"] is None and sched.boundary_clock >= 2:
                box["s"] = sched.submit(PowerIterationSession(
                    x0.copy(), tol=0.0, max_iter=3, tenant_id="rolling"))
        sem = fresh_sem(store_path)
        with SharedScanScheduler(sem, use_cache=False, elastic=elastic,
                                 sharded=sharded,
                                 boundary_probe=probe) as sched:
            sched.submit(PowerIterationSession(
                np.ones(sem.n_cols, np.float32), tol=0.0, max_iter=6))
            sched.run()
        return box["s"]

    rolled, plain = run(True, 2), run(False, 0)
    assert rolled.done and plain.done
    assert rolled.iterations == plain.iterations
    assert rolled.residuals == plain.residuals
    np.testing.assert_array_equal(rolled.result, plain.result)


def test_partial_pass_row_accounting(store_path):
    sem = fresh_sem(store_path)
    sched = SharedScanScheduler(sem, use_cache=False, elastic=True)
    sched._row_starts()
    trow = sem.store.chunk_tile_rows()
    n_tile_rows = -(-sem.n_rows // sem.T)
    assert sched._tr_of(0) == 0
    assert sched._tr_of(len(trow)) == n_tile_rows
    for cs in range(1, len(trow)):
        tr = sched._tr_of(cs)
        assert np.all(np.nonzero(trow >= tr)[0] >= cs)
        assert np.any(np.nonzero(trow == trow[cs - 1])[0] < cs)


# ---------------------------------------------------------------------------
# Replica routing
# ---------------------------------------------------------------------------
def test_replica_set_bit_identical(replica_paths, small_valued, store_path):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((small_valued.n_cols, 4)).astype(np.float32)
    want = fresh_sem(store_path).multiply(x)
    rs = replica_set(replica_paths)
    np.testing.assert_array_equal(rs.multiply(x), want)
    assert rs.passes == 1


def test_replica_set_devices_default_to_the_card(replica_paths,
                                                 monkeypatch):
    """No devices named: every copy's executor asks for the card, as a
    lone SEMSpMM does, and raises without one (no quiet move to the
    CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaSet(TileStore.open_replicas(replica_paths[:2]))
    rs = replica_set(replica_paths[:2])
    assert [ex.device.type for ex in rs.execs] == ["cpu", "cpu"]


def test_replica_failure_fallback_mid_run(replica_paths, small_valued,
                                          store_path):
    """A replica dying mid-scan is routed around with identical bits; the
    read's OSError reaches the router as it was raised (through the
    prefetch thread), and the failed executor is reusable: once restored
    and routed to, it serves the same bits again."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((small_valued.n_cols, 2)).astype(np.float32)
    want = fresh_sem(store_path).multiply(x)
    rs = replica_set(replica_paths)
    victim = rs.router.ranked()[0]
    calls = {"n": 0}
    real = rs.execs[victim].store.read_batch_raw

    def dying(start, count):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("replica removed mid-run")
        return real(start, count)

    rs.execs[victim].store.read_batch_raw = dying
    np.testing.assert_array_equal(rs.multiply(x), want)
    st = rs.router.states[victim]
    assert not st.healthy and st.failures == 1
    assert st.last_error == repr(OSError("replica removed mid-run"))
    assert victim not in rs.router.ranked()
    np.testing.assert_array_equal(rs.multiply(x), want)  # keeps serving
    assert calls["n"] == 3  # the dead replica was never touched again
    rs.router.restore(victim)
    assert victim in rs.router.ranked()
    # repaired: route a pass to it alone
    rs.execs[victim].store.read_batch_raw = real
    for rid in range(rs.n_replicas):
        if rid != victim:
            rs.router.fail(rid, OSError("drained for the check"))
    scans = st.scans
    np.testing.assert_array_equal(rs.multiply(x), want)
    assert st.scans == scans + 1


def test_replica_routing_prefers_fast_idle_copies(replica_paths):
    rs = replica_set(replica_paths)
    nb = rs.store.nbytes
    rs.router.complete(0, nb, 1.0)
    rs.router.complete(1, nb, 0.25)
    rs.router.complete(2, nb, 0.5)
    assert rs.router.ranked() == [1, 2, 0]
    rs.router.begin(1)
    rs.router.begin(1)
    assert rs.router.ranked()[0] == 2
    rs.router.end(1)
    rs.router.end(1)


def test_router_first_touch_measures_every_replica(replica_paths,
                                                   small_valued, store_path):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((small_valued.n_cols, 2)).astype(np.float32)
    want = fresh_sem(store_path).multiply(x)
    rs = replica_set(replica_paths)
    for _ in range(len(rs.execs)):
        np.testing.assert_array_equal(rs.multiply(x), want)
    assert all(s.scans == 1 and s.ewma_bps > 0 for s in rs.router.states)


def test_sharded_scheduler_over_replica_set_uses_copies(replica_paths,
                                                        small_valued,
                                                        store_path):
    rng = np.random.default_rng(16)
    x = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    want = fresh_sem(store_path).multiply(x[:, None])[:, 0]
    rs = replica_set(replica_paths)
    with SharedScanScheduler(rs, use_cache=False, sharded=3) as sched:
        assert {s.path for s in sched.sharded.shards} == set(replica_paths)
        assert {ex.device.type for ex in sched.sharded.execs} == {"cpu"}
        req = sched.query(x)
        sched.run()
    np.testing.assert_array_equal(req.result, want)


def test_boundary_clock_ticks_through_sliced_scans(store_path, small_valued):
    n = small_valued.n_cols
    sem = fresh_sem(store_path)
    sem.cfg.memory_budget_bytes = (sem.stream_overhead_bytes()
                                   + 3 * sem.column_bytes()
                                   + sem.column_bytes() // 2)
    seen = []
    sched = SharedScanScheduler(sem, use_cache=False,
                                boundary_probe=lambda s, b: seen.append(1))
    req = sched.submit(MultiplyRequest(np.ones((n, 7), np.float32)))
    rep = sched.run_pass()
    assert rep.scan_passes == 3                      # ceil(7/3) slices
    assert sched.boundary_clock == 3 * sem.n_batches == len(seen)
    assert req.first_result_clock == sched.boundary_clock
    np.testing.assert_array_equal(
        req.result, fresh_sem(store_path).multiply(np.ones((n, 7),
                                                           np.float32)))


def test_replica_validation_rejects_mismatch(replica_paths, small_graph,
                                             tmp_path):
    other_path = str(tmp_path / "other")
    RefTileStore.write(other_path, ref_to_chunked(small_graph, T=512, C=128),
                       binary=True)
    with pytest.raises(ValueError, match="header"):
        TileStore.open_replicas([replica_paths[0], other_path])
    validate_replicas(TileStore.open_replicas(replica_paths))


def test_scheduler_over_replica_set(replica_paths, small_valued, store_path):
    rng = np.random.default_rng(12)
    x = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    want = fresh_sem(store_path).multiply(x[:, None])[:, 0]
    probe, box = one_shot_probe(x, at_clock=4)
    rs = replica_set(replica_paths)
    sched = SharedScanScheduler(rs, use_cache=False, elastic=True,
                                boundary_probe=probe)
    sched.submit(PowerIterationSession(
        rng.standard_normal(rs.n_cols).astype(np.float32), tol=0.0,
        max_iter=4))
    sched.run()
    req = box["req"]
    assert req is not None and req.done
    np.testing.assert_array_equal(req.result, want)
    assert sum(r.completed_midpass for r in sched.reports) == 1


def test_sharded_scan_over_replicas_bit_identical(replica_paths, small_valued,
                                                  store_path):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((small_valued.n_cols, 3)).astype(np.float32)
    want = fresh_sem(store_path).multiply(x)
    stores = TileStore.open_replicas(replica_paths)
    with ShardedSEMSpMM(stores[0], n_shards=4,
                        config=SEMConfig(chunk_batch=BATCH),
                        devices=["cpu"], replicas=stores[1:]) as sh:
        np.testing.assert_array_equal(sh.multiply(x), want)
        assert {s.path for s in sh.shards} == set(replica_paths)
        assert sh.io_stats.bytes_read == stores[0].nbytes
