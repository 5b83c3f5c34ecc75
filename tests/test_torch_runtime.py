"""The port's serving runtime (``repro_torch.runtime``) on the CPU: the
shared-scan scheduler, its sessions and the hot-chunk cache, against the
port's own dedicated runs and against the JAX package's runtime.

It mirrors ``tests/test_runtime.py`` case for case, over the port's engine
(``SEMSpMM(device="cpu")``), where the plain step is deterministic, so the
reference's bit-identity claims (shared scan against per-request runs,
cached against uncached) hold bit for bit on float operands too.

The cross-check runs first: the JAX package's ``SharedScanScheduler`` is
duck-typed over executors, so it runs over the port's engine too.  Over the
port's engine it must give the port scheduler's results bit for bit, and
the reference engine's on integer-valued operands, with every
``PassReport`` counter equal.  Float sessions (power iteration, PageRank)
differ from the reference engine's by float32 rounding of the sums' order:
they are held to ``RTOL``/``ATOL`` there, the tolerance
``tests/test_torch_apps.py`` holds the port's PageRank to.

It also carries the scheduler cases of ``tests/test_mutable.py``
(compaction at a pass boundary, SSSP sessions, mixed ring and plus waves).
"""
import dataclasses
import time
from collections import defaultdict, deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.sem import SEMConfig as RefConfig
from repro.core.sem import SEMSpMM as RefSEM
from repro.io.storage import TileStore as RefTileStore
from repro.runtime import BFSSession as RefBFS
from repro.runtime import MultiplyRequest as RefMultiply
from repro.runtime import PowerIterationSession as RefPower
from repro.runtime import SharedScanScheduler as RefScheduler
from repro.runtime import SSSPSession as RefSSSP
from repro.sparse.generate import sbm
from repro_torch.apps.common import SEMOperator
from repro_torch.apps.labelprop import (build_operator as lp_operator,
                                        labelprop_dense_reference,
                                        labelprop_session)
from repro_torch.apps.pagerank import (build_operator as pr_operator,
                                       dangling_vertices, pagerank,
                                       pagerank_session)
from repro_torch.convert import coo_from_arrays
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.io.storage import TileStore, UpdateBatch
from repro_torch.runtime import (Batcher, BFSSession, HotChunkCache,
                                 MultiplyRequest, PartitionedHotChunkCache,
                                 PowerIterationSession, SharedScanScheduler,
                                 SSSPSession)

BATCH = 64
RTOL, ATOL = 1e-5, 1e-8


def port_coo(g):
    return coo_from_arrays(g.n_rows, g.n_cols, g.rows, g.cols,
                           None if g.vals is None else np.asarray(g.vals))


@pytest.fixture(scope="module")
def store_path(small_valued, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trt") / "g")
    RefTileStore.write(path, ref_to_chunked(small_valued, T=512, C=128))
    return path


@pytest.fixture(scope="module")
def int_paths(small_graph, tmp_path_factory):
    """Integer weights in [-3, 3] (every sum exact in float32, in any
    order) and the binary pattern, for the cross-check with the reference
    engine."""
    vals = np.random.default_rng(31).integers(-3, 4, small_graph.nnz)
    d = tmp_path_factory.mktemp("trt_int")
    RefTileStore.write(str(d / "int"), ref_to_chunked(
        small_graph.with_values(vals.astype(np.float32)), T=512, C=128))
    RefTileStore.write(str(d / "bin"), ref_to_chunked(small_graph, T=512,
                                                      C=128), binary=True)
    return {"int": str(d / "int"), "bin": str(d / "bin")}


def fresh_sem(path, **cfg):
    """Independent store handle -> independent I/O stats."""
    return SEMSpMM(TileStore.open(path), SEMConfig(chunk_batch=BATCH, **cfg),
                   device="cpu")


def fresh_ref(path, **cfg):
    return RefSEM(RefTileStore.open(path), RefConfig(chunk_batch=BATCH,
                                                     **cfg))


def budget_for_cols(sem, cols: int) -> int:
    """A memory budget that admits exactly ``cols`` dense columns."""
    return (sem.stream_overhead_bytes() + sem.column_bytes() * cols
            + sem.column_bytes() // 2)


# ---------------------------------------------------------------------------
# Cross-check: the reference scheduler over the port's engine
# ---------------------------------------------------------------------------
def int_vectors(n, count, seed, width=1):
    r = np.random.default_rng(seed)
    return [r.integers(-3, 4, (n, width)).astype(np.float32)
            for _ in range(count)]


def serve_mix(sched_cls, sem, classes, scenario, n):
    """One tenant mix through one scheduler; returns (sessions, scheduler).
    ``classes`` = (MultiplyRequest, PowerIterationSession, BFSSession,
    SSSPSession) of the scheduler's own package."""
    mul, power, bfs, sssp = classes
    kw = dict(use_cache=scenario != "budget", elastic=scenario == "elastic")
    if scenario == "budget":
        sem.cfg.memory_budget_bytes = budget_for_cols(sem, 4)
    late = int_vectors(n, 1, 9)[0]
    box = []
    if scenario == "elastic":
        def probe(sched, b):
            if not box and sched.boundary_clock >= 3:
                box.append(sched.submit(mul(late, tenant_id="late")))
        kw["boundary_probe"] = probe
    sched = sched_cls(sem, **kw)
    sessions = [sched.submit(mul(x, tenant_id=f"q{i}"))
                for i, x in enumerate(int_vectors(n, 6, 5))]
    sessions.append(sched.submit(mul(int_vectors(n, 1, 6, 3)[0])))
    sessions.append(sched.submit(power(int_vectors(n, 1, 7)[0][:, 0],
                                       tol=0.0, max_iter=4)))
    if scenario == "rings":
        sessions.append(sched.submit(sssp(np.array([0, 17]), n)))
        sessions.append(sched.submit(bfs(np.array([0, 5]), n)))
    sched.run()
    return sessions + box, sched


REF_CLASSES = (RefMultiply, RefPower, RefBFS, RefSSSP)
PORT_CLASSES = (MultiplyRequest, PowerIterationSession, BFSSession,
                SSSPSession)


@pytest.mark.parametrize("scenario", ["budget", "cache", "elastic", "rings"])
def test_reference_scheduler_over_port_engine(int_paths, small_graph,
                                              scenario):
    """The reference scheduler over the port's engine gives the reference
    engine's results (bit for bit on integer operands, RTOL for power
    iteration) and every PassReport counter; the port scheduler over the
    port engine gives the same bits as the reference scheduler over it."""
    path = int_paths["bin" if scenario == "rings" else "int"]
    n = small_graph.n_cols
    runs = {}
    for name, sched_cls, make, classes in (
            ("ref/ref", RefScheduler, fresh_ref, REF_CLASSES),
            ("ref/port", RefScheduler, fresh_sem, REF_CLASSES),
            ("port/port", SharedScanScheduler, fresh_sem, PORT_CLASSES)):
        runs[name] = serve_mix(sched_cls, make(path), classes, scenario, n)
    (ref_s, ref_sched) = runs["ref/ref"]
    reps = ref_sched.reports
    covered = {  # what each scenario exercises
        "budget": max(r.wave_cols for r in reps) == 4 and len(reps) >= 4,
        "cache": sum(r.cache_hit_bytes for r in reps) > 0,
        "elastic": sum(r.admitted_midpass for r in reps) == 1,
        "rings": {r.semiring for r in reps} == {"plus_times", "min_plus"}}
    assert covered[scenario], [dataclasses.asdict(r) for r in reps]
    for name in ("ref/port", "port/port"):
        got_s, got_sched = runs[name]
        assert [dataclasses.asdict(r) for r in got_sched.reports] == \
            [dataclasses.asdict(r) for r in ref_sched.reports], name
        assert got_sched.boundary_clock == ref_sched.boundary_clock
        if got_sched.cache is not None:
            assert dataclasses.asdict(got_sched.cache.stats) == \
                dataclasses.asdict(ref_sched.cache.stats)
        assert got_sched.sem.io_stats.cache_hits == \
            ref_sched.sem.io_stats.cache_hits
        assert got_sched.sem.io_stats.cache_hit_bytes == \
            ref_sched.sem.io_stats.cache_hit_bytes
        assert len(got_s) == len(ref_s)
        for g, r in zip(got_s, ref_s):
            assert g.done and r.done and g.iterations == r.iterations
            if isinstance(g, (PowerIterationSession, RefPower)):
                np.testing.assert_allclose(g.result, r.result, rtol=RTOL,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g.result, r.result)
    # same engine, two schedulers: every session's bits
    for g, r in zip(runs["port/port"][0], runs["ref/port"][0]):
        np.testing.assert_array_equal(g.result, r.result)
        if isinstance(g, PowerIterationSession):
            assert g.residuals == r.residuals
            assert g.eigenvalue == r.eigenvalue


def test_pagerank_session_against_reference_runtime(small_graph, tmp_path):
    """PageRank tenants through the port scheduler against the reference
    scheduler over the reference engine: within RTOL/ATOL (float sums in
    another order), the same passes and bytes."""
    from repro.apps.common import SEMOperator as RefSEMOperator
    from repro.apps.pagerank import build_operator as ref_pr_operator
    from repro.apps.pagerank import pagerank_session as ref_session
    g = port_coo(small_graph)
    op = SEMOperator.from_coo(pr_operator(g), path=str(tmp_path / "p"),
                              T=512, C=128, device="cpu")
    rop = RefSEMOperator.from_coo(ref_pr_operator(small_graph),
                                  path=str(tmp_path / "r"), T=512, C=128)
    port = SharedScanScheduler(SEMSpMM(op.sem.store, SEMConfig(
        chunk_batch=BATCH), device="cpu"), use_cache=False)
    ref = RefScheduler(RefSEM(rop.sem.store, RefConfig(chunk_batch=BATCH)),
                       use_cache=False)
    # tol=0 runs all 20 iterations on both sides: where the residual
    # crosses a tolerance is decided by last-ulp noise
    got = [port.submit(pagerank_session(g, max_iter=20, tol=0.0, damping=d))
           for d in (0.8, 0.85)]
    want = [ref.submit(ref_session(small_graph, max_iter=20, tol=0.0,
                                   damping=d)) for d in (0.8, 0.85)]
    port.run()
    ref.run()
    for s, r in zip(got, want):
        assert s.done and s.iterations == r.iterations
        np.testing.assert_allclose(s.result, r.result, rtol=RTOL, atol=ATOL)
    assert [r.bytes_read for r in port.reports] == \
        [r.bytes_read for r in ref.reports]


# ---------------------------------------------------------------------------
# Correctness: the shared scan is bit-for-bit the dedicated multiply
# ---------------------------------------------------------------------------
def test_shared_scan_matches_per_request_bitwise(store_path, small_valued):
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(small_valued.n_cols).astype(np.float32)
          for _ in range(8)]
    sched = SharedScanScheduler(fresh_sem(store_path), use_cache=False)
    reqs = [sched.query(x, tenant_id=f"t{i}") for i, x in enumerate(xs)]
    sched.run()
    dedicated = fresh_sem(store_path)
    for x, r in zip(xs, reqs):
        assert r.done
        np.testing.assert_array_equal(r.result,
                                      dedicated.multiply(x[:, None])[:, 0])


def test_matrix_request_roundtrip(store_path, small_valued):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((small_valued.n_cols, 3)).astype(np.float32)
    sched = SharedScanScheduler(fresh_sem(store_path), use_cache=False)
    req = sched.submit(MultiplyRequest(x))
    sched.run()
    np.testing.assert_array_equal(req.result,
                                  fresh_sem(store_path).multiply(x))


# ---------------------------------------------------------------------------
# I/O amortization: N tenants, ~1 pass
# ---------------------------------------------------------------------------
def test_wave_of_n_requests_reads_one_pass(store_path, small_valued):
    rng = np.random.default_rng(5)
    sem = fresh_sem(store_path)
    sched = SharedScanScheduler(sem, use_cache=False)
    for i in range(8):
        sched.query(rng.standard_normal(small_valued.n_cols)
                    .astype(np.float32), tenant_id=f"q{i}")
    sched.run()
    assert sem.store.stats.bytes_read == sem.store.nbytes  # == 1 pass
    assert sched.total_scan_passes() == 1


def test_amortization_bound_under_column_budget(store_path, small_valued):
    rng = np.random.default_rng(6)
    n_req = 10
    sem = fresh_sem(store_path)
    sem.cfg.memory_budget_bytes = budget_for_cols(sem, 4)
    assert sem.columns_that_fit(n_req) == 4
    sched = SharedScanScheduler(sem, use_cache=False)
    for i in range(n_req):
        sched.query(rng.standard_normal(small_valued.n_cols)
                    .astype(np.float32), tenant_id=f"q{i}")
    sched.run()
    max_passes = -(-n_req // 4)  # ceil(10/4) = 3
    assert sched.total_scan_passes() <= max_passes
    assert sem.store.stats.bytes_read <= max_passes * sem.store.nbytes


def test_oversized_tenant_served_by_vertical_slices(store_path, small_valued):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((small_valued.n_cols, 7)).astype(np.float32)
    sem = fresh_sem(store_path)
    sem.cfg.memory_budget_bytes = budget_for_cols(sem, 3)
    sched = SharedScanScheduler(sem, use_cache=False)
    req = sched.submit(MultiplyRequest(x))
    rep = sched.run_pass()
    assert rep.scan_passes == -(-7 // 3)  # 3 slices
    np.testing.assert_array_equal(req.result,
                                  fresh_sem(store_path).multiply(x))


def test_fifo_admission_no_overtaking(store_path, small_valued):
    n = small_valued.n_cols
    sem = fresh_sem(store_path)
    sem.cfg.memory_budget_bytes = budget_for_cols(sem, 4)
    sched = SharedScanScheduler(sem, use_cache=False)
    wide = sched.submit(MultiplyRequest(np.ones((n, 3), np.float32)))
    wide2 = sched.submit(MultiplyRequest(np.ones((n, 3), np.float32)))
    narrow = sched.submit(MultiplyRequest(np.ones(n, np.float32)))
    rep1 = sched.run_pass()
    assert rep1.wave_cols == 3 and rep1.tenants == 1
    assert wide.done and not wide2.done and not narrow.done
    rep2 = sched.run_pass()
    assert rep2.wave_cols == 4 and rep2.tenants == 2
    assert wide2.done and narrow.done


# ---------------------------------------------------------------------------
# Hot-chunk cache
# ---------------------------------------------------------------------------
def test_cache_preserves_results_and_reduces_io(store_path, small_valued):
    n = small_valued.n_cols
    rng = np.random.default_rng(8)
    x0 = rng.standard_normal(n).astype(np.float32)

    def serve(use_cache):
        sem = fresh_sem(store_path)
        sem.cfg.memory_budget_bytes = 1 << 30  # plenty left over
        sched = SharedScanScheduler(sem, use_cache=use_cache)
        s = sched.submit(PowerIterationSession(x0.copy(), tol=0.0,
                                               max_iter=6))
        sched.run()
        return s, sem.store.stats

    s_plain, st_plain = serve(False)
    s_cache, st_cache = serve(True)
    np.testing.assert_array_equal(s_plain.result, s_cache.result)
    assert s_plain.eigenvalue == s_cache.eigenvalue
    assert st_cache.bytes_read < st_plain.bytes_read
    assert st_cache.bytes_read == st_plain.bytes_read // 6  # 1 cold pass
    assert st_cache.cache_hit_bytes == st_plain.bytes_read - \
        st_cache.bytes_read
    assert st_cache.bytes_read + st_cache.cache_hit_bytes == \
        6 * st_cache.bytes_read


def test_cache_respects_budget_and_lfu_eviction():
    cache = HotChunkCache(100)
    batch = ("b",)
    assert cache.get((0, 1)) is None          # miss, freq[(0,1)] = 1
    assert cache.offer((0, 1), batch, 60)
    assert cache.offer((1, 1), batch, 60) is False   # over budget, colder
    assert cache.get((0, 1)) is batch          # hit
    cache.set_budget(50)                       # squeeze -> evict
    assert len(cache) == 0 and cache.pinned_bytes == 0
    assert cache.offer((0, 1), batch, 40)      # frequency survived
    for _ in range(3):
        cache.get((2, 1))
    assert cache.offer((2, 1), batch, 40)      # a strictly hotter key
    assert cache.get((0, 1)) is None and cache.get((2, 1)) is batch


def test_cache_budget_grows_as_tenants_retire(store_path, small_valued):
    n = small_valued.n_cols
    sem = fresh_sem(store_path)
    sem.cfg.memory_budget_bytes = budget_for_cols(sem, 8)
    sched = SharedScanScheduler(sem, use_cache=True)
    sched.submit(PowerIterationSession(np.ones(n, np.float32), tol=0.0,
                                       max_iter=5))
    for i in range(4):
        sched.query(np.ones(n, np.float32), tenant_id=f"q{i}")
    reports = sched.run()
    assert reports[0].wave_cols == 5 and reports[0].retired == 4
    assert reports[1].wave_cols == 1
    assert reports[1].cache_budget > reports[0].cache_budget


# ---------------------------------------------------------------------------
# Iterative sessions vs their dedicated implementations
# ---------------------------------------------------------------------------
def test_pagerank_session_matches_dedicated_run(small_graph, tmp_path):
    """Three tenants share the scan.  Against a dedicated run of the same
    update over the port's engine (the reference's ``pagerank`` loop, which
    takes any operator with ``dot``): bit for bit, residuals included.
    Against the port's own ``pagerank``, which reduces the dangling mass
    and the residual in torch rather than numpy: RTOL/ATOL."""
    from repro.apps.pagerank import pagerank as host_pagerank
    g = port_coo(small_graph)
    op = SEMOperator.from_coo(pr_operator(g), path=str(tmp_path / "pr"),
                              T=512, C=128, config=SEMConfig(
                                  chunk_batch=BATCH), device="cpu")
    want = host_pagerank(op, dangling_vertices(g), max_iter=20)
    port_run = pagerank(op, dangling_vertices(g), max_iter=20, device="cpu")

    sched = SharedScanScheduler(
        SEMSpMM(op.sem.store, SEMConfig(chunk_batch=BATCH), device="cpu"),
        use_cache=False)
    sessions = [sched.submit(pagerank_session(g, max_iter=20,
                                              tenant_id=f"pr{i}"))
                for i in range(3)]
    sched.run()
    assert sched.total_scan_passes() == want.iterations
    for s in sessions:
        assert s.done and s.iterations == want.iterations
        np.testing.assert_array_equal(s.result, want.scores)
        assert s.residuals == want.residuals
        assert s.iterations == port_run.iterations
        np.testing.assert_allclose(s.result, port_run.scores, rtol=RTOL,
                                   atol=ATOL)


def test_labelprop_session_recovers_sbm_communities(tmp_path):
    """Against a dedicated loop of the same update over the port's engine:
    bit for bit.  Against the dense float reference: the reference test's
    own bar (over 90% of labels agree)."""
    from repro_torch.runtime import LabelPropagationSession
    ref_adj = sbm(1024, 8192, n_clusters=4, in_out_ratio=8.0, seed=2)
    adj = port_coo(ref_adj)
    op = SEMOperator.from_coo(lp_operator(adj), path=str(tmp_path / "lp"),
                              T=512, C=128, device="cpu")
    rng = np.random.default_rng(0)
    seeds = np.concatenate([rng.integers(c * 256, (c + 1) * 256, 8)
                            for c in range(4)])
    seed_labels = np.repeat(np.arange(4), 8)

    sched = SharedScanScheduler(
        SEMSpMM(op.sem.store, SEMConfig(chunk_batch=BATCH), device="cpu"),
        use_cache=False)
    s = sched.submit(labelprop_session(adj, seeds, seed_labels, 4,
                                       max_iter=30))
    sched.run()
    assert s.done
    np.testing.assert_array_equal(s.labels[seeds], seed_labels)

    alone = LabelPropagationSession(seeds, seed_labels, adj.n_rows, 4,
                                    max_iter=30)
    dedicated = SEMSpMM(op.sem.store, SEMConfig(chunk_batch=BATCH),
                        device="cpu")
    while not alone.done:
        alone.consume(dedicated.multiply(alone.x_columns()))
    assert alone.iterations == s.iterations
    np.testing.assert_array_equal(s.result, alone.result)
    ref = labelprop_dense_reference(adj, seeds, seed_labels, 4, max_iter=30)
    agree = float((s.labels == ref).mean())
    assert agree > 0.9, agree


def bfs_oracle(graph, sources, n):
    nbrs = defaultdict(list)
    for v, u in zip(graph.rows, graph.cols):
        nbrs[int(u)].append(int(v))
    dist = {s: 0 for s in sources}
    q = deque(sources)
    while q:
        u = q.popleft()
        for v in nbrs[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                q.append(v)
    want = np.full(n, -1, np.int32)
    for v, d in dist.items():
        want[v] = d
    return want


def test_bfs_session_matches_python_oracle(small_graph, int_paths):
    n = small_graph.n_rows
    sched = SharedScanScheduler(fresh_sem(int_paths["bin"]), use_cache=False)
    source_sets = [[0], [17], [0, 5]]
    sessions = [sched.submit(BFSSession(np.array(s), n, tenant_id=str(i)))
                for i, s in enumerate(source_sets)]
    sched.run()
    for sources, sess in zip(source_sets, sessions):
        assert sess.done
        np.testing.assert_array_equal(sess.result,
                                      bfs_oracle(small_graph, sources, n))
        assert sess.frontier_size == 0       # converged, not depth-capped


def test_bfs_session_respects_max_depth(small_graph, int_paths):
    n = small_graph.n_rows
    sched = SharedScanScheduler(fresh_sem(int_paths["bin"]), use_cache=False)
    capped = sched.submit(BFSSession(np.array([0]), n, max_depth=1))
    sched.run()
    assert capped.done and capped.iterations == 1
    assert capped.result.max() <= 1


def test_mixed_wave_shares_one_scan(store_path, small_valued):
    n = small_valued.n_cols
    sem = fresh_sem(store_path)
    sched = SharedScanScheduler(sem, use_cache=False)
    rng = np.random.default_rng(11)
    power = sched.submit(PowerIterationSession(
        rng.standard_normal(n).astype(np.float32), tol=0.0, max_iter=4))
    oneshot = sched.query(rng.standard_normal(n).astype(np.float32))
    reports = sched.run()
    assert oneshot.done and power.done
    assert len(reports) == 4                      # power's 4 iterations
    assert sem.store.stats.bytes_read == 4 * sem.store.nbytes
    assert reports[0].wave_cols == 2 and reports[1].wave_cols == 1


# ---------------------------------------------------------------------------
# Batcher unit behavior
# ---------------------------------------------------------------------------
def test_batcher_rejects_wrong_shape(store_path):
    sem = fresh_sem(store_path)
    b = Batcher(sem.n_cols)
    with pytest.raises(ValueError):
        b.submit(MultiplyRequest(np.ones(sem.n_cols + 1, np.float32)))


def test_batcher_rejects_zero_width(store_path):
    sem = fresh_sem(store_path)
    b = Batcher(sem.n_cols)
    with pytest.raises(ValueError):
        b.submit(MultiplyRequest(np.empty((sem.n_cols, 0), np.float32)))


def test_cache_doomed_offer_does_not_strip_entries():
    cache = HotChunkCache(100)
    a, b, k = ("a",), ("b",), ("k",)
    cache.get((0, 1))
    for _ in range(5):
        cache.get((1, 1))
    assert cache.offer((0, 1), a, 30)
    assert cache.offer((1, 1), b, 60)
    cache.get((2, 1))
    cache.get((2, 1))
    assert cache.offer((2, 1), k, 50) is False
    assert cache.get((0, 1)) is a and cache.get((1, 1)) is b


def test_prewarmed_cache_survives_budget_squeeze():
    cache = HotChunkCache(100)
    assert cache.offer((0, 1), ("a",), 60)
    cache.set_budget(10)
    assert len(cache) == 0
    assert cache.offer((1, 1), ("b",), 10)
    cache.get((2, 1))
    assert cache.offer((2, 1), ("c",), 10)
    assert cache.get((2, 1)) == ("c",)


def test_partitioned_cache_isolates_shard_budgets():
    part = PartitionedHotChunkCache(2, budget_bytes=200)  # 100 per shard
    slow, fast = part.shard(0), part.shard(1)
    cold = ("slow-batch",)
    slow.get((0, 1))
    assert slow.offer((0, 1), cold, 90)
    for _ in range(50):
        fast.get((9, 1))
    assert fast.offer((9, 1), ("hot",), 150) is False
    assert fast.offer((9, 1), ("hot",), 80)
    assert slow.get((0, 1)) is cold
    assert part.pinned_bytes == 170 and len(part) == 2
    part.set_budget(160)
    assert slow.get((0, 1)) is None
    assert fast.get((9, 1)) == ("hot",)


def test_sharded_scheduler_uses_partitioned_cache(store_path, small_valued):
    """The sharded serving path over a CPU engine runs on the CPU (its
    shards take the engine's device, not a default card), splits the
    hot-chunk budget per shard and serves the unsharded bits."""
    rng = np.random.default_rng(21)
    x0 = rng.standard_normal(small_valued.n_cols).astype(np.float32)
    sem = fresh_sem(store_path)
    sem.cfg.memory_budget_bytes = 1 << 30
    with SharedScanScheduler(sem, use_cache=True, sharded=2) as sched:
        assert isinstance(sched.cache, PartitionedHotChunkCache)
        assert [ex.device.type for ex in sched.sharded.execs] == ["cpu"] * 2
        s = sched.submit(PowerIterationSession(x0.copy(), tol=0.0,
                                               max_iter=4))
        sched.run()
        assert sched.cache.stats.hits > 0
        assert sched.sharded.io_stats.cache_hit_bytes > 0
    plain = SharedScanScheduler(fresh_sem(store_path), use_cache=False)
    p = plain.submit(PowerIterationSession(x0.copy(), tol=0.0, max_iter=4))
    plain.run()
    np.testing.assert_array_equal(s.result, p.result)
    assert s.residuals == p.residuals


def test_sharded_scheduler_without_a_card_stays_off_it(store_path,
                                                       monkeypatch):
    """With no card at all, a sharded scheduler over a CPU engine still
    builds: nothing asks for a default device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with SharedScanScheduler(fresh_sem(store_path), sharded=2) as sched:
        assert {ex.device.type for ex in sched.sharded.execs} == {"cpu"}


def test_scheduler_adopts_prewarmed_cache(store_path, small_valued):
    prewarmed = HotChunkCache(1 << 30)
    sem = SEMSpMM(TileStore.open(store_path), SEMConfig(chunk_batch=BATCH),
                  cache=prewarmed, device="cpu")
    sched = SharedScanScheduler(sem, use_cache=True)
    assert sched.cache is prewarmed and sem.cache is prewarmed


# ---------------------------------------------------------------------------
# Mutable graphs under the scheduler (tests/test_mutable.py's session cases)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mut_path(tmp_path_factory):
    from repro.sparse.generate import rmat
    g = rmat(10, 8, seed=9)
    vals = np.random.default_rng(2).integers(1, 5, g.nnz).astype(np.float32)
    path = str(tmp_path_factory.mktemp("tmut") / "g")
    RefTileStore.write(path, ref_to_chunked(g.with_values(vals), T=256,
                                            C=64))
    return path


def int_operand(n, k=3, seed=5):
    r = np.random.default_rng(seed)
    return np.round(r.standard_normal((n, k)) * 4).astype(np.float32)


def coords(n, count, seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, n, count).astype(np.int64),
            r.integers(0, n, count).astype(np.int64))


def test_scheduler_compaction_converges_and_preserves_bits(mut_path):
    st = TileStore.open(mut_path)
    n = st.header["n_rows"]
    sem = SEMSpMM(st, SEMConfig(chunk_batch=16), device="cpu")
    sched = SharedScanScheduler(sem, compact_ratio=0.01)
    x = int_operand(n, k=1)
    base_nnz = st.nnz()
    for i in range(4):
        sem.apply_updates(UpdateBatch.insert(
            *coords(n, max(1, base_nnz // 100), 70 + i)))
        sched.submit(MultiplyRequest(x, tenant_id=f"q{i}"))
        sched.run_pass()
    assert sched.reports[-1].version == 4
    assert not sched.active

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        probe = MultiplyRequest(x, tenant_id="probe")
        sched.submit(probe)
        sched.run_pass()
        h = st.handle
        if st.generation >= 1 and h.delta_nnz == 0 and not h.compacting:
            break
        time.sleep(0.02)
    assert st.generation >= 1, "compaction never installed"
    assert st.handle.delta_nnz == 0, "log did not drain"
    post = MultiplyRequest(x, tenant_id="post")
    sched.submit(post)
    rep = sched.run_pass()
    assert rep.version == 4 and rep.delta_nnz == 0
    np.testing.assert_array_equal(post.result, probe.result)
    st.close()


def sssp_oracle(store, sources, extra=None):
    """Host Bellman-Ford: stored entry (i, j) relaxes dist[i] against
    dist[j] + w(i, j)."""
    n = store.header["n_rows"]
    er, ec, ev = [], [], []
    for _, rr, cc, vv in store.iter_tile_row_entries():
        er.append(rr), ec.append(cc), ev.append(vv)
    if extra is not None:
        er.append(extra[0]), ec.append(extra[1]), ev.append(extra[2])
    er, ec = np.concatenate(er), np.concatenate(ec)
    ev = np.concatenate(ev).astype(np.float64)
    dist = np.full(n, np.inf, np.float64)
    dist[np.asarray(sources)] = 0.0
    for _ in range(n):
        new = dist.copy()
        np.minimum.at(new, er, dist[ec] + ev)
        if np.array_equal(new, dist):
            return new
        dist = new
    return dist


def test_sssp_session_matches_bellman_ford_and_reference(mut_path):
    """Integer weights: the distances are exact, so the port's session
    equals the oracle and the reference runtime's session bit for bit."""
    st = TileStore.open(mut_path)
    n = st.header["n_rows"]
    sched = SharedScanScheduler(SEMSpMM(st, SEMConfig(chunk_batch=16),
                                        device="cpu"))
    sess = SSSPSession(np.array([0, 3]), n)
    assert sess.semiring == "min_plus"
    sched.submit(sess)
    sched.drain(timeout=300)
    assert sess.done
    np.testing.assert_array_equal(np.asarray(sess.result, np.float64),
                                  sssp_oracle(st, [0, 3]))
    ring_reports = [r for r in sched.reports if r.semiring == "min_plus"]
    assert ring_reports and all(r.tenants >= 1 for r in ring_reports)
    ref = RefScheduler(RefSEM(RefTileStore.open(mut_path),
                              RefConfig(chunk_batch=16)))
    rsess = ref.submit(RefSSSP(np.array([0, 3]), n))
    ref.drain(timeout=300)
    np.testing.assert_array_equal(sess.result, rsess.result)
    assert [dataclasses.asdict(r) for r in sched.reports] == \
        [dataclasses.asdict(r) for r in ref.reports]
    st.close()


def test_sssp_over_delta_overlay_and_wire_roundtrip(mut_path):
    from repro_torch.runtime import SessionSpec
    st = TileStore.open(mut_path)
    n = st.header["n_rows"]
    sem = SEMSpMM(st, SEMConfig(chunk_batch=16), device="cpu")
    r = np.random.default_rng(91)
    keys = np.unique(r.integers(0, n * n, 120))[:80]
    ir, ic = keys // n, keys % n
    iv = np.full(ir.size, 0.5, np.float32)
    sem.apply_updates(UpdateBatch.insert(ir, ic, iv))
    spec = SessionSpec.sssp(np.array([1]), n, tenant_id="w")
    rebuilt = SessionSpec.from_wire(*spec.to_wire())
    assert rebuilt.build().semiring == "min_plus"
    sched = SharedScanScheduler(sem)
    tk = sched.submit(rebuilt)
    sched.drain(timeout=300)
    np.testing.assert_array_equal(np.asarray(tk.wait(1), np.float64),
                                  sssp_oracle(st, [1], extra=(ir, ic, iv)))
    st.close()


def test_mixed_ring_and_plus_waves_share_scheduler(mut_path):
    st = TileStore.open(mut_path)
    n = st.header["n_rows"]
    sched = SharedScanScheduler(SEMSpMM(st, SEMConfig(chunk_batch=16),
                                        device="cpu"))
    x = int_operand(n, k=2)
    mul = MultiplyRequest(x, tenant_id="mul")
    sssp = SSSPSession(np.array([2]), n)
    sched.submit(mul)
    sched.submit(sssp)
    sched.drain(timeout=300)
    assert mul.done and sssp.done
    assert {r.semiring for r in sched.reports} == {"plus_times", "min_plus"}
    np.testing.assert_array_equal(mul.result, SEMSpMM(
        TileStore.open(mut_path), SEMConfig(chunk_batch=16),
        device="cpu").multiply(x))
    np.testing.assert_array_equal(np.asarray(sssp.result, np.float64),
                                  sssp_oracle(st, [2]))
    st.close()
