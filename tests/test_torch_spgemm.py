"""The port's semi-external SpGEMM (``repro_torch.core.spgemm``) on the CPU,
mirroring ``tests/test_spgemm.py``: the product of two ``TileStore``s
equals the dense oracle across raw, optimized and overlaid stores and under
a budget that forces spills, triangle counts equal the masked oracle, and
the ``spgemm``/``triangle_count`` sessions flow through the port's
scheduler.  Every product is also held against the JAX package's
``SpGEMMJob`` on the same stores: the same stats, bit for bit the same
output store (its chunk file and header).  The job is host code in both
packages and its inputs are integer-valued, so every sum is exact.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import COO as RefCOO
from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.spgemm import spgemm as ref_spgemm
from repro.core.spgemm import triangle_count as ref_triangle_count
from repro.core.spmm import spmm_chunked
from repro.io.storage import GraphHandle as RefHandle
from repro.io.storage import TileStore as RefTileStore
from repro.io.storage import UpdateBatch as RefUpdateBatch
from repro.sparse.generate import rmat
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.core.spgemm import (SpGEMMJob, materialize_dense, spgemm,
                                     triangle_count)
from repro_torch.io.storage import GraphHandle, TileStore, UpdateBatch
from repro_torch.runtime import SharedScanScheduler
from repro_torch.runtime.session import SessionSpec, SpGEMMSession


@pytest.fixture(scope="module")
def graph():
    """~1k vertices, power-law, binary."""
    return rmat(10, 8, seed=3)


@pytest.fixture(scope="module")
def a_path(graph, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tspgemm") / "a")
    RefTileStore.write(path, ref_to_chunked(graph, T=256, C=64))
    return path


@pytest.fixture(scope="module")
def dense_a(graph):
    return graph.to_dense(np.float64)


@pytest.fixture(scope="module")
def aa_oracle(dense_a):
    return (dense_a @ dense_a).astype(np.float32)


def int_coo(n_rows, n_cols, nnz, seed):
    r = np.random.default_rng(seed)
    rows = r.integers(0, n_rows, nnz).astype(np.int64)
    cols = r.integers(0, n_cols, nnz).astype(np.int64)
    m = RefCOO(n_rows, n_cols, rows, cols, None).dedup()
    return m.with_values(r.integers(1, 6, m.nnz).astype(np.float32))


def symmetric(graph):
    r = np.concatenate([graph.rows, graph.cols])
    c = np.concatenate([graph.cols, graph.rows])
    keep = r != c
    return RefCOO(graph.n_rows, graph.n_cols, r[keep], c[keep], None).dedup()


def same_store(path, ref_path):
    """The two packages wrote the same product: the chunk file byte for
    byte and the same header."""
    with open(path + ".bin", "rb") as f, open(ref_path + ".bin", "rb") as g:
        assert f.read() == g.read()
    with open(path + ".json") as f, open(ref_path + ".json") as g:
        assert json.load(f) == json.load(g)


def same_stats(stats, ref_stats):
    assert vars(stats) == vars(ref_stats)


# ---------------------------------------------------------------------------
# oracle identity, rectangular A @ B
# ---------------------------------------------------------------------------
def test_spgemm_matches_dense_oracle_rectangular(tmp_path):
    a = int_coo(300, 200, 2500, seed=1)
    b = int_coo(200, 150, 2000, seed=2)
    pa, pb = str(tmp_path / "a"), str(tmp_path / "b")
    RefTileStore.write(pa, ref_to_chunked(a, T=64, C=32))
    RefTileStore.write(pb, ref_to_chunked(b, T=64, C=32))
    with TileStore.open(pa) as sa, TileStore.open(pb) as sb:
        prod, stats = spgemm(sa, sb, str(tmp_path / "p"))
    with RefTileStore.open(pa) as sa, RefTileStore.open(pb) as sb:
        rprod, rstats = ref_spgemm(sa, sb, str(tmp_path / "r"))
    oracle = (a.to_dense(np.float64) @ b.to_dense(np.float64)).astype(
        np.float32)
    assert np.array_equal(materialize_dense(prod), oracle)
    assert stats.product_nnz == int(np.count_nonzero(oracle))
    assert stats.spill_cycles == 0
    assert prod.header["n_rows"] == 300 and prod.header["n_cols"] == 150
    same_stats(stats, rstats)
    prod.close()
    rprod.close()
    same_store(str(tmp_path / "p"), str(tmp_path / "r"))


def test_budget_forces_spill_and_stays_bit_identical(a_path, aa_oracle,
                                                     tmp_path):
    with TileStore.open(a_path) as a:
        _, ref = spgemm(a, None, str(tmp_path / "ref"),
                        partial_budget_bytes=1 << 30)
        assert ref.spill_cycles == 0
        budget = max(1 << 16, ref.peak_partial_bytes // 3)
        prod, stats = spgemm(a, None, str(tmp_path / "p"),
                             partial_budget_bytes=budget)
    with RefTileStore.open(a_path) as a:
        rprod, rstats = ref_spgemm(a, None, str(tmp_path / "r"),
                                   partial_budget_bytes=budget)
    assert ref.peak_partial_bytes > budget
    assert stats.spill_cycles >= 1
    assert stats.merge_rounds >= 1
    assert stats.peak_partial_bytes <= budget
    assert np.array_equal(materialize_dense(prod), aa_oracle)
    same_stats(stats, rstats)
    prod.close()
    rprod.close()
    same_store(str(tmp_path / "p"), str(tmp_path / "r"))


def test_optimized_stores_and_optimized_output(a_path, aa_oracle, tmp_path):
    with TileStore.open(a_path) as a:
        ao = a.optimize(str(tmp_path / "a-opt"))
    prod, _ = spgemm(ao, None, str(tmp_path / "p"),
                     partial_budget_bytes=1 << 18)
    assert np.array_equal(materialize_dense(prod), aa_oracle)
    prod.close()
    prod2, stats = spgemm(ao, None, str(tmp_path / "p2"),
                          partial_budget_bytes=1 << 18, optimize_out=True)
    assert prod2.header["meta_ints"] == 6    # really the optimized store
    assert np.array_equal(materialize_dense(prod2), aa_oracle)
    prod2.close()
    ao.close()
    with RefTileStore.open(str(tmp_path / "a-opt")) as rao:
        rprod, rstats = ref_spgemm(rao, None, str(tmp_path / "r2"),
                                   partial_budget_bytes=1 << 18,
                                   optimize_out=True)
    rprod.close()
    same_stats(stats, rstats)
    same_store(str(tmp_path / "p2-opt"), str(tmp_path / "r2-opt"))


def test_delta_overlay_folds_into_both_operands(a_path, dense_a, tmp_path):
    n = dense_a.shape[0]
    r = np.random.default_rng(17)
    ir = r.integers(0, n, 50).astype(np.int64)
    ic = r.integers(0, n, 50).astype(np.int64)
    jr = r.integers(0, n, 30).astype(np.int64)
    jc = r.integers(0, n, 30).astype(np.int64)
    base = np.flatnonzero(dense_a.ravel())[:25]
    runs = []
    for store_cls, handle_cls, batch_cls, run, out in (
            (TileStore, GraphHandle, UpdateBatch, spgemm, "p"),
            (RefTileStore, RefHandle, RefUpdateBatch, ref_spgemm, "r")):
        a, b = store_cls.open(a_path), store_cls.open(a_path)
        ha, hb = handle_cls([a]), handle_cls([b])
        ha.apply_updates(batch_cls.insert(ir, ic))
        hb.apply_updates(batch_cls.insert(jr, jc,
                                          2.0 * np.ones(30, np.float32)))
        hb.apply_updates(batch_cls.delete(base // n, base % n))
        prod, stats = run(a, b, str(tmp_path / out),
                          partial_budget_bytes=1 << 18)
        runs.append((prod, stats))
        a.close()
        b.close()
    (prod, stats), (rprod, rstats) = runs
    Ad = dense_a.copy()
    np.add.at(Ad, (ir, ic), 1.0)
    Bd = dense_a.copy()
    np.add.at(Bd, (jr, jc), 2.0)
    np.add.at(Bd, (base // n, base % n), -1.0)
    assert stats.spill_cycles >= 1
    assert np.array_equal(materialize_dense(prod), (Ad @ Bd).astype(np.float32))
    same_stats(stats, rstats)
    prod.close()
    rprod.close()
    same_store(str(tmp_path / "p"), str(tmp_path / "r"))


def test_medium_oracle_via_spmm_chunked_columns(small_graph, tmp_path):
    """On the medium fixture the oracle is the reference's SpMM:
    A @ (materialized B column block) == the product's column block."""
    path = str(tmp_path / "a")
    ct = ref_to_chunked(small_graph, T=512, C=128)
    RefTileStore.write(path, ct)
    with TileStore.open(path) as a:
        prod, stats = spgemm(a, None, str(tmp_path / "p"),
                             partial_budget_bytes=1 << 20)
    assert stats.spill_cycles >= 1
    dense = materialize_dense(prod)
    n = small_graph.n_rows
    bdense = small_graph.to_dense(np.float32)
    for lo in range(0, n, 1024):
        cols = bdense[:, lo:lo + 1024]
        assert np.array_equal(dense[:, lo:lo + 1024],
                              np.asarray(spmm_chunked(ct, cols)))
    prod.close()


# ---------------------------------------------------------------------------
# triangle counting (masked A·A reduction, no product store)
# ---------------------------------------------------------------------------
def test_triangle_count_matches_masked_oracle(graph, tmp_path):
    sym = symmetric(graph)
    path = str(tmp_path / "sym")
    RefTileStore.write(path, ref_to_chunked(sym, T=256, C=64))
    S = sym.to_dense(np.float64)
    oracle = ((S @ S) * S).sum(axis=1) / 2.0
    with TileStore.open(path) as st:
        tri, stats = triangle_count(st, partial_budget_bytes=1 << 18)
    with RefTileStore.open(path) as st:
        rtri, rstats = ref_triangle_count(st, partial_budget_bytes=1 << 18)
    assert stats.spill_cycles >= 1
    assert np.array_equal(tri, oracle)
    assert float(tri.sum()) % 3.0 == 0.0
    np.testing.assert_array_equal(tri, rtri)
    same_stats(stats, rstats)


# ---------------------------------------------------------------------------
# input validation
# ---------------------------------------------------------------------------
def test_rejects_shard_views_and_dim_mismatch(a_path, tmp_path):
    with TileStore.open(a_path) as a:
        shard = a.partition_rows(2)[1]
        with pytest.raises(ValueError, match="shard view"):
            SpGEMMJob(shard, None, str(tmp_path / "p"))
        pb = str(tmp_path / "b")
        RefTileStore.write(pb, ref_to_chunked(int_coo(64, 64, 100, seed=4),
                                              T=32, C=16))
        with TileStore.open(pb) as b:
            with pytest.raises(ValueError, match="dimension mismatch"):
                SpGEMMJob(a, b, str(tmp_path / "p"))
    with TileStore.open(a_path) as a:
        with pytest.raises(ValueError, match="out_path"):
            SpGEMMJob(a, None, None)
        with pytest.raises(ValueError, match="unknown spgemm mode"):
            SpGEMMJob(a, None, None, mode="nope")


# ---------------------------------------------------------------------------
# the serving tier: spgemm / triangle_count session kinds
# ---------------------------------------------------------------------------
def scheduler_over(path):
    return SharedScanScheduler(SEMSpMM(TileStore.open(path),
                                       SEMConfig(chunk_batch=64),
                                       device="cpu"))


def test_spgemm_session_through_scheduler(a_path, aa_oracle, tmp_path):
    out = str(tmp_path / "tenant-product")
    with scheduler_over(a_path) as sched:
        ticket = sched.submit(SessionSpec.spgemm(
            out, budget_bytes=1 << 18, tile_rows_per_pass=2,
            tenant_id="spgemm-0"))
        passes = 0
        while not sched.idle:
            assert sched.run_pass() is not None
            passes += 1
        assert ticket.done and ticket.error is None
        assert passes > 1 and ticket.iterations == passes
        summary = ticket.result
        assert summary.dtype == np.int64
        assert summary[2] == int(np.count_nonzero(aa_oracle))
        assert summary[3] >= 1                      # forced spill
        assert summary[4] <= summary[5]             # peak <= budget
    with TileStore.open(out) as prod:
        assert np.array_equal(materialize_dense(prod), aa_oracle)
    with RefTileStore.open(a_path) as a:
        rprod, _ = ref_spgemm(a, None, str(tmp_path / "r"),
                              partial_budget_bytes=1 << 18, chunk_batch=64)
    rprod.close()
    same_store(out, str(tmp_path / "r"))


def test_spgemm_session_with_explicit_b_store(a_path, tmp_path):
    b = int_coo(1024, 320, 4000, seed=9)
    pb = str(tmp_path / "b")
    RefTileStore.write(pb, ref_to_chunked(b, T=256, C=64))
    out = str(tmp_path / "p")
    with scheduler_over(a_path) as sched:
        ticket = sched.submit(SessionSpec.spgemm(out, b=pb,
                                                 tile_rows_per_pass=0))
        while not sched.idle:
            sched.run_pass()
        assert ticket.done and ticket.iterations == 1
    with TileStore.open(a_path) as a, TileStore.open(out) as prod:
        oracle = (materialize_dense(a).astype(np.float64)
                  @ b.to_dense(np.float64)).astype(np.float32)
        assert np.array_equal(materialize_dense(prod), oracle)


def test_triangle_session_and_unbound_error(graph, tmp_path):
    sess = SpGEMMSession(out_path=str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="not bound"):
        sess.x_columns()
    sym = symmetric(graph)
    path = str(tmp_path / "sym")
    RefTileStore.write(path, ref_to_chunked(sym, T=256, C=64))
    S = sym.to_dense(np.float64)
    oracle = ((S @ S) * S).sum(axis=1) / 2.0
    with scheduler_over(path) as sched:
        ticket = sched.submit(SessionSpec.triangle_count(
            budget_bytes=1 << 18, tenant_id="tri-0"))
        while not sched.idle:
            sched.run_pass()
        assert ticket.done
        assert np.array_equal(ticket.result, oracle)


def test_spgemm_rides_alongside_spmm_tenants(a_path, dense_a, tmp_path):
    out = str(tmp_path / "p")
    x = np.round(np.random.default_rng(5).standard_normal(
        (dense_a.shape[0], 2)) * 3).astype(np.float32)
    with scheduler_over(a_path) as sched:
        tg = sched.submit(SessionSpec.spgemm(out, budget_bytes=1 << 18,
                                             tile_rows_per_pass=1))
        tm = sched.submit(SessionSpec.multiply(x))
        while not sched.idle:
            sched.run_pass()
        assert tg.done and tm.done
    with TileStore.open(out) as prod:
        assert np.array_equal(materialize_dense(prod),
                              (dense_a @ dense_a).astype(np.float32))
    oracle_y = (dense_a @ x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(tm.result, oracle_y)
    assert not os.path.exists(out + "-opt.bin")
