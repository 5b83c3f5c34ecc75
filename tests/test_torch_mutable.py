"""The port's delta overlay and mutation surface against the JAX package
on the CPU.

A mutable graph is a base store ⊕ a delta log behind one version counter;
the engine serves ``base ⊕ delta`` bit for bit equal to a store rebuilt at
the same version (integer weights and operands keep every sum exact).  The
port's engine (``device="cpu"``: the kernels' plain versions) must give the
reference engine's bits and counters in each of the reference's
configurations (``tests/test_mutable.py``), before and after compaction,
and the stores either package's compaction writes must serve the same bits
in the other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.sem import SEMConfig as RefConfig
from repro.core.sem import SEMSpMM as RefSEMSpMM
from repro.io.storage import GraphHandle as RefGraphHandle
from repro.io.storage import TileStore as RefTileStore
from repro.io.storage import UpdateBatch as RefUpdateBatch
from repro.runtime import Mutable
from repro.sparse.generate import rmat
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.io.storage import GraphHandle, TileStore, UpdateBatch

COUNTERS = ("bytes_read", "h2d_bytes", "overlap_batches")
# (label, reference config, port config): the reference's configurations
# in tests/test_mutable.py; its counters are compared on its use_pallas
# staging layout (the port always ships the n_valid plane)
CFGS = [
    ("serial", dict(chunk_batch=16, overlap=False, use_async=False), {}),
    ("overlap", dict(chunk_batch=16, overlap=True), {}),
    ("pallas", dict(chunk_batch=16), dict(kernel_variant="gather")),
    ("mxu", dict(chunk_batch=16, pallas_variant="mxu"),
     dict(kernel_variant="mxu")),
]


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    g = rmat(10, 8, seed=9)
    vals = np.random.default_rng(2).integers(1, 5, g.nnz).astype(np.float32)
    path = str(tmp_path_factory.mktemp("tmut") / "g")
    RefTileStore.write(path, ref_to_chunked(g.with_values(vals), T=256, C=64))
    return path


def int_operand(n, k=3, seed=5):
    r = np.random.default_rng(seed)
    return np.round(r.standard_normal((n, k)) * 4).astype(np.float32)


def coords(n, count, seed, unique=False):
    r = np.random.default_rng(seed)
    rows = r.integers(0, n, count).astype(np.int64)
    cols = r.integers(0, n, count).astype(np.int64)
    if unique:
        keep = np.unique(rows * n + cols, return_index=True)[1]
        rows, cols = rows[keep], cols[keep]
    return rows, cols


def churn(handle_cls, batch_cls, store, n):
    """150 inserts then 30 deletes (version 2), from fixed seeds."""
    h = handle_cls([store])
    h.apply_updates(batch_cls.insert(*coords(n, 150, 21)))
    h.apply_updates(batch_cls.delete(*coords(n, 30, 22)))
    return h


def assert_same_run(port, ref):
    for k in COUNTERS:
        assert getattr(port.io_stats, k) == getattr(ref.io_stats, k), k
    assert port.passes == ref.passes


@pytest.mark.parametrize("label,ref_cfg,port_cfg", CFGS,
                         ids=[c[0] for c in CFGS])
def test_overlay_matches_reference_and_rebuilt(store_path, tmp_path, label,
                                               ref_cfg, port_cfg):
    rst, pst = RefTileStore.open(store_path), TileStore.open(store_path)
    n = pst.header["n_rows"]
    x = int_operand(n)
    churn(RefGraphHandle, RefUpdateBatch, rst, n)
    ph = churn(GraphHandle, UpdateBatch, pst, n)
    cfg = {k: v for k, v in ref_cfg.items() if k != "pallas_variant"}
    ref = RefSEMSpMM(rst, RefConfig(**ref_cfg, use_pallas=True))
    port = SEMSpMM(pst, SEMConfig(**cfg, **port_cfg), device="cpu")
    want = ref.multiply(x)
    y_overlay = port.multiply(x)
    np.testing.assert_array_equal(y_overlay, want)
    if label != "pallas":   # the reference's own configuration, scan step
        scan = RefSEMSpMM(RefTileStore.open(store_path), RefConfig(
            **{k: v for k, v in ref_cfg.items() if k != "pallas_variant"}))
        churn(RefGraphHandle, RefUpdateBatch, scan.store, n)
        np.testing.assert_array_equal(y_overlay, scan.multiply(x))
    assert port.last_pass_version == ref.last_pass_version == 2
    assert port.version == 2 and port.delta_nnz == ph.delta_nnz > 0
    assert_same_run(port, ref)

    assert ph.compact(str(tmp_path / f"rebuilt-{label}")) is not None
    assert ph.try_install()
    assert pst.generation == 1 and ph.delta_nnz == 0
    again = SEMSpMM(pst, SEMConfig(**cfg, **port_cfg), device="cpu")
    np.testing.assert_array_equal(again.multiply(x), y_overlay)
    assert again.last_pass_version == 2


@pytest.mark.parametrize("ring", ["or_and", "min_plus", "max_times"])
def test_ring_overlay_inserts_only(store_path, ring):
    """A ring pass over an insert-only log equals the reference's, bit for
    bit (unique coordinates: the log sums duplicates)."""
    rst, pst = RefTileStore.open(store_path), TileStore.open(store_path)
    n = pst.header["n_rows"]
    ir, ic = coords(n, 80, 91, unique=True)
    iv = (np.arange(ir.size) % 4 + 1).astype(np.float32)
    RefGraphHandle([rst]).apply_updates(RefUpdateBatch.insert(ir, ic, iv))
    port = SEMSpMM(pst, SEMConfig(chunk_batch=16), device="cpu")
    assert port.apply_updates(UpdateBatch.insert(ir, ic, iv)) == 1
    ref = RefSEMSpMM(rst, RefConfig(chunk_batch=16, use_pallas=True))
    x = int_operand(n, k=2)
    got, want = port.multiply(x, semiring=ring), ref.multiply(x,
                                                              semiring=ring)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert port.last_pass_version == 1
    assert_same_run(port, ref)


def test_ring_refuses_deletions_and_the_pass_still_ends(store_path,
                                                        tmp_path):
    """Negated values only cancel under plus-times: a min-plus pass over a
    log with deletions raises the reference's error, and the pass it began
    is ended (a compaction can still install)."""
    pst = TileStore.open(store_path)
    n = pst.header["n_rows"]
    port = SEMSpMM(pst, SEMConfig(chunk_batch=16), device="cpu")
    port.apply_updates(UpdateBatch.delete(np.array([0]), np.array([1]),
                                          np.array([1.0], np.float32)))
    with pytest.raises(ValueError, match="delet"):
        port.multiply(int_operand(n, k=1), semiring="min_plus")
    h = port.graph_handle
    assert h.compact(str(tmp_path / "c")) is not None
    assert h.try_install()


def test_overlay_under_boundary_hook(store_path):
    """A boundary hook rewrites a column mid-pass: the delta accumulator
    is rebuilt against the new operand, as the reference's is."""
    new_col = (np.arange(1 << 10) % 7).astype(np.float32)
    runs = []
    for Handle, Batch, Store, Sem, Cfg, kw in (
            (RefGraphHandle, RefUpdateBatch, RefTileStore, RefSEMSpMM,
             RefConfig, dict(use_pallas=True)),
            (GraphHandle, UpdateBatch, TileStore, SEMSpMM, SEMConfig, {})):
        st = Store.open(store_path)
        n = st.header["n_rows"]
        churn(Handle, Batch, st, n)
        sem = (Sem(st, Cfg(chunk_batch=16, **kw)) if kw
               else Sem(st, Cfg(chunk_batch=16), device="cpu"))
        seen = {}

        def hook(b, seen=seen):
            if b.chunk_start == 32:
                b.write_columns(1, new_col[:n])
                seen["prefix"] = b.read_output(2, 0, 3)
        runs.append((sem.multiply(int_operand(n), boundary_hook=hook),
                     seen["prefix"], sem))
    (want, want_pre, ref), (got, got_pre, port) = runs
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_pre, want_pre)
    assert_same_run(port, ref)


def test_snapshot_pins_the_version_and_mutable_surface(store_path):
    """A supplied snapshot holds a pass at its version; the engine is the
    reference's ``Mutable``; a shard view refuses ``apply_updates``."""
    pst = TileStore.open(store_path)
    n = pst.header["n_rows"]
    port = SEMSpMM(pst, SEMConfig(chunk_batch=16), device="cpu")
    assert isinstance(port, Mutable) and port.version == 0
    assert port.graph_handle is None and port.delta_nnz == 0
    x = int_operand(n)
    base = port.multiply(x)
    assert port.last_pass_version == 0
    port.apply_updates(UpdateBatch.insert(*coords(n, 40, 7)))
    snap = port.store.delta_log.snapshot()
    port.apply_updates(UpdateBatch.insert(*coords(n, 40, 8)))
    pinned = port.multiply(x, snapshot=snap)
    assert port.last_pass_version == 1
    fresh = TileStore.open(store_path)
    GraphHandle([fresh]).apply_updates(UpdateBatch.insert(*coords(n, 40, 7)))
    np.testing.assert_array_equal(
        pinned, SEMSpMM(fresh, SEMConfig(chunk_batch=16),
                        device="cpu").multiply(x))
    assert not np.array_equal(port.multiply(x), pinned)
    assert port.last_pass_version == 2 and not np.array_equal(base, pinned)
    shard = SEMSpMM(TileStore.open(store_path).partition_rows(2)[1],
                    device="cpu")
    with pytest.raises(ValueError, match="shard view"):
        shard.apply_updates(UpdateBatch.insert([0], [0], [1.0]))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_compacted_stores_cross_open(store_path, tmp_path, writer):
    """A store written by one package's compaction opens in the other and
    serves the same bits."""
    Handle, Batch, Store = ((GraphHandle, UpdateBatch, TileStore)
                            if writer == "port" else
                            (RefGraphHandle, RefUpdateBatch, RefTileStore))
    st = Store.open(store_path)
    n = st.header["n_rows"]
    h = churn(Handle, Batch, st, n)
    out = h.compact(str(tmp_path / "compacted"))
    x = int_operand(n)
    want = (SEMSpMM(st, SEMConfig(chunk_batch=16), device="cpu").multiply(x)
            if writer == "port" else
            RefSEMSpMM(st, RefConfig(chunk_batch=16)).multiply(x))
    port = SEMSpMM(TileStore.open(out), SEMConfig(chunk_batch=16),
                   device="cpu")
    ref = RefSEMSpMM(RefTileStore.open(out),
                     RefConfig(chunk_batch=16, use_pallas=True))
    np.testing.assert_array_equal(port.multiply(x), want)
    np.testing.assert_array_equal(ref.multiply(x), want)
    assert_same_run(port, ref)


def test_cluster_update_fanout_routed_and_partitioned(store_path, tmp_path):
    """``tests/test_mutable.py``'s cluster case on the port's ``net/``: two
    CPU hosts over two copies behind one front door.  One update batch
    fans out to both (version 1 on each); routed queries on either host
    and a partitioned one serve the same post-update bits, which are the
    reference engine's over the same base ⊕ delta."""
    import shutil
    import time
    from repro_torch.net import ClusterFrontDoor, HostServer
    from repro_torch.runtime import ReplicaSet, ServingFleet, SessionSpec
    paths = [str(tmp_path / f"copy{i}") for i in range(2)]
    for p in paths:
        for ext in (".bin", ".json"):
            shutil.copyfile(store_path + ext, p + ext)
    n = TileStore.open(store_path).header["n_rows"]
    hosts = [HostServer(ServingFleet(ReplicaSet([TileStore.open(p)],
                                                devices=["cpu"]),
                                     n_waves=1)) for p in paths]
    door = ClusterFrontDoor(heartbeat_interval=0.1)
    try:
        for h in hosts:
            door.add_host("127.0.0.1", h.start())
        x = int_operand(n, k=2, seed=14)
        y_pre = door.submit(SessionSpec.multiply(
            x, tenant_id="pre")).wait(timeout=60)

        ver = door.apply_updates(UpdateBatch.insert(*coords(n, 120, 15)))
        assert ver == 1

        routed = [door.submit(SessionSpec.multiply(
            x, tenant_id=f"r{i}")).wait(timeout=60) for i in range(4)]
        for y in routed[1:]:
            assert np.array_equal(y, routed[0])
        assert not np.array_equal(y_pre, routed[0])
        assert all(h.fleet.total_scan_passes() > 0 for h in hosts)

        part = door.submit(SessionSpec.multiply(x, tenant_id="p"),
                           partitioned=True).wait(timeout=120)
        assert np.array_equal(part, routed[0])

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            stats = door.stats()
            if set(stats["versions"].values()) == {1}:
                break
            time.sleep(0.05)
        assert stats["version_skew"] == 0
        assert set(stats["versions"].values()) == {1}
        assert stats["delta_nnz"] > 0
    finally:
        door.close()
        for h in hosts:
            h.stop()
    rst = RefTileStore.open(store_path)
    RefGraphHandle([rst]).apply_updates(
        RefUpdateBatch.insert(*coords(n, 120, 15)))
    want = RefSEMSpMM(rst, RefConfig(use_pallas=True)).multiply(x)
    np.testing.assert_array_equal(routed[0], want)
    np.testing.assert_array_equal(
        y_pre, RefSEMSpMM(RefTileStore.open(store_path),
                          RefConfig(use_pallas=True)).multiply(x))
