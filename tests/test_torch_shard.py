"""The port's sharded scan (``repro_torch.distributed.shard_scan``) against
its own single scan and the JAX package's sharded scan, on the CPU.

Shards are contiguous tile-row ranges of one store; every output row keeps
the single scan's order of accumulation, so the concatenated result equals
the single scan bit for bit, and ``IOStats`` and ``passes`` equal the
reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.sem import SEMConfig as RefConfig
from repro.distributed.shard_scan import ShardedSEMSpMM as RefSharded
from repro.io.storage import TileStore as RefTileStore
from repro.io.storage import UpdateBatch as RefUpdateBatch
from repro.runtime import Mutable
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.distributed.shard_scan import ShardedSEMSpMM
from repro_torch.io.storage import GraphHandle, TileStore, UpdateBatch

T, C, BATCH = 256, 64, 16
COUNTERS = ("bytes_read", "h2d_bytes", "overlap_batches")


@pytest.fixture(scope="module")
def paths(small_graph, tmp_path_factory):
    rng = np.random.default_rng(41)
    valued = small_graph.with_values(
        rng.integers(-3, 4, small_graph.nnz).astype(np.float32))
    d = tmp_path_factory.mktemp("tshard")
    RefTileStore.write(str(d / "val"), ref_to_chunked(valued, T=T, C=C))
    RefTileStore.write(str(d / "bin"), ref_to_chunked(small_graph, T=T, C=C),
                       binary=True)
    RefTileStore.open(str(d / "val")).optimize(str(d / "valopt"))
    return {k: str(d / k) for k in ("val", "bin", "valopt")}


@pytest.fixture(scope="module")
def x3(small_graph):
    return np.random.default_rng(6).integers(
        -4, 5, (small_graph.n_cols, 3)).astype(np.float32)


def sharded(path, n_shards, **kw):
    return ShardedSEMSpMM(TileStore.open(path), n_shards=n_shards,
                          config=SEMConfig(chunk_batch=BATCH),
                          devices=["cpu"], **kw)


def ref_sharded(path, n_shards):
    return RefSharded(RefTileStore.open(path), n_shards=n_shards,
                      config=RefConfig(chunk_batch=BATCH, use_pallas=True))


def single(path):
    return SEMSpMM(TileStore.open(path), SEMConfig(chunk_batch=BATCH),
                   device="cpu")


def assert_same_run(port, ref):
    for k in COUNTERS:
        assert getattr(port.io_stats, k) == getattr(ref.io_stats, k), k
    assert port.passes == ref.passes


@pytest.mark.parametrize("name", ["val", "bin", "valopt"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_scan_equals_single_scan(paths, x3, name, n_shards):
    with sharded(paths[name], n_shards) as sh:
        ref = ref_sharded(paths[name], n_shards)
        got = sh.multiply(x3)
        assert sh.n_shards == ref.n_shards == n_shards
        np.testing.assert_array_equal(got.view(np.int32),
                                      single(paths[name]).multiply(x3)
                                      .view(np.int32))
        np.testing.assert_array_equal(got, ref.multiply(x3))
        assert sh.io_stats.bytes_read == sh.store.nbytes
        assert_same_run(sh, ref)
        ref.close()


@pytest.mark.parametrize("ring", ["or_and", "min_plus", "max_times"])
def test_sharded_ring_scan(paths, x3, ring):
    with sharded(paths["valopt"], 3) as sh:
        got = sh.multiply(x3, semiring=ring)
        want = single(paths["valopt"]).multiply(x3, semiring=ring)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_coordinator_hook_matches_reference(paths, x3):
    """The hook runs on shard 0 only; its column writes are replayed for
    the held-back shards, and the prefix it reads is global."""
    new_col = (np.arange(x3.shape[0]) % 5).astype(np.float32)
    runs = []
    for eng in (ref_sharded(paths["valopt"], 2), sharded(paths["valopt"], 2)):
        seen = {"starts": []}

        def hook(b, seen=seen):
            seen["starts"].append(b.chunk_start)
            if b.chunk_start == 2 * BATCH:
                b.write_columns(2, new_col)
                seen["prefix"] = b.read_output(1, 0, 3)
        runs.append((eng.multiply(x3, boundary_hook=hook), seen, eng))
    (want, rseen, ref), (got, pseen, port) = runs
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pseen["prefix"], rseen["prefix"])
    assert pseen["starts"] == rseen["starts"]
    assert_same_run(port, ref)
    port.close()
    ref.close()


def test_sharded_overlay_and_pin_gating(paths, x3):
    """``tests/test_mutable.py``'s sharded overlay: one snapshot for the
    fan-out, bit-equal to a single engine sharing the overlay, equal to the
    reference's sharded overlay; the shard views pin the layout until
    close."""
    st = TileStore.open(paths["val"])
    n = st.header["n_rows"]
    r = np.random.default_rng(31)
    ins = (r.integers(0, n, 100), r.integers(0, n, 100))
    sh = ShardedSEMSpMM(st, n_shards=2, config=SEMConfig(chunk_batch=BATCH),
                        devices=["cpu"])
    assert sh.apply_updates(UpdateBatch.insert(*ins)) == 1
    assert isinstance(sh, Mutable) and sh.version == 1 and sh.delta_nnz > 0
    ys = sh.multiply(x3)
    assert sh.last_pass_version == 1

    shared = TileStore.open(paths["val"])
    shared._delta_src = st   # share the overlay
    np.testing.assert_array_equal(ys, SEMSpMM(
        shared, SEMConfig(chunk_batch=BATCH), device="cpu").multiply(x3))

    ref = RefSharded(RefTileStore.open(paths["val"]), n_shards=2,
                     config=RefConfig(chunk_batch=BATCH, use_pallas=True))
    ref.apply_updates(RefUpdateBatch.insert(*ins))
    np.testing.assert_array_equal(ys, ref.multiply(x3))
    assert_same_run(sh, ref)
    ref.close()

    h = st.handle
    assert h.compact() is not None
    assert not h.try_install()
    sh.close()
    assert h.try_install() and st.generation == 1


def test_pin_taken_when_the_handle_comes_later(paths):
    """A handle attached after construction: ``pin_layout`` takes the pin
    once, however often it is called, and close drops it."""
    st = TileStore.open(paths["bin"])
    sh = ShardedSEMSpMM(st, n_shards=2, devices=["cpu"])
    h = GraphHandle([st])
    sh.pin_layout()
    sh.pin_layout()
    assert h._pins == 1
    sh.close()
    assert h._pins == 0


def test_default_devices_need_a_card(paths, monkeypatch):
    """No devices named and no card: the sharded engine raises instead of
    moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedSEMSpMM(TileStore.open(paths["val"]))
