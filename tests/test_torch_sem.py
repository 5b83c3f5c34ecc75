"""The port's semi-external engine on the CPU (``device="cpu"``: the step
is the kernel's plain version) against the JAX package's engine with
``use_pallas=True`` — its staging layout, with the gather kernel in
interpret mode.

Integer-valued stores and operands make every comparison bitwise; the
``IOStats`` counters (``bytes_read``, ``h2d_bytes``, ``overlap_batches``)
and ``passes`` do not depend on the machine and must be equal exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import to_chunked
from repro.core.sem import SEMConfig as RefConfig
from repro.core.sem import SEMSpMM as RefSEMSpMM
from repro.io.storage import DenseStore as RefDenseStore
from repro.io.storage import TileStore as RefTileStore
from repro.runtime.cache import HotChunkCache
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.io.storage import DenseStore, TileStore

T, C, BATCH = 512, 128, 53   # 53 does not divide the chunk count
COUNTERS = ("bytes_read", "h2d_bytes", "overlap_batches")


@pytest.fixture(scope="module")
def paths(small_graph, tmp_path_factory):
    rng = np.random.default_rng(21)
    valued = small_graph.with_values(
        rng.integers(-3, 4, small_graph.nnz).astype(np.float32))
    d = tmp_path_factory.mktemp("tsem")
    RefTileStore.write(str(d / "val"), to_chunked(valued, T=T, C=C))
    RefTileStore.write(str(d / "bin"), to_chunked(small_graph, T=T, C=C),
                       binary=True)
    RefTileStore.open(str(d / "val")).optimize(str(d / "valopt"))
    RefTileStore.open(str(d / "bin")).optimize(str(d / "binopt"))
    return {k: str(d / k) for k in ("val", "bin", "valopt", "binopt")}


@pytest.fixture(scope="module")
def x8(small_graph):
    return np.random.default_rng(3).integers(
        -4, 5, (small_graph.n_cols, 8)).astype(np.float32)


def ref_engine(path, mode="sem", **cfg):
    return RefSEMSpMM(RefTileStore.open(path),
                      RefConfig(chunk_batch=BATCH, use_pallas=True,
                                pallas_variant="gather", **cfg), mode=mode)


def port_engine(path, mode="sem", **cfg):
    return SEMSpMM(TileStore.open(path), SEMConfig(chunk_batch=BATCH, **cfg),
                   mode=mode, device="cpu")


def assert_same_run(port, ref):
    for k in COUNTERS:
        assert getattr(port.io_stats, k) == getattr(ref.io_stats, k), k
    assert port.passes == ref.passes


@pytest.mark.parametrize("name", ["val", "bin", "valopt", "binopt"])
@pytest.mark.parametrize("cfg", [dict(), dict(overlap=False),
                                 dict(fixed_shape=False),
                                 dict(overlap=False, fixed_shape=False)],
                         ids=["overlap-fixed", "serial-fixed",
                              "overlap-ragged", "serial-ragged"])
def test_multiply_matches_reference(paths, x8, name, cfg):
    ref, port = ref_engine(paths[name], **cfg), port_engine(paths[name], **cfg)
    np.testing.assert_array_equal(port.multiply(x8), ref.multiply(x8))
    assert_same_run(port, ref)
    assert port.n_batches == ref.n_batches


@pytest.mark.parametrize("name", ["val", "binopt"])
def test_default_matches_reference_default_scan_step(paths, x8, name):
    """The reference engine's default step is its scan (``use_pallas``
    off): the same gather arithmetic, so the port's default agrees with it
    bit for bit on integer data (h2d differs by the 4-byte ``n_valid`` the
    port ships per batch, as the reference's own Pallas layout does)."""
    ref = RefSEMSpMM(RefTileStore.open(paths[name]),
                     RefConfig(chunk_batch=BATCH))
    port = port_engine(paths[name])
    np.testing.assert_array_equal(port.multiply(x8), ref.multiply(x8))
    assert port.io_stats.bytes_read == ref.io_stats.bytes_read
    assert (port.io_stats.h2d_bytes
            == ref.io_stats.h2d_bytes + 4 * port.n_batches)


@pytest.mark.parametrize("name", ["val", "bin", "valopt"])
def test_im_mode_and_host_decode_match_reference(paths, x8, name):
    """IM mode (host-resident decoded batches, staged every pass) and the
    host-decode ablation ship int32 planes plus values."""
    for kw in (dict(mode="im"), dict(decode_on_device=False)):
        ref, port = ref_engine(paths[name], **kw), port_engine(paths[name],
                                                               **kw)
        for _ in range(2):
            np.testing.assert_array_equal(port.multiply(x8),
                                          ref.multiply(x8))
        assert_same_run(port, ref)


def test_multiply_external_reuses_accumulator(paths, x8, tmp_path):
    """Regime 3: two column slices, two streaming passes, one reused
    accumulator; output written once."""
    n = x8.shape[0]
    outs = []
    for tag, Store, mk in (("ref", RefDenseStore, ref_engine),
                           ("port", DenseStore, port_engine)):
        xs = Store(str(tmp_path / f"x{tag}.f32"), n, 8)
        xs.write_cols(0, x8)
        out = Store(str(tmp_path / f"o{tag}.f32"), n, 8)
        sem = mk(paths["val"])
        sem.multiply_external(xs, out, cols_in_memory=4)
        outs.append((out.to_array(), sem, out.stats.bytes_written))
    (want, ref, ref_w), (got, port, port_w) = outs
    np.testing.assert_array_equal(got, want)
    assert port.passes == ref.passes == 2
    assert port.io_stats.bytes_read == 2 * port.store.nbytes
    assert_same_run(port, ref)
    assert port_w == ref_w == n * 8 * 4
    assert port.columns_that_fit(8) == ref.columns_that_fit(8)
    assert port.leftover_budget(3) == ref.leftover_budget(3)


def test_accumulator_reuse_keeps_earlier_results(paths, x8):
    """A slice's host result must not alias the accumulator the next slice
    re-zeroes."""
    port = port_engine(paths["val"])
    first, acc = port._multiply(x8[:, :4])
    keep = first.copy()
    port._multiply(x8[:, 4:], acc)
    np.testing.assert_array_equal(first, keep)


@pytest.mark.parametrize("name", ["val", "valopt"])
def test_boundary_hook_matches_reference(paths, x8, name):
    """A mid-pass column swap and a prefix read through PassBoundary land
    identically: rows streamed after the boundary see the new column."""
    new_col = (np.arange(x8.shape[0]) % 7).astype(np.float32)
    results = []
    for mk in (ref_engine, port_engine):
        sem = mk(paths[name])
        seen = {}

        def hook(b, seen=seen):
            seen.setdefault("starts", []).append(b.chunk_start)
            if b.chunk_start == 2 * BATCH:
                b.write_columns(3, new_col)
                seen["prefix"] = b.read_output(1, 0, 2)
        results.append((sem.multiply(x8, boundary_hook=hook), seen, sem))
    (want, rseen, ref), (got, pseen, port) = results
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pseen["prefix"], rseen["prefix"])
    assert pseen["starts"] == rseen["starts"]
    assert_same_run(port, ref)
    assert not np.array_equal(got[:, 3], port_engine(paths[name])
                              .multiply(x8)[:, 3])


def test_hot_chunk_cache_serves_second_pass(paths, x8):
    """The duck-typed hot-chunk cache: the second pass is served from
    pinned batches, counted as cache hits, not slow-tier reads."""
    runs = []
    for mk in (ref_engine, port_engine):
        sem = mk(paths["valopt"])
        cache = HotChunkCache(budget_bytes=1 << 30)
        a = sem.multiply(x8, cache=cache)
        b = sem.multiply(x8, cache=cache)
        np.testing.assert_array_equal(a, b)
        runs.append((b, sem.io_stats.cache_hit_bytes, sem))
    (want, ref_hits, ref), (got, port_hits, port) = runs
    np.testing.assert_array_equal(got, want)
    assert port_hits == ref_hits == port.store.nbytes
    assert_same_run(port, ref)


def test_prestaged_operand_is_taken_as_is(paths, x8):
    """A float32 tensor already padded on the device is used without a
    copy and without h2d accounting (a boundary write copies it, leaving
    the caller's tensor untouched)."""
    port = port_engine(paths["val"])
    x_pad = torch.zeros((port.padded_cols, 8))
    x_pad[: x8.shape[0]] = torch.from_numpy(x8)
    before = x_pad.clone()
    got = port.multiply(x_pad, boundary_hook=lambda b: b.write_columns(
        0, np.ones(x8.shape[0], np.float32)))
    assert torch.equal(x_pad, before)
    want = port_engine(paths["val"]).multiply(
        np.concatenate([np.ones((x8.shape[0], 1), np.float32), x8[:, 1:]],
                       axis=1))
    np.testing.assert_array_equal(got, want)


def test_out_of_slice_features_raise(paths, x8):
    """Features once out of the port's slice now answer as the reference's
    engine does: a ring other than plus-times, the densify variant, and a
    store with a delta log.  Only an unknown kernel variant still
    raises."""
    from repro.io.storage import GraphHandle as RefGraphHandle
    from repro.io.storage import UpdateBatch as RefUpdateBatch
    from repro_torch.io.storage import GraphHandle, UpdateBatch
    port, ref = port_engine(paths["val"]), ref_engine(paths["val"])
    np.testing.assert_array_equal(port.multiply(x8, semiring="min_plus"),
                                  ref.multiply(x8, semiring="min_plus"))
    assert_same_run(port, ref)
    mxu = port_engine(paths["val"], kernel_variant="mxu")
    ref = RefSEMSpMM(RefTileStore.open(paths["val"]),
                     RefConfig(chunk_batch=BATCH, use_pallas=True,
                               pallas_variant="mxu"))
    np.testing.assert_array_equal(mxu.multiply(x8), ref.multiply(x8))
    assert_same_run(mxu, ref)
    with pytest.raises(ValueError, match="unknown kernel variant"):
        port_engine(paths["val"], kernel_variant="vpu").multiply(x8)
    st, rst = TileStore.open(paths["val"]), RefTileStore.open(paths["val"])
    GraphHandle([st]).apply_updates(UpdateBatch.insert([0], [1], [1.0]))
    RefGraphHandle([rst]).apply_updates(RefUpdateBatch.insert([0], [1],
                                                              [1.0]))
    port = SEMSpMM(st, SEMConfig(chunk_batch=BATCH), device="cpu")
    ref = RefSEMSpMM(rst, RefConfig(chunk_batch=BATCH, use_pallas=True,
                                    pallas_variant="gather"))
    np.testing.assert_array_equal(port.multiply(x8), ref.multiply(x8))
    assert port.last_pass_version == ref.last_pass_version == 1
    assert_same_run(port, ref)
