"""Semiring passes of the port's engine, its chunked ring path and its
partition functions, against the JAX package on the CPU.

The engine's ring step (``device="cpu"``) is held against the reference
engine's ring step with ``use_pallas=True`` (its staging layout: the
``n_valid`` plane is shipped and counted), bit for bit: min and max do not
depend on the order of their terms, and the port reduces in the reference's
order on -0.0/+0.0 ties.  NaN is compared by position (its payload is not
part of the contract).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.partition import block_partition as ref_block
from repro.core.partition import lpt_partition as ref_lpt
from repro.core.partition import split_chunks as ref_split
from repro.core.partition import tile_row_nnz as ref_trow_nnz
from repro.core.sem import SEMConfig as RefConfig
from repro.core.sem import SEMSpMM as RefSEMSpMM
from repro.core.spmm import spmm as ref_spmm
from repro.io.storage import TileStore as RefTileStore
from repro_torch.convert import chunked_from_arrays, coo_from_arrays
from repro_torch.core.partition import (block_partition, lpt_partition,
                                        split_chunks, tile_row_nnz)
from repro_torch.core.sem import SEMConfig, SEMSpMM, _ring_keys, _ring_values
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.core.spmm import spmm
from repro_torch.io.storage import TileStore

T, C, BATCH = 512, 128, 53   # 53 does not divide the chunk count
RINGS = ["plus_times", "or_and", "min_plus", "max_times"]
COUNTERS = ("bytes_read", "h2d_bytes", "overlap_batches")


@pytest.fixture(scope="module")
def paths(small_graph, tmp_path_factory):
    rng = np.random.default_rng(31)
    valued = small_graph.with_values(
        rng.integers(-3, 4, small_graph.nnz).astype(np.float32))
    d = tmp_path_factory.mktemp("trings")
    RefTileStore.write(str(d / "val"), ref_to_chunked(valued, T=T, C=C))
    RefTileStore.write(str(d / "bin"), ref_to_chunked(small_graph, T=T, C=C),
                       binary=True)
    RefTileStore.open(str(d / "val")).optimize(str(d / "valopt"))
    RefTileStore.open(str(d / "bin")).optimize(str(d / "binopt"))
    return {k: str(d / k) for k in ("val", "bin", "valopt", "binopt")}


@pytest.fixture(scope="module")
def x4(small_graph):
    """Integer operand with zeros and negatives: min/max ties between
    -0.0 and +0.0 arise (a negative weight times a zero)."""
    return np.random.default_rng(4).integers(
        -3, 4, (small_graph.n_cols, 4)).astype(np.float32)


def ref_engine(path, **cfg):
    return RefSEMSpMM(RefTileStore.open(path),
                      RefConfig(chunk_batch=BATCH, use_pallas=True,
                                pallas_variant="gather", **cfg))


def port_engine(path, **cfg):
    return SEMSpMM(TileStore.open(path), SEMConfig(chunk_batch=BATCH, **cfg),
                   device="cpu")


def assert_same_bits(got, want):
    """Equal bit for bit, NaN by position."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.where(nan, 0, got).view(np.int32),
                                  np.where(nan, 0, want).view(np.int32))


def assert_same_run(port, ref):
    for k in COUNTERS:
        assert getattr(port.io_stats, k) == getattr(ref.io_stats, k), k
    assert port.passes == ref.passes


@pytest.mark.parametrize("name", ["val", "bin", "valopt", "binopt"])
@pytest.mark.parametrize("ring", RINGS)
def test_ring_pass_matches_reference(paths, x4, name, ring):
    ref, port = ref_engine(paths[name]), port_engine(paths[name])
    want = ref.multiply(x4, semiring=ring)
    assert_same_bits(port.multiply(x4, semiring=ring), want)
    assert_same_run(port, ref)
    if ring != "plus_times":
        # a finite pass's answer is never the identity's NaN key
        assert np.isfinite(want).any()


@pytest.mark.parametrize("ring", RINGS[1:])
def test_ring_pass_serial_ragged_and_reused_accumulator(paths, x4, ring):
    """No overlap, no tail padding, and the accumulator refilled with the
    ring's identity when a second slice reuses it."""
    cfg = dict(overlap=False, fixed_shape=False)
    ref, port = ref_engine(paths["valopt"], **cfg), port_engine(
        paths["valopt"], **cfg)
    first, acc = port._multiply(x4[:, :2], semiring=ring)
    second, _ = port._multiply(x4[:, 2:], acc, semiring=ring)
    assert_same_bits(first, ref.multiply(x4[:, :2], semiring=ring))
    assert_same_bits(second, ref.multiply(x4[:, 2:], semiring=ring))
    assert_same_run(port, ref)


@pytest.mark.parametrize("ring", RINGS[1:])
def test_ring_pass_on_non_finite_operand(paths, x4, ring):
    """NaN, inf, -inf and both zeros in the operand: NaN propagates, and
    -0.0/+0.0 ties resolve as the reference's (XLA's) min and max do."""
    x = x4.copy()
    x[::7, 0] = np.nan
    x[1::7, 1] = np.inf
    x[2::7, 2] = -np.inf
    x[3::5, 3] = -0.0
    x[4::5, :] = 0.0
    for name in ("val", "binopt"):
        ref, port = ref_engine(paths[name]), port_engine(paths[name])
        assert_same_bits(port.multiply(x, semiring=ring),
                         ref.multiply(x, semiring=ring))


@pytest.mark.parametrize("ring", ["min_plus", "max_times"])
def test_ring_boundary_hook_matches_reference(paths, x4, ring):
    """A mid-pass column write and a prefix read under a ring: the read
    sees the ring's values, not the pass's internal keys."""
    new_col = (np.arange(x4.shape[0]) % 5).astype(np.float32)
    runs = []
    for mk in (ref_engine, port_engine):
        sem, seen = mk(paths["val"]), {}

        def hook(b, seen=seen):
            if b.chunk_start == 2 * BATCH:
                b.write_columns(1, new_col)
                seen["prefix"] = b.read_output(1, 0, 4)
        runs.append((sem.multiply(x4, boundary_hook=hook, semiring=ring),
                     seen["prefix"], sem))
    (want, want_pre, ref), (got, got_pre, port) = runs
    assert_same_bits(got, want)
    assert_same_bits(got_pre, want_pre)
    assert_same_run(port, ref)


def test_ring_keys_round_trip_and_order():
    """The key map is the order XLA's min and max follow: -0.0 below +0.0,
    NaN winning; every non-NaN float comes back bit for bit."""
    bits = np.random.default_rng(0).integers(-2 ** 31, 2 ** 31, 4096,
                                             dtype=np.int64).astype(np.int32)
    v = np.concatenate([bits.view(np.float32), np.float32(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45])])
    for name in ("min_plus", "max_times"):
        ring = SEMIRINGS[name]
        k = _ring_keys(torch.from_numpy(v), ring)
        back = _ring_values(k, ring).numpy()
        assert_same_bits(back, v)
        fin = ~np.isnan(v)
        order = np.argsort(k.numpy()[fin], kind="stable")
        vals = v[fin][order].astype(np.float64)
        assert np.all(np.diff(vals) >= 0)
        z = _ring_keys(torch.tensor([-0.0, 0.0]), ring)
        assert int(z[0]) < int(z[1])
        winner = (int(k.min()) if ring.scatter == "min" else int(k.max()))
        back = _ring_values(torch.tensor([winner]), ring).numpy()
        assert np.isnan(back[0])


@pytest.mark.parametrize("ring", RINGS)
def test_spmm_chunked_matches_reference(small_valued, ring):
    """The reference's ``test_semiring_paths_agree`` cases through the
    port's COO and chunked ring paths: the same finite pattern, and values
    within its tolerance."""
    x = np.random.default_rng(3).standard_normal(
        (small_valued.n_cols, 5)).astype(np.float32)
    xp = np.abs(x) + 0.1
    rct = ref_to_chunked(small_valued, T=512, C=128)
    pct = chunked_from_arrays(rct.n_rows, rct.n_cols, rct.T, rct.C, rct.meta,
                              rct.row_local, rct.col_local, rct.vals)
    coo = coo_from_arrays(small_valued.n_rows, small_valued.n_cols,
                          small_valued.rows, small_valued.cols,
                          small_valued.vals)
    want = np.asarray(ref_spmm(rct, jnp.asarray(xp), semiring=ring))
    for a in (coo, pct):
        got = spmm(a, xp, semiring=ring, device="cpu").numpy()
        fw, fg = np.isfinite(want), np.isfinite(got)
        np.testing.assert_array_equal(fg, fw)
        np.testing.assert_allclose(np.where(fg, got, 0),
                                   np.where(fw, want, 0), atol=1e-4)
    if ring != "plus_times":
        with pytest.raises(NotImplementedError, match="plus-times only"):
            spmm(pct, xp, semiring=ring, use_kernel=True, device="cpu")


@pytest.mark.parametrize("T_,C_,parts", [(32, 64, 8), (256, 64, 4)])
def test_partitions_match_reference(small_valued, T_, C_, parts):
    """``test_spmm.py``'s load-balancing cases: the port's LPT and block
    partitions, tile-row loads and chunk splits equal the reference's."""
    rct = ref_to_chunked(small_valued, T=T_, C=C_)
    pct = chunked_from_arrays(rct.n_rows, rct.n_cols, rct.T, rct.C, rct.meta,
                              rct.row_local, rct.col_local, rct.vals)
    nnz = tile_row_nnz(pct)
    np.testing.assert_array_equal(nnz, ref_trow_nnz(rct))
    for mine, theirs in ((lpt_partition, ref_lpt),
                         (block_partition, ref_block)):
        got, want = mine(nnz, parts), theirs(nnz, parts)
        np.testing.assert_array_equal(got.assignment, want.assignment)
        np.testing.assert_array_equal(got.loads, want.loads)
        assert got.imbalance == want.imbalance
    lpt = lpt_partition(nnz, parts)
    assert lpt.loads.sum() == small_valued.nnz
    assert lpt.imbalance <= block_partition(nnz, parts).imbalance
    for got, want in zip(split_chunks(pct, lpt, parts),
                         ref_split(rct, ref_lpt(nnz, parts), parts)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.sort(np.concatenate(split_chunks(pct, lpt, parts))),
        np.arange(pct.n_chunks))
