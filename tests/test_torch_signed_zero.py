"""The reference's +0.0 rule on the port's gather path, and the lane order
the gather kernel's fast path relies on, on the CPU.

The +0.0 rule.  The reference's engine step adds a (T, p) block that
starts at +0.0 into every tile row a chunk visits
(``repro/core/sem.py::_scan_batch``: ``blk = zeros.at[r].add(contrib)``,
then ``out.at[m[0]].add(blk)``), and its Pallas gather kernel does the same
(``repro/kernels/sem_spmm.py::_merge_block``: ``acc + blk``).  So after a
batch no element of a visited tile row is -0.0, while tile rows the batch
does not visit keep their bits, signs included.  The port's gather plain
version (``spmm_tiles_acc_plain``) is held to both here, bit for bit with
signs, on accumulators of -0.0, of +0.0 and of a sentinel, and to the
port's densify plain version, which follows the same rule.

The batches are hand-built corners (T = 128, C = 32, 3 tile rows x 2 tile
columns, integer values, so every float32 sum is exact in any order),
valued and binary, as uint16 and as int32 planes, padded to 7 chunks with
the engine's tail pads (the last real chunk's coordinates, nnz 0):

* hub        every lane of a chunk in one row;
* distinct   every live lane in a row of its own;
* split      a row in several runs of lanes (no writer produces it);
* empty      a chunk with nnz = 0 alone on its tile row (still +0.0 there);
* alternate  tile rows 0, 1, 0, 1, 0 (the writers keep a tile row's chunks
             together).

The order.  The writers of both packages sort a chunk's lanes by (row, col)
and the chunks by (tile row, tile col), and an optimized store's flattened
delta keys never decrease; the gather kernel takes a faster route where a
chunk's rows do not go back, so these tests hold the writers to it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.sem import _batch_step, _batch_step_binary
from repro.io.storage import TileStore as RefTileStore
from repro.kernels.sem_spmm import spmm_tiles_acc as ref_spmm_tiles_acc
from repro_torch.convert import coo_from_arrays
from repro_torch.core.formats import ENC_COLS_U8, to_chunked
from repro_torch.io.storage import TileStore
from repro_torch.kernels import sem_spmm

T, C, N_TILE_ROWS, N_CHUNKS = 128, 32, 3, 7
CASES = ("hub", "distinct", "split", "empty", "alternate")
FILLS = (-0.0, 0.0, 12345.0)


def _hand_built(case, rng):
    """``(meta, rows, cols, vals, n_valid)`` of one hand-built batch of
    N_CHUNKS chunks: the case's tiles, then tail pads."""
    tiles = {"hub": [(1, 0, C), (1, 1, 9)],
             "distinct": [(0, 1, 20), (2, 0, C), (2, 1, 1)],
             "split": [(2, 0, 12), (2, 1, C)],
             "empty": [(0, 0, 6), (1, 1, 0), (2, 1, 3)],
             "alternate": [(0, 0, 10), (1, 1, 7), (0, 1, C), (1, 0, 5),
                           (0, 0, 4)]}[case]
    meta = np.zeros((N_CHUNKS, 4), np.int32)
    rows = np.zeros((N_CHUNKS, C), np.uint16)
    cols = np.zeros((N_CHUNKS, C), np.uint16)
    vals = np.zeros((N_CHUNKS, C), np.float32)
    for g, (tr, tc, k) in enumerate(tiles):
        meta[g] = (tr, tc, 0, k)
        cols[g, :k] = np.sort(rng.choice(T, k, replace=False))
        if case == "hub" and g == 0:
            r = np.full(k, 5)
        elif case == "distinct":
            r = np.sort(rng.choice(T, k, replace=False))
        elif case == "split" and g == 0:
            r = np.array([4, 4, 9, 9, 4, 4, 11, 4, 9, 9, 9, 4])
        else:
            r = np.sort(rng.integers(0, T, k))
        rows[g, :k] = r
        vals[g, :k] = rng.integers(-3, 4, k)
    meta[len(tiles):] = meta[len(tiles) - 1]      # the engine's tail pads
    meta[len(tiles):, 3] = 0
    return meta, rows, cols, vals, len(tiles)


def _as_torch(a):
    if a is None:
        return None
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _port(variant, meta, nv, rows, cols, vals, x_pad, acc0):
    """One batch through the port's wrapper on CPU tensors (the variant's
    plain version)."""
    return sem_spmm.spmm_tiles_acc(
        _as_torch(meta), torch.tensor([nv], dtype=torch.int32),
        _as_torch(rows), _as_torch(cols), _as_torch(vals),
        torch.from_numpy(x_pad), torch.from_numpy(acc0.copy()), T=T,
        variant=variant).numpy()


def _engine_step(meta, rows, cols, vals, x_pad, acc0):
    """The reference engine's default step over the whole batch, tail pads
    included (the engine runs them; a pad adds nothing)."""
    out = jnp.asarray(acc0.reshape(-1, T, acc0.shape[1]))
    if vals is None:
        out = _batch_step_binary(jnp.asarray(meta), jnp.asarray(rows),
                                 jnp.asarray(cols), jnp.asarray(x_pad), out,
                                 T)
    else:
        out = _batch_step(jnp.asarray(meta), jnp.asarray(rows),
                          jnp.asarray(cols), jnp.asarray(vals),
                          jnp.asarray(x_pad), out, T)
    return np.asarray(out).reshape(acc0.shape)


def _pallas_gather(meta, nv, rows, cols, vals, x_pad, acc0):
    """The reference's Pallas gather kernel in interpret mode.  It keeps one
    tile row's window across a run of that row's chunks and seeds it from
    the accumulator it was given, so it is called once per run of one tile
    row, each call on the previous one's output; every call sees all
    N_CHUNKS chunks from the run's first on (the rest past ``n_valid``),
    so one compiled shape serves every run."""
    want = jnp.asarray(acc0)
    bounds = [0] + [g for g in range(1, nv)
                    if meta[g, 0] != meta[g - 1, 0]] + [nv]
    for s, e in zip(bounds, bounds[1:]):
        take = np.minimum(np.arange(s, s + N_CHUNKS), N_CHUNKS - 1)
        want = ref_spmm_tiles_acc(
            meta[take], np.asarray([e - s], np.int32), rows[take],
            cols[take], None if vals is None else vals[take],
            jnp.asarray(x_pad), want, T=T, variant="gather")
    return np.asarray(want)


def _case(case, binary, dtype, p=3):
    rng = np.random.default_rng(CASES.index(case) + 10 * p)
    meta, rows, cols, vals, nv = _hand_built(case, rng)
    if dtype == "i32":
        rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    x_pad = rng.integers(-4, 5, (2 * T, p)).astype(np.float32)
    return meta, nv, rows, cols, None if binary else vals, x_pad


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", ["u16", "i32"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_gather_plain_matches_reference_with_signs(case, binary, dtype):
    """The port's gather plain version against the reference's engine step
    on accumulators of -0.0, +0.0 and a sentinel, and against its Pallas
    gather kernel on the -0.0 one, bit for bit with signs: visited tile
    rows hold no -0.0 after the batch, tile rows outside it keep their
    bits."""
    meta, nv, rows, cols, vals, x_pad = _case(case, binary, dtype)
    touched = np.isin(np.arange(N_TILE_ROWS), meta[:nv, 0])
    for fill in FILLS:
        acc0 = np.full((N_TILE_ROWS * T, x_pad.shape[1]), fill, np.float32)
        got = _port("gather", meta, nv, rows, cols, vals, x_pad, acc0)
        np.testing.assert_array_equal(
            _bits(got), _bits(_engine_step(meta, rows, cols, vals, x_pad,
                                           acc0)))
        # interpret mode costs about a second a call: the Pallas kernel on
        # the input that shows the rule
        if np.signbit(fill):
            np.testing.assert_array_equal(
                _bits(got), _bits(_pallas_gather(meta, nv, rows, cols, vals,
                                                 x_pad, acc0)))
        blocks = got.reshape(N_TILE_ROWS, T, -1)
        np.testing.assert_array_equal(
            _bits(blocks[~touched]), _bits(np.full_like(blocks[~touched],
                                                        fill)))
        assert not (np.signbit(blocks[touched])
                    & (blocks[touched] == 0)).any()


@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["u16", "i32"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_gather_and_densify_plain_agree_with_signs(case, binary, dtype, p):
    """The port's two plain versions give the same bits, signs included,
    on the same integer batch and accumulator."""
    meta, nv, rows, cols, vals, x_pad = _case(case, binary, dtype, p)
    for fill in FILLS:
        acc0 = np.full((N_TILE_ROWS * T, p), fill, np.float32)
        np.testing.assert_array_equal(
            _bits(_port("gather", meta, nv, rows, cols, vals, x_pad, acc0)),
            _bits(_port("mxu", meta, nv, rows, cols, vals, x_pad, acc0)))


@pytest.mark.parametrize("kind", ["val", "bin", "opt"])
def test_stream_on_negative_zero_matches_engine_step(small_graph, tmp_path,
                                                     kind):
    """A reference-written store's 37-chunk batches (so batches start and
    end inside tile rows) through the port's gather plain version and the
    reference's engine step, on an accumulator of -0.0: the same bits,
    signs included, after every batch."""
    rng = np.random.default_rng(3)
    g = small_graph.with_values(rng.integers(-3, 4, small_graph.nnz)
                                .astype(np.float32))
    Tc, Cc, p = 256, 64, 2
    st = RefTileStore.write(str(tmp_path / "s"),
                            ref_to_chunked(small_graph if kind == "bin"
                                           else g, T=Tc, C=Cc),
                            binary=kind == "bin")
    if kind == "opt":
        st = st.optimize(str(tmp_path / "o"), reorder=False)
    x_pad = np.zeros((-(-st.header["n_cols"] // Tc) * Tc, p), np.float32)
    x_pad[: st.header["n_cols"]] = rng.integers(-4, 5,
                                                (st.header["n_cols"], p))
    n = -(-st.header["n_rows"] // Tc) * Tc
    acc_p = torch.full((n, p), -0.0)
    acc_r = jnp.full((n // Tc, Tc, p), -0.0)
    for s, c in st.batch_plan(37):
        meta, rows, cols, vals = (np.array(a) if a is not None else None
                                  for a in st.read_batch_raw(s, c))
        sem_spmm.spmm_tiles_acc(_as_torch(meta),
                                torch.tensor([c], dtype=torch.int32),
                                _as_torch(rows), _as_torch(cols),
                                _as_torch(vals), torch.from_numpy(x_pad),
                                acc_p, T=Tc)
        if vals is None:
            acc_r = _batch_step_binary(jnp.asarray(meta), jnp.asarray(rows),
                                       jnp.asarray(cols), jnp.asarray(x_pad),
                                       acc_r, Tc)
        else:
            acc_r = _batch_step(jnp.asarray(meta), jnp.asarray(rows),
                                jnp.asarray(cols), jnp.asarray(vals),
                                jnp.asarray(x_pad), acc_r, Tc)
        np.testing.assert_array_equal(
            _bits(acc_p.numpy()), _bits(np.asarray(acc_r).reshape(n, p)))


# -- the order the writers keep ----------------------------------------------
def _stores(writer, coo, binary_coo, tmp_path, Tc, Cc):
    """Every store kind one package writes at (Tc, Cc): the ChunkedTiles,
    raw valued and binary stores, and both optimized (reordered)."""
    if writer == "reference":
        ct, ct_bin = (ref_to_chunked(m, T=Tc, C=Cc) for m in (coo,
                                                              binary_coo))
        write = RefTileStore.write
    else:
        ct, ct_bin = (to_chunked(coo_from_arrays(
            m.n_rows, m.n_cols, m.rows, m.cols, m.vals), T=Tc, C=Cc)
            for m in (coo, binary_coo))
        write = TileStore.write
    val = write(str(tmp_path / f"{writer}v{Tc}"), ct)
    binary = write(str(tmp_path / f"{writer}b{Tc}"), ct_bin, binary=True)
    return ct, {"val": val, "bin": binary,
                "valopt": val.optimize(str(tmp_path / f"{writer}vo{Tc}")),
                "binopt": binary.optimize(str(tmp_path / f"{writer}bo{Tc}"))}


def _check_order(meta, rows, cols, Tc):
    """Chunks by (tile row, tile col); each chunk's live lanes by
    (row, col), so the flattened key row * T + col never decreases."""
    key = meta[:, 0].astype(np.int64) * (1 << 20) + meta[:, 1]
    assert (np.diff(key) >= 0).all()
    live = np.arange(rows.shape[1])[None, :] < meta[:, 3:4]
    k = rows.astype(np.int64) * Tc + cols.astype(np.int64)
    assert (np.diff(k, axis=1)[live[:, 1:]] >= 0).all()


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("Tc,Cc", [(128, 32), (256, 64), (512, 128)])
def test_writers_sort_lanes_and_chunks(small_graph, tmp_path, writer, Tc,
                                       Cc):
    """``to_chunked``, ``TileStore.write`` valued and binary, and
    ``.optimize()`` (decoded), from both packages' writers: chunks sorted by
    (tile row, tile col) and each chunk's live lanes by (row, col).  An
    optimized store's delta planes, decoded as the kernels decode them
    (``_decode_lanes``), give the same lanes, so the keys they rebuild
    never decrease."""
    rng = np.random.default_rng(Tc)
    coo = small_graph.with_values(rng.integers(-3, 4, small_graph.nnz)
                                  .astype(np.float32))
    ct, stores = _stores(writer, coo, small_graph, tmp_path, Tc, Cc)
    _check_order(ct.meta, ct.row_local, ct.col_local, Tc)
    for name, st in stores.items():
        for s, n in st.batch_plan(64):
            meta, rows, cols, _ = (np.asarray(a) if a is not None else None
                                   for a in st.read_batch(s, n))
            _check_order(meta, rows, cols, Tc)
            raw = st.read_batch_raw(s, n)
            if np.asarray(raw[2]).dtype != np.uint8:
                continue
            r, c = sem_spmm._decode_lanes(*(_as_torch(a) for a in raw[:3]),
                                          Tc)
            live = np.arange(Cc)[None, :] < meta[:, 3:4]
            np.testing.assert_array_equal(r.numpy()[live], rows[live])
            np.testing.assert_array_equal(c.numpy()[live], cols[live])
        if name.endswith("opt"):
            tags = np.asarray(st.header["encodings"])
            assert (tags & ENC_COLS_U8).any()
