"""The port's densify variant on the CPU: the plain versions of the
chunk-batch densify kernel (K1b, ``spmm_tiles_acc(variant="mxu")``) and of
the one-shot one (K2-mxu, ``spmm_tiles(variant="mxu")``) against the JAX
package's Pallas mxu kernels in interpret mode, and the engine with
``kernel_variant="mxu"`` against the reference engine's Pallas mxu path.

Sizes are the reference tests': T in {128, 256, 512}, C <= 128, p in
{1, 3, 8, 16}; hand-built batches of the densify kernel's corners (T = 128,
C = 32, p up to 16) join them.  Integer-valued data is compared bit for bit (each chunk's
one-hot products and the f32 sums of integers below 2**24 are exact in any
order, in both packages); normal data to ``rtol = atol = 1e-5``, since the
two packages' matrix products sum a chunk's lanes in different orders.
IOStats counters do not depend on the variant and must be equal exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.sem import SEMConfig as RefConfig
from repro.core.sem import SEMSpMM as RefSEMSpMM
from repro.io.storage import TileStore as RefTileStore
from repro.kernels.ops import spmm_pallas, spmm_pallas_batch
from repro.kernels.ref import spmm_ref
from repro.kernels.sem_spmm import spmm_tiles as ref_spmm_tiles
from repro.kernels.sem_spmm import spmm_tiles_acc as ref_spmm_tiles_acc
from repro_torch.convert import chunked_from_arrays, coo_from_arrays
from repro_torch.core.formats import ENC_FLAT_U16, ENC_FLAT_U24, to_chunked
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.core.spmm import spmm
from repro_torch.io.storage import TileStore
from repro_torch.kernels import sem_spmm
from repro_torch.kernels.ops import spmm_kernel

SIZES = {128: 32, 256: 64, 512: 128}     # T -> C
TOL = 1e-5


@pytest.fixture(scope="module")
def small_int(small_graph):
    rng = np.random.default_rng(11)
    return small_graph.with_values(
        rng.integers(-3, 4, small_graph.nnz).astype(np.float32))


@pytest.fixture(scope="module")
def stores(small_int, small_graph, tmp_path_factory):
    """Reference-written stores at each T: raw valued (integer values), raw
    binary, and the valued store optimized (16-bit deltas at T = 128 and
    256; unreordered at T = 512, which leaves some 24-bit chunks)."""
    d = tmp_path_factory.mktemp("tmxu")
    out = {}
    for T, C in SIZES.items():
        out[f"val{T}"] = RefTileStore.write(
            str(d / f"v{T}"), ref_to_chunked(small_int, T=T, C=C)).path
        out[f"bin{T}"] = RefTileStore.write(
            str(d / f"b{T}"), ref_to_chunked(small_graph, T=T, C=C),
            binary=True).path
        out[f"opt{T}"] = RefTileStore.open(out[f"val{T}"]).optimize(
            str(d / f"o{T}"), reorder=T != 512).path
    return out


def _as_torch(a):
    if a is None:
        return None
    a = np.array(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _x_pad(st, p, seed, integer=True):
    rng = np.random.default_rng(seed)
    T = st.header["T"]
    x = np.zeros((-(-st.header["n_cols"] // T) * T, p), np.float32)
    x[: st.header["n_cols"]] = (rng.integers(-4, 5, (st.header["n_cols"], p))
                                if integer else
                                rng.standard_normal((st.header["n_cols"], p)))
    return x


# Hand-built batches for the densify kernel's corners (T = 128, C = 32,
# 3 tile rows x 2 tile columns, raw uint16 planes, integer values):
#   hub        every lane of a chunk in one row (one compressed group spans
#              all C lanes);
#   distinct   every live lane in a row of its own;
#   split      a row in several runs of lanes (no writer produces it: they
#              sort a tile's entries by (row, col), see
#              test_writers_keep_each_row_one_run);
#   empty      a chunk with nnz = 0 alone on its tile row, which still
#              takes +0.0;
#   alternate  tile rows 0, 1, 0, 1, 0 (the writers keep a tile row's
#              chunks together).
# Each batch ends in two tail pads past n_valid.
HAND_T, HAND_C = 128, 32
HAND_BUILT = ("hub", "distinct", "split", "empty", "alternate")


def _hand_built(case, rng):
    """``(meta, rows, cols, vals, n_valid)`` of one hand-built batch; vals
    is None for a binary batch."""
    T, C = HAND_T, HAND_C
    tiles = {"hub": [(1, 0, C), (1, 1, 9)],
             "distinct": [(0, 1, 20), (2, 0, C), (2, 1, 1)],
             "split": [(2, 0, 12), (2, 1, C)],
             "empty": [(0, 0, 6), (1, 1, 0), (2, 1, 3)],
             "alternate": [(0, 0, 10), (1, 1, 7), (0, 1, C), (1, 0, 5),
                           (0, 0, 4)]}[case]
    n = len(tiles) + 2
    meta = np.zeros((n, 4), np.int32)
    rows = np.zeros((n, C), np.uint16)
    cols = np.zeros((n, C), np.uint16)
    vals = np.zeros((n, C), np.float32)
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
    binary = case in ("hub", "empty")
    return (meta, rows, cols, None if binary else vals,
            np.asarray([len(tiles)], np.int32))


def _hand_built_both(case, p, decoded):
    """One hand-built batch through the port's wrapper (the plain version,
    on the CPU) and the Pallas mxu kernel, both on a -0.0 accumulator.  The
    Pallas kernel keeps one tile row's window across a run of that row's
    chunks and seeds it from the accumulator it was given, so it is called
    once per run of one tile row, each call on the previous one's output."""
    rng = np.random.default_rng(p)
    meta, rows, cols, vals, nv = _hand_built(case, rng)
    T = HAND_T
    x_pad = rng.integers(-4, 5, (2 * T, p)).astype(np.float32)
    acc0 = np.full((3 * T, p), -0.0, np.float32)
    if decoded:
        rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    got = sem_spmm.spmm_tiles_acc(
        _as_torch(meta), torch.from_numpy(nv), _as_torch(rows),
        _as_torch(cols), _as_torch(vals), torch.from_numpy(x_pad),
        torch.from_numpy(acc0.copy()), T=T, variant="mxu").numpy()
    want = jnp.asarray(acc0)
    bounds = [0] + [g for g in range(1, nv[0])
                    if meta[g, 0] != meta[g - 1, 0]] + [nv[0]]
    for s, e in zip(bounds, bounds[1:]):
        want = ref_spmm_tiles_acc(
            meta[s:e], np.asarray([e - s], np.int32), rows[s:e], cols[s:e],
            None if vals is None else vals[s:e], jnp.asarray(x_pad), want,
            T=T, variant="mxu")
    return got, np.asarray(want)


def _stream_both(path, x_pad, decoded=False, batch=37):
    """Every batch of a store through the port's wrapper (the plain version,
    on the CPU) and the reference's jitted engine step, both "mxu"."""
    st = TileStore.open(path)
    T = st.header["T"]
    n = -(-st.header["n_rows"] // T) * T
    acc_p = torch.zeros((n, x_pad.shape[1]))
    acc_r = jnp.zeros((n // T, T, x_pad.shape[1]))
    xp = torch.from_numpy(x_pad)
    for s, c in st.batch_plan(batch):
        meta, rows, cols, vals = (st.read_batch if decoded
                                  else st.read_batch_raw)(s, c)
        nv = np.asarray([c], np.int32)
        sem_spmm.spmm_tiles_acc(_as_torch(meta), torch.from_numpy(nv),
                                _as_torch(rows), _as_torch(cols),
                                _as_torch(vals), xp, acc_p, T=T,
                                variant="mxu")
        acc_r = spmm_pallas_batch(meta, nv, np.array(rows), np.array(cols),
                                  None if vals is None else np.array(vals),
                                  jnp.asarray(x_pad), acc_r, T=T,
                                  variant="mxu")
    return acc_p.numpy(), np.asarray(acc_r).reshape(n, -1)


@pytest.mark.parametrize("name,decoded,p", [
    ("val128", False, 1),     # raw u16 planes, valued
    ("bin256", False, 3),     # raw u16 planes, binary (no value plane)
    ("val512", True, 8),      # host-decoded int32 planes (IM mode)
    ("bin128", True, 16),
    ("opt256", False, 16),    # u8/u8 16-bit flattened deltas
    ("opt512", False, 3),     # 16-bit and u16/u8 24-bit deltas mixed
    ("hub", False, 3),        # hand-built batches (_hand_built)
    ("distinct", True, 16),
    ("split", False, 8),
    ("empty", False, 1),
    ("alternate", False, 9),
])
def test_batch_mxu_plain_matches_reference_bitwise(stores, name, decoded, p):
    """37-chunk batches, so batches start and end inside tile rows; the
    hand-built batches on a -0.0 accumulator, bit for bit with signs."""
    if name in HAND_BUILT:
        got, want = _hand_built_both(name, p, decoded)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        meta, nv = (_hand_built(name, np.random.default_rng(p))[i]
                    for i in (0, 4))
        touched = np.isin(np.arange(3), meta[: nv[0], 0])
        blocks = got.reshape(3, HAND_T, p)
        assert not (np.signbit(blocks[touched]) & (blocks[touched] == 0)).any()
        assert np.signbit(blocks[~touched]).all()
        return
    st = TileStore.open(stores[name])
    tr = st.chunk_tile_rows()
    starts = [s for s, _ in st.batch_plan(37)][1:]
    assert any(tr[s] == tr[s - 1] for s in starts)   # the premise
    if name.startswith("opt"):
        tags = set(np.asarray(st.header["encodings"]).tolist())
        assert ENC_FLAT_U16 in tags
        assert name != "opt512" or ENC_FLAT_U24 in tags
    got, want = _stream_both(stores[name], _x_pad(st, p, seed=p),
                             decoded=decoded)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer,kind", [
    ("reference", "val"), ("reference", "bin"), ("reference", "opt"),
    ("port", "val"), ("port", "bin"), ("port", "opt")])
def test_writers_keep_each_row_one_run(stores, small_int, tmp_path, writer,
                                       kind):
    """The densify kernel reduces a chunk's rows run by run: every store
    kind, raw or ``.optimize()``d, written by either package, keeps each
    row of a chunk in one run of consecutive lanes (a tile's entries
    sorted by (row, col)), so no row is reduced twice."""
    for T, C in SIZES.items():
        if writer == "reference":
            st = TileStore.open(stores[f"{kind}{T}"])
        else:
            ct = to_chunked(coo_from_arrays(
                small_int.n_rows, small_int.n_cols, small_int.rows,
                small_int.cols, None if kind == "bin" else small_int.vals),
                T=T, C=C)
            st = TileStore.write(str(tmp_path / f"{kind}{T}"), ct,
                                 binary=kind == "bin")
            if kind == "opt":
                st = st.optimize(str(tmp_path / f"o{T}"), reorder=T != 512)
        for s, n in st.batch_plan(64):
            meta, rows, _, _ = st.read_batch(s, n)
            live = np.arange(C)[None, :] < meta[:, 3:4]
            step = np.diff(rows.astype(np.int64), axis=1)
            assert (step[live[:, 1:]] >= 0).all()


def test_batch_mxu_float_within_tolerance(small_valued, tmp_path):
    path = str(tmp_path / "f")
    ct = ref_to_chunked(small_valued, T=256, C=64)
    RefTileStore.write(path, ct)
    x_pad = _x_pad(TileStore.open(path), 4, seed=2, integer=False)
    got, want = _stream_both(path, x_pad)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    oracle = spmm_ref(ct.meta, ct.row_local, ct.col_local, ct.vals, x_pad,
                      256)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


def test_batch_mxu_skips_pads_and_keeps_untouched_rows(stores):
    """Poisoned pad chunks past ``n_valid`` (wild indices, NaN values) are
    skipped; tile rows the batch never visits keep their content; a visited
    tile row's rows without entries take ``+ 0.0`` as in the reference, so
    an accumulator of -0.0 comes back with the same sign bits."""
    st = TileStore.open(stores["val256"])
    T, C = 256, 64
    x_pad = _x_pad(st, 3, seed=3)
    s = st.n_chunks // 3
    meta, rows, cols, vals = (np.array(a) for a in st.read_batch_raw(s, 40))
    pad = 5
    meta_p = np.concatenate([meta, np.repeat(meta[-1:], pad, 0)])
    meta_p[-pad:, 3] = 0
    rows_p = np.concatenate([rows, np.full((pad, C), 7, rows.dtype)])
    cols_p = np.concatenate([cols, np.full((pad, C), 7, cols.dtype)])
    vals_p = np.concatenate([vals, np.full((pad, C), np.nan, np.float32)])
    n = -(-st.header["n_rows"] // T) * T
    nv = np.asarray([40], np.int32)
    acc0 = np.full((n, 3), -0.0, np.float32)
    got = sem_spmm.spmm_tiles_acc(
        _as_torch(meta_p), torch.from_numpy(nv), _as_torch(rows_p),
        _as_torch(cols_p), _as_torch(vals_p), torch.from_numpy(x_pad),
        torch.from_numpy(acc0.copy()), T=T, variant="mxu").numpy()
    want = np.asarray(ref_spmm_tiles_acc(
        meta_p, nv, rows_p, cols_p, vals_p, jnp.asarray(x_pad),
        jnp.asarray(acc0), T=T, variant="mxu"))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    touched = np.unique(meta[:, 0])
    untouched = np.setdiff1d(np.arange(n // T), touched)
    assert untouched.size > 0
    blocks = got.reshape(-1, T, 3)
    assert (np.signbit(blocks[untouched])).all()
    assert not np.signbit(blocks[touched]).all()


@pytest.mark.parametrize("Tc,p", [(128, 1), (256, 3), (512, 16)])
def test_one_shot_mxu_plain_matches_reference(small_int, small_valued, Tc,
                                              p):
    """K2-mxu: bitwise on integer data against the Pallas mxu kernel and
    the float64 oracle, through both the wrapper and ``spmm_kernel``; to
    1e-5 on normal data."""
    rng = np.random.default_rng(p)
    for coo, integer in ((small_int, True), (small_valued, False)):
        ct = ref_to_chunked(coo, T=Tc, C=SIZES[Tc])
        x = (rng.integers(-4, 5, (coo.n_cols, p)) if integer else
             rng.standard_normal((coo.n_cols, p))).astype(np.float32)
        x_pad = np.zeros((ct.padded_cols, p), np.float32)
        x_pad[: coo.n_cols] = x
        got = sem_spmm.spmm_tiles(
            torch.from_numpy(ct.meta), torch.from_numpy(ct.row_local),
            torch.from_numpy(ct.col_local), torch.from_numpy(ct.vals),
            torch.from_numpy(x_pad), T=Tc, n_tile_rows=ct.n_tile_rows,
            variant="mxu").numpy()
        ref = np.asarray(ref_spmm_tiles(
            ct.meta, ct.row_local, ct.col_local, ct.vals, jnp.asarray(x_pad),
            T=Tc, n_tile_rows=ct.n_tile_rows, variant="mxu"))
        port_ct = chunked_from_arrays(ct.n_rows, ct.n_cols, ct.T, ct.C,
                                      ct.meta, ct.row_local, ct.col_local,
                                      ct.vals)
        via_ops = spmm_kernel(port_ct, x, variant="mxu", device="cpu")
        want_ops = np.asarray(spmm_pallas(ct, jnp.asarray(x), variant="mxu"))
        oracle = spmm_ref(ct.meta, ct.row_local, ct.col_local, ct.vals,
                          x_pad, Tc)
        if integer:
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, oracle)
            np.testing.assert_array_equal(via_ops.numpy(), want_ops)
        else:
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(via_ops.numpy(), want_ops, rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("name", ["val512", "bin512", "opt256", "bin128"])
def test_engine_mxu_matches_reference(stores, name):
    """The engine with ``kernel_variant="mxu"`` against the reference
    engine's Pallas mxu step: same bits, same IOStats and passes."""
    st = TileStore.open(stores[name])
    x = np.random.default_rng(3).integers(
        -4, 5, (st.header["n_cols"], 8)).astype(np.float32)
    ref = RefSEMSpMM(RefTileStore.open(stores[name]),
                     RefConfig(chunk_batch=53, use_pallas=True,
                               pallas_variant="mxu"))
    port = SEMSpMM(st, SEMConfig(chunk_batch=53, kernel_variant="mxu"),
                   device="cpu")
    np.testing.assert_array_equal(port.multiply(x), ref.multiply(x))
    for k in ("bytes_read", "h2d_bytes", "overlap_batches"):
        assert getattr(port.io_stats, k) == getattr(ref.io_stats, k), k
    assert port.passes == ref.passes == 1


def test_spmm_use_kernel_mxu_matches_reference(small_int):
    ct = ref_to_chunked(small_int, T=256, C=64)
    port_ct = chunked_from_arrays(ct.n_rows, ct.n_cols, ct.T, ct.C, ct.meta,
                                  ct.row_local, ct.col_local, ct.vals)
    x = np.random.default_rng(8).integers(
        -4, 5, (small_int.n_cols, 3)).astype(np.float32)
    want = np.asarray(spmm_pallas(ct, jnp.asarray(x), variant="mxu"))
    got = spmm(port_ct, x, use_kernel=True, variant="mxu", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_mxu_wrapper_validates_and_plain_runs_count_nothing(stores):
    st = TileStore.open(stores["val256"])
    meta, rows, cols, vals = (_as_torch(a) for a in st.read_batch_raw(0, 8))
    x_pad = torch.zeros((-(-st.header["n_cols"] // 256) * 256, 2))
    acc = torch.zeros((-(-st.header["n_rows"] // 256) * 256, 2))
    nv = torch.tensor([8], dtype=torch.int32)
    sem_spmm.reset_launches()
    sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, acc, T=256,
                            variant="mxu")
    assert not any(sem_spmm.LAUNCHES.values())
    wide = sem_spmm.MXU_MAX_C + 16
    planes = (torch.zeros((1, 6), dtype=torch.int32),
              torch.ones(1, dtype=torch.int32),
              torch.zeros((1, wide), dtype=torch.int16),
              torch.zeros((1, wide), dtype=torch.int16), None)
    with pytest.raises(ValueError, match="densify kernel takes C"):
        sem_spmm.spmm_tiles_acc(*planes, x_pad, acc, T=256, variant="mxu")
    sem_spmm.spmm_tiles_acc(*planes, x_pad, acc, T=256)   # gather takes it
