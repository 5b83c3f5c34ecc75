"""The port's kernel module on the CPU: the plain versions of the chunk-batch
kernel (K1a, ``spmm_tiles_acc``) and of the one-shot kernel (K2,
``spmm_tiles``) against the JAX package's Pallas kernels in interpret mode
and its float64 oracle, plus the port's SpMM paths and semirings.

Integer-valued data is compared bit for bit (f32 sums of integers below
2**24 are exact in any order); normal data to ``rtol = atol = 1e-5``, since
the port sums each lane straight into the accumulator where the reference
first sums a chunk's block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.spmm import spmm_chunked as ref_spmm_chunked
from repro.core.spmm import spmm_coo as ref_spmm_coo
from repro.io.storage import TileStore as RefTileStore
from repro.kernels.ops import spmm_pallas, spmm_pallas_batch
from repro.kernels.ref import spmm_ref
from repro.kernels.sem_spmm import spmm_tiles as ref_spmm_tiles
from repro.kernels.sem_spmm import spmm_tiles_acc as ref_spmm_tiles_acc
from repro_torch.convert import chunked_from_arrays, coo_from_arrays
from repro_torch.core.spmm import spmm, spmm_chunked, spmm_coo
from repro_torch.io.storage import TileStore
from repro_torch.kernels import sem_spmm
from repro_torch.kernels.ops import pick_variant, spmm_kernel, spmm_kernel_batch
from repro_torch.kernels.ref import spmm_ref_torch

T, C = 256, 64


@pytest.fixture(scope="module")
def small_int(small_graph):
    rng = np.random.default_rng(11)
    return small_graph.with_values(
        rng.integers(-3, 4, small_graph.nnz).astype(np.float32))


@pytest.fixture(scope="module")
def stores(small_int, small_graph, tmp_path_factory):
    """Reference-written stores: raw valued, raw binary, optimized valued
    (16-bit deltas at T=256) and an unreordered T=4096 copy (24-bit
    deltas)."""
    d = tmp_path_factory.mktemp("tk")
    out = {
        "val": RefTileStore.write(str(d / "v"), ref_to_chunked(small_int, T=T,
                                                               C=C)),
        "bin": RefTileStore.write(str(d / "b"), ref_to_chunked(small_graph,
                                                               T=T, C=C),
                                  binary=True),
        "val4096": RefTileStore.write(
            str(d / "v4"), ref_to_chunked(small_int, T=4096, C=256)),
    }
    out["opt"] = out["val"].optimize(str(d / "vo"))
    out["opt24"] = out["val4096"].optimize(str(d / "vo4"), reorder=False)
    return {k: str(d / {"val": "v", "bin": "b", "val4096": "v4", "opt": "vo",
                        "opt24": "vo4"}[k]) for k in out}


def _x_pad(st, p, seed, integer=True):
    rng = np.random.default_rng(seed)
    T_ = st.header["T"]
    n_pad = -(-st.header["n_cols"] // T_) * T_
    x = np.zeros((n_pad, p), np.float32)
    x[: st.header["n_cols"]] = (rng.integers(-4, 5, (st.header["n_cols"], p))
                                if integer else
                                rng.standard_normal((st.header["n_cols"], p)))
    return x


def _as_torch(a):
    if a is None:
        return None
    a = np.array(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _stream_both(path, x_pad, decoded=False, batch=37):
    """Apply every batch of a store through the port's plain version and
    the reference Pallas kernel (interpret mode, through its jitted engine
    step); returns both accumulators."""
    st = TileStore.open(path)
    T_ = st.header["T"]
    n = -(-st.header["n_rows"] // T_) * T_
    acc_p = torch.zeros((n, x_pad.shape[1]))
    acc_r = jnp.zeros((n // T_, T_, x_pad.shape[1]))
    xp = torch.from_numpy(x_pad)
    for s, c in st.batch_plan(batch):
        meta, rows, cols, vals = (st.read_batch if decoded
                                  else st.read_batch_raw)(s, c)
        nv = np.asarray([c], np.int32)
        sem_spmm.spmm_tiles_acc(_as_torch(meta), torch.from_numpy(nv),
                                _as_torch(rows), _as_torch(cols),
                                _as_torch(vals), xp, acc_p, T=T_)
        acc_r = spmm_pallas_batch(meta, nv, np.array(rows), np.array(cols),
                                  None if vals is None else np.array(vals),
                                  jnp.asarray(x_pad), acc_r, T=T_,
                                  variant="gather")
    return acc_p.numpy(), np.asarray(acc_r).reshape(n, -1)


@pytest.mark.parametrize("name,decoded", [
    ("val", False),      # raw u16 planes, valued
    ("bin", False),      # raw u16 planes, binary (no value plane)
    ("val", True),       # host-decoded int32 planes (IM mode)
    ("bin", True),
    ("opt", False),      # u8/u8 16-bit flattened deltas
    ("opt24", False),    # u16/u8 24-bit flattened deltas
])
def test_batch_plain_matches_reference_bitwise(stores, name, decoded):
    st = TileStore.open(stores[name])
    x_pad = _x_pad(st, 3, seed=1)
    got, want = _stream_both(stores[name], x_pad, decoded=decoded)
    np.testing.assert_array_equal(got, want)


def test_batch_plain_float_within_tolerance(small_valued, tmp_path):
    path = str(tmp_path / "f")
    ct = ref_to_chunked(small_valued, T=T, C=C)
    RefTileStore.write(path, ct)
    st = TileStore.open(path)
    x_pad = _x_pad(st, 4, seed=2, integer=False)
    got, want = _stream_both(path, x_pad)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = spmm_ref(ct.meta, ct.row_local, ct.col_local, ct.vals, x_pad, T)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_batch_skips_tail_pads(stores):
    """Chunks past ``n_valid`` are skipped outright: poisoned pad planes
    (wild indices, NaN values) leave the accumulator as the unpadded batch
    does, and as the reference leaves it."""
    st = TileStore.open(stores["val"])
    x_pad = _x_pad(st, 3, seed=3)
    meta, rows, cols, vals = (np.array(a) for a in st.read_batch_raw(0, 40))
    pad = 5
    meta_p = np.concatenate([meta, np.repeat(meta[-1:], pad, 0)])
    meta_p[-pad:, 3] = 0
    rows_p = np.concatenate([rows, np.full((pad, C), 7, rows.dtype)])
    cols_p = np.concatenate([cols, np.full((pad, C), 7, cols.dtype)])
    vals_p = np.concatenate([vals, np.full((pad, C), np.nan, np.float32)])
    n = -(-st.header["n_rows"] // T) * T
    nv = np.asarray([40], np.int32)
    want = sem_spmm.spmm_tiles_acc(
        _as_torch(meta), torch.from_numpy(nv), _as_torch(rows),
        _as_torch(cols), _as_torch(vals), torch.from_numpy(x_pad),
        torch.zeros((n, 3)), T=T).numpy()
    got = sem_spmm.spmm_tiles_acc(
        _as_torch(meta_p), torch.from_numpy(nv), _as_torch(rows_p),
        _as_torch(cols_p), _as_torch(vals_p), torch.from_numpy(x_pad),
        torch.zeros((n, 3)), T=T).numpy()
    np.testing.assert_array_equal(got, want)
    ref = ref_spmm_tiles_acc(meta_p, nv, rows_p, cols_p, vals_p,
                             jnp.asarray(x_pad), jnp.zeros((n, 3)), T=T)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_batch_preserves_untouched_tile_rows(stores):
    """Tile rows a batch never visits keep their content bit for bit."""
    st = TileStore.open(stores["bin"])
    x_pad = _x_pad(st, 3, seed=4)
    n = -(-st.header["n_rows"] // T) * T
    acc0 = np.random.default_rng(5).integers(-9, 9, (n, 3)).astype(np.float32)
    s, e = st.n_chunks // 3, 2 * st.n_chunks // 3
    meta, rows, cols, _ = st.read_batch_raw(s, e - s)
    nv = np.asarray([e - s], np.int32)
    got = sem_spmm.spmm_tiles_acc(
        _as_torch(meta), torch.from_numpy(nv), _as_torch(rows),
        _as_torch(cols), None, torch.from_numpy(x_pad),
        torch.from_numpy(acc0.copy()), T=T).numpy()
    want = ref_spmm_tiles_acc(meta, nv, np.array(rows), np.array(cols), None,
                              jnp.asarray(x_pad), jnp.asarray(acc0), T=T)
    np.testing.assert_array_equal(got, np.asarray(want))
    touched = np.unique(meta[:, 0])
    untouched = np.setdiff1d(np.arange(n // T), touched)
    assert untouched.size > 0
    blocks, blocks0 = got.reshape(-1, T, 3), acc0.reshape(-1, T, 3)
    np.testing.assert_array_equal(blocks[untouched], blocks0[untouched])
    assert not np.array_equal(blocks[touched], blocks0[touched])


@pytest.mark.parametrize("Tc,Cc,p", [(128, 32, 1), (256, 64, 3),
                                     (512, 128, 8)])
def test_one_shot_plain_matches_reference(small_int, small_valued, Tc, Cc, p):
    """K2: bitwise on integer data against the Pallas gather kernel and the
    float64 oracle; to 1e-5 on normal data."""
    rng = np.random.default_rng(p)
    for coo, integer in ((small_int, True), (small_valued, False)):
        ct = ref_to_chunked(coo, T=Tc, C=Cc)
        x = (rng.integers(-4, 5, (coo.n_cols, p)) if integer else
             rng.standard_normal((coo.n_cols, p))).astype(np.float32)
        x_pad = np.zeros((ct.padded_cols, p), np.float32)
        x_pad[: coo.n_cols] = x
        got = sem_spmm.spmm_tiles(
            torch.from_numpy(ct.meta), torch.from_numpy(ct.row_local),
            torch.from_numpy(ct.col_local), torch.from_numpy(ct.vals),
            torch.from_numpy(x_pad), T=Tc, n_tile_rows=ct.n_tile_rows).numpy()
        ref = np.asarray(ref_spmm_tiles(
            ct.meta, ct.row_local, ct.col_local, ct.vals, jnp.asarray(x_pad),
            T=Tc, n_tile_rows=ct.n_tile_rows, variant="gather"))
        oracle = spmm_ref(ct.meta, ct.row_local, ct.col_local, ct.vals,
                          x_pad, Tc)
        if integer:
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, oracle)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["gather", "mxu"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 5e-4),
                                        (torch.bfloat16, 0.25)])
def test_one_shot_dtype_sweep(small_valued, variant, dtype, atol):
    """K2 in both variants keeps a bfloat16 operand's dtype, as the
    reference's ``spmm_pallas`` does, within the tolerance of
    ``tests/test_kernels.py::test_kernel_dtype_sweep`` of the float64
    oracle on the unrounded operand."""
    ct = ref_to_chunked(small_valued, T=256, C=64)
    port_ct = chunked_from_arrays(ct.n_rows, ct.n_cols, ct.T, ct.C, ct.meta,
                                  ct.row_local, ct.col_local, ct.vals)
    x = np.random.default_rng(0).standard_normal(
        (small_valued.n_cols, 4)).astype(np.float32)
    out = spmm_kernel(port_ct, torch.from_numpy(x).to(dtype),
                      variant=variant, device="cpu")
    assert out.dtype == dtype
    x_pad = np.zeros((ct.padded_cols, 4), np.float64)
    x_pad[: x.shape[0]] = x
    ref = spmm_ref(ct.meta, ct.row_local, ct.col_local, ct.vals, x_pad,
                   ct.T)[: ct.n_rows]
    np.testing.assert_allclose(out.double().numpy(), ref, atol=atol,
                               rtol=atol)


def test_ops_entry_points_match_reference(small_int):
    """``spmm_kernel`` / ``spmm_kernel_batch`` (the engine step, in place)
    against ``spmm_pallas`` / ``spmm_pallas_batch``."""
    ct = ref_to_chunked(small_int, T=T, C=C)
    x = np.random.default_rng(6).integers(
        -4, 5, (small_int.n_cols, 3)).astype(np.float32)
    port_ct = chunked_from_arrays(ct.n_rows, ct.n_cols, ct.T, ct.C, ct.meta,
                                  ct.row_local, ct.col_local, ct.vals)
    got = spmm_kernel(port_ct, x, device="cpu").numpy()
    want = np.asarray(spmm_pallas(ct, jnp.asarray(x), variant="gather"))
    np.testing.assert_array_equal(got, want)
    x_pad = np.zeros((ct.padded_cols, 3), np.float32)
    x_pad[: x.shape[0]] = x
    out = torch.zeros((ct.n_tile_rows, T, 3))
    ref = jnp.zeros((ct.n_tile_rows, T, 3))
    for s in range(0, ct.n_chunks, 7):
        e = min(s + 7, ct.n_chunks)
        planes = (ct.meta[s:e], e - s, ct.row_local[s:e], ct.col_local[s:e],
                  ct.vals[s:e], x_pad)
        res = spmm_kernel_batch(*planes, out, T=T, device="cpu")
        assert res is out                      # updated in place
        ref = spmm_pallas_batch(*planes, ref, T=T, variant="gather")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_plain_runs_launch_nothing_and_wrappers_validate(stores):
    st = TileStore.open(stores["val"])
    meta, rows, cols, vals = (_as_torch(a) for a in st.read_batch_raw(0, 8))
    x_pad = torch.zeros((st.header["n_cols"] // T * T + T, 2))
    acc = torch.zeros((st.header["n_rows"] // T * T + T, 2))
    nv = torch.tensor([8], dtype=torch.int32)
    sem_spmm.reset_launches()
    sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, acc, T=T)
    with pytest.raises(ValueError, match="unknown kernel variant"):
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, acc, T=T,
                                variant="vpu")
    # the densify variant runs its plain version here, equal to the
    # reference's mxu kernel (integer data: bit for bit)
    got = sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad,
                                  torch.zeros_like(acc), T=T, variant="mxu")
    raw = [np.array(a) for a in st.read_batch_raw(0, 8)]
    want = ref_spmm_tiles_acc(raw[0], nv.numpy(), *raw[1:],
                              jnp.asarray(x_pad.numpy()),
                              jnp.zeros(tuple(acc.shape)), T=T,
                              variant="mxu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sem_spmm.LAUNCHES == {"spmm_tiles_acc": 0, "spmm_tiles": 0,
                                 "spmm_tiles_acc_mxu": 0,
                                 "spmm_tiles_mxu": 0}
    with pytest.raises(ValueError, match="index planes"):
        sem_spmm.spmm_tiles_acc(meta, nv, rows.to(torch.int64), cols, vals,
                                x_pad, acc, T=T)
    with pytest.raises(ValueError, match="float32"):
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad.double(),
                                acc, T=T)
    with pytest.raises(ValueError, match="6-int meta"):
        sem_spmm.spmm_tiles_acc(meta, nv, rows.to(torch.uint8),
                                cols.to(torch.uint8), vals, x_pad, acc, T=T)
    # the H100 crossover (PERF.md, section 6): gather wins at every
    # measured T
    assert all(pick_variant(t) == "gather"
               for t in (256, 512, 1024, 2048, 4096, 16384))


@pytest.mark.parametrize("ring", ["plus_times", "or_and", "min_plus",
                                  "max_times"])
def test_spmm_paths_match_reference(small_int, ring):
    """COO and chunked paths in every semiring against the reference's
    (integer data: exact), and the kernel path for plus-times."""
    rng = np.random.default_rng(8)
    x = rng.integers(-4, 5, (small_int.n_cols, 3)).astype(np.float32)
    coo = coo_from_arrays(small_int.n_rows, small_int.n_cols, small_int.rows,
                          small_int.cols, small_int.vals)
    ct = ref_to_chunked(small_int, T=T, C=C)
    port_ct = chunked_from_arrays(ct.n_rows, ct.n_cols, ct.T, ct.C, ct.meta,
                                  ct.row_local, ct.col_local, ct.vals)
    want_coo = np.asarray(ref_spmm_coo(small_int, jnp.asarray(x), ring))
    want_ch = np.asarray(ref_spmm_chunked(ct, jnp.asarray(x), ring))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(spmm_coo(coo, xt, ring).numpy(), want_coo)
    np.testing.assert_array_equal(spmm_chunked(port_ct, xt, ring).numpy(),
                                  want_ch)
    np.testing.assert_array_equal(
        spmm(port_ct, x, ring, device="cpu").numpy(), want_ch)
    if ring == "plus_times":
        np.testing.assert_array_equal(
            spmm(port_ct, x, use_kernel=True, device="cpu").numpy(), want_ch)
    else:
        with pytest.raises(NotImplementedError):
            spmm(port_ct, x, ring, use_kernel=True, device="cpu")


def test_torch_oracle_matches_numpy_oracle(small_valued):
    ct = ref_to_chunked(small_valued, T=T, C=C)
    x_pad = np.random.default_rng(9).standard_normal(
        (ct.padded_cols, 2)).astype(np.float64)
    want = spmm_ref(ct.meta, ct.row_local, ct.col_local, ct.vals, x_pad, T)
    got = spmm_ref_torch(torch.from_numpy(ct.meta),
                         torch.from_numpy(ct.row_local),
                         torch.from_numpy(ct.col_local),
                         torch.from_numpy(ct.vals), torch.from_numpy(x_pad),
                         T, ct.n_tile_rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
