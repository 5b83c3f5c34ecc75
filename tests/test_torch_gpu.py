"""The CUDA kernels against their plain PyTorch versions, on the card: the
gather kernel (K1a, and K2 through it), the densify kernel (K1b, and
K2-mxu through it), flash attention (K3) and the SSD chunk scan (K4); and
the engine's plain steps on the card (the ring step, the delta overlay's
scatter and fold, the sharded scan's threads), the serving runtime and
the cross-host tier's hosts against the CPU engine; the reduced models of
every family through the kernels against the CPU.

Small shapes; every test needs a card and skips without one (decided in the
``cuda`` fixture, never at import).  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Integer-valued data is compared bit for bit (f32 sums of integers below
2**24 are exact in any order, and the densify kernel's two-term TF32 split
is exact for integers below 2**22).  Normal data is compared elementwise to
1e-5 of |A|·|x|, the sum of the terms' magnitudes: kernel and plain version
add float32 terms in orders that change from run to run (atomics on both
sides), so they differ by rounding of the order of the terms, which for a
row whose terms cancel is far larger than the result (see ``_terms``).
"""
import copy
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.formats import to_chunked
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.io.storage import TileStore
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import sem_spmm
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.kernels.ops import spmm_kernel
from repro_torch.models import model_api
from repro_torch.sparse.generate import rmat
from ulp import one_ulp

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Raw valued (integer values), raw binary, and optimized copies of
    both: T=256 packs 16-bit deltas, T=4096 without reordering leaves
    24-bit ones.  For the densify kernel also raw stores with C=1024 (more
    lanes than one of its shared-memory slabs holds) and with T=200 (no
    multiple of its 16-row fragments)."""
    g = rmat(12, 8, seed=1)
    rng = np.random.default_rng(7)
    gv = g.with_values(rng.integers(-3, 4, g.nnz).astype(np.float32))
    d = tmp_path_factory.mktemp("gpu")
    out = {}
    for T, C, tag in ((256, 64, "256"), (4096, 256, "4096"),
                      (4096, 1024, "4096c1024"), (200, 48, "200")):
        out[f"val{tag}"] = TileStore.write(str(d / f"v{tag}"),
                                           to_chunked(gv, T=T, C=C))
        out[f"bin{tag}"] = TileStore.write(str(d / f"b{tag}"),
                                           to_chunked(g, T=T, C=C),
                                           binary=True)
        if tag in ("256", "4096"):
            out[f"valopt{tag}"] = out[f"val{tag}"].optimize(
                str(d / f"vo{tag}"), reorder=T == 256)
            out[f"binopt{tag}"] = out[f"bin{tag}"].optimize(
                str(d / f"bo{tag}"), reorder=T == 256)
    return out


def _planes(batch, device):
    """A raw batch as contiguous tensors (uint16 as int16 bits)."""
    out = []
    for a in batch:
        if a is None:
            out.append(None)
            continue
        a = np.array(a)
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        out.append(torch.from_numpy(a).to(device))
    return out


def _run_both(st, s, n, x, cuda, acc0=None, n_valid=None, decoded=False,
              variant="gather"):
    """One batch through the kernel and through the plain version (on the
    card, same inputs); returns (kernel acc, plain acc, launches)."""
    T = st.header["T"]
    read = st.read_batch if decoded else st.read_batch_raw
    meta, rows, cols, vals = _planes(read(s, n), cuda)
    nv = torch.tensor([n if n_valid is None else n_valid], dtype=torch.int32,
                      device=cuda)
    n_rows = -(-st.header["n_rows"] // T) * T
    x_pad = torch.zeros((-(-st.header["n_cols"] // T) * T, x.shape[1]),
                        device=cuda)
    x_pad[: x.shape[0]] = torch.from_numpy(x).to(cuda)
    acc = (torch.zeros((n_rows, x.shape[1]), device=cuda) if acc0 is None
           else acc0.clone())
    plain = acc.clone()
    key = "spmm_tiles_acc" + ("" if variant == "gather" else "_mxu")
    before = sem_spmm.LAUNCHES[key]
    sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, acc, T=T,
                            variant=variant)
    launches = sem_spmm.LAUNCHES[key] - before
    sem_spmm._PLAIN[variant](meta, nv, rows, cols, vals, x_pad, plain, T=T)
    torch.cuda.synchronize()
    return acc.cpu().numpy(), plain.cpu().numpy(), launches


def _terms(st, s, n, x, variant="gather"):
    """|A|·|x| for one batch, on the host: the plain version on the planes'
    and the operand's magnitudes.  A reordered float32 sum of n terms is
    typically off by sqrt(n)·2**-24 of it, so 1e-5 of it leaves room; a
    dropped or doubled term is off by far more."""
    T = st.header["T"]
    meta, rows, cols, vals = _planes(st.read_batch_raw(s, n), "cpu")
    x_pad = torch.zeros((-(-st.header["n_cols"] // T) * T, x.shape[1]))
    x_pad[: x.shape[0]] = torch.from_numpy(np.abs(x))
    out = torch.zeros((-(-st.header["n_rows"] // T) * T, x.shape[1]))
    sem_spmm._PLAIN[variant](meta, torch.tensor([n], dtype=torch.int32),
                             rows, cols, None if vals is None else vals.abs(),
                             x_pad, out, T=T)
    return out.numpy()


@pytest.mark.parametrize("name", ["val256", "bin256", "valopt256",
                                  "binopt256", "valopt4096", "binopt4096",
                                  "val4096"])
@pytest.mark.parametrize("decoded", [False, True])
def test_kernel_matches_plain_integer(cuda, stores, name, decoded):
    """Every plane type (u16, i32, u8/u8 and u16/u8 deltas; valued and
    binary), bit for bit on integer data, one launch per call."""
    st = stores[name]
    x = np.random.default_rng(1).integers(
        -4, 5, (st.header["n_cols"], 5)).astype(np.float32)
    for s, n in st.batch_plan(37):
        got, want, launches = _run_both(st, s, n, x, cuda, decoded=decoded)
        np.testing.assert_array_equal(got, want)
        assert launches == 1


def test_kernel_matches_plain_float(cuda, stores):
    st = stores["val256"]
    x = np.random.default_rng(2).standard_normal(
        (st.header["n_cols"], 8)).astype(np.float32)
    got, want, _ = _run_both(st, 0, st.n_chunks, x, cuda)
    assert (np.abs(got - want) <= 1e-5 * _terms(st, 0, st.n_chunks, x)).all()


def test_kernel_skips_pads_and_keeps_untouched_rows(cuda, stores):
    """Chunks at or past n_valid contribute nothing; tile rows the batch
    does not visit keep their content bit for bit; a visited tile row's
    rows without entries take + 0.0 (a -0.0 there turns +0.0, as in the
    reference and the plain version)."""
    st = stores["bin256"]
    T = st.header["T"]
    x = np.ones((st.header["n_cols"], 3), np.float32)
    s, n = st.n_chunks // 3, st.n_chunks // 3
    n_rows = -(-st.header["n_rows"] // T) * T
    for fill in (12345.0, -0.0):
        acc0 = torch.full((n_rows, 3), fill, device=cuda)
        got, want, _ = _run_both(st, s, n, x, cuda, acc0=acc0,
                                 n_valid=n - 5)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        meta = st.read_batch_raw(s, n)[0]
        touched = np.unique(meta[: n - 5, 0])
        rows = got.reshape(-1, T, 3)
        untouched = np.setdiff1d(np.arange(rows.shape[0]), touched)
        assert untouched.size > 0
        np.testing.assert_array_equal(
            rows[untouched].view(np.uint32),
            np.full_like(rows[untouched], fill).view(np.uint32))
        assert not (rows[touched].view(np.uint32)
                    == np.float32(fill).view(np.uint32)).all()


def test_one_shot_kernel_matches_plain(cuda):
    g = rmat(11, 8, seed=3)
    ct = to_chunked(g, T=256, C=64)
    x = np.random.default_rng(3).integers(
        -4, 5, (g.n_cols, 4)).astype(np.float32)
    before = sem_spmm.LAUNCHES["spmm_tiles"]
    got = spmm_kernel(ct, x, device=cuda).cpu().numpy()
    assert sem_spmm.LAUNCHES["spmm_tiles"] - before == 1
    want = spmm_kernel(ct, x, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,dtype", [(3, "float32"), (5, "float32"),
                                     (17, "float32"), (3, "bfloat16"),
                                     (8, "bfloat16"), (9, "bfloat16")])
def test_one_shot_many_chunks(cuda, p, dtype):
    """A one-shot product over more chunks than the gather kernel gives a
    block per slab of lanes (one block a chunk there), at ragged and
    4-aligned widths, bit for bit on integer data."""
    g = rmat(13, 8, seed=5)
    ct = to_chunked(g, T=256, C=8)
    assert ct.n_chunks > 4096
    x = torch.from_numpy(np.random.default_rng(p).integers(
        -4, 5, (g.n_cols, p)).astype(np.float32)).to(getattr(torch, dtype))
    before = sem_spmm.LAUNCHES["spmm_tiles"]
    got = spmm_kernel(ct, x, device=cuda)
    assert sem_spmm.LAUNCHES["spmm_tiles"] - before == 1
    assert torch.equal(got.cpu(), spmm_kernel(ct, x, device="cpu"))


@pytest.mark.parametrize("name", ["val256", "binopt256", "valopt4096"])
@pytest.mark.parametrize("mode", ["sem", "im"])
def test_engine_on_card_matches_cpu(cuda, stores, name, mode):
    """The whole engine on the card: same bits and same IOStats as the
    engine on the host, one kernel launch per batch."""
    path = stores[name].path
    x = np.random.default_rng(4).integers(
        -4, 5, (stores[name].header["n_cols"], 8)).astype(np.float32)
    cfg = SEMConfig(chunk_batch=53)
    gpu = SEMSpMM(TileStore.open(path), cfg, mode=mode, device=cuda)
    cpu = SEMSpMM(TileStore.open(path), cfg, mode=mode, device="cpu")
    sem_spmm.reset_launches()
    got = gpu.multiply(x)
    assert sem_spmm.LAUNCHES["spmm_tiles_acc"] == gpu.n_batches
    np.testing.assert_array_equal(got, cpu.multiply(x))
    for k in ("bytes_read", "h2d_bytes", "overlap_batches"):
        assert getattr(gpu.io_stats, k) == getattr(cpu.io_stats, k), k


def test_boundary_hook_on_card(cuda, stores):
    st = stores["val256"]
    x = np.random.default_rng(5).integers(
        -4, 5, (st.header["n_cols"], 4)).astype(np.float32)
    new_col = np.arange(x.shape[0], dtype=np.float32) % 7
    results = []
    for dev in (cuda, "cpu"):
        sem = SEMSpMM(TileStore.open(st.path), SEMConfig(chunk_batch=53),
                      device=dev)
        seen = {}

        def hook(b, seen=seen):
            if b.chunk_start == 2 * 53:
                b.write_columns(2, new_col)
                seen["prefix"] = b.read_output(1, 0, 2)
        results.append((sem.multiply(x, boundary_hook=hook), seen["prefix"]))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])


def _non_finite_operand(n, p, seed):
    """Integers with NaN, inf, -inf, -0.0 and +0.0 spread over the rows."""
    x = np.random.default_rng(seed).integers(-3, 4, (n, p)).astype(
        np.float32)
    x[::7, 0] = np.nan
    x[1::7, 1 % p] = np.inf
    x[2::7, 2 % p] = -np.inf
    x[3::5, :] = -0.0
    x[4::5, :] = 0.0
    return x


def _same_bits(got, want):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.where(nan, 0, got).view(np.int32),
                                  np.where(nan, 0, want).view(np.int32))


def _churn(store, n, inserts_only=False):
    """Updates from fixed seeds through a fresh handle: integer weights in
    [1, 4] at unique coordinates, and (unless ``inserts_only``) deletes."""
    from repro_torch.io.storage import GraphHandle, UpdateBatch
    r = np.random.default_rng(11)
    key = np.unique(r.integers(0, n * n, 300))
    h = GraphHandle([store])
    h.apply_updates(UpdateBatch.insert(
        key // n, key % n, (np.arange(key.size) % 4 + 1).astype(np.float32)))
    if not inserts_only:
        h.apply_updates(UpdateBatch.delete(r.integers(0, n, 60),
                                           r.integers(0, n, 60)))
    return h


@pytest.mark.parametrize("name", ["val256", "binopt256"])
@pytest.mark.parametrize("ring", ["or_and", "min_plus", "max_times"])
@pytest.mark.parametrize("overlay", [False, True], ids=["frozen", "overlay"])
def test_ring_pass_on_card_matches_cpu(cuda, stores, name, ring, overlay):
    """Each ring step (and, over an insert-only log, each ring fold) on the
    card against the plain CPU path on an operand holding NaN, inf and
    both zeros: the same bits, NaN by position, and the same IOStats."""
    path = stores[name].path
    n = stores[name].header["n_cols"]
    x = _non_finite_operand(n, 3, 6)
    runs = []
    for dev in (cuda, "cpu"):
        st = TileStore.open(path)
        if overlay:
            _churn(st, n, inserts_only=True)
        sem = SEMSpMM(st, SEMConfig(chunk_batch=53), device=dev)
        runs.append((sem.multiply(x, semiring=ring), sem))
    (got, gpu), (want, cpu) = runs
    _same_bits(got, want)
    for k in ("bytes_read", "h2d_bytes", "overlap_batches"):
        assert getattr(gpu.io_stats, k) == getattr(cpu.io_stats, k), k


@pytest.mark.parametrize("variant", ["gather", "mxu"])
@pytest.mark.parametrize("name", ["val256", "binopt256"])
def test_overlay_on_card_matches_cpu(cuda, stores, variant, name):
    """The plus-times overlay (inserts and deletes) over both kernel
    variants: the same bits as the CPU engine on integer data, one kernel
    launch per batch, and the same IOStats."""
    path = stores[name].path
    n = stores[name].header["n_cols"]
    x = np.random.default_rng(8).integers(-4, 5, (n, 8)).astype(np.float32)
    runs = []
    for dev in (cuda, "cpu"):
        st = TileStore.open(path)
        _churn(st, n)
        sem = SEMSpMM(st, SEMConfig(chunk_batch=53, kernel_variant=variant),
                      device=dev)
        sem_spmm.reset_launches()
        runs.append((sem.multiply(x), sem, dict(sem_spmm.LAUNCHES)))
    (got, gpu, launches), (want, cpu, _) = runs
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    key = "spmm_tiles_acc" + ("_mxu" if variant == "mxu" else "")
    assert launches[key] == gpu.n_batches
    assert gpu.last_pass_version == cpu.last_pass_version == 2
    for k in ("bytes_read", "h2d_bytes", "overlap_batches"):
        assert getattr(gpu.io_stats, k) == getattr(cpu.io_stats, k), k


@pytest.mark.parametrize("overlay", [False, True], ids=["frozen", "overlay"])
def test_sharded_scan_threads_on_one_card(cuda, stores, overlay):
    """Two shards as threads on one card, each on its own streams: the
    single engine's bits, every byte of the store read once."""
    from repro_torch.distributed.shard_scan import ShardedSEMSpMM
    path = stores["val256"].path
    n = stores["val256"].header["n_cols"]
    x = np.random.default_rng(9).integers(-4, 5, (n, 8)).astype(np.float32)
    st = TileStore.open(path)
    if overlay:
        _churn(st, n)
    sh = ShardedSEMSpMM(st, n_shards=2, config=SEMConfig(chunk_batch=53),
                        devices=[cuda])
    one = SEMSpMM(TileStore.open(path), SEMConfig(chunk_batch=53),
                  device=cuda)
    if overlay:
        one.store._delta_src = st   # share the overlay
    try:
        for _ in range(2):
            got = sh.multiply(x)
            np.testing.assert_array_equal(got.view(np.int32),
                                          one.multiply(x).view(np.int32))
        assert sh.io_stats.bytes_read == 2 * st.nbytes
    finally:
        sh.close()


def test_build_reports_registers(cuda):
    """Every source builds, one nvcc each, started together."""
    from repro_torch.kernels._build import build_all
    infos = build_all()
    assert set(infos) == {"sem_spmm", "sem_spmm_mxu", "flash_attention",
                          "ssd_chunk"}
    for info in infos.values():
        assert info.path.exists() and "registers" in info.ptxas


def test_kernel_is_graph_capturable(cuda, stores):
    """The wrapper allocates nothing and never synchronises: a launch can
    be captured in a CUDA graph, and replaying it adds the same sums."""
    st = stores["bin256"]
    T = st.header["T"]
    meta, rows, cols, vals = _planes(st.read_batch_raw(0, 40), cuda)
    nv = torch.tensor([40], dtype=torch.int32, device=cuda)
    x = torch.ones((-(-st.header["n_cols"] // T) * T, 2), device=cuda)
    acc = torch.zeros((-(-st.header["n_rows"] // T) * T, 2), device=cuda)
    once = sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x,
                                   acc.clone(), T=T)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x, acc, T=T)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(acc, 2 * once)



# -- the densify kernel (K1b, and K2-mxu through it) ------------------------
# Hand-built batches of the chunk-batch kernels' corners (raw uint16 planes,
# integer values), each ending in two tail pads past n_valid:
#   hub        every lane of a chunk in one row;
#   distinct   every live lane in a row of its own;
#   split      a row in several runs of lanes (no writer produces it);
#   empty      a chunk with nnz = 0 alone on its tile row (+0.0 there);
#   alternate  tile rows 0, 1, 0, 1, 0;
#   max_c      C = MXU_MAX_C (the largest shared-memory footprint): a hub
#              chunk and a chunk of distinct rows, T = 16384.
HAND_BUILT = ("hub", "distinct", "split", "empty", "alternate", "max_c")


def _hand_built(case, rng):
    """``(meta, rows, cols, vals, n_valid, T, n_tile_rows)`` of one
    hand-built batch over 2 tile columns; vals is None for a binary
    batch."""
    T, C = (16384, sem_spmm.MXU_MAX_C) if case == "max_c" else (128, 32)
    tiles = {"hub": [(1, 0, C), (1, 1, 9)],
             "distinct": [(0, 1, 20), (2, 0, C), (2, 1, 1)],
             "split": [(2, 0, 12), (2, 1, C)],
             "empty": [(0, 0, 6), (1, 1, 0), (2, 1, 3)],
             "alternate": [(0, 0, 10), (1, 1, 7), (0, 1, C), (1, 0, 5),
                           (0, 0, 4)],
             "max_c": [(0, 1, C), (2, 0, C)]}[case]
    n = len(tiles) + 2
    meta = np.zeros((n, 4), np.int32)
    rows = np.zeros((n, C), np.uint16)
    cols = np.zeros((n, C), np.uint16)
    vals = np.zeros((n, C), np.float32)
    for g, (tr, tc, k) in enumerate(tiles):
        meta[g] = (tr, tc, 0, k)
        cols[g, :k] = np.sort(rng.choice(T, k, replace=False))
        if case in ("hub", "max_c") and g == 0:
            r = np.full(k, 5)
        elif case in ("distinct", "max_c"):
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
    return (meta, rows, cols, None if binary else vals, len(tiles), T, 3)


def _check_hand_built(case, decoded, p, cuda, variant="mxu"):
    """A hand-built batch through the variant's kernel and its plain
    version on a sentinel and on a -0.0 accumulator: bit for bit with
    signs, tile rows outside the batch untouched."""
    rng = np.random.default_rng(p)
    meta, rows, cols, vals, nv, T, ntr = _hand_built(case, rng)
    if decoded:
        rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    meta, rows, cols, vals = _planes((meta, rows, cols, vals), cuda)
    x_pad = torch.from_numpy(rng.integers(-4, 5, (2 * T, p)).astype(
        np.float32)).to(cuda)
    n_valid = torch.tensor([nv], dtype=torch.int32, device=cuda)
    touched = torch.zeros(ntr, dtype=torch.bool)
    touched[meta[:nv, 0].long().cpu()] = True
    for fill in (12345.0, -0.0):
        acc = torch.full((ntr * T, p), fill, device=cuda)
        plain = acc.clone()
        key = "spmm_tiles_acc" + ("" if variant == "gather" else "_mxu")
        before = sem_spmm.LAUNCHES[key]
        sem_spmm.spmm_tiles_acc(meta, n_valid, rows, cols, vals, x_pad, acc,
                                T=T, variant=variant)
        assert sem_spmm.LAUNCHES[key] - before == 1
        sem_spmm._PLAIN[variant](meta, n_valid, rows, cols, vals, x_pad,
                                 plain, T=T)
        got = acc.cpu().numpy().reshape(ntr, T, p)
        np.testing.assert_array_equal(
            got.view(np.uint32), plain.cpu().numpy().reshape(
                ntr, T, p).view(np.uint32))
        np.testing.assert_array_equal(
            got[~touched.numpy()].view(np.uint32),
            np.full_like(got[~touched.numpy()], fill).view(np.uint32))


@pytest.mark.parametrize("name", ["val256", "bin256", "valopt256",
                                  "binopt256", "valopt4096", "binopt4096",
                                  "val4096c1024", "bin200", *HAND_BUILT])
@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("p", [1, 3, 5, 8, 9, 16, 17, 20])
def test_mxu_kernel_matches_plain_integer(cuda, stores, name, decoded, p):
    """Every plane type and store shape, p below, at and above one and two
    16-column passes (ragged and 4-aligned widths: scalar and vector
    reductions), bit for bit on integer data, one launch per call; the
    hand-built batches also on sentinel and -0.0 accumulators."""
    if name in HAND_BUILT:
        _check_hand_built(name, decoded, p, cuda)
        return
    st = stores[name]
    x = np.random.default_rng(p).integers(
        -4, 5, (st.header["n_cols"], p)).astype(np.float32)
    for s, n in st.batch_plan(37):
        got, want, launches = _run_both(st, s, n, x, cuda, decoded=decoded,
                                        variant="mxu")
        np.testing.assert_array_equal(got, want)
        assert launches == 1


@pytest.mark.parametrize("name", ["val256", "bin256", "valopt256",
                                  "binopt256", "valopt4096", "binopt4096",
                                  "val4096c1024", "bin200", *HAND_BUILT])
@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("p", [1, 3, 4, 5, 8, 9, 16, 17])
def test_gather_kernel_matches_plain_integer(cuda, stores, name, decoded,
                                             p):
    """The gather kernel on every plane type and store shape, p below, at
    and above one and two groups of 8 columns (ragged widths: scalar loads
    and reductions; 4-aligned: vector ones), on a -0.0 accumulator, bit
    for bit with signs, one launch per call; the hand-built batches (a
    row in several runs, tile rows revisited, C = MXU_MAX_C) also on a
    sentinel accumulator."""
    if name in HAND_BUILT:
        _check_hand_built(name, decoded, p, cuda, variant="gather")
        return
    st = stores[name]
    T = st.header["T"]
    x = np.random.default_rng(p).integers(
        -4, 5, (st.header["n_cols"], p)).astype(np.float32)
    acc0 = torch.full((-(-st.header["n_rows"] // T) * T, p), -0.0,
                      device=cuda)
    for s, n in st.batch_plan(37):
        got, want, launches = _run_both(st, s, n, x, cuda, acc0=acc0,
                                        decoded=decoded)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert launches == 1


def test_mxu_kernel_matches_plain_float(cuda, stores):
    st = stores["val256"]
    x = np.random.default_rng(2).standard_normal(
        (st.header["n_cols"], 8)).astype(np.float32)
    got, want, _ = _run_both(st, 0, st.n_chunks, x, cuda, variant="mxu")
    assert (np.abs(got - want)
            <= 1e-5 * _terms(st, 0, st.n_chunks, x, "mxu")).all()


def test_mxu_kernel_skips_pads_and_keeps_untouched_rows(cuda, stores):
    """Chunks at or past n_valid contribute nothing; tile rows the batch
    does not visit keep their content bit for bit; a visited tile row's
    rows without entries take + 0.0 (a -0.0 there turns +0.0, as in the
    reference and the plain version)."""
    st = stores["bin256"]
    T = st.header["T"]
    x = np.ones((st.header["n_cols"], 3), np.float32)
    s, n = st.n_chunks // 3, st.n_chunks // 3
    n_rows = -(-st.header["n_rows"] // T) * T
    for fill in (12345.0, -0.0):
        acc0 = torch.full((n_rows, 3), fill, device=cuda)
        got, want, _ = _run_both(st, s, n, x, cuda, acc0=acc0,
                                 n_valid=n - 5, variant="mxu")
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        meta = st.read_batch_raw(s, n)[0]
        touched = np.unique(meta[: n - 5, 0])
        rows = got.reshape(-1, T, 3)
        untouched = np.setdiff1d(np.arange(rows.shape[0]), touched)
        assert untouched.size > 0
        np.testing.assert_array_equal(
            rows[untouched].view(np.uint32),
            np.full_like(rows[untouched], fill).view(np.uint32))
        assert not (rows[touched].view(np.uint32)
                    == np.float32(fill).view(np.uint32)).all()


def test_mxu_one_shot_kernel_matches_plain(cuda):
    g = rmat(11, 8, seed=3)
    ct = to_chunked(g, T=256, C=64)
    x = np.random.default_rng(3).integers(
        -4, 5, (g.n_cols, 4)).astype(np.float32)
    before = sem_spmm.LAUNCHES["spmm_tiles_mxu"]
    got = spmm_kernel(ct, x, variant="mxu", device=cuda).cpu().numpy()
    assert sem_spmm.LAUNCHES["spmm_tiles_mxu"] - before == 1
    want = spmm_kernel(ct, x, variant="mxu", device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, spmm_kernel(ct, x, device=cuda)
                                  .cpu().numpy())


@pytest.mark.parametrize("p,dtype", [(3, "float32"), (16, "float32"),
                                     (8, "bfloat16")])
def test_mxu_one_shot_many_chunks(cuda, p, dtype):
    """A one-shot product over more chunks than the kernel gives four warps
    each (one warp a chunk there), bit for bit on integer data."""
    g = rmat(13, 8, seed=5)
    ct = to_chunked(g, T=256, C=8)
    assert ct.n_chunks > 4096
    x = torch.from_numpy(np.random.default_rng(p).integers(
        -4, 5, (g.n_cols, p)).astype(np.float32)).to(getattr(torch, dtype))
    before = sem_spmm.LAUNCHES["spmm_tiles_mxu"]
    got = spmm_kernel(ct, x, variant="mxu", device=cuda)
    assert sem_spmm.LAUNCHES["spmm_tiles_mxu"] - before == 1
    assert torch.equal(got.cpu(), spmm_kernel(ct, x, variant="mxu",
                                              device="cpu"))


@pytest.mark.parametrize("name", ["val256", "binopt256"])
def test_mxu_engine_on_card_matches_cpu(cuda, stores, name):
    path = stores[name].path
    x = np.random.default_rng(4).integers(
        -4, 5, (stores[name].header["n_cols"], 8)).astype(np.float32)
    cfg = SEMConfig(chunk_batch=53, kernel_variant="mxu")
    gpu = SEMSpMM(TileStore.open(path), cfg, device=cuda)
    cpu = SEMSpMM(TileStore.open(path), cfg, device="cpu")
    sem_spmm.reset_launches()
    got = gpu.multiply(x)
    assert sem_spmm.LAUNCHES["spmm_tiles_acc_mxu"] == gpu.n_batches
    assert sem_spmm.LAUNCHES["spmm_tiles_acc"] == 0
    np.testing.assert_array_equal(got, cpu.multiply(x))
    for k in ("bytes_read", "h2d_bytes", "overlap_batches"):
        assert getattr(gpu.io_stats, k) == getattr(cpu.io_stats, k), k


def test_mxu_kernel_is_graph_capturable(cuda, stores):
    st = stores["bin256"]
    T = st.header["T"]
    meta, rows, cols, vals = _planes(st.read_batch_raw(0, 40), cuda)
    nv = torch.tensor([40], dtype=torch.int32, device=cuda)
    x = torch.ones((-(-st.header["n_cols"] // T) * T, 16), device=cuda)
    acc = torch.zeros((-(-st.header["n_rows"] // T) * T, 16), device=cuda)
    once = sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x,
                                   acc.clone(), T=T, variant="mxu")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x, acc, T=T,
                                variant="mxu")
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(acc, 2 * once)


@pytest.mark.parametrize("variant", ["gather", "mxu"])
@pytest.mark.parametrize("p", [2, 9])
def test_kernels_on_non_finite_operand(cuda, variant, p):
    """K1a and K1b in 37-chunk batches, and K2 through them, on an operand
    with ``x[0, 0] = inf`` (and a NaN at p = 9) and a value inf: NaN for NaN
    equal to the gather plain version on the CPU, which
    tests/test_torch_nonfinite.py holds to the reference's default path.
    The input is that test's (R-MAT scale 10, T = 256, C = 64, integers)."""
    T = 256
    g = rmat(10, 8, seed=1)
    rng = np.random.default_rng(11)
    gv = g.with_values(rng.integers(-3, 4, g.nnz).astype(np.float32))
    ct = to_chunked(gv, T=T, C=64)
    x = rng.integers(-4, 5, (g.n_cols, p)).astype(np.float32)
    x[0, 0] = np.inf
    if p > 2:
        x[5, 7] = np.nan
    vals = ct.vals.copy()
    vals[3, 0] = np.inf
    x_pad = np.zeros((ct.padded_cols, p), np.float32)
    x_pad[: g.n_cols] = x
    planes = [torch.from_numpy(a) for a in (ct.meta, ct.row_local,
                                            ct.col_local, vals)]
    want = sem_spmm.spmm_tiles(*planes, torch.from_numpy(x_pad), T=T,
                               n_tile_rows=ct.n_tile_rows).numpy()
    assert not np.isfinite(want).all()
    acc = torch.zeros((ct.n_tile_rows * T, p), device=cuda)
    xp = torch.from_numpy(x_pad).to(cuda)
    dev = [a.to(cuda) for a in planes]
    for s in range(0, ct.n_chunks, 37):
        meta, rows, cols, v = (a[s:s + 37].contiguous() for a in dev)
        nv = torch.tensor([meta.shape[0]], dtype=torch.int32, device=cuda)
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, v, xp, acc, T=T,
                                variant=variant)
    one_shot = sem_spmm.spmm_tiles(*dev, xp, T=T, n_tile_rows=ct.n_tile_rows,
                                   variant=variant)
    np.testing.assert_array_equal(acc.cpu().numpy(), want)
    np.testing.assert_array_equal(one_shot.cpu().numpy(), want)


# -- K2 with a bfloat16 operand ---------------------------------------------
@pytest.mark.parametrize("variant", ["gather", "mxu"])
def test_one_shot_bf16(cuda, variant):
    """Integer-valued operand: exact in bfloat16 and in every float32 sum,
    so kernel and plain version agree bit for bit; a normal operand rounded
    to bfloat16 stays within the reference's bfloat16 tolerance (0.25) of
    the float32 product on the unrounded operand."""
    g = rmat(11, 8, seed=3)
    gv = g.with_values(np.random.default_rng(2).integers(
        -3, 4, g.nnz).astype(np.float32))
    ct = to_chunked(gv, T=256, C=64)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-4, 5, (g.n_cols, 4)).astype(
        np.float32)).to(torch.bfloat16)
    got = spmm_kernel(ct, x, variant=variant, device=cuda)
    assert got.dtype == torch.bfloat16
    want = spmm_kernel(ct, x, variant=variant, device="cpu")
    assert torch.equal(got.cpu(), want)
    xn = rng.standard_normal((g.n_cols, 4)).astype(np.float32)
    got = spmm_kernel(ct, torch.from_numpy(xn).to(torch.bfloat16),
                      variant=variant, device=cuda).double().cpu().numpy()
    exact = spmm_kernel(ct, xn, variant=variant, device="cpu").double().numpy()
    np.testing.assert_allclose(got, exact, rtol=0.25, atol=0.25)


@pytest.mark.parametrize("p", [3, 6, 8, 17])
def test_mxu_one_shot_bf16_copy_widths(cuda, p):
    """The densify kernel's bfloat16 operand at each way a row is gathered:
    plain loads (odd p), 4-byte copies (p = 6) and 16-byte copies (p a
    multiple of 8), bit for bit on integer data."""
    g = rmat(11, 8, seed=3)
    gv = g.with_values(np.random.default_rng(2).integers(
        -3, 4, g.nnz).astype(np.float32))
    ct = to_chunked(gv, T=256, C=64)
    x = torch.from_numpy(np.random.default_rng(p).integers(
        -4, 5, (g.n_cols, p)).astype(np.float32)).to(torch.bfloat16)
    got = spmm_kernel(ct, x, variant="mxu", device=cuda)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), spmm_kernel(ct, x, variant="mxu",
                                              device="cpu"))


# -- K3: flash attention -----------------------------------------------------
def _randn(gen, shape, cuda, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=cuda).to(dtype)


@pytest.mark.parametrize("B,L,H,KV,hd,causal,softcap,S", [
    (1, 256, 4, 4, 64, True, 0.0, 0),
    (2, 256, 8, 2, 64, True, 0.0, 0),
    (1, 512, 4, 1, 128, True, 0.0, 0),
    (1, 128, 2, 2, 32, True, 0.0, 0),
    (2, 128, 4, 2, 16, True, 0.0, 0),       # reduced Zamba2-7B, G = 2
    (1, 256, 2, 2, 64, False, 30.0, 0),
    (2, 2048, 32, 32, 112, True, 0.0, 0),   # Zamba2-7B's prefill
    (2, 2048, 32, 4, 128, True, 0.0, 0),    # Yi-9B's prefill, G = 8
    (2, 2048, 32, 16, 128, True, 50.0, 0),  # Gemma2-27B's global layers
    # hd padded to the next multiple of 8 (none, or up to 7 columns)
    (1, 256, 2, 2, 8, True, 0.0, 0),
    (1, 256, 2, 2, 48, True, 0.0, 0),
    (2, 192, 4, 2, 80, True, 0.0, 0),
    (1, 256, 2, 1, 120, True, 0.0, 0),
    (1, 128, 2, 2, 100, True, 0.0, 0),
    (1, 128, 2, 2, 6, True, 0.0, 0),       # 4-byte copies: hd % 4 != 0
    # S != L, non-causal: more keys than queries, and a ragged last tile
    (2, 256, 4, 4, 64, False, 0.0, 384),
    (1, 384, 2, 2, 112, False, 0.0, 200),
    (2, 256, 8, 2, 64, True, 20.0, 0),      # G = 4 with softcap
    # L a multiple of the blocks (32) but not of a block's query rows
    (1, 160, 4, 4, 112, True, 0.0, 0),
])
def test_flash_kernel_matches_plain(cuda, B, L, H, KV, hd, causal, softcap,
                                    S):
    """Float32 at the reference's tolerance (2e-4), one launch a call; S = 0
    means S = L."""
    S = S or L
    gen = torch.Generator(cuda).manual_seed(L + H + hd)
    q = _randn(gen, (B, L, H, hd), cuda)
    k, v = (_randn(gen, (B, S, KV, hd), cuda) for _ in range(2))
    before = k3.LAUNCHES["flash_attention"]
    blocks = dict(Bq=math.gcd(L, 256), Bk=math.gcd(S, 256))
    got = k3.flash_attention(q, k, v, causal=causal, softcap=softcap,
                             **blocks)
    assert k3.LAUNCHES["flash_attention"] - before == 1
    want = k3.flash_attention_plain(q, k, v, causal=causal, softcap=softcap,
                                    **blocks)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_flash_kernel_bf16(cuda):
    gen = torch.Generator(cuda).manual_seed(0)
    q, k, v = (_randn(gen, (1, 256, 4, 64), cuda, torch.bfloat16)
               for _ in range(3))
    got = k3.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = k3.flash_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)


# -- K4: the SSD chunk scan --------------------------------------------------
def _ssd_inputs(cuda, B, L, H, dh, N, dtype=torch.float32, dt_scale=None):
    """Normal x, B, C, D; dt uniform in [0.001, 0.1) and A in (-2, -0.5]
    (the reference tests' ranges), or, with ``dt_scale``, dt = softplus of
    a normal times it and A = -1 (the models' default init at 1)."""
    gen = torch.Generator(cuda).manual_seed(L + H + N)
    x = _randn(gen, (B, L, H, dh), cuda, dtype)
    if dt_scale is None:
        dt = torch.rand((B, L, H), generator=gen, device=cuda) * 0.099 + 0.001
        A = -(torch.rand((H,), generator=gen, device=cuda) * 1.5 + 0.5)
    else:
        dt = torch.nn.functional.softplus(torch.randn(
            (B, L, H), generator=gen, device=cuda)) * dt_scale
        A = -torch.ones((H,), device=cuda)
    Bm, Cm = (_randn(gen, (B, L, N), cuda, dtype) for _ in range(2))
    D = _randn(gen, (H,), cuda)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("B,L,H,dh,N,Q", [
    (1, 256, 2, 32, 16, 128),
    (2, 256, 4, 64, 32, 128),
    (1, 512, 2, 64, 64, 256),
    (1, 128, 1, 16, 8, 128),
    (2, 128, 16, 8, 16, 128),        # reduced Zamba2-7B
    (2, 2048, 112, 64, 64, 256),     # Zamba2-7B's prefill
    (2, 2048, 24, 64, 128, 256),     # Mamba2-130M's prefill
    (1, 256, 3, 24, 40, 256),        # L = Q; dh, N no multiples of 16
    (1, 2048, 2, 64, 64, 128),       # nc = 16
    (2, 288, 2, 24, 72, 96),         # Q no multiple of the 64-row tiles
    (1, 192, 2, 6, 5, 64),           # rows no multiple of 16 bytes
])
def test_ssd_kernel_matches_plain(cuda, B, L, H, dh, N, Q):
    """Float32 at the reference's tolerance (2e-4), one launch a call."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(cuda, B, L, H, dh, N)
    before = k4.LAUNCHES["ssd_chunked"]
    y, s = k4.ssd_chunked(x, dt, A, Bm, Cm, D, Q=Q)
    assert k4.LAUNCHES["ssd_chunked"] - before == 1
    y_p, s_p = k4.ssd_chunked_plain(x, dt, A, Bm, Cm, D, Q=Q)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, s_p, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("N", [64, 128])
def test_ssd_kernel_bf16(cuda, N):
    """bfloat16 x, B, C against the plain version on the same bfloat16
    inputs (which widens them and sums in float32 too).  y is compared in
    bfloat16 at 1e-2: the two float32 results may round to neighbouring
    bfloat16 values (8 significant bits: an ulp is at most 2**-7
    relative); the float32 state at the float32 tolerance (2e-4)."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(cuda, 2, 512, 4, 64, N, torch.bfloat16)
    y, s = k4.ssd_chunked(x, dt, A, Bm, Cm, D, Q=256)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y_p, s_p = k4.ssd_chunked_plain(x, dt, A, Bm, Cm, D, Q=256)
    torch.testing.assert_close(y, y_p, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(s, s_p, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_strong_decay(cuda):
    """dt about 0.7 and A = -1 (the models' default init): cum passes -88
    inside every 256-row chunk, so exp(cum) underflows to 0 there while
    exp(cum_i - cum_j) near the diagonal does not; y and the state are
    finite and equal the plain version's.  B and C are scaled by N**-0.5,
    so C·B is of order 1 as in the models: each weight carries the float32
    rounding of two cumulative sums near -200 (an ulp is 1.5e-5), taken in
    other orders by the kernel's scan and torch.cumsum, relative to the
    terms it scales."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(cuda, 2, 1024, 4, 64, 64, dt_scale=1.0)
    Bm, Cm = Bm / 8.0, Cm / 8.0
    cum = torch.cumsum((dt * A).reshape(2, 4, 256, 4), dim=2)
    assert float(cum.min()) < -88.0
    y, s = k4.ssd_chunked(x, dt, A, Bm, Cm, D, Q=256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    y_p, s_p = k4.ssd_chunked_plain(x, dt, A, Bm, Cm, D, Q=256)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, s_p, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_repeats_bit_for_bit(cuda):
    """No atomics: two calls on the same inputs give the same bits, so a
    stale or shared workspace would show; a call at another shape between
    them reuses the freed workspaces."""
    ins = _ssd_inputs(cuda, 2, 512, 8, 64, 128)
    y1, s1 = k4.ssd_chunked(*ins, Q=256)
    k4.ssd_chunked(*_ssd_inputs(cuda, 1, 256, 3, 24, 40), Q=128)
    y2, s2 = k4.ssd_chunked(*ins, Q=256)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_flash_dispatch_at_odd_128_blocks(cuda):
    """L = 384 through the models' attention: one launch, with blocks that
    divide L (gcd(L, 256) = 128), against the plain version."""
    from repro_torch.models import layers
    gen = torch.Generator(cuda).manual_seed(384)
    q = _randn(gen, (2, 384, 8, 64), cuda)
    k, v = (_randn(gen, (2, 384, 2, 64), cuda) for _ in range(2))
    kw = dict(q_positions=torch.arange(384, device=cuda), s_valid=384)
    before = k3.LAUNCHES["flash_attention"]
    got = layers.flash_attention(q, k, v, **kw)
    assert k3.LAUNCHES["flash_attention"] - before == 1
    prev = layers.set_flash_impl("plain")
    try:
        want = layers.flash_attention(q, k, v, **kw)
    finally:
        layers.set_flash_impl(prev)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _reduced_batch(cfg, L, seed=1):
    """Tokens (B = 2) so that the attention's length is L (a vlm's patch
    prefix included), with vlm's patches and audio's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, L - cfg.n_patches)))}
    if cfg.family == "vlm":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    return out


def _one_ulp(model, seed):
    """A copy of ``model`` with its parameters moved by ``ulp.one_ulp``."""
    moved = copy.deepcopy(model)
    params = dict(moved.named_parameters())
    with torch.no_grad():
        for name, a in one_ulp({k: p.numpy() for k, p in params.items()},
                               seed).items():
            params[name].copy_(torch.from_numpy(a))
    return moved


@pytest.mark.parametrize("arch,k3_calls,k4_calls", [
    ("zamba2-7b", 2, 13), ("mamba2-130m", 0, 4), ("yi-9b", 4, 0),
    ("gemma2-27b", 2, 0), ("olmoe-1b-7b", 4, 0), ("internvl2-2b", 4, 0),
    ("whisper-medium", 4, 0)])
def test_reduced_model_on_card_matches_cpu(cuda, arch, k3_calls, k4_calls):
    """The reduced models' forward (B = 2, L = 128 with a vlm's patches) on
    the card through the kernels against the same weights on the CPU (the
    plain versions), at the forward tolerance of tests/test_torch_models.py
    (2e-4); the attention families' beyond twice the CPU forward's own
    spread under one-ulp moves of its weights (tests/test_torch_dense.py:
    their reduced stacks amplify rounding; the hybrid and SSM ones are held
    at 2e-4 alone); then each layer on the card, teacher-forced with the
    CPU forward's input to it, at 2e-4 alone (``_check_layers_on_card``)."""
    cfg = get_config(arch).reduced()
    cpu = model_api.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    batch = _reduced_batch(cfg, 128)
    k3.reset_launches()
    k4.reset_launches()
    got, _ = model_api.forward(card, cfg, {k: v.to(cuda)
                                           for k, v in batch.items()})
    assert k3.LAUNCHES["flash_attention"] == k3_calls
    assert k4.LAUNCHES["ssd_chunked"] == k4_calls
    want, _ = model_api.forward(cpu, cfg, batch)
    spread = 0.0 if cfg.family in ("ssm", "hybrid") else max(
        float((model_api.forward(_one_ulp(cpu, s), cfg, batch)[0]
               - want).abs().max()) for s in range(4))
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4,
                               atol=2e-4 + 2 * spread)
    _check_layers_on_card(cfg, cpu, card, batch, cuda)


# The layer functions of the reduced models, by module.
_LAYER_FNS = (("transformer", "_attn_mlp_layer"),
              ("transformer", "_shared_attn_apply"),
              ("transformer", "_mamba_apply"),
              ("encdec", "_encoder_layer"), ("encdec", "_decoder_layer"))


def _check_layers_on_card(cfg, cpu, card, batch, cuda):
    """Teacher-forced, layer by layer: every layer call of the CPU forward
    is repeated on the card, on the same input and with the card's copy of
    the layer, through the kernels, and held within 2e-4 of each entry and
    of the layer output's largest magnitude (the forward tolerance of
    tests/test_torch_models.py)."""
    import importlib
    calls = []

    def recorder(fn):
        def wrapped(cfg, lp, x, *a, **kw):
            out = fn(cfg, lp, x, *a, **kw)
            calls.append((fn, lp, x, a, kw,
                          out[0] if isinstance(out, tuple) else out))
            return out
        return wrapped
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        for mod, name in _LAYER_FNS:
            module = importlib.import_module(f"repro_torch.models.{mod}")
            m.setattr(module, name, recorder(getattr(module, name)))
        model_api.forward(cpu, cfg, batch)
    assert calls
    names = {id(mod): n for n, mod in cpu.named_modules()}
    on_card = dict(card.named_modules())

    def to_card(v):
        return v.to(cuda) if isinstance(v, torch.Tensor) else v
    for i, (fn, lp, x, a, kw, want) in enumerate(calls):
        out = fn(cfg, on_card[names[id(lp)]], x.to(cuda),
                 *map(to_card, a), **{k: to_card(v) for k, v in kw.items()})
        got = out[0] if isinstance(out, tuple) else out
        tol = 2e-4 * float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=tol,
                                   msg=lambda m, i=i: f"layer call {i}: {m}")


# ---------------------------------------------------------------------------
# The serving runtime on the card (select with ``-k serving``)
# ---------------------------------------------------------------------------
def _abs_product(st, x):
    """|A|·|x| on the host: the scale a float result is held to."""
    from repro_torch.core.spgemm import materialize_dense
    return np.abs(materialize_dense(st)).astype(np.float64) @ np.abs(
        x.astype(np.float64))


def _within_scale(got, want, scale):
    """Elementwise within 1e-5 of |A|·|x| (the module docstring's rule)."""
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-5 * scale)


def _track_acc(sem):
    """Record the accumulator each pass of ``sem`` fills."""
    ptrs = []
    real = sem._multiply

    def tracking(*a, **kw):
        out = real(*a, **kw)
        ptrs.append(out[1].data_ptr())
        return out
    sem._multiply = tracking
    return ptrs


@pytest.mark.parametrize("operand", ["integer", "float"])
def test_serving_scheduler_on_card_matches_cpu(cuda, stores, operand):
    """A shared wave (8 one-shot tenants and a 3-column one, under a
    4-column budget: several passes) on the card against the same wave
    through the CPU engine: integer operands bit for bit, float ones
    within 1e-5 of |A|·|x|; the same reports, one K1a launch per batch,
    and one accumulator per width kept across passes."""
    from repro_torch.runtime import MultiplyRequest, SharedScanScheduler
    st = stores["val256"]
    n = st.header["n_cols"]
    r = np.random.default_rng(21)
    xs = [(r.integers(-4, 5, (n, w)) if operand == "integer"
           else r.standard_normal((n, w))).astype(np.float32)
          for w in (1,) * 8 + (3,)]
    runs = []
    for dev in (cuda, "cpu"):
        sem = SEMSpMM(TileStore.open(st.path), SEMConfig(chunk_batch=53),
                      device=dev)
        sem.cfg.memory_budget_bytes = (sem.stream_overhead_bytes()
                                       + 4 * sem.column_bytes()
                                       + sem.column_bytes() // 2)
        ptrs = _track_acc(sem)
        sched = SharedScanScheduler(sem, use_cache=False)
        reqs = [sched.submit(MultiplyRequest(x)) for x in xs]
        sem_spmm.reset_launches()
        sched.run()
        runs.append((reqs, sched, sem_spmm.LAUNCHES["spmm_tiles_acc"],
                     ptrs))
    (reqs, sched, launches, ptrs), (want, cpu_sched, _, _) = runs
    passes = sched.total_scan_passes()
    assert passes == cpu_sched.total_scan_passes() >= 3
    assert launches == passes * sched.sem.n_batches
    assert [(p.wave_cols, p.bytes_read) for p in sched.reports] == \
        [(p.wave_cols, p.bytes_read) for p in cpu_sched.reports]
    assert len(set(ptrs)) == len({p.wave_cols for p in sched.reports})
    for g, w, x in zip(reqs, want, xs):
        if operand == "integer":
            np.testing.assert_array_equal(g.result, w.result)
        else:
            _within_scale(g.result, w.result, _abs_product(st, x))


def test_serving_midpass_admission_on_card(cuda, stores):
    """An elastic wave on the card admits a query at a chunk-batch
    boundary of an in-flight pass and delivers it from the stitched
    partial passes: the CPU engine's bits, one K1a launch per batch and
    one accumulator for the whole run."""
    from repro_torch.runtime import (PowerIterationSession,
                                     SharedScanScheduler)
    st = stores["val256"]
    n = st.header["n_cols"]
    r = np.random.default_rng(22)
    x = r.integers(-4, 5, n).astype(np.float32)
    box = {}

    def probe(sched, b):
        if "req" not in box and sched.boundary_clock >= 4:
            box["req"] = sched.query(x, tenant_id="midpass")
    sem = SEMSpMM(TileStore.open(st.path), SEMConfig(chunk_batch=53),
                  device=cuda)
    ptrs = _track_acc(sem)
    sched = SharedScanScheduler(sem, use_cache=False, elastic=True,
                                capacity=6, boundary_probe=probe)
    sched.submit(PowerIterationSession(r.standard_normal(n).astype(
        np.float32), tol=0.0, max_iter=3))
    sem_spmm.reset_launches()
    sched.run()
    req = box["req"]
    assert req.done
    assert sum(p.admitted_midpass for p in sched.reports) == 1
    assert sum(p.completed_midpass for p in sched.reports) == 1
    want = SEMSpMM(TileStore.open(st.path), SEMConfig(chunk_batch=53),
                   device="cpu").multiply(x[:, None])[:, 0]
    np.testing.assert_array_equal(req.result, want)
    passes = sched.total_scan_passes()
    assert sem_spmm.LAUNCHES["spmm_tiles_acc"] == passes * sem.n_batches
    assert len(ptrs) == passes and len(set(ptrs)) == 1


def _replica_copy(st, tmp_path):
    import shutil
    p = str(tmp_path / "copy")
    shutil.copy(st.path + ".bin", p + ".bin")
    shutil.copy(st.path + ".json", p + ".json")
    return p


def test_serving_replica_failover_on_card(cuda, stores, tmp_path):
    """A replica whose read fails mid-pass on the card: the pass is retried
    on the other copy with the CPU engine's bits; once restored, the
    failed executor (its staging slots, events and stream left by the
    abandoned pass) serves a pass with the same bits."""
    from repro_torch.runtime import ReplicaSet
    st = stores["val256"]
    n = st.header["n_cols"]
    x = np.random.default_rng(23).integers(-4, 5, (n, 4)).astype(np.float32)
    want = SEMSpMM(TileStore.open(st.path), SEMConfig(chunk_batch=53),
                   device="cpu").multiply(x)
    rs = ReplicaSet([st.path, _replica_copy(st, tmp_path)],
                    SEMConfig(chunk_batch=53), devices=[cuda, cuda])
    victim = rs.router.ranked()[0]
    real = rs.execs[victim].store.read_batch_raw
    calls = {"n": 0}

    def dying(start, count):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("replica removed mid-run")
        return real(start, count)
    rs.execs[victim].store.read_batch_raw = dying
    np.testing.assert_array_equal(rs.multiply(x), want)
    assert not rs.router.states[victim].healthy
    rs.execs[victim].store.read_batch_raw = real
    rs.router.restore(victim)
    rs.router.fail(1 - victim, OSError("drained for the check"))
    np.testing.assert_array_equal(rs.multiply(x), want)
    assert rs.router.states[victim].scans == 1
    rs.close()


def test_serving_fleet_two_waves_on_one_card(cuda, stores, tmp_path):
    """Two waves as threads over two copies on one card: every one-shot
    tenant gets the CPU engine's bits, and the fleet reads the store once
    per pass it made."""
    from repro_torch.runtime import ReplicaSet, ServingFleet
    st = stores["val256"]
    n = st.header["n_cols"]
    r = np.random.default_rng(24)
    xs = [r.integers(-4, 5, n).astype(np.float32) for _ in range(12)]
    cpu = SEMSpMM(TileStore.open(st.path), SEMConfig(chunk_batch=53),
                  device="cpu")
    rs = ReplicaSet([st.path, _replica_copy(st, tmp_path)],
                    SEMConfig(chunk_batch=53), devices=[cuda, cuda])
    with ServingFleet(rs, n_waves=2, use_cache=False) as fleet:
        reqs = [fleet.query(x, tenant_id=f"q{i}") for i, x in enumerate(xs)]
        fleet.drain(timeout=120)
        assert {q.wave_id for q in reqs} == {0, 1}
        for q, x in zip(reqs, xs):
            np.testing.assert_array_equal(q.result,
                                          cpu.multiply(x[:, None])[:, 0])
        assert fleet.io_stats.bytes_read == \
            fleet.total_scan_passes() * st.nbytes


# ---------------------------------------------------------------------------
# The cross-host tier on the card (select with ``-k net``)
# ---------------------------------------------------------------------------
def _net_cluster(cuda, paths):
    """Two hosts on the card (the gather kernel, one wave, a copy each)
    behind one front door; returns (hosts, front door, keys)."""
    from repro_torch.net import ClusterFrontDoor, HostServer
    from repro_torch.runtime import ReplicaSet, ServingFleet
    hosts = [HostServer(ServingFleet(ReplicaSet(
        [p], SEMConfig(chunk_batch=53, kernel_variant="gather"),
        devices=[cuda]), n_waves=1, use_cache=False)) for p in paths]
    ports = [h.start() for h in hosts]
    fd = ClusterFrontDoor(heartbeat_interval=0.1, miss_limit=2)
    return hosts, fd, [fd.add_host("127.0.0.1", p) for p in ports]


def _cpu_product(st, x):
    return SEMSpMM(TileStore.open(st.path), SEMConfig(chunk_batch=53),
                   device="cpu").multiply(x[:, None] if x.ndim == 1
                                          else x)


def test_net_two_hosts_on_card_match_cpu(cuda, stores, tmp_path):
    """Routed integer queries over two hosts on the card: the CPU engine's
    bits, both hosts serving, each host's store read once a pass and K1a
    launched once a batch and pass."""
    from repro_torch.runtime import SessionSpec
    st = stores["bin4096"]
    n = st.header["n_cols"]
    r = np.random.default_rng(31)
    xs = [r.integers(-4, 5, n).astype(np.float32) for _ in range(5)]
    xs.append(r.integers(-4, 5, (n, 3)).astype(np.float32))
    hosts, fd, keys = _net_cluster(cuda, [st.path,
                                          _replica_copy(st, tmp_path)])
    try:
        sem_spmm.reset_launches()
        tickets = [fd.submit(SessionSpec.multiply(x, tenant_id=f"q{i}"))
                   for i, x in enumerate(xs)]
        results = fd.drain(tickets, timeout=120)
        assert {t.host_key for t in tickets} == set(keys)
    finally:
        fd.close()
        for h in hosts:
            h.stop()
    for got, x in zip(results, xs):
        want = _cpu_product(st, x)
        np.testing.assert_array_equal(got, want[:, 0] if x.ndim == 1
                                      else want)
    passes = [h.fleet.total_scan_passes() for h in hosts]
    for h, p in zip(hosts, passes):
        assert p >= 1 and h.fleet.io_stats.bytes_read == p * st.nbytes
    assert sem_spmm.LAUNCHES["spmm_tiles_acc"] == \
        sum(passes) * hosts[0].fleet.replicas.n_batches


def test_net_partitioned_query_on_card(cuda, stores, tmp_path):
    """A partitioned query (a slab a host, both on the card): the CPU
    engine's bits for a one-shot multiply and an iterative BFS; K1a once
    per slab batch of every slab pass (T = 256: the store has tile rows to
    split)."""
    from repro_torch.runtime import SessionSpec
    st = stores["bin256"]
    n = st.header["n_cols"]
    x = np.random.default_rng(32).integers(-4, 5, (n, 2)).astype(np.float32)
    hosts, fd, _ = _net_cluster(cuda, [st.path, _replica_copy(st, tmp_path)])
    try:
        sem_spmm.reset_launches()
        part = fd.submit(SessionSpec.multiply(x, tenant_id="p"),
                         partitioned=True)
        bfs = fd.submit(SessionSpec.bfs(np.array([0]), n, tenant_id="b"),
                        partitioned=True)
        got, levels = fd.drain([part, bfs], timeout=120)
        slabs = [rs for h in hosts for rs in h._slabs.values()]
        assert len(slabs) == 2
        assert all(ex.device.type == "cuda" for rs in slabs
                   for ex in rs.execs)
        scans = sum(h.slab_scans for h in hosts)
        assert sem_spmm.LAUNCHES["spmm_tiles_acc"] == \
            scans // 2 * sum(rs.n_batches for rs in slabs)
    finally:
        fd.close()
        for h in hosts:
            h.stop()
    np.testing.assert_array_equal(got, _cpu_product(st, x))
    from repro_torch.runtime import BFSSession, SharedScanScheduler
    sched = SharedScanScheduler(SEMSpMM(TileStore.open(st.path),
                                        SEMConfig(chunk_batch=53),
                                        device="cpu"))
    want = sched.submit(BFSSession(np.array([0]), n))
    sched.drain()
    np.testing.assert_array_equal(levels, want.result)


def test_net_killed_host_on_card(cuda, stores, tmp_path):
    """A host killed while it serves: evicted, its tenants replayed on the
    survivor with the CPU engine's bits."""
    from repro_torch.runtime import SessionSpec
    st = stores["bin4096"]
    n = st.header["n_cols"]
    r = np.random.default_rng(33)
    xs = [r.integers(-4, 5, n).astype(np.float32) for _ in range(6)]
    hosts, fd, keys = _net_cluster(cuda, [st.path,
                                          _replica_copy(st, tmp_path)])
    try:
        tickets = [fd.submit(SessionSpec.multiply(x, tenant_id=f"k{i}"))
                   for i, x in enumerate(xs)]
        hosts[0]._loop.call_soon_threadsafe(hosts[0]._shutdown.set)
        results = fd.drain(tickets, timeout=120)
        assert fd.evicted == [keys[0]]
        assert all(t.host_key == keys[1] for t in tickets if t.resubmits)
    finally:
        fd.close()
        for h in hosts:
            h.stop()
    for got, x in zip(results, xs):
        np.testing.assert_array_equal(got, _cpu_product(st, x)[:, 0])


def test_net_build_host_defaults_to_the_card(cuda, stores, tmp_path):
    """``build_host`` with no devices puts every executor on the card."""
    from repro_torch.net import build_host
    st = stores["bin4096"]
    h = build_host([st.path, _replica_copy(st, tmp_path)], waves=1)
    try:
        assert [ex.device for ex in h.fleet.replicas.execs] == [cuda, cuda]
    finally:
        h.stop()


# ---------------------------------------------------------------------------
# Training on the card (select with ``-k train``)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,L,H,KV,hd,softcap", [
    (1, 256, 4, 4, 64, 0.0),
    (2, 256, 8, 2, 64, 20.0),
    (1, 256, 2, 1, 128, 0.0),
    (2, 2048, 36, 36, 64, 0.0)])        # MiniCPM-2B's training shape
def test_train_flash_function_gradients_equal_plain(cuda, B, L, H, KV, hd,
                                                    softcap):
    """With grad enabled K3's wrapper launches the kernel (its output is
    the kernel's) and its gradients are the plain version's, which its
    backward recomputes and differentiates: equal bit for bit."""
    gen = torch.Generator(cuda).manual_seed(L + H + hd)
    q = _randn(gen, (B, L, H, hd), cuda)
    k, v = (_randn(gen, (B, L, KV, hd), cuda) for _ in range(2))
    go = _randn(gen, (B, L, H, hd), cuda)
    blocks = dict(Bq=math.gcd(L, 256), Bk=math.gcd(L, 256))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = k3.LAUNCHES["flash_attention"]
    out = k3.flash_attention(*ins, causal=True, softcap=softcap, **blocks)
    assert k3.LAUNCHES["flash_attention"] - before == 1
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(out, k3.flash_attention(q, k, v, causal=True,
                                                   softcap=softcap,
                                                   **blocks))
    out.backward(go)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    k3.flash_attention_plain(*ref, causal=True, softcap=softcap,
                             **blocks).backward(go)
    for a, b in zip(ins, ref):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("B,L,H,dh,N,Q", [
    (1, 256, 2, 32, 16, 128),
    (2, 2048, 24, 64, 128, 256)])       # Mamba2-130M's training shape
def test_train_ssd_function_gradients_equal_plain(cuda, B, L, H, dh, N, Q):
    """As above for K4: one kernel call in the forward pass, gradients
    through y and the final state equal to the plain version's."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(cuda, B, L, H, dh, N)
    gen = torch.Generator(cuda).manual_seed(5)
    gy = _randn(gen, (B, L, H, dh), cuda)
    gs = _randn(gen, (B, H, dh, N), cuda)
    grads = []
    for run in ("kernel", "plain"):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, D)]
        before = k4.LAUNCHES["ssd_chunked"]
        fn = k4.ssd_chunked if run == "kernel" else k4.ssd_chunked_plain
        y, s = fn(*ins, Q=Q)
        assert k4.LAUNCHES["ssd_chunked"] - before == (run == "kernel")
        torch.autograd.backward((y, s), (gy, gs))
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_train_k3_gives_wq_wk_wv_gradients(cuda):
    """Through K3 on the card, every layer's wq, wk and wv get nonzero
    gradients (the kernel's output carries the graph back to them)."""
    cfg = get_config("minicpm-2b").reduced()
    model = model_api.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                                  cuda)
    model.requires_grad_(True)
    batch = {k: v.to(cuda) for k, v in _reduced_batch(cfg, 128).items()}
    k3.reset_launches()
    logits, _ = model_api.forward(model, cfg, batch, remat=False)
    assert k3.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.logsumexp(logits, dim=-1).mean().backward()
    for i, lp in enumerate(model.layers):
        for name in ("wq", "wk", "wv"):
            g = lp.attn[name].grad
            assert g is not None and bool((g != 0).any()), (i, name)


@pytest.mark.parametrize("arch,k3_calls,k4_calls", [
    ("minicpm-2b", 8, 0), ("mamba2-130m", 0, 8)])
def test_train_step_on_card_matches_cpu(cuda, arch, k3_calls, k4_calls):
    """One train step (loss, backward through the kernels with their
    recompute, AdamW) of a reduced model on the card against the same step
    on the CPU from the same weights and batch: the loss within 2e-4
    relative, each parameter's move within 1e-3 of its norm, both beyond
    twice the CPU step's own spread under one-ulp moves of the weights
    (tests/test_torch_train_steps.py: AdamW turns rounding-sized gradients
    into moves of lr)."""
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    cfg = get_config(arch).reduced()
    cpu = model_api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    raw = next(TokenStream(DataConfig(vocab=cfg.vocab, seq_len=128,
                                      global_batch=2, seed=0)))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10))

    def run(model, dev):
        model = model.to(dev).requires_grad_(True)
        before = {k: p.detach().cpu().clone()
                  for k, p in model.named_parameters()}
        state = init_opt_state(dict(model.named_parameters()))
        _, _, m = step(model, state, {k: torch.from_numpy(v).to(dev)
                                      for k, v in raw.items()})
        return float(m["loss"]), before, {
            k: p.detach().cpu() for k, p in model.named_parameters()}
    near = [run(_one_ulp(cpu, s), "cpu") for s in range(2)]
    k3.reset_launches()
    k4.reset_launches()
    got_loss, start, got = run(copy.deepcopy(cpu), cuda)
    assert k3.LAUNCHES["flash_attention"] == k3_calls
    assert k4.LAUNCHES["ssd_chunked"] == k4_calls
    want_loss, _, want = run(cpu, "cpu")
    spread = max(abs(n[0] - want_loss) for n in near)
    assert abs(got_loss - want_loss) <= 2e-4 * abs(want_loss) + 2 * spread
    for k, w in want.items():
        upd = max(float((w - start[k]).norm()), 1e-30)
        rel = float((got[k] - w).norm()) / upd
        sp = max(float((n[2][k] - w).norm()) for n in near) / upd
        assert rel <= 1e-3 + 2 * sp, (k, rel, sp)


_DISTRIBUTED_ON_CARD = """
import math, socket, torch, torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.distributed import collectives as co
from repro_torch.distributed.moe_a2a import moe_block_a2a
from repro_torch.distributed.pipeline import make_pipelined_apply
from repro_torch.kernels import flash_attention as k3
from repro_torch.launch import cost_analysis
from repro_torch.models.moe import moe_block

dev = torch.device("cuda", 0)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                        rank=0, world_size=1, device_id=dev)
try:
    g = torch.Generator(dev).manual_seed(0)
    mesh = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    tree = {"a": torch.randn(1000, 37, generator=g, device=dev),
            "b": torch.randn(5, generator=g, device=dev)}
    for out in (co.hierarchical_psum(tree, mesh),
                co.chunked_psum(tree, mesh, ("pod", "data"))):
        assert all(torch.equal(out[k], v) for k, v in tree.items())
    red, err = co.compressed_pod_psum(tree, mesh,
                                      co.init_error_state(tree, mesh))
    for k, v in tree.items():
        q, s_ = co.quantize_int8(v.reshape(-1))
        # half a step, beyond float32's rounding of x / scale and q * scale
        assert float((red[k] - v).abs().max()) <= float(s_) / 2 * (1 + 2**-14)
        assert torch.equal(err[k], v.reshape(-1) - co.dequantize_int8(q, s_))

    mesh2 = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    D, E, Fd, K = 64, 8, 64, 2
    p = {"router": torch.randn(D, E, generator=g, device=dev) * 0.5,
         "w_gate": torch.randn(E, D, Fd, generator=g, device=dev) * 0.2,
         "w_in": torch.randn(E, D, Fd, generator=g, device=dev) * 0.2,
         "w_out": torch.randn(E, Fd, D, generator=g, device=dev) * 0.2}
    x = torch.randn(2, 64, D, generator=g, device=dev)
    y, aux = moe_block_a2a(p, x, mesh2, n_experts=E, top_k=K,
                           capacity_factor=8.0)
    want, want_aux = moe_block(p, x, n_experts=E, top_k=K,
                               capacity_factor=8.0)
    rel = ((y.to_local() - want).norm(dim=-1) / want.norm(dim=-1)).max()
    assert float(rel) <= 1e-5, float(rel)
    assert abs(float(aux) - float(want_aux)) <= 1e-6

    mesh1 = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    W = torch.randn(1, 32, 32, generator=g, device=dev).requires_grad_(True)
    xs = torch.randn(4, 2, 32, generator=g, device=dev)
    fn = lambda w, z, s: F.gelu(z @ w, approximate="tanh")
    yp = make_pipelined_apply(fn, mesh1)(W, xs)
    yp.sum().backward()
    gp = W.grad.clone()
    W.grad = None
    yd = fn(W[0], xs, 0)
    yd.sum().backward()
    assert torch.allclose(yp, yd, rtol=1e-6, atol=1e-6)
    assert torch.allclose(gp, W.grad, rtol=1e-5, atol=1e-5)

    q, k, v = (torch.randn(1, 256, 4, 64, generator=g, device=dev)
               for _ in range(3))
    k3.reset_launches()
    with cost_analysis.CostCounter() as c:
        k3.flash_attention(q, k, v, causal=True, Bq=256, Bk=256)
    with FlopCounterMode(display=False) as fc:
        k3.flash_attention_plain(q, k, v, causal=True, Bk=256)
    assert k3.LAUNCHES["flash_attention"] == 1
    assert c.flops == fc.get_total_flops() > 0
    assert c.bytes == 4 * 4 * q.numel()
finally:
    dist.destroy_process_group()
print("OK")
"""


def test_distributed_tooling_on_a_one_rank_nccl_group(cuda):
    """The collectives (bit for bit over one rank), moe_block_a2a against
    moe_block, a one-stage GPipe against its stage function, and the cost
    counter's report of a K3 launch, on a one-rank NCCL group in a process
    of its own (a process holds one group)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _DISTRIBUTED_ON_CARD],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.join(root, "src")))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), \
        proc.stderr[-3000:]
