"""The CUDA kernel against its plain PyTorch version, on the card.

Small shapes; every test needs a card and skips without one (decided in the
``cuda`` fixture, never at import).  Run on a machine with a card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Integer-valued data is compared bit for bit (f32 sums of integers below
2**24 are exact in any order); normal data to ``rtol = atol = 1e-5``, since
the kernel's atomics add in an order that changes from run to run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.formats import to_chunked
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.io.storage import TileStore
from repro_torch.kernels import sem_spmm
from repro_torch.kernels.ops import spmm_kernel
from repro_torch.sparse.generate import rmat

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
    24-bit ones."""
    g = rmat(12, 8, seed=1)
    rng = np.random.default_rng(7)
    gv = g.with_values(rng.integers(-3, 4, g.nnz).astype(np.float32))
    d = tmp_path_factory.mktemp("gpu")
    out = {}
    for T, C in ((256, 64), (4096, 256)):
        out[f"val{T}"] = TileStore.write(str(d / f"v{T}"),
                                         to_chunked(gv, T=T, C=C))
        out[f"bin{T}"] = TileStore.write(str(d / f"b{T}"),
                                         to_chunked(g, T=T, C=C), binary=True)
        out[f"valopt{T}"] = out[f"val{T}"].optimize(
            str(d / f"vo{T}"), reorder=T == 256)
        out[f"binopt{T}"] = out[f"bin{T}"].optimize(
            str(d / f"bo{T}"), reorder=T == 256)
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


def _run_both(st, s, n, x, cuda, acc0=None, n_valid=None, decoded=False):
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
    before = sem_spmm.LAUNCHES["spmm_tiles_acc"]
    sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, acc, T=T)
    launches = sem_spmm.LAUNCHES["spmm_tiles_acc"] - before
    sem_spmm.spmm_tiles_acc_plain(meta, nv, rows, cols, vals, x_pad, plain,
                                  T=T)
    torch.cuda.synchronize()
    return acc.cpu().numpy(), plain.cpu().numpy(), launches


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
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_skips_pads_and_keeps_untouched_rows(cuda, stores):
    """Chunks at or past n_valid contribute nothing; tile rows the batch
    does not visit keep their sentinels bit for bit."""
    st = stores["bin256"]
    T = st.header["T"]
    x = np.ones((st.header["n_cols"], 3), np.float32)
    s, n = st.n_chunks // 3, st.n_chunks // 3
    n_rows = -(-st.header["n_rows"] // T) * T
    acc0 = torch.full((n_rows, 3), 12345.0, device=cuda)
    got, want, _ = _run_both(st, s, n, x, cuda, acc0=acc0, n_valid=n - 5)
    np.testing.assert_array_equal(got, want)
    meta = st.read_batch_raw(s, n)[0]
    touched = np.unique(meta[: n - 5, 0])
    rows = got.reshape(-1, T, 3)
    untouched = np.setdiff1d(np.arange(rows.shape[0]), touched)
    assert untouched.size > 0
    assert (rows[untouched] == 12345.0).all()
    assert not (rows[touched] == 12345.0).all()


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


def test_build_reports_registers(cuda):
    from repro_torch.kernels._build import build
    info = build("sem_spmm")
    assert info.path.exists()
    assert "registers" in info.ptxas


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

