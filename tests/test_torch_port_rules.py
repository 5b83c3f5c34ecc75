"""Rules of the port: it never loads JAX or the JAX package, its entry
points run on the card unless asked for the CPU, and its on-disk format is
the reference's byte for byte."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import to_chunked as ref_to_chunked
from repro.io.storage import TileStore as RefTileStore
from repro_torch.apps.common import IMOperator, SEMOperator
from repro_torch.apps.pagerank import pagerank
from repro_torch.convert import (chunked_from_arrays, coo_from_arrays,
                                 params_from_jax)
from repro_torch.core.formats import to_chunked
from repro_torch.core.sem import SEMSpMM
from repro_torch.core.spmm import spmm
from repro_torch.io.storage import TileStore
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.kernels.ops import spmm_kernel, spmm_kernel_batch
from repro_torch.launch.serve import BatchServer
from repro_torch.models import model_api

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(' '.join(sorted(k for k in sys.modules "
        "if k.startswith('repro_torch'))))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    # every module was imported, the model slice's subpackages included
    want = {".".join(("repro_torch",) + tuple(
        part for part in p.relative_to(PORT).with_suffix("").parts
        if part != "__init__")) for p in PORT.rglob("*.py")}
    assert want <= imported, sorted(want - imported)
    for sub in ("configs", "models", "launch", "train"):
        assert any(m.startswith(f"repro_torch.{sub}.") for m in imported), sub
    training = {"repro_torch.train.data", "repro_torch.train.optimizer",
                "repro_torch.train.loop", "repro_torch.launch.train",
                "repro_torch.io.checkpoint", "repro_torch.distributed.fault"}
    assert training <= imported, sorted(training - imported)
    tooling = {f"repro_torch.distributed.{m}" for m in (
        "sharding", "collectives", "moe_a2a", "pipeline")} | {
        f"repro_torch.launch.{m}" for m in (
            "mesh", "cost_analysis", "dryrun", "roofline")}
    assert tooling <= imported, sorted(tooling - imported)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.fixture(scope="module")
def small(small_graph, tmp_path_factory):
    ct = to_chunked(coo_from_arrays(small_graph.n_rows, small_graph.n_cols,
                                    small_graph.rows, small_graph.cols),
                    T=256, C=64)
    path = str(tmp_path_factory.mktemp("rules") / "b")
    TileStore.write(path, ct, binary=True)
    return ct, path


def test_entry_points_raise_without_a_card(small, monkeypatch):
    """No card and no ``device="cpu"``: every entry point raises instead
    of moving to the CPU quietly; with ``device="cpu"`` each runs."""
    ct, path = small
    cfg = get_config("mamba2-130m").reduced()
    tree = {k: v for k, v in model_api.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu").state_dict().items()}
    tree = _stack(cfg, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((ct.n_cols, 2), np.float32)
    batch = TileStore.open(path).read_batch_raw(0, 4)
    acc = np.zeros((ct.n_tile_rows, ct.T, 2), np.float32)
    x_pad = np.zeros((ct.padded_cols, 2), np.float32)
    mask = np.zeros(ct.n_rows, bool)
    calls = {
        "SEMSpMM": lambda **d: SEMSpMM(TileStore.open(path), **d),
        "SEMOperator": lambda **d: SEMOperator(TileStore.open(path), **d),
        "IMOperator": lambda **d: IMOperator(ct, **d),
        "spmm": lambda **d: spmm(ct, x, **d),
        "spmm_kernel": lambda **d: spmm_kernel(ct, x, **d),
        "spmm_kernel_batch": lambda **d: spmm_kernel_batch(
            batch[0], 4, batch[1], batch[2], batch[3], x_pad, acc.copy(),
            T=ct.T, **d),
        "pagerank": lambda **d: pagerank(
            IMOperator(ct, device="cpu"), mask, max_iter=1, **d),
        "init_params": lambda **d: model_api.init_params(
            cfg, torch.Generator().manual_seed(0), **d),
        "init_cache": lambda **d: model_api.init_cache(cfg, 2, 8, **d),
        "make_batch": lambda **d: model_api.make_batch(
            cfg, SHAPES["decode_32k"], np.random.default_rng(0), **d),
        "params_from_jax": lambda **d: params_from_jax(cfg, tree, **d),
        "BatchServer": lambda **d: BatchServer(cfg, slots=1, max_seq=4, **d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")


def _stack(cfg, flat):
    """A Mamba2LM's state dict as the reference's tree of numpy arrays
    (layers stacked)."""
    tree = {k: flat[k].numpy() for k in ("embed", "unembed", "final_norm")}
    names = {k.split(".", 2)[2] for k in flat if k.startswith("layers.")}
    tree["layers"] = {n: np.stack([flat[f"layers.{i}.{n}"].numpy()
                                   for i in range(cfg.n_layers)])
                      for n in names}
    return tree


def _files(path):
    p = pathlib.Path(path)
    return sorted(q for q in p.parent.iterdir() if q.name.startswith(p.name))


def test_stores_are_byte_identical_both_ways(small_valued, tmp_path):
    """A reference-written store (raw and optimized) opens in the port and
    reads the same batches; the port writes the same bytes from the same
    ChunkedTiles, handed over through ``convert``."""
    rct = ref_to_chunked(small_valued, T=256, C=64)
    pct = chunked_from_arrays(rct.n_rows, rct.n_cols, rct.T, rct.C, rct.meta,
                              rct.row_local, rct.col_local, rct.vals)
    ref = RefTileStore.write(str(tmp_path / "ref"), rct)
    port = TileStore.write(str(tmp_path / "port"), pct)
    ref.optimize(str(tmp_path / "refopt"))
    port.optimize(str(tmp_path / "portopt"))
    for a, b in (("ref", "port"), ("refopt", "portopt")):
        fa, fb = _files(tmp_path / a), _files(tmp_path / b)
        assert [f.name[len(a):] for f in fa] == [f.name[len(b):] for f in fb]
        for x, y in zip(fa, fb):
            assert x.read_bytes() == y.read_bytes(), x.name
        rs, ps = RefTileStore.open(str(tmp_path / a)), TileStore.open(
            str(tmp_path / a))
        assert ps.header == rs.header and ps.nbytes == rs.nbytes
        assert ps.batch_plan(37) == rs.batch_plan(37)
        for s, n in ps.batch_plan(37):
            for u, v in zip(ps.read_batch_raw(s, n), rs.read_batch_raw(s, n)):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("scale,seed,undirected",
                         [(8, 0, False), (11, 3, False), (10, 7, True)])
def test_rmat_and_pattern_dedup_equal_the_reference(scale, seed, undirected):
    """The port builds R-MAT's ids in place and dedups a pattern by sorting
    its keys; the graph and a pattern's dedup (duplicates, int32 input)
    must still be the reference's arrays exactly."""
    from repro.core.formats import COO as RefCOO
    from repro.sparse.generate import rmat as ref_rmat
    from repro_torch.sparse.generate import rmat
    want = ref_rmat(scale, 8, seed=seed, undirected=undirected)
    got = rmat(scale, 8, seed=seed, undirected=undirected)
    assert got.vals is None and want.vals is None
    for a, b in ((want.rows, got.rows), (want.cols, got.cols)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    n = (1 << scale) + 3
    rows = rng.integers(0, n, 8 * n)
    cols = rng.integers(0, n // 5, 8 * n)
    for r, c in ((rows, cols), (rows.astype(np.int32), cols.astype(np.int32))):
        rd = RefCOO(n, n, r, c, None).dedup()
        pd = coo_from_arrays(n, n, r, c, None).dedup()
        assert pd.vals is None and pd.nnz < r.size
        for a, b in ((rd.rows, pd.rows), (rd.cols, pd.cols)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T,C", [(32, 8), (256, 64), (4096, 1024)])
def test_chunking_and_dedup_equal_the_reference(T, C):
    """The port orders entries with one stable argsort of a combined key
    where the reference lexsorts; ``dedup`` and ``to_chunked`` must still
    give the reference's arrays exactly, duplicates and int32 input
    included."""
    from repro.core.formats import COO as RefCOO
    from repro.core.formats import to_chunked as ref_chunked
    rng = np.random.default_rng(T)
    n = 3 * T + 5
    rows = rng.integers(0, n, 20 * n)
    cols = rng.integers(0, n, 20 * n)
    vals = rng.standard_normal(20 * n).astype(np.float32)
    for r, c in ((rows, cols), (rows.astype(np.int32), cols.astype(np.int32))):
        ref = RefCOO(n, n, r, c, vals)
        port = coo_from_arrays(n, n, r, c, vals)
        rd, pd = ref.dedup(), port.dedup()
        for a, b in ((rd.rows, pd.rows), (rd.cols, pd.cols),
                     (rd.vals, pd.vals)):
            np.testing.assert_array_equal(a, b)
        for src_ref, src_port in ((ref, port), (rd, pd)):
            want, got = ref_chunked(src_ref, T=T, C=C), to_chunked(src_port,
                                                                  T=T, C=C)
            for f in ("meta", "row_local", "col_local", "vals"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), f)
