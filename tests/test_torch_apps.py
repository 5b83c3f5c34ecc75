"""PageRank in the port (``device="cpu"``) against the JAX package's, over
IM and SEM operators, and against the dense float64 oracle.

Tolerances: the operator's values are 1/out-degree, not integers, so the
port's and the reference's float32 sums differ in order; over 30
iterations of a contraction (damping 0.85) that stays within a few float32
ulps of scores near 1/n, hence ``rtol = 1e-5``, ``atol = 1e-8``.  Against
the float64 oracle the bound is the reference's own test's
(``atol = 1e-6``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps.common import IMOperator as RefIM
from repro.apps.common import SEMOperator as RefSEM
from repro.apps.pagerank import pagerank as ref_pagerank
from repro.core.sem import SEMConfig as RefConfig
from repro.sparse.generate import rmat
from repro_torch.apps.common import IMOperator, SEMOperator
from repro_torch.apps.pagerank import (build_operator, dangling_vertices,
                                       pagerank, pagerank_dense_reference)
from repro_torch.convert import coo_from_arrays
from repro_torch.core.sem import SEMConfig

RTOL, ATOL = 1e-5, 1e-8


@pytest.fixture(scope="module")
def graph():
    g = rmat(10, 8, seed=2)   # 1024 vertices, the reference test's graph
    return coo_from_arrays(g.n_rows, g.n_cols, g.rows, g.cols)


@pytest.fixture(scope="module")
def ref_graph():
    return rmat(10, 8, seed=2)


def test_pagerank_im_matches_reference_and_dense(graph, ref_graph):
    from repro.apps.pagerank import build_operator as ref_build
    op = IMOperator.from_coo(build_operator(graph), T=512, C=256,
                             device="cpu")
    # tol=0 runs all 30 iterations on both sides: where the residual
    # crosses a tolerance is decided by last-ulp noise
    res = pagerank(op, dangling_vertices(graph), max_iter=30, tol=0.0,
                   device="cpu")
    ref = ref_pagerank(RefIM.from_coo(ref_build(ref_graph), T=512, C=256),
                       dangling_vertices(graph), max_iter=30, tol=0.0)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.scores, pagerank_dense_reference(
        graph, max_iter=30), atol=1e-6)
    assert res.iterations == ref.iterations == 30
    # early residuals are far above float32 noise and must agree closely
    np.testing.assert_allclose(res.residuals[:8], ref.residuals[:8],
                               rtol=1e-3)
    assert abs(res.scores.sum() - 1.0) < 1e-4


def test_pagerank_sem_matches_reference_and_im(graph, ref_graph, tmp_path):
    from repro.apps.pagerank import build_operator as ref_build
    sem = SEMOperator.from_coo(build_operator(graph), str(tmp_path / "pr"),
                               T=512, C=256,
                               config=SEMConfig(chunk_batch=16), device="cpu")
    ref_sem = RefSEM.from_coo(ref_build(ref_graph), str(tmp_path / "rpr"),
                              T=512, C=256,
                              config=RefConfig(chunk_batch=16,
                                               use_pallas=True,
                                               pallas_variant="gather"))
    r = pagerank(sem, dangling_vertices(graph), max_iter=10, tol=0.0,
                 device="cpu")
    rr = ref_pagerank(ref_sem, dangling_vertices(graph), max_iter=10,
                      tol=0.0)
    np.testing.assert_allclose(r.scores, rr.scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r.scores, pagerank_dense_reference(
        graph, max_iter=10), atol=1e-6)
    assert sem.io_bytes_read == ref_sem.io_bytes_read == 10 * \
        sem.sem.store.nbytes
    im = IMOperator.from_coo(build_operator(graph), T=512, C=256,
                             device="cpu")
    r_im = pagerank(im, dangling_vertices(graph), max_iter=10, tol=0.0,
                    device="cpu")
    np.testing.assert_allclose(r.scores, r_im.scores, rtol=RTOL, atol=ATOL)


def test_operators_dot_vectors_and_blocks(graph):
    """``dot`` takes a vector or a block of columns, as the reference's."""
    op = build_operator(graph)
    im = IMOperator.from_coo(op, T=512, C=256, device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (graph.n_cols, 3)).astype(np.float32)
    dense = op.to_dense(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(im.dot(x), dense, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(im.dot(x[:, 1]), dense[:, 1], rtol=1e-5,
                               atol=1e-6)
