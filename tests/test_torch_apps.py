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


# -- the eigensolver and NMF (paper §4.2, §4.3) -----------------------------
# Both run the reference's algorithm step for step from the same numpy-made
# start; the operators' float32 sums differ from the reference's in order
# only, so the results agree to float32 noise carried through a few
# iterations: eigenvalues to 1e-6, NMF factors to the reference's own SEM
# vs IM tolerance (rtol = 1e-4, atol = 1e-5).
EIG_ATOL = 1e-6


def _sym_ops(graph, ref_graph, kind, tmp_path):
    from repro.sparse.graph import symmetric_normalized as ref_sym
    from repro_torch.sparse.graph import symmetric_normalized
    sym, rsym = symmetric_normalized(graph), ref_sym(ref_graph)
    if kind == "im":
        return (IMOperator.from_coo(sym, T=512, C=256, device="cpu"),
                RefIM.from_coo(rsym, T=512, C=256), sym)
    return (SEMOperator.from_coo(sym, str(tmp_path / "s"), T=512, C=256,
                                 config=SEMConfig(chunk_batch=16),
                                 device="cpu"),
            RefSEM.from_coo(rsym, str(tmp_path / "rs"), T=512, C=256,
                            config=RefConfig(chunk_batch=16)), sym)


@pytest.mark.parametrize("kind", ["im", "sem"])
@pytest.mark.parametrize("on_disk", [False, True], ids=["max", "min"])
def test_lanczos_matches_reference(graph, ref_graph, kind, on_disk,
                                   tmp_path):
    """Thick-restart Lanczos over IM and SEM operators, with the Krylov
    basis on the device (SEM-max) or in a DenseStore (SEM-min), against the
    reference's solver and the dense float64 spectrum."""
    from repro.apps.eigensolver import lanczos_eigsh as ref_lanczos
    from repro_torch.apps.eigensolver import lanczos_eigsh
    op, ref_op, sym = _sym_ops(graph, ref_graph, kind, tmp_path)
    res = lanczos_eigsh(op, k=4, tol=1e-8, sem_subspace=on_disk)
    ref = ref_lanczos(ref_op, k=4, tol=1e-8, sem_subspace=on_disk)
    # Both converge (not capped by max_restarts).  The spectrum holds +1 and
    # -1 several times over; which copies the Krylov space picks up, and so
    # the restart at which the residual drops below tol, depends on
    # rounding noise, so the counts are not compared.
    assert res.residual < 1e-8 and ref.residual < 1e-8
    assert res.restarts < 29 and ref.restarts < 29
    # sorted: the order of +1 and -1 by |λ| is a tie
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(ref.eigenvalues), atol=EIG_ATOL)
    dense = np.linalg.eigvalsh(sym.to_dense(np.float64))
    dense = dense[np.argsort(-np.abs(dense))][:4]
    np.testing.assert_allclose(np.sort(res.eigenvalues), np.sort(dense),
                               atol=EIG_ATOL)


def test_lanczos_subspace_on_disk_equals_in_memory(graph, ref_graph,
                                                   tmp_path):
    """SEM-min and SEM-max hold the same float32 basis, so on the host they
    give the same eigenvalues bit for bit; the vectors' residuals are
    small."""
    from repro_torch.apps.eigensolver import lanczos_eigsh
    op, _, sym = _sym_ops(graph, ref_graph, "im", tmp_path)
    mem = lanczos_eigsh(op, k=3, tol=1e-7, want_vectors=True)
    disk = lanczos_eigsh(op, k=3, tol=1e-7, sem_subspace=True)
    np.testing.assert_array_equal(mem.eigenvalues, disk.eigenvalues)
    dense = sym.to_dense(np.float64)
    for i in range(2):
        v = mem.eigenvectors[:, i].numpy().astype(np.float64)
        assert np.linalg.norm(dense @ v - mem.eigenvalues[i] * v) < 1e-3


@pytest.mark.parametrize("k", [4, 8])
def test_nmf_matches_reference(graph, ref_graph, k, tmp_path):
    """Lee–Seung NMF over IM (gather and densify kernels) and over SEM
    stores of A and Aᵀ against the reference's: factors, losses and
    quality."""
    from repro.apps.nmf import factor_quality as ref_quality
    from repro.apps.nmf import nmf as ref_nmf
    from repro_torch.apps.nmf import factor_quality, nmf
    a_sq = float(graph.nnz)       # binary matrix: ||A||_F^2 = nnz
    t, rt = graph.transpose(), ref_graph.transpose()
    ops = {
        "im": (IMOperator.from_coo(graph, T=512, C=256, device="cpu"),
               IMOperator.from_coo(t, T=512, C=256, device="cpu")),
        "im-mxu": (IMOperator.from_coo(graph, T=512, C=256, device="cpu",
                                       variant="mxu"),
                   IMOperator.from_coo(t, T=512, C=256, device="cpu",
                                       variant="mxu")),
        "sem": (SEMOperator.from_coo(graph, str(tmp_path / "a"), T=512,
                                     C=256, device="cpu"),
                SEMOperator.from_coo(t, str(tmp_path / "at"), T=512, C=256,
                                     device="cpu")),
    }
    ref_ops = (RefIM.from_coo(ref_graph, T=512, C=256),
               RefIM.from_coo(rt, T=512, C=256))
    want = ref_nmf(*ref_ops, k=k, n_iter=4, a_sq_sum=a_sq)
    for kind, (op_a, op_at) in ops.items():
        res = nmf(op_a, op_at, k=k, n_iter=4, a_sq_sum=a_sq)
        W, H = res.W.numpy(), res.H.numpy()
        np.testing.assert_allclose(W, want.W, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(H, want.H, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res.losses, want.losses, rtol=1e-5)
        assert np.all(np.diff(res.losses) <= 1e-3)       # Lee–Seung: monotone
        assert (W >= 0).all() and (H >= 0).all()
        q = factor_quality(op_a, res.W, res.H, a_sq)
        assert q == pytest.approx(ref_quality(ref_ops[0], want.W, want.H,
                                              a_sq), rel=1e-5)
        assert q < 1.0
