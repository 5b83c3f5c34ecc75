"""The frozen yardstick against plain computations at small sizes on the
CPU: the R-MAT draw, the two references, the roofline arithmetic."""
import importlib.util

import numpy as np
import pytest
import torch

from graphbench import harness, roofline

RMAT = harness.load_module(harness.find("gen", "rmat"))
REF_PR = harness.load_module(harness.find("reference", "pagerank"))
REF_NMF = harness.load_module(harness.find("reference", "nmf"))


def plain_rmat(scale, edge_factor, a, b, c, seed):
    """The draw edge by edge, from the same stream of uniforms."""
    n, m = 1 << scale, edge_factor << scale
    gen = torch.Generator().manual_seed(seed)
    rows, cols = [0] * m, [0] * m
    d = 1.0 - a - b - c
    for _ in range(scale):
        ur = torch.rand(m, generator=gen).tolist()
        uc = torch.rand(m, generator=gen).tolist()
        for i in range(m):
            rbit = ur[i] < c + d
            cbit = uc[i] < (d / (c + d) if rbit else b / (a + b))
            rows[i] = 2 * rows[i] + rbit
            cols[i] = 2 * cols[i] + cbit
    edges = sorted(set(zip(rows, cols)))
    return np.array([e[0] for e in edges]), np.array([e[1] for e in edges]), n


def test_rmat_matches_plain_draw():
    rows, cols = RMAT.rmat(8, 4, a=0.57, b=0.19, c=0.19, seed=2**31 + 5,
                           device="cpu")
    want_r, want_c, _ = plain_rmat(8, 4, 0.57, 0.19, 0.19, 2**31 + 5)
    assert np.array_equal(rows.numpy(), want_r)
    assert np.array_equal(cols.numpy(), want_c)


def test_rmat_skew_and_seed():
    r1, c1 = RMAT.rmat(10, 16, a=0.57, b=0.19, c=0.19, seed=3, device="cpu")
    r2, _ = RMAT.rmat(10, 16, a=0.57, b=0.19, c=0.19, seed=3, device="cpu")
    r3, _ = RMAT.rmat(10, 16, a=0.57, b=0.19, c=0.19, seed=4, device="cpu")
    assert torch.equal(r1, r2) and not torch.equal(r1, r3)
    key = r1 * 1024 + c1
    assert bool((key[1:] > key[:-1]).all())          # sorted, no duplicates
    # the top-left quadrant holds about a = 0.57 of the draws
    share = float(((r1 < 512) & (c1 < 512)).float().mean())
    assert 0.5 < share < 0.75


def small_graph(seed=11, scale=8):
    rows, cols = RMAT.rmat(scale, 8, a=0.57, b=0.19, c=0.19, seed=seed,
                           device="cpu")
    return 1 << scale, rows.numpy(), cols.numpy()


def test_pagerank_reference_matches_dense():
    n, rows, cols = small_graph()
    cfg = {"params": {"damping": 0.85, "iterations": 10}}
    got = REF_PR.solve(cfg, n, rows, cols, 0, "cpu")
    a = np.zeros((n, n))
    a[rows, cols] = 1.0
    deg = a.sum(1)
    p = np.where(deg[None, :] > 0, a.T / np.maximum(deg, 1)[None, :], 0.0)
    x = np.full(n, 1.0 / n)
    for _ in range(10):
        x = 0.85 * (p @ x + x[deg == 0].sum() / n) + 0.15 / n
    np.testing.assert_allclose(got, x, rtol=1e-12)
    assert REF_PR.compare(got.astype(np.float32), x)["score_rel_err"] < 1e-6


def test_nmf_reference_matches_dense():
    n, rows, cols = small_graph()
    cfg = {"params": {"k": 4, "iterations": 5}}
    W, H = REF_NMF.solve(cfg, n, rows, cols, 9, "cpu")
    a = np.zeros((n, n))
    a[rows, cols] = 1.0
    rng = np.random.default_rng(9)
    w = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32).astype(np.float64)
    h = rng.uniform(0.1, 1.0, (4, n)).astype(np.float32).astype(np.float64)
    for _ in range(5):
        h = h * (w.T @ a) / (w.T @ w @ h + 1e-9)
        w = w * (a @ h.T) / (w @ (h @ h.T) + 1e-9)
    np.testing.assert_allclose(W, w, rtol=1e-10, atol=0)
    np.testing.assert_allclose(H, h, rtol=1e-10, atol=0)


@pytest.mark.parametrize("app", ["pagerank", "nmf"])
def test_control_fails_the_limit(app):
    """The control (the reference in bfloat16) reads over the limit, and
    the run's own decision takes it for not correct."""
    ref = REF_PR if app == "pagerank" else REF_NMF
    cfg = next(harness.load_json(p) for p in
               (harness.BENCH / "configs").glob("*.json")
               if harness.load_json(p)["app"] == app)
    n, rows, cols = small_graph(seed=5, scale=9)
    want = ref.solve(cfg, n, rows, cols, 5, "cpu")
    low = ref.solve(cfg, n, rows, cols, 5, "cpu", precision="bfloat16")
    numbers = ref.compare(low, want)
    (name, value), = numbers.items()
    assert value > cfg["limits"][name]
    correct, failed, _ = harness.decide([numbers], {}, cfg["limits"])
    assert not correct and failed == 1


LIMITS = {"err": 1e-3, "gap": 0}


@pytest.mark.parametrize("outputs, guarantees, want", [
    ([{"err": 1e-4}, {"err": 1e-3}], {"gap": 0}, (True, 0)),
    ([{"err": 1e-4}, {"err": 2e-3}], {"gap": 0}, (False, 1)),
    ([{"err": 1e-4}], {"gap": 1}, (False, 0)),
    ([{"err": float("nan")}], {}, (False, 1)),
    ([], {"gap": 0}, (False, 0)),
], ids=["sound", "one-output-over", "guarantee-broken", "nan", "no-output"])
def test_decide(outputs, guarantees, want):
    """``correct`` needs every output and every guarantee within its
    limit, and at least one output; ``failed`` counts the outputs."""
    correct, failed, numbers = harness.decide(outputs, guarantees, LIMITS)
    assert (correct, failed) == want
    assert set(numbers) == {k for d in outputs for k in d} | set(guarantees)


def test_roofline_repeats_chip_smoke_bound():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", harness.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for nbytes, flops in ((1_427_456_000, 130_491_198),
                          (4096, 10**12)):
        ms, _ = smoke.bound(nbytes, flops)
        assert roofline.bound_s(nbytes, flops) == pytest.approx(ms / 1e3,
                                                                rel=1e-12)
    work = roofline.store_work({"n_rows": 100, "n_cols": 80, "C": 8,
                                "n_chunks": 3, "record": 16 + 8 * 8}, 20)
    assert work.product(2) == (3 * 16 + 20 * 8 + 4 * 2 * 180, 2 * 20 * 2)
