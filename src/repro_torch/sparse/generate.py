"""Seeded graph generators (numpy, vectorized): R-MAT, SBM, Erdős–Rényi.

These reproduce the paper's synthetic inputs:
* R-MAT with (a, b, c, d) = (0.57, 0.19, 0.19, 0.05) — the paper's RMAT-40 /
  RMAT-160 parameters (footnote 1), at a caller-chosen scale.
* Stochastic block model (Fig 6): configurable cluster count, IN/OUT edge
  ratio, clustered vs. shuffled vertex order.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import COO


def rmat(scale: int, edge_factor: int, *, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, undirected: bool = False) -> COO:
    """R-MAT graph with 2**scale vertices and edge_factor * 2**scale edges."""
    n = 1 << scale
    n_edges = edge_factor * n
    rng = np.random.default_rng(seed)
    # ids are built in place in the narrowest type that holds them
    idx = np.int32 if scale < 31 else np.int64
    rows = np.zeros(n_edges, dtype=idx)
    cols = np.zeros(n_edges, dtype=idx)
    u = np.empty(n_edges)
    rbit, cbit, low = (np.empty(n_edges, dtype=bool) for _ in range(3))
    # Per-bit quadrant draw, vectorized over all edges at once.
    p_row1 = (c + (1.0 - a - b - c))  # P(row bit = 1) = c + d
    # P(col bit = 1 | row bit) : row0 -> b/(a+b), row1 -> d/(c+d)
    p_col1 = (b / (a + b), (1.0 - a - b - c) / (c + (1.0 - a - b - c)))
    for _ in range(scale):
        rng.random(out=u)
        np.less(u, p_row1, out=rbit)
        rng.random(out=u)
        # cbit = u < p_col1[rbit], as two comparisons against scalars
        np.less(u, p_col1[1], out=cbit)
        np.logical_and(cbit, rbit, out=cbit)
        np.less(u, p_col1[0], out=low)
        np.logical_and(low, ~rbit, out=low)
        np.logical_or(cbit, low, out=cbit)
        np.left_shift(rows, 1, out=rows)
        np.bitwise_or(rows, rbit, out=rows)
        np.left_shift(cols, 1, out=cols)
        np.bitwise_or(cols, cbit, out=cols)
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    if undirected:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    return COO(n, n, rows, cols, None).dedup()


def sbm(n: int, n_edges: int, n_clusters: int, in_out_ratio: float, *,
        clustered_order: bool = True, seed: int = 0) -> COO:
    """Stochastic block model (Fig 6): ``in_out_ratio`` = edges inside
    clusters / edges across clusters.  ``clustered_order=False`` randomly
    permutes vertex ids (the paper's "unclustered" ordering)."""
    rng = np.random.default_rng(seed)
    frac_in = in_out_ratio / (1.0 + in_out_ratio)
    n_in = int(n_edges * frac_in)
    n_out = n_edges - n_in
    cluster_size = n // n_clusters

    # In-cluster edges: pick a cluster, then two members.
    cl = rng.integers(0, n_clusters, n_in)
    r_in = cl * cluster_size + rng.integers(0, cluster_size, n_in)
    c_in = cl * cluster_size + rng.integers(0, cluster_size, n_in)
    # Cross-cluster edges: uniform.
    r_out = rng.integers(0, n, n_out)
    c_out = rng.integers(0, n, n_out)

    rows = np.concatenate([r_in, r_out])
    cols = np.concatenate([c_in, c_out])
    if not clustered_order:
        perm = rng.permutation(n)
        rows, cols = perm[rows], perm[cols]
    return COO(n, n, rows, cols, None).dedup()


def erdos_renyi(n: int, n_edges: int, *, seed: int = 0) -> COO:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n_edges)
    cols = rng.integers(0, n, n_edges)
    return COO(n, n, rows, cols, None).dedup()
