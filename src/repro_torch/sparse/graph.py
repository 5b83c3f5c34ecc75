"""Graph-matrix utilities: degrees, PageRank operator, normalization."""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import COO


def out_degrees(adj: COO) -> np.ndarray:
    """Out-degree per vertex (row sums of the adjacency matrix)."""
    return np.bincount(adj.rows, minlength=adj.n_rows).astype(np.int64)


def in_degrees(adj: COO) -> np.ndarray:
    return np.bincount(adj.cols, minlength=adj.n_cols).astype(np.int64)


def degree_order(cols: np.ndarray, n_cols: int) -> np.ndarray:
    """Degree-descending relabel order for the operand (column) dimension:
    ``order[k]`` is the old id of new column ``k``, so the relabeled
    operand is ``x[order]`` and hub columns cluster at small indices.
    Ties break by original id (stable), so the order is deterministic.
    ``TileStore.optimize`` uses this to densify tiles and shrink the
    delta-coded column deltas into uint8 range."""
    deg = np.bincount(np.asarray(cols, np.int64), minlength=n_cols)
    return np.argsort(-deg, kind="stable").astype(np.int64)


def pagerank_operator(adj: COO) -> COO:
    """Column-stochastic PageRank operator P = A^T D^{-1}: entry (u, v) =
    1/out_deg(v) for each edge v -> u, so PR update is ``x' = d P x + (1-d)/N``.
    Dangling vertices (out-degree 0) contribute nothing (handled by the
    application via the dangling correction)."""
    deg = out_degrees(adj)
    vals = 1.0 / deg[adj.rows].astype(np.float64)
    return COO(adj.n_cols, adj.n_rows, adj.cols.copy(), adj.rows.copy(),
               vals.astype(np.float32))


def symmetric_normalized(adj: COO) -> COO:
    """D^{-1/2} A D^{-1/2} on the symmetrized adjacency (spectral analysis)."""
    und = COO(adj.n_rows, adj.n_cols,
              np.concatenate([adj.rows, adj.cols]),
              np.concatenate([adj.cols, adj.rows]), None).dedup()
    deg = np.maximum(np.bincount(und.rows, minlength=und.n_rows), 1)
    d = 1.0 / np.sqrt(deg.astype(np.float64))
    vals = (d[und.rows] * d[und.cols]).astype(np.float32)
    return und.with_values(vals)
