"""SpMM-PageRank (paper §4.1, Fig 14).

PageRank as SpMV on the column-stochastic operator ``P = A^T D^{-1}``:
``x' = d * (P x + dangling/N) + (1-d)/N``.  The SEM strategy keeps the input
vector in memory (required) while the sparse operator streams; the I/O
volume is counted by the storage layer.  The iterate lives on ``device``;
each iteration hands it to the operator, which streams the matrix through
the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.apps.common import Operator
from repro_torch.core.formats import COO
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sparse.graph import out_degrees, pagerank_operator


@dataclasses.dataclass
class PageRankResult:
    scores: np.ndarray
    iterations: int
    residuals: list


def build_operator(adj: COO) -> COO:
    return pagerank_operator(adj)


def pagerank(op: Operator, dangling_mask: np.ndarray, *, damping: float = 0.85,
             max_iter: int = 30, tol: float = 1e-8,
             device: DeviceLike = None) -> PageRankResult:
    """``op`` is the PageRank operator P (built by :func:`build_operator`,
    wrapped in an IM or SEM Operator); ``dangling_mask`` flags out-degree-0
    vertices.  The float32 iterate and its update run on ``device``."""
    device = resolve_device(device)
    n = op.n_rows
    mask = torch.as_tensor(np.asarray(dangling_mask, bool), device=device)
    x = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    residuals = []
    for it in range(max_iter):
        dangling = float(x[mask].sum()) / n
        px = torch.from_numpy(op.dot(x.cpu().numpy())).to(device)
        x_new = damping * (px + dangling) + (1.0 - damping) / n
        resid = float((x_new - x).abs().sum())
        residuals.append(resid)
        x = x_new
        if resid < tol:
            break
    return PageRankResult(x.cpu().numpy(), it + 1, residuals)


def dangling_vertices(adj: COO) -> np.ndarray:
    return out_degrees(adj) == 0


def pagerank_session(adj: COO, *, damping: float = 0.85, max_iter: int = 30,
                     tol: float = 1e-8, tenant_id: str = ""):
    """Adapter for the serving runtime: a PageRank tenant for ``adj``.

    Submit it to a :class:`repro_torch.runtime.scheduler.SharedScanScheduler`
    whose store holds :func:`build_operator`'s ``P``; the session applies
    :func:`pagerank`'s update step for step (on the host, in numpy), so
    shared-scan serving returns the scores of a dedicated run.
    """
    from repro_torch.runtime.session import PageRankSession
    return PageRankSession(adj.n_rows, dangling_vertices(adj),
                           damping=damping, tol=tol, max_iter=max_iter,
                           tenant_id=tenant_id)


def pagerank_dense_reference(adj: COO, damping: float = 0.85,
                             max_iter: int = 30) -> np.ndarray:
    """Dense-matrix oracle for tests."""
    n = adj.n_rows
    a = adj.to_dense(np.float64) > 0
    deg = a.sum(1)
    p = np.where(deg[None, :] > 0, a.T / np.maximum(deg[None, :], 1), 0.0)
    x = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        dangling = x[deg == 0].sum() / n
        x = damping * (p @ x + dangling) + (1.0 - damping) / n
    return x
