"""Seeded label propagation as a serving-runtime workload.

Label propagation is the natural *wide* tenant for the shared-scan runtime:
its dense matrix has one column per label, so a single community-detection
tenant already amortizes the sparse stream the way the paper's Fig 5 says
multi-column SpMM does (SEM ~ 100% of IM at p >= 4).

The operator is the symmetrically-normalized adjacency
``D^{-1/2} (A + A^T) D^{-1/2}``; each pass computes ``A_norm @ X``, rows are
renormalized to distributions, and seed rows are clamped back to their
one-hot labels (Zhou et al.-style propagation with hard seeds).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import COO
from repro_torch.sparse.graph import symmetric_normalized


def build_operator(adj: COO) -> COO:
    """The propagation operator (symmetric normalized adjacency)."""
    return symmetric_normalized(adj)


def labelprop_session(adj: COO, seeds: np.ndarray, seed_labels: np.ndarray,
                      n_labels: int, *, tol: float = 1e-4, max_iter: int = 50,
                      tenant_id: str = ""):
    """Adapter for the serving runtime: a label-propagation tenant.

    Submit to a scheduler whose store holds :func:`build_operator`'s matrix.
    """
    from repro_torch.runtime.session import LabelPropagationSession
    return LabelPropagationSession(seeds, seed_labels, adj.n_rows, n_labels,
                                   tol=tol, max_iter=max_iter,
                                   tenant_id=tenant_id)


def labelprop_dense_reference(adj: COO, seeds: np.ndarray,
                              seed_labels: np.ndarray, n_labels: int, *,
                              tol: float = 1e-4, max_iter: int = 50
                              ) -> np.ndarray:
    """Dense oracle mirroring :class:`LabelPropagationSession`'s update."""
    a = build_operator(adj).to_dense(np.float32)
    n = adj.n_rows
    x = np.zeros((n, n_labels), np.float32)
    x[seeds, seed_labels] = 1.0
    for _ in range(max_iter):
        y = a @ x
        row_sum = y.sum(axis=1, keepdims=True)
        x_new = np.where(row_sum > 0, y / np.maximum(row_sum, 1e-12), x)
        x_new[seeds] = 0.0
        x_new[seeds, seed_labels] = 1.0
        delta = float(np.abs(x_new - x).max())
        x = x_new.astype(np.float32)
        if delta < tol:
            break
    return x.argmax(axis=1)
