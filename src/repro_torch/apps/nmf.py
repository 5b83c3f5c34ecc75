"""SEM non-negative matrix factorization (paper §4.3, Fig 16).

Lee–Seung multiplicative updates for ``A ~ W H`` with sparse A (n x n),
W (n x k), H (k x n):

    H <- H * (W^T A) / (W^T W H),   W <- W * (A H^T) / (W H H^T)

The sparse products are SpMM: ``A H^T = A @ H.T`` and
``W^T A = (A^T @ W)^T`` — so the executor needs both A and A^T stores (the
paper converts directed graphs once per direction).  W and H are float32
tensors on the operators' device; the sparse products go through the
operators (one streaming pass each for SEM), the k x k and n x k products
are plain ``torch.matmul``.  The starting factors come from numpy's
generator, so a run starts where the JAX package's does from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.apps.common import Operator

_EPS = 1e-9


@dataclasses.dataclass
class NMFResult:
    W: torch.Tensor
    H: torch.Tensor
    losses: list
    iterations: int


def _frobenius_loss(op_a: Operator, W: torch.Tensor, H: torch.Tensor,
                    a_sq_sum: float) -> float:
    """||A - WH||_F^2 = ||A||^2 - 2<A H^T, W> + <W^T W, H H^T>, computed
    without densifying A."""
    AHt = op_a.dot(H.T)                       # (n, k)
    cross = float(torch.sum(AHt * W))
    quad = float(torch.sum((W.T @ W) * (H @ H.T)))
    return a_sq_sum - 2.0 * cross + quad


def nmf(op_a: Operator, op_at: Operator, k: int, *, n_iter: int = 20,
        seed: int = 0, a_sq_sum: Optional[float] = None,
        track_loss: bool = True) -> NMFResult:
    """``op_a`` applies A, ``op_at`` applies A^T (IM or SEM backed, on one
    device)."""
    n, m = op_a.n_rows, op_a.n_cols
    dev = op_a.device
    rng = np.random.default_rng(seed)
    W = torch.from_numpy(
        rng.uniform(0.1, 1.0, (n, k)).astype(np.float32)).to(dev)
    H = torch.from_numpy(
        rng.uniform(0.1, 1.0, (k, m)).astype(np.float32)).to(dev)
    losses = []
    for _ in range(n_iter):
        # H update: H *= (W^T A) / (W^T W H)
        WtA = op_at.dot(W).T                  # (k, m)
        H = H * WtA / (W.T @ W @ H + _EPS)
        # W update: W *= (A H^T) / (W H H^T)
        AHt = op_a.dot(H.T)                   # (n, k)
        W = W * AHt / (W @ (H @ H.T) + _EPS)
        if track_loss and a_sq_sum is not None:
            losses.append(_frobenius_loss(op_a, W, H, a_sq_sum))
    return NMFResult(W, H, losses, n_iter)


def factor_quality(op_a: Operator, W: torch.Tensor, H: torch.Tensor,
                   a_sq_sum: float) -> float:
    """Relative reconstruction error ||A - WH||_F / ||A||_F."""
    loss = max(_frobenius_loss(op_a, W, H, a_sq_sum), 0.0)
    return float(np.sqrt(loss / a_sq_sum))
