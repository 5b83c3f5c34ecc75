"""SEM eigensolver (paper §4.2, Fig 15).

The paper plugs SEM-SpMM into the Anasazi KrylovSchur solver and keeps the
Krylov vector subspace either on SSDs (SEM-min) or in memory (SEM-max).  The
same structure here: a thick-restart Lanczos solver whose subspace lives
behind a :class:`Subspace` — a float32 tensor on the operator's device
(max) or the :class:`~repro_torch.io.storage.DenseStore` slow tier (min).
The reorthogonalisation (CGS2) runs in float64 on the operator's device;
the small tridiagonal problem is solved on the host with numpy.  The start
vector comes from numpy's generator, so a run starts where the JAX
package's does from the same seed.  The operator must be symmetric (the
paper runs undirected graphs; use ``symmetric_normalized`` or A+A^T).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.apps.common import Operator
from repro_torch.io.storage import DenseStore


class Subspace:
    """Krylov basis storage: on the device, or on the slow tier (SEM-min)."""

    def __init__(self, n: int, m: int, on_disk: bool, device: torch.device,
                 path: Optional[str] = None):
        self.n, self.m = n, m
        self.on_disk = on_disk
        self.device = device
        if on_disk:
            if path is None:
                path = os.path.join(tempfile.mkdtemp(prefix="krylov_"), "V")
            self._store = DenseStore(path, n, m)
        else:
            self._mem = torch.zeros((n, m), dtype=torch.float32,
                                    device=device)

    def get(self, j: int) -> torch.Tensor:
        return self.block(j, j + 1)[:, 0]

    def set(self, j: int, v: torch.Tensor) -> None:
        v = v.to(torch.float32)
        if self.on_disk:
            self._store.write_cols(j, v[:, None].cpu().numpy())
        else:
            self._mem[:, j] = v

    def block(self, j0: int, j1: int) -> torch.Tensor:
        if self.on_disk:
            return torch.from_numpy(self._store.read_cols(j0, j1)).to(
                self.device)
        return self._mem[:, j0:j1]

    @property
    def io_stats(self):
        return self._store.stats if self.on_disk else None


@dataclasses.dataclass
class EigResult:
    eigenvalues: np.ndarray
    eigenvectors: Optional[torch.Tensor]
    iterations: int
    restarts: int
    residual: float


def lanczos_eigsh(op: Operator, k: int = 8, *,
                  subspace_dim: Optional[int] = None,
                  max_restarts: int = 30, tol: float = 1e-6,
                  sem_subspace: bool = False, seed: int = 0,
                  want_vectors: bool = False) -> EigResult:
    """Largest-|λ| eigenpairs of a symmetric operator via thick-restart
    Lanczos (the KrylovSchur family member for symmetric problems)."""
    n = op.n_rows
    dev = op.device
    m = subspace_dim or max(2 * k + 2, 10)
    rng = np.random.default_rng(seed)
    V = Subspace(n, m + 1, on_disk=sem_subspace, device=dev)

    v = rng.standard_normal(n).astype(np.float32)
    v /= np.linalg.norm(v)
    V.set(0, torch.from_numpy(v).to(dev))
    Tmat = np.zeros((m + 1, m + 1), np.float64)
    n_lock = 0          # leading locked/compressed Ritz directions
    it = 0

    for restart in range(max_restarts):
        j0 = n_lock if restart > 0 else 0
        for j in range(j0, m):
            w = op.dot(V.get(j)).to(torch.float64)
            it += 1
            # Full reorthogonalization (CGS2).  The summed projection
            # coefficients ARE column j of T (including, after a restart, the
            # couplings to the locked Ritz directions), so assign — the
            # pre-seeded arrowhead entries are their exact-arithmetic values.
            basis = V.block(0, j + 1).to(torch.float64)
            col = torch.zeros(j + 1, dtype=torch.float64, device=dev)
            for _ in range(2):
                coeffs = basis.T @ w
                w = w - basis @ coeffs
                col += coeffs
            col = col.cpu().numpy()
            Tmat[: j + 1, j] = col
            Tmat[j, : j + 1] = col
            beta = float(torch.linalg.norm(w))
            Tmat[j + 1, j] = Tmat[j, j + 1] = beta
            if beta < 1e-12:
                w = torch.from_numpy(rng.standard_normal(n)).to(dev)
                basis = V.block(0, j + 1).to(torch.float64)
                w = w - basis @ (basis.T @ w)
                beta = float(torch.linalg.norm(w))
            V.set(j + 1, w / beta)

        # Rayleigh-Ritz on the leading m x m block.
        evals, S = np.linalg.eigh(Tmat[:m, :m])
        order = np.argsort(-np.abs(evals))
        evals, S = evals[order], S[:, order]
        beta_m = Tmat[m, m - 1]
        resid = np.abs(beta_m * S[m - 1, :k]).max()
        if resid < tol or restart == max_restarts - 1:
            vecs = None
            if want_vectors:
                vecs = (V.block(0, m).to(torch.float64)
                        @ torch.from_numpy(S[:, :k]).to(dev)).to(
                            torch.float32)
            return EigResult(evals[:k].copy(), vecs, it, restart, float(resid))

        # Thick restart: keep 'keep' Ritz vectors + the residual direction.
        keep = min(k + 2, m - 1)
        basis = V.block(0, m).to(torch.float64)
        new_basis = basis @ torch.from_numpy(S[:, :keep]).to(dev)
        r = V.get(m).to(torch.float64)  # residual vector
        for i in range(keep):
            V.set(i, new_basis[:, i])
        V.set(keep, r)
        Tnew = np.zeros_like(Tmat)
        Tnew[:keep, :keep] = np.diag(evals[:keep])
        Tnew[keep, :keep] = beta_m * S[m - 1, :keep]
        Tnew[:keep, keep] = Tnew[keep, :keep]
        Tmat = Tnew
        n_lock = keep
    raise RuntimeError("unreachable")
