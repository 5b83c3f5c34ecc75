"""Plain NMF: the reference that decides an NMF cell's ``correct``.

Lee-Seung multiplicative updates for A ~ W H, with A the binary adjacency
of the benchmark's own edge list (``A[rows[i], cols[i]] = 1``):

    H <- H * (W^T A) / (W^T W H + eps),  W <- W * (A H^T) / (W H H^T + eps)

from the configuration's start: ``numpy.random.default_rng(seed)`` draws
``uniform(0.1, 1.0)`` of shape (n, k) for W, then of shape (k, n) for H,
each rounded to float32.  The sparse products are plain torch
(``index_add_`` over the edges, in blocks); everything is float64.

``precision="bfloat16"`` is the control: W, H, every product's inputs and
every result rounded to bfloat16, the sums in float32.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-9
# Entries below this share of their factor's largest are compared against
# it instead of themselves: the updates shrink some entries geometrically,
# and float32 flushes to zero what float64 still holds (1e-53 and less).
FLOOR = 1e-6
# Edges at a time in the sparse products (bounds the temporaries).
BLOCK = 1 << 22


def _spmm(src, dst, x: torch.Tensor, n_out: int) -> torch.Tensor:
    """``out[src[i]] += x[dst[i]]`` over every edge: ``A @ x`` when
    ``src`` are A's rows and ``dst`` its columns."""
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    for lo in range(0, src.shape[0], BLOCK):
        out.index_add_(0, src[lo:lo + BLOCK], x[dst[lo:lo + BLOCK]])
    return out


def solve(cfg: dict, n: int, rows: np.ndarray, cols: np.ndarray, seed: int,
          device, precision: str = "float64"):
    k = int(cfg["params"]["k"])
    iters = int(cfg["params"]["iterations"])
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0.1, 1.0, (n, k)).astype(np.float32)
    h0 = rng.uniform(0.1, 1.0, (k, n)).astype(np.float32)
    low = precision == "bfloat16"
    dt = torch.float32 if low else torch.float64

    def q(t):
        return t.to(torch.bfloat16).to(torch.float32) if low else t
    W = torch.from_numpy(w0).to(device, dt)
    H = torch.from_numpy(h0).to(device, dt)
    del w0, h0
    r = torch.from_numpy(rows).to(device)
    c = torch.from_numpy(cols).to(device)
    for _ in range(iters):
        W, H = q(W), q(H)
        WtA = q(_spmm(c, r, W, n)).T                    # (k, n) = (A^T W)^T
        H = q(H * WtA / (q(q(W.T @ W) @ H) + EPS))
        AHt = q(_spmm(r, c, H.T.contiguous(), n))       # (n, k)
        W = q(W * AHt / (q(W @ q(H @ H.T)) + EPS))
    return (W.to(torch.float64).cpu().numpy(),
            H.to(torch.float64).cpu().numpy())


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of an entry, relative to the larger of the entry and
    ``FLOOR`` times the factor's largest entry.  The updates multiply
    positive ratios, so the sums hold no cancellation and every entry
    keeps float32's relative precision down to the floor."""
    got = np.asarray(got, np.float64)
    scale = np.maximum(np.abs(want), FLOOR * np.abs(want).max(initial=0.0))
    diff = np.abs(got - want)
    if not np.isfinite(diff).all():
        return float("inf")
    return float(np.max(diff / np.where(scale > 0, scale, 1.0), initial=0.0))


def compare(got, want) -> dict:
    if any(np.shape(g) != w.shape for g, w in zip(got, want)):
        return {"factor_rel_err": float("inf")}
    return {"factor_rel_err": max(_rel(g, w) for g, w in zip(got, want))}
