"""Plain PageRank: the reference that decides a PageRank cell's ``correct``.

It starts from the benchmark's own edge list (``rows[i] -> cols[i]``) and
works out again everything the port derives: the out-degrees, the
dangling set and P = A^T D^-1, whose entry (u, v) is ``1 / outdeg(v)`` for
an edge v -> u.  The update is LDBC Graphalytics' PageRank with the
dangling mass spread uniformly: ``x' = d (P x + sum(x[dangling]) / n) +
(1 - d) / n`` from ``x = 1 / n``, a fixed number of times.  Plain torch
(``index_add_``) in float64.

``precision="bfloat16"`` is the control: the same steps with the iterate
and P's values held in bfloat16 and the sums in float32, as a kernel in
the precision below the configuration's float32 would compute them.
"""
from __future__ import annotations

import numpy as np
import torch

# Edges at a time in the sparse product (bounds the temporaries).
BLOCK = 1 << 24


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def solve(cfg: dict, n: int, rows: np.ndarray, cols: np.ndarray, seed: int,
          device, precision: str = "float64") -> np.ndarray:
    d = float(cfg["params"]["damping"])
    iters = int(cfg["params"]["iterations"])
    low = precision == "bfloat16"
    dt = torch.float32 if low else torch.float64
    src = torch.from_numpy(rows).to(device)
    dst = torch.from_numpy(cols).to(device)
    deg = torch.bincount(src, minlength=n)
    dangling = deg == 0
    w = 1.0 / deg.to(torch.float64)[src]
    w = _bf16(w) if low else w
    x = torch.full((n,), 1.0 / n, dtype=dt, device=device)
    for _ in range(iters):
        if low:
            x = _bf16(x)
        y = torch.zeros(n, dtype=dt, device=device)
        for lo in range(0, src.shape[0], BLOCK):
            s, t = src[lo:lo + BLOCK], dst[lo:lo + BLOCK]
            y.index_add_(0, t, x[s] * w[lo:lo + BLOCK])
        x = d * (y + x[dangling].sum() / n) + (1.0 - d) / n
    if low:
        x = _bf16(x)
    return x.to(torch.float64).cpu().numpy()


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """The widest relative gap of a score: every score is at least
    ``(1 - d) / n``, so none divides by zero."""
    got = np.asarray(got, np.float64)
    if got.shape != want.shape:
        return {"score_rel_err": float("inf")}
    return {"score_rel_err": float(np.max(np.abs(got - want) / want))}
