"""R-MAT edge draw (frozen copy of the draw in ``repro_torch/sparse/generate.py``,
redone in seeded torch so that it runs on the card in a few large calls).

Each of ``edge_factor * 2**scale`` edges picks one quadrant per bit level:
the row bit is 1 with probability ``c + d``; the column bit is 1 with
probability ``b / (a + b)`` under a row bit of 0 and ``d / (c + d)`` under
a row bit of 1.  Duplicate (row, col) pairs are dropped; the result is
sorted by row, then column.  The same seed on the same kind of device
gives the same edges.
"""
from __future__ import annotations

import torch


def rmat(scale: int, edge_factor: int, *, a: float, b: float, c: float,
         seed: int, device) -> tuple:
    """Returns ``(rows, cols)``: int64 tensors on ``device``, deduplicated
    and sorted."""
    n = 1 << scale
    m = edge_factor * n
    d = 1.0 - a - b - c
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    p_row1, p_col1 = c + d, (b / (a + b), d / (c + d))
    rows = torch.zeros(m, dtype=torch.int64, device=device)
    cols = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        rbit = torch.rand(m, generator=gen, device=device) < p_row1
        u = torch.rand(m, generator=gen, device=device)
        cbit = torch.where(rbit, u < p_col1[1], u < p_col1[0])
        rows.mul_(2).add_(rbit)
        cols.mul_(2).add_(cbit)
    del rbit, u, cbit
    key = torch.unique(rows.mul_(n).add_(cols))   # sorted, deduplicated
    return key // n, key % n
