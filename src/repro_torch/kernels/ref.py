"""Oracles for the SpMM kernels.

Operate on the same ChunkedTiles arrays the kernels consume — a direct
transcription of the math: for each chunk ``g`` in tile
``(meta[g,0], meta[g,1])``, scatter ``vals[g] * X[tile_col*T + col_local[g]]``
into output rows ``tile_row*T + row_local[g]``.
"""
from __future__ import annotations

import numpy as np
import torch


def spmm_ref(meta: np.ndarray, row_local: np.ndarray, col_local: np.ndarray,
             vals: np.ndarray, x_pad: np.ndarray, T: int) -> np.ndarray:
    """Oracle: flat float64 scatter-add over all chunk entries.

    x_pad: (n_tile_cols * T, p); returns (n_tile_rows * T, p) where
    n_tile_rows = meta[:, 0].max() + 1.
    """
    meta = np.asarray(meta)
    n_tile_rows = int(meta[:, 0].max()) + 1
    rows_g = (meta[:, 0:1] * T + np.asarray(row_local)).reshape(-1)
    cols_g = (meta[:, 1:2] * T + np.asarray(col_local)).reshape(-1)
    v = np.asarray(vals).reshape(-1)
    x = np.asarray(x_pad, np.float64)
    out = np.zeros((n_tile_rows * T, x.shape[1]), np.float64)
    np.add.at(out, rows_g, v[:, None].astype(np.float64) * x[cols_g])
    return out


def spmm_ref_torch(meta: torch.Tensor, row_local: torch.Tensor,
                   col_local: torch.Tensor, vals: torch.Tensor,
                   x_pad: torch.Tensor, T: int,
                   n_tile_rows: int) -> torch.Tensor:
    """Torch variant (in the inputs' dtype and on their device) of
    :func:`spmm_ref`, for comparisons on the card."""
    meta = meta.to(torch.int64)
    rows_g = (meta[:, 0:1] * T + row_local.to(torch.int64)).reshape(-1)
    cols_g = (meta[:, 1:2] * T + col_local.to(torch.int64)).reshape(-1)
    v = vals.reshape(-1).to(x_pad.dtype)
    out = torch.zeros((n_tile_rows * T, x_pad.shape[1]), dtype=x_pad.dtype,
                      device=x_pad.device)
    return out.index_add_(0, rows_g, v[:, None] * x_pad[cols_g])
