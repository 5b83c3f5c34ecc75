"""Carrying a matrix across from the JAX package.

This system has no weights: its state is the sparse matrix.  Two routes
carry it over without importing the JAX package:

* the on-disk format — a store written by the JAX package's
  ``TileStore.write`` or ``.optimize()`` opens in
  :meth:`repro_torch.io.storage.TileStore.open`, and a store this package
  writes from the same ChunkedTiles is byte-identical;
* the in-memory layouts — :func:`chunked_from_arrays` and
  :func:`coo_from_arrays` rebuild this package's ``ChunkedTiles`` / ``COO``
  from the reference's fields handed over as numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.formats import COO, ChunkedTiles


def chunked_from_arrays(n_rows: int, n_cols: int, T: int, C: int,
                        meta: np.ndarray, row_local: np.ndarray,
                        col_local: np.ndarray,
                        vals: np.ndarray) -> ChunkedTiles:
    """A ChunkedTiles from its fields (``meta`` int32 (n_chunks, 4), planes
    (n_chunks, C)); raises on shapes that do not fit together."""
    meta = np.ascontiguousarray(meta, np.int32)
    planes = [np.ascontiguousarray(a) for a in (row_local, col_local, vals)]
    if meta.ndim != 2 or meta.shape[1] != 4:
        raise ValueError("meta must be (n_chunks, 4)")
    for a in planes:
        if a.shape != (meta.shape[0], C):
            raise ValueError(f"plane of shape {a.shape}, expected "
                             f"({meta.shape[0]}, {C})")
    row_l, col_l, v = planes
    return ChunkedTiles(int(n_rows), int(n_cols), int(T), int(C), meta,
                        row_l.astype(np.int32), col_l.astype(np.int32), v)


def coo_from_arrays(n_rows: int, n_cols: int, rows: np.ndarray,
                    cols: np.ndarray,
                    vals: Optional[np.ndarray] = None) -> COO:
    """A COO from its fields (``vals is None`` for a binary matrix)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError("rows and cols must be 1-D of one length")
    if vals is not None and np.shape(vals) != rows.shape:
        raise ValueError("vals must match rows in length")
    return COO(int(n_rows), int(n_cols), rows, cols,
               None if vals is None else np.asarray(vals))
