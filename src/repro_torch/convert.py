"""Carrying state across from the JAX package, without importing it.

The sparse system's state is its matrix.  Two routes carry it over:

* the on-disk format — a store written by the JAX package's
  ``TileStore.write`` or ``.optimize()`` opens in
  :meth:`repro_torch.io.storage.TileStore.open`, and a store this package
  writes from the same ChunkedTiles is byte-identical;
* the in-memory layouts — :func:`chunked_from_arrays` and
  :func:`coo_from_arrays` rebuild this package's ``ChunkedTiles`` / ``COO``
  from the reference's fields handed over as numpy arrays.

The model substrate's state is its weights: :func:`params_from_jax` builds
the port's model from the reference's parameter tree handed over as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import COO, ChunkedTiles
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model_api import build_model


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


def params_from_jax(cfg: ArchConfig, tree: dict,
                    device: DeviceLike = None) -> nn.Module:
    """The port's model for ``cfg`` holding the values of the reference's
    parameter tree (nested dicts of numpy arrays with the reference's
    stacked shapes), on ``device``.  The layer stacks (``layers``,
    ``mamba_super`` (n_super, per, ...), ``mamba_tail``, encdec's
    ``encoder`` and ``decoder``) are unstacked into the model's
    ModuleLists; a MoE layer's expert stacks (nl, E, ...) by layer only.
    Raises on a missing or extra key, or on a shape that differs from the
    reference's definition."""
    device = resolve_device(device)

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(device)
    return build_model(cfg, to_torch(tree))
