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
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``), and
:func:`params_to_jax` gives that tree back.  :func:`named_to_tree` and
:func:`load_tree` do the same for any tensors keyed by the model's
parameter names (the optimizer's moments), which is how a checkpoint
carries the training state in the reference's layout.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import COO, ChunkedTiles
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model_api import build_model, pdefs
from repro_torch.models.params import leaves, split_name


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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16, which numpy lacks, as its
    raw 2-byte words of dtype ``V2`` (what ``np.savez`` writes for the
    reference's bfloat16 arrays and ``np.load`` gives back)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`to_numpy`: a ``V2`` array as bfloat16."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def named_to_tree(cfg: ArchConfig, named: Dict[str, torch.Tensor]) -> dict:
    """Tensors keyed by the model's parameter names (``layers.3.attn.wq``;
    the parameters, or moments like them) as the reference's parameter
    tree of numpy arrays in its stacked shapes (``['layers']['attn']['wq']``
    (nl, D, H, hd)); bfloat16 as :func:`to_numpy` gives it.  Raises on a
    missing or extra key, a stack with a layer missing, or a shape that
    differs from the reference's definition."""
    want = dict(leaves(pdefs(cfg)))
    groups: Dict[tuple, list] = {}
    for name, t in named.items():
        path, idx = split_name(name)
        groups.setdefault(path, []).append((idx, t))
    if set(groups) != set(want):
        missing = sorted(".".join(k) for k in set(want) - set(groups))
        extra = sorted(".".join(k) for k in set(groups) - set(want))
        raise KeyError(f"parameter tree of {cfg.arch_id}: missing {missing},"
                       f" extra {extra}")
    out: dict = {}
    for path, d in want.items():
        items = sorted(groups[path], key=lambda it: it[0])
        lead = d.shape[:len(items[0][0])]
        if [i for i, _ in items] != list(itertools.product(
                *(range(n) for n in lead))):
            raise KeyError(f"{'.'.join(path)}: layers "
                           f"{[i for i, _ in items]}, expected a full "
                           f"stack of {lead}")
        arr = np.stack([to_numpy(t) for _, t in items]).reshape(
            lead + tuple(items[0][1].shape)) if lead else to_numpy(items[0][1])
        if arr.shape != tuple(d.shape):
            raise ValueError(f"{'.'.join(path)}: shape {arr.shape}, "
                             f"expected {d.shape}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def params_to_jax(cfg: ArchConfig, model: nn.Module) -> dict:
    """The reference's parameter tree of ``model``: nested dicts of numpy
    arrays in the reference's stacked shapes, the inverse of
    :func:`params_from_jax` (see :func:`named_to_tree`)."""
    return named_to_tree(cfg, dict(model.named_parameters()))


@torch.no_grad()
def load_tree(named: Dict[str, torch.Tensor], tree: dict) -> None:
    """Copy the reference's stacked tree ``tree`` (numpy arrays, or
    anything ``np.asarray`` takes) into the tensors ``named``, keyed by the
    model's parameter names, in place and in each tensor's dtype (``V2``
    arrays read as bfloat16, :func:`from_numpy`).  Raises on a key of
    either side without its counterpart or a shape that differs."""
    flat = {path: v for path, v in leaves(tree)}
    used = set()
    for name, t in named.items():
        path, idx = split_name(name)
        if path not in flat:
            raise KeyError(f"{name}: no {'.'.join(path)} in the tree")
        used.add(path)
        arr = np.asarray(flat[path])[idx]
        if arr.shape != tuple(t.shape):
            raise ValueError(f"{name}: shape {arr.shape} in the tree, "
                             f"expected {tuple(t.shape)}")
        t.copy_(from_numpy(arr))
    if used != set(flat):
        extra = sorted(".".join(k) for k in set(flat) - used)
        raise KeyError(f"keys of the tree without a tensor: {extra}")
