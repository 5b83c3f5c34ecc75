"""Shared linear-operator abstraction for the applications.

Every app consumes ``A @ X`` through :class:`Operator`, which is backed by
either the in-memory chunked path (IM) or the semi-external executor (SEM) —
the paper's IM-SpMM / SEM-SpMM pair behind one interface.  Both run on the
card unless built with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import COO, ChunkedTiles, to_chunked
from repro_torch.core.sem import SEMConfig, SEMSpMM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.io.storage import TileStore
from repro_torch.kernels.ops import spmm_kernel


class Operator:
    """A (n_rows x n_cols) sparse operator with `.dot(X)` on host arrays."""

    def __init__(self, n_rows: int, n_cols: int):
        self.n_rows, self.n_cols = n_rows, n_cols

    def dot(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def io_bytes_read(self) -> int:
        return 0


class IMOperator(Operator):
    """In-memory chunked SpMM (IM-SpMM): the chunk planes stay resident on
    the device and every product is one launch of the one-shot kernel."""

    def __init__(self, ct: ChunkedTiles, device: DeviceLike = None):
        super().__init__(ct.n_rows, ct.n_cols)
        self.device = resolve_device(device)
        self.ct = dataclasses.replace(
            ct,
            meta=torch.as_tensor(ct.meta, device=self.device),
            row_local=torch.as_tensor(ct.row_local, device=self.device),
            col_local=torch.as_tensor(ct.col_local, device=self.device),
            vals=torch.as_tensor(ct.vals, device=self.device))

    @classmethod
    def from_coo(cls, coo: COO, T: int = 4096, C: int = 1024,
                 device: DeviceLike = None) -> "IMOperator":
        return cls(to_chunked(coo, T=T, C=C), device=device)

    def dot(self, x: np.ndarray) -> np.ndarray:
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        out = spmm_kernel(self.ct, np.asarray(x, np.float32),
                          device=self.device)
        out = out.to("cpu", copy=True).numpy()
        return out[:, 0] if squeeze else out


class SEMOperator(Operator):
    """Semi-external SpMM streaming from a TileStore."""

    def __init__(self, store: TileStore, config: Optional[SEMConfig] = None,
                 device: DeviceLike = None):
        h = store.header
        super().__init__(h["n_rows"], h["n_cols"])
        self.sem = SEMSpMM(store, config, device=device)
        self.device = self.sem.device

    @classmethod
    def from_coo(cls, coo: COO, path: Optional[str] = None, T: int = 4096,
                 C: int = 1024, config: Optional[SEMConfig] = None,
                 device: DeviceLike = None) -> "SEMOperator":
        device = resolve_device(device)
        ct = to_chunked(coo, T=T, C=C)
        if path is None:
            path = os.path.join(tempfile.mkdtemp(prefix="semspmm_"), "spm")
        return cls(TileStore.write(path, ct), config, device=device)

    def dot(self, x: np.ndarray) -> np.ndarray:
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        out = self.sem.multiply(x)
        return out[:, 0] if squeeze else out

    @property
    def io_bytes_read(self) -> int:
        return self.sem.io_stats.bytes_read
