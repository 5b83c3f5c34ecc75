"""Shared linear-operator abstraction for the applications.

Every app consumes ``A @ X`` through :class:`Operator`, which is backed by
either the in-memory chunked path (IM) or the semi-external executor (SEM) —
the paper's IM-SpMM / SEM-SpMM pair behind one interface.  Both run on the
card unless built with ``device="cpu"``.

``dot`` takes a vector or a block of columns of any width.  A numpy
operand gives a numpy result (PageRank's path); a tensor gives a float32
tensor on the operator's device, and a tensor already there stays there:
the SEM operator pads it on the device and keeps the pass's accumulator
instead of reading it back (NMF's and the eigensolver's path).
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

    def dot(self, x):
        raise NotImplementedError

    @property
    def io_bytes_read(self) -> int:
        return 0


class IMOperator(Operator):
    """In-memory chunked SpMM (IM-SpMM): the chunk planes stay resident on
    the device and every product is one launch of the one-shot kernel, in
    the variant :func:`repro_torch.kernels.ops.pick_variant` picks for the
    tile size, unless ``variant`` names one."""

    def __init__(self, ct: ChunkedTiles, device: DeviceLike = None,
                 variant: Optional[str] = None):
        super().__init__(ct.n_rows, ct.n_cols)
        self.device = resolve_device(device)
        self.variant = variant
        self.ct = dataclasses.replace(
            ct,
            meta=torch.as_tensor(ct.meta, device=self.device),
            row_local=torch.as_tensor(ct.row_local, device=self.device),
            col_local=torch.as_tensor(ct.col_local, device=self.device),
            vals=torch.as_tensor(ct.vals, device=self.device))

    @classmethod
    def from_coo(cls, coo: COO, T: int = 4096, C: int = 1024,
                 device: DeviceLike = None,
                 variant: Optional[str] = None) -> "IMOperator":
        return cls(to_chunked(coo, T=T, C=C), device=device, variant=variant)

    def dot(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        if isinstance(x, torch.Tensor):
            out = spmm_kernel(self.ct, x, self.variant, device=self.device)
        else:
            out = spmm_kernel(self.ct, np.asarray(x, np.float32),
                              self.variant, device=self.device)
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

    def dot(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        if isinstance(x, torch.Tensor):
            out = self._dot_device(x.to(self.device, torch.float32))
        else:
            out = self.sem.multiply(x)
        return out[:, 0] if squeeze else out

    def _dot_device(self, x: torch.Tensor) -> torch.Tensor:
        """A @ X for X on the device: padded (and relabeled into an
        optimized store's column space) there, so nothing crosses to or
        from the host but the streamed matrix."""
        sem = self.sem
        x_pad = torch.zeros((sem.padded_cols, x.shape[1]),
                            dtype=torch.float32, device=self.device)
        x_pad[: x.shape[0]] = x
        perm = sem.store.col_perm()
        if perm is not None:
            x_pad[: perm.shape[0]] = x_pad[
                torch.as_tensor(perm, device=self.device)]
        _, acc = sem._multiply(x_pad, to_host=False)
        return acc.reshape(-1, x.shape[1])[: self.n_rows]

    @property
    def io_bytes_read(self) -> int:
        return self.sem.io_stats.bytes_read
