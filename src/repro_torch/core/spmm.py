"""SpMM execution paths.

All compute ``out = A @ X`` for sparse ``A`` and dense ``X`` (n x p):

* :func:`spmm_coo` — flat scatter over COO arrays.  The oracle, and the
  paper's *unblocked CSR baseline* stand-in (no cache blocking).
* :func:`spmm_chunked` — plain PyTorch over the chunk layout the kernel
  streams, in every semiring; the kernel's oracle at scale.
* ``spmm(..., use_kernel=True)`` — the CUDA kernel behind the same chunk
  layout (plus-times only), in the gather or densify variant:
  :func:`repro_torch.kernels.ops.spmm_kernel`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import semiring as sr
from repro_torch.core.formats import COO, ChunkedTiles
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import spmm_kernel


def spmm_coo(a: COO, x: torch.Tensor,
             semiring: str = "plus_times") -> torch.Tensor:
    """Flat COO path on ``x``'s device."""
    ring = sr.SEMIRINGS[semiring]
    dev = x.device
    vals = (torch.ones(a.nnz, dtype=x.dtype, device=dev) if a.vals is None
            else torch.as_tensor(a.vals, device=dev).to(x.dtype))
    rows = torch.as_tensor(a.rows, device=dev)
    cols = torch.as_tensor(a.cols, device=dev)
    prod = ring.mul(vals[:, None], x[cols])
    return ring.add_segment(prod, rows, a.n_rows)


def spmm_chunked(ct: ChunkedTiles, x: torch.Tensor,
                 semiring: str = "plus_times") -> torch.Tensor:
    """Chunked path on ``x``'s device.  Lanes at or past a chunk's nnz are
    padding and carry the ring's additive identity; the cross-chunk combine
    of one tile row is the ring's own reduction, so the flat segment
    reduction over all live lanes equals the chunk-by-chunk fold (exactly
    for min/max rings; in another summation order for plus-times)."""
    ring = sr.SEMIRINGS[semiring]
    dev = x.device
    p = x.shape[1]
    x_pad = torch.zeros((ct.padded_cols, p), dtype=x.dtype, device=dev)
    x_pad[: x.shape[0]] = x
    meta = torch.as_tensor(ct.meta, device=dev).to(torch.int64)
    r = torch.as_tensor(ct.row_local.astype(np.int64), device=dev)
    c = torch.as_tensor(ct.col_local.astype(np.int64), device=dev)
    v = torch.as_tensor(ct.vals, device=dev).to(x.dtype)
    lanes = torch.arange(ct.C, device=dev)[None, :]
    live = lanes < meta[:, 3:4]
    rows_g = (meta[:, 0:1] * ct.T + r)[live]
    cols_g = (meta[:, 1:2] * ct.T + c)[live]
    prod = ring.mul(v[live][:, None], x_pad[cols_g])
    out = ring.add_segment(prod, rows_g, ct.padded_rows)
    return out[: ct.n_rows]


def spmm(a, x, semiring: str = "plus_times", use_kernel: bool = False,
         device: DeviceLike = None,
         variant: Optional[str] = None) -> torch.Tensor:
    """Dispatch on input format; returns float32 on ``device``.  With
    ``use_kernel``, ``variant`` ("gather" or "mxu") picks the kernel;
    ``None`` lets :func:`repro_torch.kernels.ops.pick_variant` choose."""
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device).to(torch.float32)
    if isinstance(a, COO):
        return spmm_coo(a, x, semiring)
    if isinstance(a, ChunkedTiles):
        if use_kernel:
            if semiring != "plus_times":
                raise NotImplementedError(
                    f"semiring {semiring!r} through the kernel: the kernels "
                    "are plus-times only; other semirings take the plain "
                    "chunked path (use_kernel=False)")
            return spmm_kernel(a, x, variant=variant, device=device)
        return spmm_chunked(a, x, semiring)
    raise TypeError(f"unsupported sparse format {type(a)}")
