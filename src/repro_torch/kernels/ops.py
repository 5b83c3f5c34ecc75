"""Entry points to the SpMM kernel: the one-shot product over a whole
ChunkedTiles and the engine's per-batch step."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import ChunkedTiles
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sem_spmm import spmm_tiles, spmm_tiles_acc


# Largest tile size up to which the densify kernel (K1b) beats the gather
# kernel (K1a) on the H100; 0: at no such bound.  The crossover table in
# PERF.md (section 6, measured by chip_smoke.py phase 4c on an H100 80GB
# HBM3 at 700 W, after the gather kernel's redesign): on 256-chunk batches
# (C = 256, p = 1, 8, 16) the gather kernel won 20 of the 21 cells at
# T = 256 ... 16384, by up to 2.4x, and lost the one at T = 256, p = 16 by
# 9%; on the main path's store (T = 16384, C = 2048, a quarter of the
# lanes live) it won by 3.6x to 7.7x.  No bound on T sends a tile size to
# the densify kernel on every width, and the main path's tiles go to the
# gather kernel either way.
MXU_MAX_T = 0


def pick_variant(T: int) -> str:
    """Per-matrix execution-path dispatch (the SCSR/COO hybrid analogue):
    the densify kernel for tiles up to ``MXU_MAX_T``, the gather kernel
    above.  The JAX package sends ``T <= 2048`` to its densify variant from
    napkin math about a TPU's matrix unit; on the H100 the threshold comes
    from a measurement of both kernels on the same batches."""
    return "mxu" if T <= MXU_MAX_T else "gather"


def to_device(a, device: torch.device, dtype=None):
    """Array or tensor -> tensor on ``device``.  A numpy array is copied
    (store planes are read-only memmap views) and uint16 planes travel as
    int16 bits; a tensor already there is returned as it is."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        a = np.array(a)
        a = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)
    t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def spmm_kernel(ct: ChunkedTiles, x, variant: str | None = None,
                device: DeviceLike = None) -> torch.Tensor:
    """``out = A @ X`` through the kernel; A as ChunkedTiles (numpy planes,
    or tensors already resident on ``device``), X (n, p).  Returns
    (n_rows, p) on ``device``: bfloat16 for a bfloat16 X, as the
    reference's ``spmm_pallas`` keeps X's dtype, float32 otherwise."""
    device = resolve_device(device)
    variant = variant or pick_variant(ct.T)
    x = torch.as_tensor(x)
    dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    x = to_device(x, device, dtype)
    x_pad = torch.zeros((ct.padded_cols, x.shape[1]), dtype=dtype,
                        device=device)
    x_pad[: x.shape[0]] = x
    out = spmm_tiles(to_device(ct.meta, device, torch.int32),
                     to_device(ct.row_local, device),
                     to_device(ct.col_local, device),
                     to_device(ct.vals, device, torch.float32), x_pad,
                     T=ct.T, n_tile_rows=ct.n_tile_rows, variant=variant)
    return out[: ct.n_rows]


def spmm_kernel_batch(meta, n_valid, rows, cols, vals, x_pad, out_blocks, *,
                      T: int, variant: str | None = None,
                      device: DeviceLike = None) -> torch.Tensor:
    """SEM-streaming step: apply one chunk batch read from the slow tier
    and accumulate into ``out_blocks`` (n_tile_rows, T, p), in place.

    ``meta`` and ``n_valid`` (the batch's real chunk count; the rest are
    tail pads) are device tensors like any other plane; ``rows``/``cols``
    may be uint16 (int16 bits), int32, or an optimized store's uint8
    deltas; ``vals is None`` denotes a binary store.  Arrays are moved to
    ``device``; a tensor ``out_blocks`` already there is updated in place
    and returned."""
    device = resolve_device(device)
    variant = variant or pick_variant(T)
    out_blocks = to_device(out_blocks, device, torch.float32)
    n_tile_rows, _, p = out_blocks.shape
    if not isinstance(n_valid, torch.Tensor):
        n_valid = np.asarray(n_valid, np.int32).reshape(1)
    n_valid = to_device(n_valid, device, torch.int32).reshape(1)
    spmm_tiles_acc(to_device(meta, device, torch.int32), n_valid,
                   to_device(rows, device), to_device(cols, device),
                   to_device(vals, device, torch.float32),
                   to_device(x_pad, device, torch.float32),
                   out_blocks.view(n_tile_rows * T, p), T=T, variant=variant)
    return out_blocks
