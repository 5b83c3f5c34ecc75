"""The tiled SpMM kernels of the semi-external pass (the paper's compute
hot-spot): wrappers around the CUDA kernels in ``csrc/``, each with its
plain PyTorch version beside it.

* :func:`spmm_tiles_acc` applies ONE chunk batch of a streaming pass to a
  running accumulator, in place: ``acc (n_tile_rows*T, p) += A_batch @
  x_pad``.  Chunks at or past ``n_valid`` are the engine's fixed-shape tail
  pads and are skipped; tile rows the batch does not visit are left as they
  are, and a visited one holds no -0.0 afterwards (the reference adds a
  block that starts at +0.0 into it); a binary store ships no value plane
  (a lane is live iff its index is below the chunk's nnz).  Index planes
  arrive as stored: uint16 (as int16 bits), int32 (host-decoded), or an
  optimized store's uint8 flattened-key deltas, decoded from the bases in
  ``meta`` columns 4/5.
* :func:`spmm_tiles` is the one-shot ``A @ X`` over a whole ChunkedTiles:
  the same kernel on a zeroed accumulator with ``n_valid = n_chunks``.  Its
  operand may be bfloat16, as the reference's may: the kernel widens each
  element to float32, sums in a float32 accumulator and writes the
  bfloat16 output once at the end (the reference sums in bfloat16, so the
  two agree to bfloat16's precision, not bit for bit).

Each takes one of two variants, as the JAX package's kernels do:

* ``"gather"`` (``csrc/sem_spmm.cu``): each live lane's X row is gathered,
  scaled and added into its output row, each run of a row's lanes summed
  in the warp and added by one vector reduction per 4 columns, and the
  visited tile rows read for -0.0; O(nnz * p) work.
* ``"mxu"`` (``csrc/sem_spmm_mxu.cu``): each chunk's two one-hot products,
  ``E_rᵀ · (v ⊙ (E_c · X_blk))``, applied only where they have ones: E_c
  as a gather of the X rows the live lanes name, E_rᵀ on the tensor cores
  over the chunk's distinct rows, one vector reduction per row and 4
  columns, and +0.0 over each visited tile row once per batch; O(live
  lanes * p) work.  It takes ``C <= MXU_MAX_C`` (its shared-memory
  footprint).

A wrapper launches the kernel for tensors on the card and runs the plain
version only for tensors on the CPU; it raises on anything the kernel does
not take.  ``LAUNCHES`` counts kernel launches per wrapper and variant
(plain runs do not count), so a run can show that its path went through
the kernel.

Equality with the JAX package: on integer-valued data whose partial sums
stay below 2**24 every f32 sum is exact in any order, so kernel, plain
version and reference agree bit for bit (the densify kernel splits its
tensor-core operands in two TF32 terms, exact for integers below 2**22).
Otherwise the kernels' atomics add in an order that changes from run to
run, and agreement is to a tolerance (``rtol = atol = 1e-5`` at the shapes
the tests use).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import count_launch, library

# Kernel launches per wrapper and variant since the last reset (see
# reset_launches); the gather variant keeps the wrapper's plain name.
LAUNCHES = {"spmm_tiles_acc": 0, "spmm_tiles": 0, "spmm_tiles_acc_mxu": 0,
            "spmm_tiles_mxu": 0}
VARIANTS = ("gather", "mxu")
# Largest chunk capacity the densify kernel takes (csrc/sem_spmm_mxu.cu,
# smem_bytes): 16 bytes a lane (decoded rows and columns, compressed row
# ids, run starts) plus 64, beside two X slabs of 128 lanes x 24 words and
# their values (25,600 bytes) and 48 bytes of static scan buffers, within
# a block's 232,448 bytes of shared memory: C <= 12,921, and a multiple of
# 16 below it.
MXU_MAX_C = 12912
# Bytes of the two one-hot matrices the plain densify version holds at
# once; a longer batch goes through in groups of chunks.
MXU_PLAIN_BYTES = 1 << 27

# Element width of each accepted index-plane dtype; uint16 planes travel
# as int16 bits (PyTorch has few uint16 ops) or as torch.uint16.
_IDX_BYTES = {torch.uint8: 1, torch.int16: 2, torch.uint16: 2, torch.int32: 4}
# (row width, col width) pairs the kernel takes: raw uint16, decoded int32,
# 16-bit and 24-bit flattened deltas.
_PLANE_PAIRS = {(2, 2), (4, 4), (1, 1), (2, 1)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}: "
                         "expected 'gather' or 'mxu'")


def _upcast(plane: torch.Tensor) -> torch.Tensor:
    """Index plane -> int64, reading 16-bit planes as unsigned."""
    if plane.dtype == torch.uint16:
        plane = plane.view(torch.int16)
    if plane.dtype == torch.int16:
        return plane.to(torch.int64) & 0xFFFF
    return plane.to(torch.int64)


def _decode_lanes(meta: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain decode of a batch's index lanes (the JAX engine's
    ``core/sem.py::_decode_planes``): raw planes are upcast; a uint8 column
    plane marks flattened-key deltas, ``k = meta[:,4]*T + meta[:,5] +
    cumsum(rows << 8 | cols)``, with lanes at or past the chunk's nnz set
    to 0.  Integer-exact, so raw and optimized stores decode alike."""
    if cols.dtype == torch.uint8:
        dk = (_upcast(rows) << 8) | cols.to(torch.int64)
        m = meta.to(torch.int64)
        k = m[:, 4:5] * T + m[:, 5:6] + torch.cumsum(dk, dim=1)
        r = torch.div(k, T, rounding_mode="floor")
        c = k - r * T
        lanes = torch.arange(rows.shape[1], device=rows.device)[None, :]
        valid = lanes < m[:, 3:4]
        return r.where(valid, 0), c.where(valid, 0)
    return _upcast(rows), _upcast(cols)


def spmm_tiles_acc_plain(meta, n_valid, row_local, col_local, vals, x_pad,
                         acc, *, T: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract: decode, gather
    the live lanes of the valid chunks, ``index_add_`` into ``acc``, then
    +0.0 over every tile row a valid chunk visits.  That last step is the
    reference's ``acc + blk`` with a block that starts at +0.0
    (``core/sem.py::_scan_batch``): no element of a visited tile row stays
    -0.0, and every other value, NaN and inf included, is unchanged."""
    nv = int(n_valid.reshape(-1)[0])
    meta, x_pad = meta[:nv], x_pad.float()
    r, c = _decode_lanes(meta, row_local[:nv], col_local[:nv], T)
    m = meta.to(torch.int64)
    lanes = torch.arange(r.shape[1], device=r.device)[None, :]
    live = lanes < m[:, 3:4]
    out_rows = (m[:, 0:1] * T + r)[live]
    in_rows = (m[:, 1:2] * T + c)[live]
    gathered = x_pad[in_rows]
    if vals is not None:
        gathered = vals[:nv][live][:, None] * gathered
    acc.index_add_(0, out_rows, gathered)
    acc.view(-1, T, acc.shape[1])[torch.unique(m[:, 0])] += 0.0
    return acc


def spmm_tiles_acc_mxu_plain(meta, n_valid, row_local, col_local, vals,
                             x_pad, acc, *, T: int) -> torch.Tensor:
    """Plain PyTorch version of the densify kernel, same contract: for each
    valid chunk the two one-hot products literally, ``blk = E_rᵀ · (v ⊙
    (E_c · X[tile_col]))``, then ``acc[tile_row] += blk`` over the whole
    tile row.  Lanes at or past a chunk's nnz are zero rows of both one-hot
    matrices.  Chunks go through in groups of at most ``MXU_PLAIN_BYTES``
    of one-hot matrices.

    Non-finite operands: a live lane's product ``v * x`` that is not finite
    enters the one-hot products as 0 and is added into its own row by
    ``index_add_``, and X's non-finite entries enter ``E_c`` as 0, so
    NaN/inf reach only the rows whose live lanes meet them, as in the
    reference's default path (``core/spmm.py::_spmm_chunked_impl``).  On
    finite operands nothing changes."""
    nv = int(n_valid.reshape(-1)[0])
    meta, x_pad = meta[:nv], x_pad.float()
    r, c = _decode_lanes(meta, row_local[:nv], col_local[:nv], T)
    m = meta.to(torch.int64)
    C, p = r.shape[1], x_pad.shape[1]
    live = torch.arange(C, device=r.device)[None, :] < m[:, 3:4]
    hot = live.to(x_pad.dtype)
    v = (hot if vals is None else torch.where(live, vals[:nv], 0.0))[..., None]
    r, c = r.where(live, 0), c.where(live, 0)
    x_fin = x_pad.isfinite().all()
    if not (x_fin and v.isfinite().all()):
        prod = v * x_pad[m[:, 1:2] * T + c]
        odd = ~prod.isfinite() & live[:, :, None]
        lanes = odd.any(2)
        acc.index_add_(0, (m[:, 0:1] * T + r)[lanes],
                       torch.where(odd, prod, 0.0)[lanes])
        v = torch.where(odd, 0.0, v)
        if not x_fin:
            x_pad = torch.where(x_pad.isfinite(), x_pad, 0.0)
    xb, ab = x_pad.reshape(-1, T, p), acc.view(-1, T, p)
    step = max(1, MXU_PLAIN_BYTES // (2 * C * T * x_pad.element_size()))
    for s in range(0, nv, step):
        e = min(s + step, nv)
        one_hot = torch.zeros((2, e - s, C, T), dtype=x_pad.dtype,
                              device=x_pad.device)
        one_hot[0].scatter_(2, c[s:e, :, None], hot[s:e, :, None])
        one_hot[1].scatter_(2, r[s:e, :, None], hot[s:e, :, None])
        gathered = torch.bmm(one_hot[0], xb[m[s:e, 1]])
        blk = torch.bmm(one_hot[1].transpose(1, 2), v[s:e] * gathered)
        ab.index_add_(0, m[s:e, 0], blk)
    return acc


_PLAIN = {"gather": spmm_tiles_acc_plain, "mxu": spmm_tiles_acc_mxu_plain}


def _check(meta, n_valid, row_local, col_local, vals, x_pad, acc,
           T: int, variant: str, one_shot: bool) -> None:
    """Raise on anything the kernel does not take; a bfloat16 operand
    only in the one-shot product."""
    dev = acc.device
    for name, t in (("meta", meta), ("n_valid", n_valid),
                    ("row_local", row_local), ("col_local", col_local),
                    ("vals", vals), ("x_pad", x_pad)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, acc on {dev}")
    if meta.dtype != torch.int32 or meta.dim() != 2 \
            or meta.shape[1] not in (4, 6):
        raise ValueError("meta must be int32 (n_chunks, 4 or 6)")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise ValueError("n_valid must be one int32")
    pair = (_IDX_BYTES.get(row_local.dtype), _IDX_BYTES.get(col_local.dtype))
    if pair not in _PLANE_PAIRS:
        raise ValueError(f"unsupported index planes {row_local.dtype}, "
                         f"{col_local.dtype}")
    if pair[1] == 1 and meta.shape[1] < 6:
        raise ValueError("delta planes need the 6-int meta (chunk bases)")
    n, C = row_local.shape
    if col_local.shape != (n, C) or meta.shape[0] != n:
        raise ValueError("meta, row_local and col_local disagree on shape")
    if vals is not None and (vals.dtype != torch.float32
                             or vals.shape != (n, C)):
        raise ValueError("vals must be float32 (n_chunks, C) or None")
    x_types = (torch.float32, torch.bfloat16) if one_shot else (
        torch.float32,)
    if x_pad.dtype not in x_types or acc.dtype != torch.float32:
        raise ValueError("x_pad and acc must be float32 (x_pad may be "
                         "bfloat16 in the one-shot spmm_tiles)")
    if x_pad.dim() != 2 or acc.dim() != 2 or x_pad.shape[1] != acc.shape[1]:
        raise ValueError("x_pad and acc must be 2-D with the same width p")
    if x_pad.shape[0] % T or acc.shape[0] % T:
        raise ValueError(f"x_pad and acc rows must be multiples of T={T}")
    if variant == "mxu" and C > MXU_MAX_C:
        raise ValueError(f"the densify kernel takes C <= {MXU_MAX_C}, "
                         f"not {C}")


def _launch(meta, n_valid, row_local, col_local, vals, x_pad, acc,
            T: int, variant: str, out: Optional[torch.Tensor],
            fresh: bool) -> None:
    """Launch the variant's CUDA kernel on the current stream; raise if
    refused.  With ``out`` (bfloat16, the size of ``acc``) the kernel also
    writes the finished sums there.  ``fresh`` tells the gather kernel that
    ``acc`` is the one-shot product's zeroed accumulator, where the +0.0
    rule has nothing to do."""
    planes = (meta, n_valid, row_local, col_local, vals, x_pad, acc, out)
    if not all(t is None or t.is_contiguous() for t in planes):
        raise ValueError("the kernel takes contiguous tensors only")
    n, C = row_local.shape
    args = (meta.data_ptr(), meta.shape[1], n_valid.data_ptr(),
            row_local.data_ptr(), _IDX_BYTES[row_local.dtype],
            col_local.data_ptr(), _IDX_BYTES[col_local.dtype],
            None if vals is None else vals.data_ptr(), x_pad.data_ptr(),
            int(x_pad.dtype == torch.bfloat16), acc.data_ptr(),
            None if out is None else out.data_ptr(),
            0 if out is None else out.numel(), n, C, T, x_pad.shape[1])
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    with torch.cuda.device(acc.device):
        if variant == "gather":
            err = library("sem_spmm").sem_spmm_batch(*args, int(fresh),
                                                     stream)
        else:
            err = library("sem_spmm_mxu").sem_spmm_mxu_batch(*args, stream)
    if err != 0:
        raise RuntimeError(f"{variant} kernel launch failed: CUDA error {err}")


def _apply(meta, n_valid, row_local, col_local, vals, x_pad, acc, T: int,
           variant: str, wrapper: str,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Validate, then run the variant's plain version on the CPU or launch
    its kernel on the card (counted under ``wrapper`` and the variant);
    anything else raises.  Returns ``acc``, or ``out`` holding its sums
    when given.  The one-shot ``spmm_tiles`` (``wrapper``) hands the kernel
    a fresh zeroed accumulator."""
    _check_variant(variant)
    _check(meta, n_valid, row_local, col_local, vals, x_pad, acc, T, variant,
           out is not None)
    if acc.device.type == "cpu":
        acc = _PLAIN[variant](meta, n_valid, row_local, col_local, vals,
                              x_pad, acc, T=T)
        return acc if out is None else out.copy_(acc)
    if acc.device.type != "cuda":
        raise ValueError(f"no kernel for device {acc.device}")
    _launch(meta, n_valid, row_local, col_local, vals, x_pad, acc, T,
            variant, out, wrapper == "spmm_tiles")
    count_launch(LAUNCHES,
                 wrapper if variant == "gather" else f"{wrapper}_mxu")
    return acc if out is None else out


def spmm_tiles_acc(meta, n_valid, row_local, col_local,
                   vals: Optional[torch.Tensor], x_pad, acc, *, T: int,
                   variant: str = "gather") -> torch.Tensor:
    """One SEM chunk batch: ``acc (n_tile_rows*T, p) += A_batch @ x_pad``,
    in place; returns ``acc``.  ``meta`` is (n_chunks, 4 or 6) int32 (the
    stored first-flags are ignored), ``n_valid`` one int32 (the rest are
    tail pads), ``vals is None`` denotes a binary store."""
    return _apply(meta, n_valid, row_local, col_local, vals, x_pad, acc, T,
                  variant, "spmm_tiles_acc")


def spmm_tiles(meta, row_local, col_local, vals: Optional[torch.Tensor],
               x_pad, *, T: int, n_tile_rows: int,
               variant: str = "gather") -> torch.Tensor:
    """One-shot ``A @ X`` over a whole ChunkedTiles: returns
    (n_tile_rows*T, p) in ``x_pad``'s dtype (float32 or bfloat16), every
    tile row summed from zero in float32."""
    acc = torch.zeros((n_tile_rows * T, x_pad.shape[1]), dtype=torch.float32,
                      device=x_pad.device)
    n_valid = torch.tensor([meta.shape[0]], dtype=torch.int32,
                           device=x_pad.device)
    out = (torch.empty(acc.shape, dtype=torch.bfloat16, device=x_pad.device)
           if x_pad.dtype == torch.bfloat16 else None)
    return _apply(meta, n_valid, row_local, col_local, vals, x_pad, acc, T,
                  variant, "spmm_tiles", out)
