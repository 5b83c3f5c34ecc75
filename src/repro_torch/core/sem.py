"""The semi-external-memory SpMM executor (the paper's core system).

Data placement policy (paper §3.1/§3.6):
* the sparse matrix always lives on the slow tier and is *streamed*;
* the input dense matrix — or as many of its columns as fit the memory
  budget — lives in device memory;
* the output is accumulated per tile row in device memory and read back
  once, at the end of the pass.

``SEMSpMM.multiply`` handles all three regimes:
1. X fits in memory, output fits in memory  -> one streaming pass.
2. X fits, output streamed                  -> one pass, write-once out blocks.
3. X wider than budget                      -> vertical partitioning: one
   streaming pass of the sparse matrix per column slice (paper §3.3/§5.3).

``mode="im"`` keeps the sparse matrix in host memory (IM-SpMM, the paper's
overhead-quantification baseline); its batches are still staged to the
device every pass.

The streaming pass is a pipeline:

* **zero-copy reads** — batches arrive as strided views into the store's
  persistent memmap (``TileStore.read_batch_raw``), faulted in by the
  prefetch thread;
* **staging** — each plane is copied into a pinned host buffer and sent to
  the card on a side CUDA stream, with one event per batch; the compute
  stream waits on that event before the batch's kernel, and a pinned
  buffer is refilled only once its copy has landed.  Index planes cross as
  stored (uint16, or an optimized store's uint8 deltas) and binary stores
  ship no value plane; ``IOStats.h2d_bytes`` counts exactly what crosses;
* **overlap** — batch k+1 is staged while batch k's kernel runs;
* **fixed-shape batches** — a short batch is padded with pad chunks that
  the kernel skips (``n_valid``);
* **the step is the kernel** — a plus-times pass runs
  :func:`repro_torch.kernels.ops.spmm_kernel_batch`, which adds each batch
  into the device-resident accumulator in place.  On ``device="cpu"`` the
  step is the kernel's plain PyTorch version.  The lane decode lives beside
  the kernel (``repro_torch.kernels.sem_spmm._decode_lanes``);
* **semirings** — ``multiply(..., semiring=)`` takes every ring of
  :mod:`repro_torch.core.semiring`.  The kernels are plus-times only, as the
  JAX package's are; another ring takes one plain PyTorch step per batch
  (:func:`_ring_batch`), on the executor's device: every lane at or past its
  chunk's nnz carries the ring's identity and all lanes fold into the
  accumulator in one ``scatter_reduce_``;
* **the delta overlay** — a store with a delta log (a mutable graph, see
  :class:`repro_torch.io.storage.GraphHandle`) is served as ``base ⊕
  delta`` at one version: the log is snapshotted at pass start, staged once,
  scattered once into a delta accumulator, and each batch's base step is
  followed by the fold of the tile rows that batch completes.

The pass is *elastic*: ``multiply(x, boundary_hook=...)`` invokes the hook
at every chunk-batch boundary with a :class:`PassBoundary` through which a
caller may rewrite operand columns mid-pass and read the accumulator's
completed tile-row prefix.

On the card each executor runs its passes on a compute stream of its own,
so executors driven from several threads (the shards of
:class:`repro_torch.distributed.shard_scan.ShardedSEMSpMM`) neither
serialise on one stream nor wait for each other's work at pass end.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.semiring import PLUS_TIMES, SEMIRINGS, Semiring
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.io.storage import (DenseStore, GraphHandle, IOStats,
                                    TileStore, UpdateBatch)
from repro_torch.kernels.ops import (pick_variant, spmm_kernel_batch,
                                     to_device)
from repro_torch.kernels.sem_spmm import _decode_lanes

# Sentinel for "no per-pass cache override": ``None`` must stay expressible
# as "explicitly uncached".
_CACHE_UNSET = object()

# A min or max ring's combine, as ``scatter_reduce_`` names it.
_REDUCE = {"min": "amin", "max": "amax"}
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _nan_key(ring: Semiring) -> int:
    """The key NaN takes: the one that wins the ring's combine."""
    return _INT32_MIN if ring.scatter == "min" else _INT32_MAX


def _ring_keys(x: torch.Tensor, ring: Semiring) -> torch.Tensor:
    """float32 -> int32 keys in the order the JAX package's min and max
    follow (XLA's): the bits of a non-negative float, the low 31 bits
    flipped for a negative one, so -0.0 sorts below +0.0; NaN takes the
    key that wins the ring's combine, as NaN propagates through XLA's min
    and max.  Integer min and max then give XLA's bits on every input and
    in any order of the terms: a float ``scatter_reduce_`` keeps whichever
    zero it meets first on a -0.0/+0.0 tie (on the card, whichever atomic
    lands first)."""
    b = x.contiguous().view(torch.int32)
    k = torch.where(b < 0, b ^ _INT32_MAX, b)
    return torch.where(torch.isnan(x), _nan_key(ring), k)


def _ring_values(k: torch.Tensor, ring: Semiring) -> torch.Tensor:
    """The inverse of :func:`_ring_keys` (NaN comes back as the canonical
    quiet NaN)."""
    b = torch.where(k < 0, k ^ _INT32_MAX, k)
    return torch.where(k == _nan_key(ring), math.nan,
                       b.contiguous().view(torch.float32))


def _ring_batch(meta, rows, cols, vals, x_pad, keys, T: int,
                ring: Semiring) -> None:
    """One chunk batch under a min or max ring, in place on ``keys``, the
    pass's accumulator in :func:`_ring_keys` space (n_tile_rows, T, p): the
    JAX engine's ``_scan_batch_ring`` as one flat reduction.  Every lane's
    product ``ring.mul(v, x)`` (v = 1 on a binary store) is taken, a lane
    at or past its chunk's nnz is set to the ring's identity, and all lanes
    fold into the accumulator at row ``m0·T + r``.  Min and max of keys do
    not depend on the order of their terms, so this equals the reference's
    chunk-by-chunk fold bit for bit; pad chunks (nnz = 0) add only the
    identity, so ``n_valid`` is not needed and nothing is read back to the
    host."""
    r, c = _decode_lanes(meta, rows, cols, T)
    m = meta.to(torch.int64)
    p = x_pad.shape[1]
    gathered = x_pad[m[:, 1:2] * T + c]
    v = (torch.ones((), dtype=x_pad.dtype, device=x_pad.device)
         if vals is None else vals[..., None])
    contrib = ring.mul(v, gathered)
    live = torch.arange(r.shape[1], device=r.device)[None, :] < m[:, 3:4]
    contrib = torch.where(live[..., None], contrib, ring.zero)
    idx = (m[:, 0:1] * T + r).reshape(-1, 1).expand(-1, p)
    keys.view(-1, p).scatter_reduce_(
        0, idx, _ring_keys(contrib, ring).reshape(-1, p),
        _REDUCE[ring.scatter], include_self=True)


def _delta_acc(dr, dc, dv, n: int, x_pad, n_tile_rows: int, T: int,
               ring: Semiring) -> torch.Tensor:
    """Pass-level delta accumulator (the JAX engine's ``_delta_acc`` and
    ``_delta_acc_ring``): ONE scatter of the staged snapshot's ``n`` valid
    entries (engine coordinates) against the current operand, so the
    per-batch overlay is a fold of a tile-row window.  Under plus-times the
    fill is ``-0.0``: for every float ``f`` (both zeros included) ``f +
    (-0.0) == f`` bitwise, so untouched entries are invisible to the fold (a
    ``+0.0`` fill would flip a ``-0.0`` accumulator entry).  Other rings
    fill with their identity and combine with their own reduction, in key
    space (insert only: the caller refuses a log with deletions).  The
    staged buffers' pad entries past ``n`` are not read: the reference
    adds the identity for them."""
    p = x_pad.shape[1]
    rows, cols = dr[:n].to(torch.int64), dc[:n].to(torch.int64)
    if ring.is_plus_times():
        dacc = torch.full((n_tile_rows * T, p), -0.0, dtype=x_pad.dtype,
                          device=x_pad.device)
        dacc.index_put_((rows,), x_pad[cols] * dv[:n, None], accumulate=True)
    else:
        fill = torch.full((), ring.zero, dtype=torch.float32)
        dacc = torch.full((n_tile_rows * T, p),
                          int(_ring_keys(fill, ring)), dtype=torch.int32,
                          device=x_pad.device)
        dacc.scatter_reduce_(0, rows[:, None].expand(-1, p),
                             _ring_keys(ring.mul(dv[:n, None], x_pad[cols]),
                                        ring),
                             _REDUCE[ring.scatter], include_self=True)
    return dacc.view(n_tile_rows, T, p)


def _fold_delta(acc, dacc, lo: int, hi: int, ring: Semiring) -> None:
    """Fold tile rows ``[lo, hi)`` of the delta accumulator into the pass's
    accumulator in place: ``+`` under plus-times, the ring's min or max of
    keys otherwise.  Rows outside the window are left alone, which is what
    the reference's masked fold over the whole accumulator does to them bit
    for bit (it adds ``-0.0``, or combines with the identity)."""
    win = acc[lo:hi]
    if ring.is_plus_times():
        win += dacc[lo:hi]
    elif ring.scatter == "min":
        torch.minimum(win, dacc[lo:hi], out=win)
    else:
        torch.maximum(win, dacc[lo:hi], out=win)


@dataclasses.dataclass
class SEMConfig:
    memory_budget_bytes: int = 1 << 30
    chunk_batch: int = 256        # chunks per I/O (large sequential reads)
    prefetch: int = 2             # async prefetch depth
    use_async: bool = True        # paper's async I/O + polling
    kernel_variant: Optional[str] = None  # None -> kernels.ops.pick_variant(T)
    decode_on_device: bool = True  # ship stored index planes, decode on device
    overlap: bool = True          # stage batch k+1 while batch k computes
    fixed_shape: bool = True      # pad the tail batch to chunk_batch


class PassBoundary:
    """Mid-pass control point handed to ``boundary_hook`` before each chunk
    batch is dispatched.

    ``chunk_start`` is the index of the first chunk of the *next* batch;
    every chunk below it has already been dispatched against the operand
    columns staged at the time.  Chunks are laid out in (tile_row,
    tile_col) order, so a column written here receives exact contributions
    for every tile row whose chunks all lie at or after ``chunk_start``.
    """

    def __init__(self, sem: "SEMSpMM", chunk_start: int,
                 x_pad: torch.Tensor, out: torch.Tensor,
                 ring: Semiring = PLUS_TIMES):
        self.sem = sem
        self.chunk_start = chunk_start
        self.x_pad = x_pad
        self.out = out
        self.ring = ring

    def write_columns(self, c0: int, cols: np.ndarray) -> None:
        """Replace operand columns ``[c0, c0+w)`` from this batch onward.
        The staged operand is copied, not written in place: batches already
        dispatched keep the columns they were given, and a caller's
        pre-staged operand is never modified."""
        cols = np.asarray(cols, np.float32)
        if cols.ndim == 1:
            cols = cols[:, None]
        pad = self.sem.padded_cols
        if cols.shape[0] != pad:
            full = np.zeros((pad, cols.shape[1]), np.float32)
            full[: cols.shape[0]] = cols
            cols = full
        # an optimized store's engine column space is relabeled; the caller
        # writes user-space columns, so relabel here (no-op on raw stores)
        cols = np.ascontiguousarray(self.sem.store.apply_col_perm(cols))
        dev = torch.from_numpy(cols).to(self.sem.device)
        self.sem.store.stats.add_h2d(cols.nbytes)
        x_pad = self.x_pad.clone()
        x_pad[:, c0:c0 + cols.shape[1]] = dev
        self.x_pad = x_pad

    def read_output(self, n_tile_rows: int, c0: int, c1: int) -> np.ndarray:
        """Materialize accumulator tile rows ``[0, n_tile_rows)`` for columns
        ``[c0, c1)`` — every batch before this boundary applied.  Waits for
        the in-flight steps (the price of mid-pass delivery)."""
        if n_tile_rows <= 0:
            return np.empty((0, c1 - c0), np.float32)
        blk = self.out[:n_tile_rows, :, c0:c1]
        if not self.ring.is_plus_times():   # the pass holds ring keys
            blk = _ring_values(blk.view(torch.int32), self.ring)
        blk = blk.to("cpu", copy=True).numpy()
        n = min(n_tile_rows * self.sem.T, self.sem.n_rows)
        return blk.reshape(n_tile_rows * self.sem.T, c1 - c0)[:n]


class _PinnedSlot:
    """One batch's pinned host buffers, reused once the copy out of them
    has completed (``event``).  Buffers are kept per (plane, shape, dtype):
    an optimized store's plan mixes a few batch shapes and index widths,
    and pinning memory anew for each batch would cost more than the copy."""

    def __init__(self):
        self.buffers: dict = {}
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, i: int, a: np.ndarray) -> torch.Tensor:
        """Copy plane ``i`` into its pinned buffer and return the buffer."""
        dt = np.dtype(np.int16) if a.dtype == np.uint16 else a.dtype
        key = (i, a.shape, dt)
        buf = self.buffers.get(key)
        if buf is None:
            buf = torch.from_numpy(np.empty(a.shape, dt)).pin_memory()
            self.buffers[key] = buf
        np.copyto(buf.numpy().view(a.dtype), a)
        return buf


class SEMSpMM:
    """Semi-external-memory SpMM over a :class:`TileStore`."""

    def __init__(self, store: TileStore, config: Optional[SEMConfig] = None,
                 mode: str = "sem", cache=None, device: DeviceLike = None):
        if mode not in ("sem", "im"):
            raise ValueError(f"mode must be 'sem' or 'im', not {mode!r}")
        self.device = resolve_device(device)
        self.store = store
        self.cfg = config or SEMConfig()
        self.mode = mode
        h = store.header
        self.n_rows, self.n_cols, self.T = h["n_rows"], h["n_cols"], h["T"]
        self.n_tile_rows = -(-self.n_rows // self.T)
        self.padded_cols = (-(-self.n_cols // self.T)) * self.T
        self._cached = None
        # Optional hot-chunk cache (duck-typed get/offer, see
        # TileStore._fetch): pins chunk batches in leftover memory.
        self.cache = cache
        # ``passes`` counts streaming passes over the sparse matrix; the
        # increment is lock-protected for executors shared across threads.
        self.passes = 0
        self._passes_lock = threading.Lock()
        # Mutation surface: a GraphHandle is attached on the first
        # apply_updates (a frozen executor pays nothing for mutability).
        self._mut_lock = threading.Lock()
        # Version the last streaming pass was snapshotted at (0 = no delta
        # log / frozen store).
        self.last_pass_version = 0
        # chunk_tile_rows() cache, keyed by (generation, n_chunks): a
        # compaction install rewrites the chunk layout under the same path.
        self._trow_key = None
        self._trow_cache = None
        # Staging state on the card: the executor's own compute stream, a
        # side stream for the copies and a ring of pinned buffers (one slot
        # per batch in flight).
        self._compute_stream = None
        self._copy_stream = None
        self._slots: List[_PinnedSlot] = []
        self._next_slot = 0
        # ``multiply``'s accumulator, kept between passes and refilled in
        # place while the width holds (a serving wave's fixed capacity: no
        # allocation per pass or per admission).  One pass at a time holds
        # it, and the staging slots: threads sharing this executor (serving
        # waves routed to one replica) take turns by ``_pass_lock``.
        self._acc: Optional[torch.Tensor] = None
        self._pass_lock = threading.Lock()
        if self.device.type == "cuda":
            self._compute_stream = torch.cuda.Stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(2)]
        if mode == "im":  # IM-SpMM: sparse matrix resident in host memory
            self._cached = list(store.stream(self.cfg.chunk_batch,
                                             use_async=False))

    # -- mutation surface (the Mutable protocol) ----------------------------
    @property
    def version(self) -> int:
        """Graph version this executor serves (0 when frozen)."""
        return self.store.version

    @property
    def delta_nnz(self) -> int:
        """Consolidated entries in the delta overlay awaiting compaction."""
        dl = self.store.delta_log
        return 0 if dl is None else dl.nnz

    @property
    def graph_handle(self) -> Optional[GraphHandle]:
        return self.store.handle

    def apply_updates(self, batch: UpdateBatch) -> int:
        """Append an edge-update batch to the graph's delta log, creating
        the :class:`GraphHandle` on first use; returns the new version.
        Each pass snapshots the log at its start, so a pass is internally
        consistent and a version flip lands at a pass boundary."""
        with self._mut_lock:
            if self.store.handle is None:
                if self.store._delta_src is not None:
                    raise ValueError(
                        "apply_updates must go through the root store's "
                        "executor, not a row-partitioned shard view")
                GraphHandle([self.store])
        return self.store.handle.apply_updates(batch)

    # -- the pipelined streaming pass ---------------------------------------
    def _use_raw(self) -> bool:
        return self.cfg.decode_on_device and self._cached is None

    def _prepare_x(self, x) -> torch.Tensor:
        """Stage X on the device, padded to the tile grid and relabeled into
        the store's engine column space (optimized stores persist an
        operand permutation; raw stores pass through).  A float32 tensor
        padded to the tile grid is taken as already in engine column space
        (the sharded scan relabels and stages once for all shards): on this
        executor's device it is used as it is, uncounted; on another device
        it is moved here and counted."""
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.float32 and x.shape[0] == self.padded_cols:
                if x.device == self.device:
                    return x
                self.store.stats.add_h2d(x.nbytes)
                return x.to(self.device)
            x = x.cpu().numpy()
        full = np.zeros((self.padded_cols, x.shape[1]), np.float32)
        full[: x.shape[0]] = np.asarray(x, np.float32)
        full = np.ascontiguousarray(self.store.apply_col_perm(full))
        self.store.stats.add_h2d(full.nbytes)
        return torch.from_numpy(full).to(self.device)

    def _pad_tail(self, batches: Iterator[Tuple[np.ndarray, ...]],
                  pow2: bool = False
                  ) -> Iterator[Tuple[Tuple[np.ndarray, ...], int]]:
        """Pad a short batch to a fixed shape; yields ``(batch, n_valid)``
        with the real chunk count.  A classic plan (one short batch: the
        tail) pads to ``chunk_batch``.  A fragmented plan (an optimized
        store's encoding-run splits, ``pow2=True``) instead pads short runs
        to the next power of two and mid-size runs (>= 32) to the next
        multiple of 32, so a 70-chunk run does not ship 128 chunks.  Pad
        chunks replicate the last chunk's tile coordinates with nnz = 0 and
        zero entries; the kernel skips them by ``n_valid``."""
        B = self.cfg.chunk_batch
        for batch in batches:
            meta = batch[0]
            n = meta.shape[0]
            tgt = B
            if pow2 and 0 < n < B:
                if n < 32:
                    tgt = 1
                    while tgt < n:
                        tgt *= 2
                else:
                    tgt = min(-(-n // 32) * 32, B)
            if n == tgt or n == 0:
                yield batch, n
                continue
            meta_p = np.zeros((tgt, meta.shape[1]), meta.dtype)
            meta_p[:n] = meta
            meta_p[n:, 0] = meta[-1, 0]   # keep pointing at a live tile row
            meta_p[n:, 1] = meta[-1, 1]
            meta_p[n:, 2] = 0
            padded = [meta_p]
            for a in batch[1:]:
                if a is None:
                    padded.append(None)
                    continue
                a_p = np.zeros((tgt,) + a.shape[1:], a.dtype)
                a_p[:n] = a
                padded.append(a_p)
            yield tuple(padded), n

    @staticmethod
    def _with_valid(batches: Iterator[Tuple[np.ndarray, ...]]
                    ) -> Iterator[Tuple[Tuple[np.ndarray, ...], int]]:
        """No tail padding: every chunk of every batch is valid."""
        for batch in batches:
            yield batch, batch[0].shape[0]

    def _stage(self, batch: Tuple[np.ndarray, ...], n_valid: int
               ) -> Tuple[tuple, Optional[torch.cuda.Event]]:
        """Issue the host->device transfer for one batch and return the
        staged ``(meta, n_valid, rows, cols, vals-or-None)`` with the event
        that marks its arrival (None on the CPU).  Counts the bytes
        shipped: stored index widths, no values for binary stores, meta
        and the 4-byte ``n_valid``."""
        planes = (batch[0], np.asarray([n_valid], np.int32)) + tuple(batch[1:])
        self.store.stats.add_h2d(sum(a.nbytes for a in planes
                                     if a is not None))
        if self.device.type == "cpu":
            return tuple(to_device(a, self.device) for a in planes), None
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()   # its previous copy has landed
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            staged = tuple(
                None if a is None else
                slot.fill(i, a).to(self.device, non_blocking=True)
                for i, a in enumerate(planes))
            slot.event = torch.cuda.Event()
            slot.event.record(self._copy_stream)
        for t in staged:
            if t is not None:
                # allocated on the copy stream, consumed on the compute one
                t.record_stream(compute)
        return staged, slot.event

    def _make_step(self, ring: Semiring):
        """Bind the step for this pass: the kernel for plus-times
        (``kernel_variant``, or the one ``pick_variant`` picks), the plain
        ring step for any other ring (the kernels are plus-times only).
        ``x_pad`` is threaded through per call (a boundary hook may swap in
        a same-shape update mid-pass)."""
        if ring.is_plus_times():
            variant = self.cfg.kernel_variant or pick_variant(self.T)

            def apply(meta, nv, rows, cols, vals, x_pad, out):
                return spmm_kernel_batch(meta, nv, rows, cols, vals, x_pad,
                                         out, T=self.T, variant=variant,
                                         device=self.device)
        else:
            def apply(meta, nv, rows, cols, vals, x_pad, out):
                _ring_batch(meta, rows, cols, vals, x_pad,
                            out.view(torch.int32), self.T, ring)
                return out

        def step(staged, x_pad, out):
            planes, arrived = staged
            if arrived is not None:
                torch.cuda.current_stream(self.device).wait_event(arrived)
            return apply(*planes, x_pad, out)
        return step

    def _boundary(self, hook, chunk_start: int, x_pad: torch.Tensor,
                  out: torch.Tensor, ring: Semiring) -> torch.Tensor:
        """Run the boundary hook (if any) before a batch is dispatched;
        returns the possibly-updated operand."""
        if hook is None:
            return x_pad
        b = PassBoundary(self, chunk_start, x_pad, out, ring)
        hook(b)
        return b.x_pad

    # -- the delta overlay ---------------------------------------------------
    def _chunk_trow(self) -> np.ndarray:
        """chunk_tile_rows(), cached per (generation, n_chunks) — a
        compaction install rewrites the layout under the same path."""
        key = (self.store.generation, self.store.n_chunks)
        if self._trow_key != key:
            self._trow_cache = self.store.chunk_tile_rows()
            self._trow_key = key
        return self._trow_cache

    # The staged delta snapshot is padded to this floor (doubling beyond
    # it), as the JAX engine pads it to keep its jitted shapes few; the
    # port pads the same way so that a pass ships, and counts, the same
    # bytes: 96 KB per pass at the floor.
    DELTA_PAD_FLOOR = 8192

    def _stage_delta(self, rows: np.ndarray, cols: np.ndarray,
                     vals: np.ndarray) -> tuple:
        """Ship the pass's whole (frame-sliced) delta snapshot once,
        length-padded to the floor (then powers of two): three transfers
        per pass, not three per batch."""
        n = rows.shape[0]
        tgt = self.DELTA_PAD_FLOOR
        while tgt < n:
            tgt *= 2
        rp = np.zeros(tgt, np.int32)
        cp = np.zeros(tgt, np.int32)
        vp = np.zeros(tgt, np.float32)
        rp[:n], cp[:n], vp[:n] = rows, cols, vals
        self.store.stats.add_h2d(rp.nbytes + cp.nbytes + vp.nbytes)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (rp, cp, vp))

    def _prepare_delta(self, snap, starts, ring: Semiring):
        """Slice a pass-start delta snapshot to this executor's row frame
        and assign each tile row's entries to a chunk batch: tile row t's
        delta is applied right AFTER the batch holding t's first base chunk
        — by then the operand columns that batch's boundary admitted are
        staged, and any completion read at a later boundary already
        includes the delta.  Returns ``(dr, dc, dv, n, tr_lo, tr_hi)`` —
        the snapshot staged once, its valid-entry count, and per-batch
        tile-row windows ``[tr_lo[i], tr_hi[i])`` (contiguous and
        exhaustive, host arrays) — or None when the snapshot holds nothing
        for this frame.  Raises ``ValueError`` for a log with deletions
        under a ring other than plus-times."""
        ver, rows, cols, vals = snap
        if rows.size == 0:
            return None
        st = self.store
        if not ring.is_plus_times() and st.delta_log.has_deletes:
            raise ValueError(
                f"semiring {ring.name!r} cannot serve a delta log with "
                "deletions (negated values only cancel under plus-times); "
                "compact the graph first")
        r0 = st.row_offset
        lo, hi = np.searchsorted(rows, [r0, r0 + self.n_rows])
        if hi == lo:
            return None
        rows = (rows[lo:hi] - r0).astype(np.int32)
        cols = cols[lo:hi]
        vals = np.asarray(vals[lo:hi], np.float32)
        perm = st.col_perm()
        if perm is not None:
            rank = np.empty_like(perm)
            rank[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
            cols = rank[cols]
        cols = cols.astype(np.int32)
        # first base chunk of every tile row (each tile row owns >= 1
        # chunk, even when empty), then the batch that chunk falls in
        first_chunk = np.searchsorted(self._chunk_trow(),
                                      np.arange(self.n_tile_rows))
        sarr = np.asarray(starts, np.int64)
        batch_of_row = np.clip(
            np.searchsorted(sarr, first_chunk, side="right") - 1,
            0, len(starts) - 1)
        b = np.arange(len(starts))
        tr_lo = np.searchsorted(batch_of_row, b, side="left")
        tr_hi = np.searchsorted(batch_of_row, b, side="right")
        return self._stage_delta(rows, cols, vals) + (
            rows.shape[0], tr_lo, tr_hi)

    def _make_step_delta(self, step, ring: Semiring, delta_plan):
        """Bind one pass's overlay dispatch: ``dispatch(i, staged, x_pad,
        out)`` applies batch ``i`` (the kernel, or the ring step), then
        folds its tile-row window of the pass-level delta accumulator,
        skipping an empty window.  The accumulator is bound to the operand:
        a mid-pass ``write_columns`` swaps in a new ``x_pad``, so the next
        dispatch rebuilds it and the not-yet-folded tile rows' delta
        gathers the rewritten columns — the columns their base chunks
        see."""
        dr, dc, dv, n, tr_lo, tr_hi = delta_plan
        state = {"src": None, "dacc": None}

        def dispatch(i, staged, x_pad, out):
            out = step(staged, x_pad, out)
            lo, hi = int(tr_lo[i]), int(tr_hi[i])
            if hi > lo:
                if state["src"] is not x_pad:
                    state["dacc"] = _delta_acc(dr, dc, dv, n, x_pad,
                                               self.n_tile_rows, self.T,
                                               ring)
                    state["src"] = x_pad
                _fold_delta(out if ring.is_plus_times()
                            else out.view(torch.int32), state["dacc"], lo,
                            hi, ring)
            return out
        return dispatch

    def _stream_pass(self, x_pad: torch.Tensor, out: torch.Tensor,
                     hook=None, cache=_CACHE_UNSET,
                     ring: Semiring = PLUS_TIMES,
                     snapshot=None) -> torch.Tensor:
        """One full streaming pass of the sparse matrix, accumulated into
        ``out`` in place.  ``cache`` overrides the executor-attached
        hot-chunk cache for this pass only.  When the store carries a delta
        log, the log is snapshotted once at pass start (bracketed by
        ``begin_pass``/``end_pass``, so a compaction cannot install a new
        base generation mid-stream; ``end_pass`` runs even when the pass
        raises) and each batch's base step is followed by the delta of the
        tile rows it completed: the pass computes ``(base ⊕ delta) @ X`` at
        one version.  ``snapshot`` replaces the pass's own snapshot (a
        coordinator holding several executors at one version)."""
        raw = self._use_raw()
        pass_cache = self.cache if cache is _CACHE_UNSET else cache
        handle = self.store.handle
        dl = self.store.delta_log
        snap = None
        if dl is not None:
            if handle is not None:
                # begin_pass gates installation and returns the current
                # snapshot; a supplied one takes its place
                got = handle.begin_pass()
                snap = snapshot if snapshot is not None else got
            else:
                snap = snapshot if snapshot is not None else dl.snapshot()
            self.last_pass_version = snap[0]
        try:
            batches = (iter(self._cached) if self._cached is not None else
                       self.store.stream(self.cfg.chunk_batch,
                                         prefetch=self.cfg.prefetch,
                                         use_async=self.cfg.use_async,
                                         cache=pass_cache, raw=raw))
            step = self._make_step(ring)
            stats = self.store.stats
            B = self.cfg.chunk_batch
            # Batch boundaries come from the store's plan, not ``i * B``: an
            # optimized store splits batches at encoding-run boundaries.
            starts = [s for s, _ in self.store.batch_plan(B)]
            fragmented = len(starts) > -(-self.store.n_chunks // B)
            if not ring.is_plus_times():
                # a ring pass accumulates _ring_keys in out's storage
                out.view(torch.int32).copy_(_ring_keys(out, ring))
            delta_plan = (self._prepare_delta(snap, starts, ring)
                          if snap is not None else None)
            if delta_plan is None:
                def dispatch(i, staged, x_pad, out):
                    return step(staged, x_pad, out)
            else:
                dispatch = self._make_step_delta(step, ring, delta_plan)
            batches = (self._pad_tail(batches, pow2=fragmented)
                       if self.cfg.fixed_shape else self._with_valid(batches))

            def boundary(i, x_pad):   # the hook, before batch i
                return self._boundary(hook, starts[i], x_pad, out, ring)
            if not self.cfg.overlap:
                for i, (batch, nv) in enumerate(batches):
                    x_pad = boundary(i, x_pad)
                    out = dispatch(i, self._stage(batch, nv), x_pad, out)
            else:
                pending = None
                for i, (batch, nv) in enumerate(batches):
                    staged = self._stage(batch, nv)  # stage k+1 ...
                    if pending is not None:
                        j, st_j = pending
                        x_pad = boundary(j, x_pad)
                        out = dispatch(j, st_j, x_pad, out)  # ... while k
                        stats.add_overlap()
                    pending = (i, staged)
                if pending is not None:
                    j, st_j = pending
                    x_pad = boundary(j, x_pad)
                    out = dispatch(j, st_j, x_pad, out)
            if not ring.is_plus_times():
                out.copy_(_ring_values(out.view(torch.int32), ring))
        finally:
            if handle is not None and snap is not None:
                handle.end_pass()
        with self._passes_lock:
            self.passes += 1
        return out

    # -- regime 1/2: X in memory ------------------------------------------
    def multiply(self, x, *, boundary_hook=None, cache=_CACHE_UNSET,
                 semiring: str = "plus_times", snapshot=None) -> np.ndarray:
        """A @ X with X (n, p) in memory; returns the result on the host.
        ``boundary_hook`` (optional) is called with a :class:`PassBoundary`
        before each chunk batch.  ``cache`` (optional) overrides the
        attached hot-chunk cache for this pass (``None`` = uncached).
        ``semiring`` names a ring of :mod:`repro_torch.core.semiring`:
        ``min_plus`` makes the pass one shortest-path relaxation.
        ``snapshot`` (optional) supplies a pre-taken delta snapshot, so a
        coordinator fanning one pass across several executors holds every
        partial scan at one version.  The accumulator is the executor's
        own, reused by every pass of the same width."""
        with self._pass_lock:
            out, self._acc = self._multiply(
                x, self._acc, boundary_hook=boundary_hook, cache=cache,
                semiring=semiring, snapshot=snapshot)
        return out

    def _multiply(self, x, acc: Optional[torch.Tensor] = None,
                  boundary_hook=None, cache=_CACHE_UNSET,
                  semiring: str = "plus_times", to_host: bool = True,
                  snapshot=None
                  ) -> Tuple[Optional[np.ndarray], torch.Tensor]:
        """multiply() plus accumulator reuse: a caller looping over slices of
        equal width passes back the returned ``acc``, refilled in place here
        with the ring's identity.  ``to_host=False`` skips the read-back
        (the host result is then ``None``) for a caller that keeps working
        on the device: its current stream is made to wait for the pass."""
        ring = (semiring if isinstance(semiring, Semiring)
                else SEMIRINGS[semiring])
        p = x.shape[1]
        x_pad = self._prepare_x(x)
        if acc is None or acc.shape[2] != p:
            acc = torch.full((self.n_tile_rows, self.T, p), ring.zero,
                             dtype=torch.float32, device=self.device)
        else:
            if self._compute_stream is not None:
                # a pass that raised (a replica's failed read) left its
                # steps queued on the executor's stream: they land first
                torch.cuda.current_stream(self.device).wait_stream(
                    self._compute_stream)
            acc.fill_(ring.zero)
        if self._compute_stream is None:
            out = self._stream_pass(x_pad, acc, hook=boundary_hook,
                                    cache=cache, ring=ring,
                                    snapshot=snapshot)
        else:
            # the operand and the accumulator were made on the caller's
            # stream; the pass runs on the executor's own
            caller = torch.cuda.current_stream(self.device)
            self._compute_stream.wait_stream(caller)
            with torch.cuda.stream(self._compute_stream):
                out = self._stream_pass(x_pad, acc, hook=boundary_hook,
                                        cache=cache, ring=ring,
                                        snapshot=snapshot)
            if to_host:
                self._compute_stream.synchronize()   # only here, at pass end
            else:
                caller.wait_stream(self._compute_stream)
        if not to_host:
            return None, out
        result = out.reshape(-1, p)[: self.n_rows].to("cpu", copy=True)
        return result.numpy(), out

    # -- regime 3: vertical partitioning ------------------------------------
    def column_bytes(self) -> int:
        """Memory cost of one dense column (input slice + output slice)."""
        return 4 * (self.n_rows + self.padded_cols)

    def stream_overhead_bytes(self) -> int:
        """Memory cost of the streaming buffers (one in-flight chunk batch
        per prefetch slot plus the one being consumed)."""
        return self.store.header["record"] * self.cfg.chunk_batch * (
            self.cfg.prefetch + 1)

    def columns_that_fit(self, p_total: int) -> int:
        """How many dense columns fit the memory budget (input slice +
        output slice + one chunk batch of buffers), min 1 (paper: minimum
        memory requirement is O(n) — one column)."""
        fit = (self.cfg.memory_budget_bytes - self.stream_overhead_bytes()
               ) // self.column_bytes()
        return int(max(1, min(p_total, fit)))

    def leftover_budget(self, cols_in_use: int) -> int:
        """Memory budget remaining after ``cols_in_use`` dense columns and
        the streaming buffers are paid for."""
        return max(0, self.cfg.memory_budget_bytes
                   - self.stream_overhead_bytes()
                   - self.column_bytes() * cols_in_use)

    def multiply_external(self, x_store: DenseStore, out_store: DenseStore,
                          cols_in_memory: Optional[int] = None) -> IOStats:
        """A @ X with X on the slow tier: vertical partitioning.  Each slice
        triggers one full streaming pass over the sparse matrix (paper
        §3.6: passes = ceil(p / p_fit)); the accumulator is reused across
        equal-width slices."""
        p_total = x_store.n_cols
        p_fit = cols_in_memory or self.columns_that_fit(p_total)
        acc = None
        for c0 in range(0, p_total, p_fit):
            c1 = min(c0 + p_fit, p_total)
            x_slice = x_store.read_cols(c0, c1)      # slow tier -> memory
            out_slice, acc = self._multiply(x_slice, acc)  # stream A
            out_store.write_cols(c0, out_slice)      # write-once
        out_store.flush()
        return out_store.stats

    @property
    def n_batches(self) -> int:
        """Chunk batches per streaming pass (boundary-hook call count)."""
        return len(self.store.batch_plan(self.cfg.chunk_batch))

    @property
    def io_stats(self) -> IOStats:
        return self.store.stats

    def close(self) -> None:
        """Release the store's file mappings, the IM-mode resident batches,
        the accumulator and the pinned staging buffers.  Idempotent."""
        self._cached = None
        self._acc = None
        for slot in self._slots:
            if slot.event is not None:
                slot.event.synchronize()
            slot.buffers.clear()
        self.store.close()

    def __enter__(self) -> "SEMSpMM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
