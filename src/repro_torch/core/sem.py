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
* **the step is the kernel** — :func:`repro_torch.kernels.ops.spmm_kernel_batch`
  adds each batch into the device-resident accumulator in place.  On
  ``device="cpu"`` the step is the kernel's plain PyTorch version.  The
  lane decode lives beside the kernel
  (``repro_torch.kernels.sem_spmm._decode_lanes``).

The pass is *elastic*: ``multiply(x, boundary_hook=...)`` invokes the hook
at every chunk-batch boundary with a :class:`PassBoundary` through which a
caller may rewrite operand columns mid-pass and read the accumulator's
completed tile-row prefix.

Not in this module yet (see ROADMAP.md): the delta overlay of a mutable
store, semirings other than plus-times, and sharded scans.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.semiring import SEMIRINGS, Semiring
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.io.storage import DenseStore, IOStats, TileStore
from repro_torch.kernels.ops import (pick_variant, spmm_kernel_batch,
                                     to_device)

# Sentinel for "no per-pass cache override": ``None`` must stay expressible
# as "explicitly uncached".
_CACHE_UNSET = object()


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
                 x_pad: torch.Tensor, out: torch.Tensor):
        self.sem = sem
        self.chunk_start = chunk_start
        self.x_pad = x_pad
        self.out = out

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
        blk = self.out[:n_tile_rows, :, c0:c1].to("cpu", copy=True).numpy()
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
        # Staging state on the card: a side stream for the copies and a
        # ring of pinned buffers (one slot per batch in flight).
        self._copy_stream = None
        self._slots: List[_PinnedSlot] = []
        self._next_slot = 0
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [_PinnedSlot() for _ in range(2)]
        if mode == "im":  # IM-SpMM: sparse matrix resident in host memory
            self._cached = list(store.stream(self.cfg.chunk_batch,
                                             use_async=False))

    # -- the pipelined streaming pass ---------------------------------------
    def _use_raw(self) -> bool:
        return self.cfg.decode_on_device and self._cached is None

    def _prepare_x(self, x) -> torch.Tensor:
        """Stage X on the device, padded to the tile grid and relabeled into
        the store's engine column space (optimized stores persist an
        operand permutation; raw stores pass through).  A float32 tensor
        already on the device and padded is taken as it is, uncounted."""
        if isinstance(x, torch.Tensor):
            if x.device == self.device and x.dtype == torch.float32 \
                    and x.shape[0] == self.padded_cols:
                return x
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

    def _make_step(self):
        """Bind the kernel for this pass.  ``x_pad`` is threaded through per
        call (a boundary hook may swap in a same-shape update mid-pass)."""
        variant = self.cfg.kernel_variant or pick_variant(self.T)

        def step(staged, x_pad, out):
            (meta, nv, rows, cols, vals), arrived = staged
            if arrived is not None:
                torch.cuda.current_stream(self.device).wait_event(arrived)
            return spmm_kernel_batch(meta, nv, rows, cols, vals, x_pad, out,
                                     T=self.T, variant=variant,
                                     device=self.device)
        return step

    def _boundary(self, hook, chunk_start: int, x_pad: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
        """Run the boundary hook (if any) before a batch is dispatched;
        returns the possibly-updated operand."""
        if hook is None:
            return x_pad
        b = PassBoundary(self, chunk_start, x_pad, out)
        hook(b)
        return b.x_pad

    def _stream_pass(self, x_pad: torch.Tensor, out: torch.Tensor,
                     hook=None, cache=_CACHE_UNSET) -> torch.Tensor:
        """One full streaming pass of the sparse matrix, accumulated into
        ``out`` in place.  ``cache`` overrides the executor-attached
        hot-chunk cache for this pass only."""
        if self.store.delta_log is not None:
            raise NotImplementedError(
                "a store with a delta log (mutable graph) in the engine: "
                "slice 2, see ROADMAP.md")
        raw = self._use_raw()
        pass_cache = self.cache if cache is _CACHE_UNSET else cache
        batches = (iter(self._cached) if self._cached is not None else
                   self.store.stream(self.cfg.chunk_batch,
                                     prefetch=self.cfg.prefetch,
                                     use_async=self.cfg.use_async,
                                     cache=pass_cache, raw=raw))
        step = self._make_step()
        stats = self.store.stats
        B = self.cfg.chunk_batch
        # Batch boundaries come from the store's plan, not ``i * B``: an
        # optimized store splits batches at encoding-run boundaries.
        starts = [s for s, _ in self.store.batch_plan(B)]
        fragmented = len(starts) > -(-self.store.n_chunks // B)
        batches = (self._pad_tail(batches, pow2=fragmented)
                   if self.cfg.fixed_shape else self._with_valid(batches))
        if not self.cfg.overlap:
            for i, (batch, nv) in enumerate(batches):
                x_pad = self._boundary(hook, starts[i], x_pad, out)
                out = step(self._stage(batch, nv), x_pad, out)
        else:
            pending = None
            for i, (batch, nv) in enumerate(batches):
                staged = self._stage(batch, nv)  # stage k+1 ...
                if pending is not None:
                    j, st_j = pending
                    x_pad = self._boundary(hook, starts[j], x_pad, out)
                    out = step(st_j, x_pad, out)  # ... while k computes
                    stats.add_overlap()
                pending = (i, staged)
            if pending is not None:
                j, st_j = pending
                x_pad = self._boundary(hook, starts[j], x_pad, out)
                out = step(st_j, x_pad, out)
        with self._passes_lock:
            self.passes += 1
        return out

    # -- regime 1/2: X in memory ------------------------------------------
    def multiply(self, x, *, boundary_hook=None, cache=_CACHE_UNSET,
                 semiring: str = "plus_times") -> np.ndarray:
        """A @ X with X (n, p) in memory; returns the result on the host.
        ``boundary_hook`` (optional) is called with a :class:`PassBoundary`
        before each chunk batch.  ``cache`` (optional) overrides the
        attached hot-chunk cache for this pass (``None`` = uncached)."""
        out, _ = self._multiply(x, boundary_hook=boundary_hook, cache=cache,
                                semiring=semiring)
        return out

    def _multiply(self, x, acc: Optional[torch.Tensor] = None,
                  boundary_hook=None, cache=_CACHE_UNSET,
                  semiring: str = "plus_times", to_host: bool = True
                  ) -> Tuple[Optional[np.ndarray], torch.Tensor]:
        """multiply() plus accumulator reuse: a caller looping over slices of
        equal width passes back the returned ``acc``, re-zeroed in place
        here.  ``to_host=False`` skips the read-back (the host result is
        then ``None``) for a caller that keeps working on the device."""
        ring = (semiring if isinstance(semiring, Semiring)
                else SEMIRINGS[semiring])
        if not ring.is_plus_times():
            raise NotImplementedError(
                f"semiring {ring.name!r} in the engine: slice 2, "
                "see ROADMAP.md")
        p = x.shape[1]
        x_pad = self._prepare_x(x)
        if acc is None or acc.shape[2] != p:
            acc = torch.zeros((self.n_tile_rows, self.T, p),
                              dtype=torch.float32, device=self.device)
        else:
            acc.zero_()
        out = self._stream_pass(x_pad, acc, hook=boundary_hook, cache=cache)
        if not to_host:
            return None, out
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # only here, at pass end
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
        """Release the store's file mappings, the IM-mode resident batches
        and the pinned staging buffers.  Idempotent."""
        self._cached = None
        for slot in self._slots:
            if slot.event is not None:
                slot.event.synchronize()
            slot.buffers.clear()
        self.store.close()

    def __enter__(self) -> "SEMSpMM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
