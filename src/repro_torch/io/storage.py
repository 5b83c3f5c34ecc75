"""The semi-external storage tier.

On the paper's machine this is the SSD array; on the GPU it is host DRAM
(or local disk) feeding device memory.  Here it is a file on disk accessed
through ``np.memmap``.  The on-disk format is byte-identical to the JAX
reference package's, so a store written by either package opens in the
other.  The mechanisms reproduced:

* **Sequential streaming** — chunks are laid out in execution order and read
  in large batches (the paper: "large I/O to access matrices on SSDs")
  through one persistent ``np.memmap`` per store; the raw read path returns
  strided uint16 views into the mapping (zero-copy — the SCSR 2-byte index
  width survives until the device-side decode).
* **Buffer pool** — :class:`BufferPool` reproduces the paper's §3.5
  preallocated, reused read buffers (resize a too-small buffer and keep it);
  the memmap read path itself needs no buffers, so the pool survives as a
  standalone mechanism.
* **Asynchronous prefetch with polling** — a background reader thread keeps a
  bounded queue of ready batches ahead of compute; the consumer polls the
  queue (the paper's async I/O + I/O polling, emulated with a thread since
  there is no io_uring guarantee).  The engine's pinned staging buffers and
  side copy stream carry the same overlap one level down, host -> device.
* **Write-once outputs, merged writes** — ``DenseStore.write_rows`` appends
  whole row blocks sequentially; nothing is rewritten.
* **I/O accounting** — byte counters let benchmarks report I/O volume
  (``bytes_read``, ``h2d_bytes``) independently of the machine.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.formats import (ENC_COLS_U8, ENC_FLAT_U16,
                                      ENC_FLAT_U24, ENC_ROWS_U8,
                                      ChunkedTiles, decode_packed_planes,
                                      encode_chunk_planes)


@dataclasses.dataclass
class IOStats:
    """Per-store I/O counters.

    Thread-safe: one store (a replica, or a shard view of it) is read by
    every serving wave that streams it, concurrently — a fleet of
    schedulers over one replica set of the serving runtime updates
    these counters from N wave threads plus their prefetch threads, so
    every mutation takes the instance lock (a plain ``+=`` would drop
    increments under that interleaving).

    ``reads_inflight`` / ``max_reads_inflight`` are the per-replica
    in-flight accounting shared across waves: how many slow-tier reads this
    store is serving *right now* (a gauge), and the high-water mark — the
    direct evidence of whether concurrent waves actually overlapped on this
    spindle or were serialized somewhere above it.
    """
    bytes_read: int = 0
    bytes_written: int = 0
    reads: int = 0
    writes: int = 0
    cache_hits: int = 0
    cache_hit_bytes: int = 0   # bytes served from the hot-chunk cache
                               # instead of the slow tier
    h2d_bytes: int = 0         # host->device bytes staged by the engine
    overlap_batches: int = 0   # batches whose staging overlapped compute
    reads_inflight: int = 0    # slow-tier reads running right now (gauge)
    max_reads_inflight: int = 0  # high-water mark of the gauge

    def __post_init__(self):
        # not a dataclass field: locks are identity objects, not counters —
        # they must stay out of aggregate()'s field walk
        self._lock = threading.Lock()

    def begin_read(self) -> None:
        """Mark a slow-tier read as in flight (call :meth:`end_read` when it
        completes, whatever the outcome)."""
        with self._lock:
            self.reads_inflight += 1
            if self.reads_inflight > self.max_reads_inflight:
                self.max_reads_inflight = self.reads_inflight

    def end_read(self) -> None:
        with self._lock:
            self.reads_inflight -= 1

    def add_read(self, n: int) -> None:
        with self._lock:
            self.bytes_read += n
            self.reads += 1

    def add_write(self, n: int) -> None:
        with self._lock:
            self.bytes_written += n
            self.writes += 1

    def add_cache_hit(self, n: int) -> None:
        with self._lock:
            self.cache_hits += 1
            self.cache_hit_bytes += n

    def add_h2d(self, n: int) -> None:
        with self._lock:
            self.h2d_bytes += n

    def add_overlap(self, n: int = 1) -> None:
        with self._lock:
            self.overlap_batches += n

    @classmethod
    def aggregate(cls, stats: "Iterator[IOStats]") -> "IOStats":
        """Point-in-time field-wise sum (every field, so counters added
        later aggregate without edits at the call sites).  High-water marks
        (``max_*`` fields) take the max instead — summing per-store peaks
        would fabricate a concurrency level no single spindle ever saw."""
        agg = cls()
        for st in stats:
            for f in dataclasses.fields(cls):
                if f.name.startswith("max_"):
                    setattr(agg, f.name,
                            max(getattr(agg, f.name), getattr(st, f.name)))
                else:
                    setattr(agg, f.name,
                            getattr(agg, f.name) + getattr(st, f.name))
        return agg

    # -- wire serialization (cross-host heartbeats) --------------------------
    def to_dict(self) -> dict:
        """Snapshot every counter as a plain ``{name: int}`` dict — the
        JSON-safe form heartbeats carry across hosts.  Taken under the lock
        so a beat never reports a torn read of a mid-update pair (e.g.
        ``reads`` bumped but ``bytes_read`` not yet)."""
        with self._lock:
            return {f.name: int(getattr(self, f.name))
                    for f in dataclasses.fields(type(self))}

    @classmethod
    def from_dict(cls, d: dict) -> "IOStats":
        """Rebuild from :meth:`to_dict` output.  Unknown keys are ignored so
        a newer host's beat parses on an older front door (and vice versa —
        missing keys keep their zero default)."""
        st = cls()
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k in names:
                setattr(st, k, int(v))
        return st

    def merge(self, other) -> "IOStats":
        """Fold another stats snapshot (an :class:`IOStats` or a
        :meth:`to_dict` dict) into this one, in place, with
        :meth:`aggregate`'s semantics: counters add, ``max_*`` high-water
        marks take the max.  Returns ``self`` for chaining — the front door
        folds every host's beat into one cluster-wide view."""
        if isinstance(other, dict):
            other = type(self).from_dict(other)
        with self._lock:
            for f in dataclasses.fields(type(self)):
                mine, theirs = getattr(self, f.name), getattr(other, f.name)
                if f.name.startswith("max_"):
                    setattr(self, f.name, max(mine, theirs))
                else:
                    setattr(self, f.name, mine + theirs)
        return self


class _ReaderFailure:
    """Wrapper carrying an exception from the prefetch thread to the
    consumer (a plain sentinel would be indistinguishable from data)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


# ---------------------------------------------------------------------------
# Mutable graphs: update batches, the delta log, and the graph handle
# ---------------------------------------------------------------------------

#: one delta entry: (row, col, value, version stamp).  Deletions ride as
#: negated values so the binary base path stays binary; the per-entry
#: version stamp makes post-compaction truncation exact (``drop_through``
#: filters entries, not whole segments).
_DELTA_DT = np.dtype([("r", np.int64), ("c", np.int64),
                      ("v", np.float32), ("g", np.int64)])


@dataclasses.dataclass
class UpdateBatch:
    """One batch of edge mutations in *user* coordinates (the matrix the
    caller sees — any column relabel of an optimized store is applied by
    the engine, never by the caller).  ``vals`` are signed: an insert
    contributes ``+w``, a delete ``-w``, so a delete annihilates exactly
    the inserted weight under plus-times and the base store is never
    rewritten on the hot path."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @classmethod
    def insert(cls, rows, cols, vals=None) -> "UpdateBatch":
        rows = np.ascontiguousarray(np.asarray(rows, np.int64).ravel())
        cols = np.ascontiguousarray(np.asarray(cols, np.int64).ravel())
        vals = (np.ones(rows.shape[0], np.float32) if vals is None else
                np.ascontiguousarray(np.asarray(vals, np.float32).ravel()))
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError(
                f"update planes disagree: rows {rows.shape}, "
                f"cols {cols.shape}, vals {vals.shape}")
        return cls(rows, cols, vals)

    @classmethod
    def delete(cls, rows, cols, vals=None) -> "UpdateBatch":
        """Delete edges carrying weight ``vals`` (default 1 — the binary
        case).  The delete must name the weight being removed: the log is
        additive, so removing edge ``(r, c, w)`` appends ``(r, c, -w)``."""
        b = cls.insert(rows, cols, vals)
        return cls(b.rows, b.cols, -b.vals)

    @classmethod
    def concat(cls, batches: "Sequence[UpdateBatch]") -> "UpdateBatch":
        return cls(np.concatenate([b.rows for b in batches]),
                   np.concatenate([b.cols for b in batches]),
                   np.concatenate([b.vals for b in batches]))

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    # -- wire form (the ``update`` RPC) --------------------------------------
    def to_wire(self) -> Tuple[dict, List[np.ndarray]]:
        return {"n": len(self)}, [np.ascontiguousarray(self.rows),
                                  np.ascontiguousarray(self.cols),
                                  np.ascontiguousarray(self.vals)]

    @classmethod
    def from_wire(cls, header: dict, planes: List[np.ndarray]
                  ) -> "UpdateBatch":
        if len(planes) != 3:
            raise ValueError(
                f"update wire form carries 3 planes (rows, cols, vals), "
                f"got {len(planes)}")
        b = cls(np.asarray(planes[0], np.int64).ravel(),
                np.asarray(planes[1], np.int64).ravel(),
                np.asarray(planes[2], np.float32).ravel())
        if not (b.rows.shape == b.cols.shape == b.vals.shape) \
                or len(b) != int(header.get("n", len(b))):
            raise ValueError("malformed update planes")
        return b


class DeltaLog:
    """Log-structured edge-delta overlay over an immutable base store.

    Appended :class:`UpdateBatch` segments accumulate in memory and spill
    to one on-disk file (``spill_path``, reopened ``mmap_mode='r'``) once
    their resident bytes pass ``memory_budget_bytes`` — the log never
    forces the base's O(E) into host RAM.  Every append bumps the
    monotonic ``version``; every entry is stamped with the version that
    introduced it, so :meth:`drop_through` (compaction truncation) is
    exact even when updates landed while the compactor ran.

    :meth:`snapshot` is the read side: the consolidated, row-sorted,
    duplicate-summed, zero-free COO view the engine scatters per pass —
    cached per version, recomputed only after a mutation.  All methods are
    thread-safe (serving waves snapshot while a front door appends)."""

    def __init__(self, *, memory_budget_bytes: int = 64 << 20,
                 spill_path: Optional[str] = None):
        self.memory_budget_bytes = int(memory_budget_bytes)
        self.spill_path = (None if spill_path is None else
                           (spill_path if spill_path.endswith(".npy")
                            else spill_path + ".npy"))
        self.version = 0
        self.spills = 0
        self.has_deletes = False
        self._segments: List[np.ndarray] = []
        self._lock = threading.RLock()
        self._snap: Optional[Tuple] = None

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(int(s.nbytes) for s in self._segments)

    @property
    def nnz(self) -> int:
        """Live (consolidated, non-cancelled) delta entries."""
        return self.snapshot()[1].shape[0]

    def append(self, batch: UpdateBatch) -> int:
        """Append one update batch; returns the new version."""
        with self._lock:
            self.version += 1
            seg = np.empty(len(batch), _DELTA_DT)
            seg["r"], seg["c"] = batch.rows, batch.cols
            seg["v"], seg["g"] = batch.vals, self.version
            self._segments.append(seg)
            if bool((batch.vals < 0).any()):
                self.has_deletes = True
            self._snap = None
            if (self.spill_path is not None
                    and self.nbytes > self.memory_budget_bytes):
                self._spill()
            return self.version

    def _spill(self) -> None:
        # one consolidated file, reloaded as a read-only map: the log's
        # resident footprint drops to the page cache's discretion
        merged = np.concatenate([np.asarray(s) for s in self._segments])
        np.save(self.spill_path, merged)
        self._segments = [np.load(self.spill_path, mmap_mode="r")]
        self.spills += 1

    def snapshot(self) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        """``(version, rows, cols, vals)`` — consolidated user-space COO,
        lexsorted by (row, col), duplicates summed, exact-zero (cancelled)
        entries dropped.  The tuple is immutable and cached: a pass that
        snapshots at its start stays internally consistent however many
        appends land mid-pass."""
        with self._lock:
            if self._snap is not None:
                return self._snap
            total = sum(s.shape[0] for s in self._segments)
            if total == 0:
                self._snap = (self.version, np.zeros(0, np.int64),
                              np.zeros(0, np.int64), np.zeros(0, np.float32))
                return self._snap
            a = np.concatenate([np.asarray(s) for s in self._segments])
            r, c, v = (a["r"].astype(np.int64), a["c"].astype(np.int64),
                       a["v"].astype(np.float32))
            order = np.lexsort((c, r))
            r, c, v = r[order], c[order], v[order]
            new = np.ones(r.shape[0], bool)
            new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
            starts = np.flatnonzero(new)
            v = np.add.reduceat(v, starts).astype(np.float32)
            r, c = r[starts], c[starts]
            keep = v != 0.0
            self._snap = (self.version, np.ascontiguousarray(r[keep]),
                          np.ascontiguousarray(c[keep]),
                          np.ascontiguousarray(v[keep]))
            return self._snap

    def drop_through(self, version: int) -> None:
        """Discard every entry introduced at or before ``version`` — they
        are merged into the installed base generation.  Entries stamped
        later survive verbatim (per-entry stamps, not per-segment)."""
        with self._lock:
            segs = [np.asarray(s)[np.asarray(s)["g"] > version]
                    for s in self._segments]
            self._segments = [s for s in segs if s.size]
            self.has_deletes = any(bool((s["v"] < 0).any())
                                   for s in self._segments)
            self._snap = None


class GraphHandle:
    """A versioned mutable graph: one shared :class:`DeltaLog` over one or
    more attached base :class:`TileStore` replicas.

    The handle is the mutation surface's anchor (``apply_updates`` →
    version) and the compaction arbiter: :meth:`compact_async` rebuilds
    ``base ⊕ delta`` into a new base generation on a background thread
    while serving continues against the old base, and :meth:`try_install`
    atomically adopts the rebuilt store on every attached replica —
    refused while any pass streams the old layout (``begin_pass`` /
    ``end_pass`` bracket each engine pass) or while a layout consumer
    holds a pin (shard views: :meth:`pin_layout`).  Installation then
    truncates the log through the compacted version, so the overlay
    converges to empty under a finite update stream.

    Shard views created by :meth:`TileStore.partition_rows` delegate
    ``delta_log`` / ``handle`` to their parent, so attaching the parent is
    enough — slab scans and sharded engines see updates immediately."""

    def __init__(self, stores, *, delta_memory_budget_bytes: int = 64 << 20,
                 spill_path: Optional[str] = None):
        if isinstance(stores, TileStore):
            stores = [stores]
        if not stores:
            raise ValueError("a GraphHandle needs at least one base store")
        self.delta = DeltaLog(memory_budget_bytes=delta_memory_budget_bytes,
                              spill_path=spill_path)
        self.stores: List[TileStore] = []
        self._lock = threading.Lock()
        self._active = 0
        self._pins = 0
        self._compactor: Optional[threading.Thread] = None
        self._built: Optional[Tuple[int, str]] = None
        self.compactions = 0
        self.installs = 0
        self.generation = 0
        self.compact_error: Optional[BaseException] = None
        for s in stores:
            self.attach(s)

    def attach(self, store: "TileStore") -> None:
        if store.chunk_offset or store.tile_row_offset or store.row_offset:
            raise ValueError(
                "attach whole stores, not shard views (shards delegate "
                "to their parent's handle)")
        store.delta_log = self.delta
        store.handle = self
        self.stores.append(store)

    # -- the mutation surface ------------------------------------------------
    @property
    def version(self) -> int:
        return self.delta.version

    @property
    def delta_nnz(self) -> int:
        return self.delta.nnz

    @property
    def compacting(self) -> bool:
        """Whether a background rebuild is currently running."""
        t = self._compactor
        return t is not None and t.is_alive()

    def apply_updates(self, batch: UpdateBatch) -> int:
        """Append one update batch; returns the new monotonic version.
        Coordinates are validated against the base shape here — an
        out-of-range row or column would silently corrupt the engine's
        device scatter, so it must fail loudly at the door."""
        h = self.stores[0].header
        if len(batch):
            if int(batch.rows.min()) < 0 \
                    or int(batch.rows.max()) >= h["n_rows"]:
                raise ValueError(
                    f"update rows out of range [0, {h['n_rows']})")
            if int(batch.cols.min()) < 0 \
                    or int(batch.cols.max()) >= h["n_cols"]:
                raise ValueError(
                    f"update cols out of range [0, {h['n_cols']})")
        return self.delta.append(batch)

    # -- pass / layout bracketing --------------------------------------------
    def begin_pass(self) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        """Mark a streaming pass in flight and return the delta snapshot it
        must apply — installation waits for :meth:`end_pass`."""
        with self._lock:
            self._active += 1
        return self.delta.snapshot()

    def end_pass(self) -> None:
        with self._lock:
            self._active -= 1

    def pin_layout(self) -> None:
        """A consumer holds derived layout state (shard views' chunk
        ranges, tags, offsets); installation is refused until unpinned."""
        with self._lock:
            self._pins += 1

    def unpin_layout(self) -> None:
        with self._lock:
            self._pins -= 1

    # -- compaction ----------------------------------------------------------
    def compact_async(self) -> bool:
        """Kick a background rebuild of ``base ⊕ delta`` (no-op if one is
        already running, already built, or the log is empty).  Returns
        whether a compactor was started."""
        with self._lock:
            if self._compactor is not None and self._compactor.is_alive():
                return False
            if self._built is not None or self.delta.nnz == 0:
                return False
            t = threading.Thread(target=self._compact_job, daemon=True,
                                 name="graph-compactor")
            self._compactor = t
        t.start()
        return True

    def _compact_job(self) -> None:
        try:
            self.compact()
        except BaseException as e:  # noqa: BLE001 — surfaced on install
            self.compact_error = e

    def compact(self, out_path: Optional[str] = None) -> Optional[str]:
        """Synchronously rebuild the base ⊕ delta merge at the current
        version into a new store file (default ``{base}.g{generation+1}``).
        Streams one tile row at a time — O(tile row) host memory, like
        :meth:`TileStore.optimize`.  The rebuilt store is *staged*, not
        live: :meth:`try_install` adopts it between passes."""
        snap = self.delta.snapshot()
        if snap[1].size == 0:
            return None
        base = self.stores[0]
        out_path = out_path or f"{base.path}.g{self.generation + 1}"
        st = _merge_rebuild(base, snap, out_path)
        st.close()
        with self._lock:
            self._built = (snap[0], out_path)
        self.compactions += 1
        return out_path

    def try_install(self) -> bool:
        """Adopt the staged rebuilt store on every attached replica and
        truncate the log through the compacted version — only when no pass
        is in flight and no layout pin is held (call between passes; the
        scheduler does, at ``run_pass`` entry).  Returns whether the
        install happened."""
        if self.compact_error is not None:
            err, self.compact_error = self.compact_error, None
            raise RuntimeError("background compaction failed") from err
        with self._lock:
            if self._built is None or self._active or self._pins:
                return False
            ver, path = self._built
            with open(path + ".json") as f:
                header = json.load(f)
            for s in self.stores:
                s._adopt_generation(path, dict(header))
            self.generation += 1
            self.delta.drop_through(ver)
            self._built = None
            self.installs += 1
            return True


def _merge_rebuild(base: "TileStore", snap, out_path: str) -> "TileStore":
    """Stream ``base ⊕ delta`` into a new optimized store: per tile row,
    merge the base's decoded entries with the delta slice (delta columns
    relabeled into the base's engine column space), sum duplicates, drop
    exact zeros, and emit through the incremental writer.  Bit-identity
    target: ``stream(base ⊕ delta) == stream(rebuilt)`` under exact
    arithmetic (the accumulation grouping changes, the values do not)."""
    _, drows, dcols, dvals = snap
    h = base.header
    T = h["T"]
    binary = bool(h["binary"])
    perm = base.col_perm()
    if perm is not None:
        rank = np.empty_like(perm)
        rank[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
        dcols = rank[dcols].astype(np.int64)
    writer = _OptimizedWriter(
        out_path, n_rows=h["n_rows"], n_cols=h["n_cols"], T=T, C=h["C"],
        binary=binary, pack=base.meta_ints == 6, col_perm=perm)
    for trow, br, bc, bv in base.iter_tile_row_entries():
        lo = int(np.searchsorted(drows, trow * T))
        hi = int(np.searchsorted(drows, (trow + 1) * T))
        if hi > lo:
            r = np.concatenate([br, drows[lo:hi]])
            c = np.concatenate([bc, dcols[lo:hi]])
            v = np.concatenate([bv, dvals[lo:hi]])
            order = np.lexsort((c, r))
            r, c, v = r[order], c[order], v[order]
            new = np.ones(r.shape[0], bool)
            new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
            starts = np.flatnonzero(new)
            v = np.add.reduceat(v, starts).astype(np.float32)
            r, c = r[starts], c[starts]
            keep = v != 0.0
            r, c, v = r[keep], c[keep], v[keep]
            if binary and r.size and not bool((v == 1.0).all()):
                raise ValueError(
                    "compaction would leave a binary store non-binary: "
                    "insert only absent edges / delete only present ones "
                    "on binary graphs")
        else:
            r, c, v = br, bc, bv
        writer.put_tile_row(trow, r, c, v)
    return writer.finalize()


class BufferPool:
    """Reusable read buffers (paper §3.5: avoid repeated large allocations;
    resize a previously allocated buffer if too small)."""

    def __init__(self, n_buffers: int = 4):
        self._free: List[np.ndarray] = []
        self._n = n_buffers
        self.allocations = 0

    def get(self, nbytes: int) -> np.ndarray:
        buf = self._free.pop() if self._free else None
        if buf is None or buf.nbytes < nbytes:
            self.allocations += 1
            buf = np.empty(nbytes, dtype=np.uint8)
        return buf

    def put(self, buf: np.ndarray) -> None:
        if len(self._free) < self._n:
            self._free.append(buf)


class TileStore:
    """On-"SSD" chunked sparse matrix.

    Layout: a JSON header file plus one binary file holding, per chunk and in
    execution order: ``meta`` int32[meta_ints], ``row_local``, ``col_local``,
    ``vals`` f32[C] (omitted for binary matrices — the 2-byte index width is
    the SCSR I/O-volume saving carried over).

    A legacy (raw) store has ``meta_ints == 4`` and uint16 index planes.  An
    *optimized* store (see :meth:`optimize`) has ``meta_ints == 6`` — meta
    columns 4/5 carry the chunk's (row, col) delta bases — and a per-chunk
    encoding tag (``header["encodings"]``, the ``ENC_*`` bits from
    ``core.formats``): tagged planes are stored as uint8 deltas and decoded
    on device inside the batch kernel.  Raw and packed chunks mix freely in
    one store; :meth:`batch_plan` splits a pass into tag-homogeneous read
    batches so every read stays a zero-copy strided view.
    """

    def __init__(self, path: str, header: dict, *, chunk_offset: int = 0,
                 tile_row_offset: int = 0, row_offset: int = 0,
                 tags: Optional[np.ndarray] = None,
                 offsets: Optional[np.ndarray] = None):
        self.path = path
        self.header = header
        self.stats = IOStats()
        self._mm: Optional[np.memmap] = None
        self._perm: Optional[np.ndarray] = None
        # Shard views (see :meth:`partition_rows`) share the backing file but
        # cover a contiguous chunk range; offsets are 0 for a whole store.
        self.chunk_offset = chunk_offset
        self.tile_row_offset = tile_row_offset
        self.row_offset = row_offset
        self.meta_ints = int(header.get("meta_ints", 4))
        if tags is None:
            # Whole-store open: derive the per-chunk encoding tags and byte
            # offsets from the header.  Shard views receive the parent's
            # arrays instead (their header keeps the full-store encoding
            # list, but their chunk range is a slice of it).
            enc = header.get("encodings")
            tags = (np.zeros(header["n_chunks"], np.uint8) if enc is None
                    else np.asarray(enc, np.uint8))
        if offsets is None:
            sizes = np.array([self._rec_of(t) for t in range(4)],
                             np.int64)[tags]
            offsets = np.zeros(tags.shape[0] + 1, np.int64)
            np.cumsum(sizes, out=offsets[1:])
        self._tags = tags
        self._offsets = offsets
        # Per-store encoding signature carried in cache keys: replicas of
        # one optimized store share pins (identical tag sequences), but a
        # raw pin is never served to a reader of the re-encoded store.
        self._enc_sig = (self.meta_ints, zlib.crc32(tags.tobytes()))
        # Mutable-graph state: a frozen store carries none of it.  The
        # delta log / handle are attached by a GraphHandle; shard views
        # delegate to their parent (``_delta_src``) so an attach after the
        # shards were cut still reaches them.  ``generation`` counts
        # in-place base rewrites (compaction installs) — it rides cache
        # keys next to the logical version because a rebuilt base can
        # carry identical encoding tags over different payload bytes.
        self._delta_log: Optional[DeltaLog] = None
        self._handle: Optional["GraphHandle"] = None
        self._delta_src: Optional["TileStore"] = None
        self.generation = 0

    # -- construction --------------------------------------------------------
    @classmethod
    def write(cls, path: str, ct: ChunkedTiles, binary: bool = False
              ) -> "TileStore":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        C = ct.C
        rec = cls._record_bytes(C, binary)
        with open(path + ".bin", "wb") as f:
            for i in range(ct.n_chunks):
                f.write(ct.meta[i].astype(np.int32).tobytes())
                f.write(ct.row_local[i].astype(np.uint16).tobytes())
                f.write(ct.col_local[i].astype(np.uint16).tobytes())
                if not binary:
                    f.write(ct.vals[i].astype(np.float32).tobytes())
        header = dict(n_rows=ct.n_rows, n_cols=ct.n_cols, T=ct.T, C=C,
                      n_chunks=ct.n_chunks, binary=binary, record=rec)
        with open(path + ".json", "w") as f:
            json.dump(header, f)
        st = cls(path, header)
        st.stats.add_write(rec * ct.n_chunks)
        return st

    @classmethod
    def write_optimized(cls, path: str, ct: ChunkedTiles,
                        binary: bool = False, *, pack: bool = True,
                        col_perm: Optional[np.ndarray] = None
                        ) -> "TileStore":
        """Write ``ct`` with the per-chunk uint8 delta encoding wherever a
        plane's deltas fit a byte (``pack=False`` keeps every chunk raw —
        the reorder-only ablation).  ``col_perm`` (the operand relabel:
        ``x_engine = x[col_perm]``) is persisted next to the store."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        C = ct.C
        tags, bases, rows_hi, cols_lo = encode_chunk_planes(
            ct.meta, ct.row_local, ct.col_local, ct.T)
        if not pack:
            tags = np.zeros_like(tags)
        elif ct.n_chunks:
            # Batch plans split at tag-run boundaries so every transfer has
            # uniform plane dtypes.  An isolated 16-bit chunk between 24-bit
            # runs would cost two extra splits (and their padded tails) to
            # save C bytes — demote it to the 24-bit mode instead: the
            # flattened-delta decode is identical, the row plane just rides
            # along as uint16.
            left = np.concatenate([[0], tags[:-1]])
            right = np.concatenate([tags[1:], [0]])
            iso = ((tags == ENC_FLAT_U16)
                   & (left != ENC_FLAT_U16) & (right != ENC_FLAT_U16)
                   & ((left == ENC_FLAT_U24) | (right == ENC_FLAT_U24)))
            tags = np.where(iso, ENC_FLAT_U24, tags).astype(np.uint8)
        meta6 = np.zeros((ct.n_chunks, 6), np.int32)
        meta6[:, :4] = ct.meta
        meta6[:, 4:6] = bases
        with open(path + ".bin", "wb") as f:
            for i in range(ct.n_chunks):
                t = int(tags[i])
                f.write(meta6[i].tobytes())
                # packed chunks store dk >> 8 in the row plane (uint8 in
                # the 16-bit mode, uint16 in the 24-bit mode) and dk & 255
                # in the column plane; raw chunks keep the u16 coordinates
                if t & ENC_ROWS_U8:
                    f.write(rows_hi[i].astype(np.uint8).tobytes())
                elif t:
                    f.write(rows_hi[i].tobytes())
                else:
                    f.write(ct.row_local[i].astype(np.uint16).tobytes())
                f.write(cols_lo[i].tobytes() if t & ENC_COLS_U8 else
                        ct.col_local[i].astype(np.uint16).tobytes())
                if not binary:
                    f.write(ct.vals[i].astype(np.float32).tobytes())
        # ``record`` stays the worst-case (all-raw) chunk size: the engine's
        # stream-buffer budget accounting wants a conservative per-chunk
        # bound, not the (variable) actual sizes.
        header = dict(n_rows=ct.n_rows, n_cols=ct.n_cols, T=ct.T, C=C,
                      n_chunks=ct.n_chunks, binary=binary,
                      record=cls._record_bytes(C, binary) + 8,
                      meta_ints=6, encodings=[int(t) for t in tags],
                      col_perm=col_perm is not None)
        with open(path + ".json", "w") as f:
            json.dump(header, f)
        if col_perm is not None:
            # int32 halves the sidecar: the permutation is O(V) next to the
            # store's O(E), and V < 2**31 for every graph the engine addresses
            np.save(path + ".perm.npy", np.asarray(col_perm, np.int32))
        st = cls(path, header)
        st.stats.add_write(st.nbytes)
        return st

    def optimize(self, out_path: str, *, reorder: bool = True,
                 pack: bool = True) -> "TileStore":
        """Offline re-encode into a smaller store at ``out_path``.

        ``reorder=True`` relabels the *operand (column) dimension* degree-
        descending (:func:`repro_torch.sparse.graph.degree_order`): hub columns
        cluster at small in-tile indices, which both densifies tiles (fewer
        partial chunks) and pulls the column deltas into uint8 range.  The
        output row space is untouched, so results need no un-permute and
        the whole serving stack (elastic stitching, sharding, replicas,
        the wire protocol) runs unchanged; the engine relabels the operand
        at staging time from the persisted permutation.  Row-side
        reordering would change the accumulator's tile-row prefix
        semantics — see ROADMAP ("arrow-style reordering").

        ``pack=True`` stores each index plane as uint8 deltas where they
        fit (per-chunk, per-plane tags).  With ``reorder=False`` the chunk
        layout is byte-for-byte the raw store's modulo encoding, so results
        are unconditionally bit-identical; with ``reorder=True`` the
        accumulation grouping changes, so bit-identity holds under exact
        (e.g. integer-valued) arithmetic.
        """
        if self.chunk_offset:
            raise ValueError("optimize() works on whole stores, not shards")
        h = self.header
        T = h["T"]
        lanes = np.arange(h["C"])[None, :]
        perm = rank = None
        if reorder:
            # Pass 1: column degrees only — O(n_cols) host memory.  The
            # accumulated bincount equals degree_order()'s bincount over
            # the materialized COO, so the permutation is unchanged.
            deg = np.zeros(h["n_cols"], np.int64)
            for s, n in self.batch_plan(256):
                m, r, c, v = self.read_batch(s, n)
                gc = (m[:, 1:2].astype(np.int64) * T + c)[lanes < m[:, 3:4]]
                deg += np.bincount(gc, minlength=h["n_cols"])
            perm = np.argsort(-deg, kind="stable").astype(np.int64)
            rank = np.empty_like(perm)
            rank[perm] = np.arange(h["n_cols"])
        # Pass 2: one tile row of entries in memory at a time, emitted
        # through the incremental writer (which buffers a single chunk for
        # the iso-demotion lookahead) — never the whole COO.
        writer = _OptimizedWriter(
            out_path, n_rows=h["n_rows"], n_cols=h["n_cols"], T=T,
            C=h["C"], binary=h["binary"], pack=pack, col_perm=perm)
        for trow, rows, cols, vals in self.iter_tile_row_entries():
            if rank is not None:
                cols = rank[cols]
            writer.put_tile_row(trow, rows, cols, vals)
        return writer.finalize(store_cls=type(self))

    def iter_tile_row_entries(self, batch: int = 256
                              ) -> Iterator[Tuple[int, np.ndarray,
                                                  np.ndarray, np.ndarray]]:
        """Stream this store one *tile row* at a time: yields
        ``(tile_row, rows, cols, vals)`` for every tile row in order
        (empty tile rows yield empty arrays), coordinates global in this
        store's frame, vals f32 (synthesized ones for binary stores).
        Host memory is O(one tile row + one read batch) — the foundation
        of the streaming :meth:`optimize` and of compaction."""
        h = self.header
        T = h["T"]
        ntr = -(-h["n_rows"] // T)
        lanes = np.arange(h["C"])[None, :]
        pend: dict = {}
        cur = 0

        def pop(t):
            parts = pend.pop(t, None)
            if not parts:
                return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.float32))
            return tuple(np.concatenate([p[i] for p in parts])
                         for i in range(3))

        for s, n in self.batch_plan(batch):
            m, r, c, v = self.read_batch(s, n)
            # chunks ascend in tile row, so everything below this batch's
            # first chunk's row is complete — flush it
            first = int(m[0, 0])
            while cur < first:
                yield (cur, *pop(cur))
                cur += 1
            valid = lanes < m[:, 3:4]
            gr = m[:, 0:1].astype(np.int64) * T + r
            gc = m[:, 1:2].astype(np.int64) * T + c
            for i in range(n):
                vi = valid[i]
                pend.setdefault(int(m[i, 0]), []).append(
                    (gr[i][vi], gc[i][vi], v[i][vi]))
        while cur < ntr:
            yield (cur, *pop(cur))
            cur += 1

    # -- operand permutation (optimized stores) ------------------------------
    def col_perm(self) -> Optional[np.ndarray]:
        """The persisted operand relabel of an optimized store
        (``x_engine = x[perm]``), or None for raw stores."""
        if not self.header.get("col_perm"):
            return None
        if self._perm is None:
            self._perm = np.load(self.path + ".perm.npy")
        return self._perm

    def apply_col_perm(self, x: np.ndarray) -> np.ndarray:
        """Relabel an operand (rows = columns of the stored matrix) into
        this store's engine column space; no-op for raw stores.  ``x`` may
        be padded beyond ``n_cols`` — padding rows map to themselves."""
        perm = self.col_perm()
        if perm is None:
            return x
        x = np.asarray(x)
        out = x.copy()
        out[: perm.shape[0]] = x[perm]
        return out

    @classmethod
    def open(cls, path: str) -> "TileStore":
        with open(path + ".json") as f:
            return cls(path, json.load(f))

    @classmethod
    def open_replicas(cls, paths: "Sequence[str]") -> List["TileStore"]:
        """Open N copies of the same logical matrix (e.g. per-NUMA/per-SSD
        paths) and validate they really are replicas; see
        :func:`validate_replicas`."""
        stores = [cls.open(p) for p in paths]
        validate_replicas(stores)
        return stores

    @staticmethod
    def _record_bytes(C: int, binary: bool) -> int:
        return 16 + 2 * C + 2 * C + (0 if binary else 4 * C)

    def _rec_of(self, tag: int) -> int:
        """On-disk bytes of one chunk with encoding ``tag`` (ENC_* bits):
        a tagged index plane is uint8 deltas, an untagged one raw uint16;
        values are never packed."""
        C = self.header["C"]
        wr = 1 if tag & ENC_ROWS_U8 else 2
        wc = 1 if tag & ENC_COLS_U8 else 2
        return (4 * self.meta_ints + (wr + wc) * C
                + (0 if self.header["binary"] else 4 * C))

    @property
    def n_chunks(self) -> int:
        return self.header["n_chunks"]

    @property
    def nbytes(self) -> int:
        co = self.chunk_offset
        return int(self._offsets[co + self.n_chunks] - self._offsets[co])

    def range_nbytes(self, start: int, count: int) -> int:
        """On-disk bytes of ``count`` chunks starting at ``start`` (this
        store's frame) — per-chunk records vary with the encoding tag."""
        g0 = self.chunk_offset + start
        return int(self._offsets[g0 + count] - self._offsets[g0])

    # -- mutable-graph surface (delta overlay + generations) -----------------
    @property
    def delta_log(self) -> Optional[DeltaLog]:
        """The attached delta overlay, or None for a frozen store.  Shard
        views delegate to their parent so an attach after sharding still
        reaches every view."""
        if self._delta_src is not None:
            return self._delta_src.delta_log
        return self._delta_log

    @delta_log.setter
    def delta_log(self, dl: Optional[DeltaLog]) -> None:
        self._delta_log = dl

    @property
    def handle(self) -> Optional["GraphHandle"]:
        if self._delta_src is not None:
            return self._delta_src.handle
        return self._handle

    @handle.setter
    def handle(self, h: Optional["GraphHandle"]) -> None:
        self._handle = h

    @property
    def version(self) -> int:
        """The graph's logical version: 0 for a frozen store, else the
        delta log's monotonic counter.  Host-identical across replicas
        applying the same update sequence (unlike ``generation``, which
        counts this store's local base rewrites)."""
        dl = self.delta_log
        return 0 if dl is None else dl.version

    def nnz(self) -> int:
        """Stored entries (base store only, not the delta overlay) — the
        compaction trigger compares the overlay's size against this."""
        if self.n_chunks == 0:
            return 0
        mm = self._memmap()
        co = self.chunk_offset
        off = self._offsets[co:co + self.n_chunks]
        meta = mm[off[:, None] + np.arange(16)].view(np.int32)
        return int(meta[:, 3].astype(np.int64).sum())

    def _adopt_generation(self, path: str, header: dict) -> None:
        """Swap this (whole) store onto a rebuilt backing file in place —
        the compaction install.  Re-derives every layout-dependent field
        exactly like ``__init__``; counters (``stats``) and the attached
        delta log survive.  Shard views cannot adopt (their chunk ranges
        index the old layout) — that is what ``GraphHandle.pin_layout``
        guards."""
        if self.chunk_offset or self.tile_row_offset or self.row_offset:
            raise ValueError("only whole stores adopt a new generation")
        old, new = self.header, header
        for k in ("n_rows", "n_cols", "T", "C", "binary"):
            if old[k] != new[k]:
                raise ValueError(
                    f"generation header mismatch on {k!r}: "
                    f"{old[k]} -> {new[k]}")
        self.close()
        self.path = path
        self.header = header
        self.meta_ints = int(header.get("meta_ints", 4))
        self._perm = None
        enc = header.get("encodings")
        tags = (np.zeros(header["n_chunks"], np.uint8) if enc is None
                else np.asarray(enc, np.uint8))
        sizes = np.array([self._rec_of(t) for t in range(4)],
                         np.int64)[tags]
        offsets = np.zeros(tags.shape[0] + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        self._tags = tags
        self._offsets = offsets
        self._enc_sig = (self.meta_ints, zlib.crc32(tags.tobytes()))
        self.generation += 1

    def batch_plan(self, batch: int) -> List[Tuple[int, int]]:
        """Split this store's chunk range into ``(start, count)`` read
        batches of at most ``batch`` chunks, each encoding-homogeneous so
        :meth:`read_batch_raw` stays one zero-copy strided view.  A raw
        store (one tag everywhere) gets exactly the classic
        ``range(0, n_chunks, batch)`` plan; mixed stores split batches at
        tag-run boundaries."""
        n = self.n_chunks
        co = self.chunk_offset
        t = self._tags[co:co + n]
        run_starts = np.flatnonzero(np.diff(t.astype(np.int16))) + 1
        bounds = [0, *run_starts.tolist(), n]
        plan: List[Tuple[int, int]] = []
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            for s in range(r0, r1, batch):
                plan.append((s, min(batch, r1 - s)))
        return plan

    # -- sequential batched reads --------------------------------------------
    def _memmap(self) -> np.memmap:
        """Persistent read-only byte map of the backing file (opened once per
        store, not once per batch)."""
        if self._mm is None:
            self._mm = np.memmap(self.path + ".bin", dtype=np.uint8, mode="r")
        return self._mm

    def close(self) -> None:
        """Drop the persistent memmap (the file mapping, and with it the
        page-cache pin on the backing file).  Safe to call on a live store:
        the next read lazily remaps — close() releases resources, it does
        not poison the handle."""
        self._mm = None

    def __enter__(self) -> "TileStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def read_batch_raw(self, start: int, count: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  Optional[np.ndarray]]:
        """Zero-copy read of ``count`` chunks starting at ``start``: returns
        (meta (count, meta_ints) i32, rows (count,C) u16-or-u8 view,
        cols (count,C) u16-or-u8 view, vals (count,C) f32 view — or ``None``
        for a binary matrix).

        rows/cols/vals are strided views straight into the file mapping — no
        host-side upcast, unpack, or repack; the stored index width (uint16
        SCSR, or uint8 deltas in an optimized store) survives until the
        device decode.  Only ``meta`` is copied (it is tens of bytes per
        chunk and shard views rebase its tile-row ids).  The range must be
        encoding-homogeneous — :meth:`batch_plan` produces exactly such
        ranges; a mixed range cannot be one strided view and is an error.
        """
        h = self.header
        C = h["C"]
        g0 = self.chunk_offset + start
        tag = int(self._tags[g0]) if count else 0
        if count and (self._tags[g0:g0 + count] != tag).any():
            raise ValueError(
                f"chunk range [{start}, {start + count}) mixes encodings; "
                "read tag-homogeneous ranges (see batch_plan())")
        rec = self._rec_of(tag)
        mm = self._memmap()
        off = int(self._offsets[g0])
        nbytes = rec * count
        if count:
            # Touch one byte per page so the disk I/O happens *here* (inside
            # the prefetch thread under stream()), not lazily at staging
            # time.  The strided walk can step over the final page when
            # ``off`` is not page-aligned — touch the last byte explicitly.
            # The in-flight gauge brackets exactly this window: it is the
            # slow-tier access concurrent waves contend over.
            self.stats.begin_read()
            try:
                int(np.add.reduce(mm[off:off + nbytes:4096], dtype=np.int64))
                int(mm[off + nbytes - 1])
            finally:
                self.stats.end_read()
        self.stats.add_read(nbytes)
        mb = 4 * self.meta_ints
        meta = np.ndarray((count, self.meta_ints), np.int32, buffer=mm,
                          offset=off, strides=(rec, 4)).copy()
        if self.tile_row_offset:
            meta[:, 0] -= self.tile_row_offset
        wr = 1 if tag & ENC_ROWS_U8 else 2
        wc = 1 if tag & ENC_COLS_U8 else 2
        rows = np.ndarray((count, C), np.uint8 if wr == 1 else np.uint16,
                          buffer=mm, offset=off + mb, strides=(rec, wr))
        cols = np.ndarray((count, C), np.uint8 if wc == 1 else np.uint16,
                          buffer=mm, offset=off + mb + wr * C,
                          strides=(rec, wc))
        vals = None
        if not h["binary"]:
            vals = np.ndarray((count, C), np.float32, buffer=mm,
                              offset=off + mb + (wr + wc) * C,
                              strides=(rec, 4))
        return meta, rows, cols, vals

    def read_batch(self, start: int, count: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Decoded read: ``count`` chunks from ``start`` as
        (meta (count, meta_ints) i32, rows (count,C) i32, cols (count,C)
        i32, vals (count,C) f32) — the host-decoded path kept for IM
        caching and as the engine ablation baseline.  Delta-packed planes
        are unpacked here with the same integer arithmetic the device
        decode uses, so both paths yield bitwise-equal planes."""
        meta, rows16, cols16, vals = self.read_batch_raw(start, count)
        if rows16.dtype == np.uint8 or cols16.dtype == np.uint8:
            rows, cols = decode_packed_planes(meta, rows16, cols16,
                                              self.header["T"])
        else:
            rows = rows16.astype(np.int32)
            cols = cols16.astype(np.int32)
        if vals is None:
            vals = np.ones((count, self.header["C"]), np.float32)
            lanes = np.arange(self.header["C"])[None, :]
            vals[lanes >= meta[:, 3:4]] = 0.0
        else:
            vals = np.ascontiguousarray(vals)
        return meta, rows, cols, vals

    def _fetch(self, start: int, count: int, cache, raw: bool = False
               ) -> Tuple[np.ndarray, ...]:
        """Cached read path: serve a pinned batch from memory (counted as a
        cache hit, not slow-tier I/O); on a miss, read and offer the batch
        for pinning.  ``cache`` is duck-typed (get/offer) so this layer
        stays independent of the runtime subsystem above it."""
        if cache is None:
            return (self.read_batch_raw if raw else self.read_batch)(
                start, count)
        # Key in *global* chunk ids so shard views of one store can share a
        # cache, and tag the format: raw u16 and decoded i32 pins of the
        # same range are different resident objects.  The tile-row offset is
        # part of the key because a pinned batch's meta is rebased to the
        # reader's shard frame — an offset-0 consumer must never be served a
        # shard-rebased pin (or vice versa).  The encoding signature is part
        # of the key for the same reason one level down: a raw store's u16
        # pin must never be served to a reader of the re-encoded store
        # sharing the cache (replicas share a signature, so true copies
        # still share pins).
        # The graph's logical version and the store's physical generation
        # both tag the key: a pin taken at version v must MISS (not serve
        # corrupt rows) after an update touched its chunk, and a rebuilt
        # base can carry identical tags over different payload bytes — the
        # encoding-signature rule above, one axis further.
        key = (self.chunk_offset + start, count, self.tile_row_offset,
               "raw" if raw else "i32", self._enc_sig,
               self.generation, self.version)
        hit = cache.get(key)
        if hit is not None:
            # hit accounting is in on-disk bytes: the I/O this hit avoided
            self.stats.add_cache_hit(self.range_nbytes(start, count))
            return hit
        batch = (self.read_batch_raw if raw else self.read_batch)(start, count)
        if raw:
            # materialize the memmap views before pinning: a pinned view
            # holds no pages resident, so it would be a fake cache entry
            batch = tuple(None if a is None else np.ascontiguousarray(a)
                          for a in batch)
        # charge the cache what the pinned arrays actually occupy resident
        # (raw u16 pins cost ~half the decoded int32/f32 arrays)
        cache.offer(key, batch,
                    sum(a.nbytes for a in batch if a is not None))
        return batch

    def stream(self, batch: int, prefetch: int = 2, use_async: bool = True,
               cache=None, raw: bool = False
               ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Iterate chunk batches in execution order, optionally with an async
        prefetch thread keeping ``prefetch`` batches ready.  ``raw=True``
        yields uint16 index views (see :meth:`read_batch_raw`).

        Failure propagates both ways: an exception in the prefetch thread is
        re-raised in the consumer (a failed read must not hang the pipeline
        waiting for a sentinel that will never arrive), and a consumer that
        abandons the iterator mid-pass (downstream exception, generator
        close) releases the reader — it must not stay blocked on the bounded
        queue forever."""
        plan = self.batch_plan(batch)
        if not use_async:
            for s, c in plan:
                yield self._fetch(s, c, cache, raw)
            return
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            try:
                for s, c in plan:
                    if not put(self._fetch(s, c, cache, raw)):
                        return
            except BaseException as e:  # noqa: BLE001 — forwarded, not eaten
                put(_ReaderFailure(e))
                return
            put(None)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()  # poll; consumer rarely waits if reader ahead
                if item is None:
                    break
                if isinstance(item, _ReaderFailure):
                    raise item.exc
                yield item
        finally:
            stop.set()
            t.join()

    # -- chunk -> tile-row mapping (elastic-admission accounting) -------------
    def chunk_tile_rows(self) -> np.ndarray:
        """Tile row of every chunk in this store's frame, ascending (chunks
        are laid out in (tile_row, tile_col) order).  Read from the memmap's
        meta stride — no decode of the index planes.  The serving runtime
        uses this to account which tile rows a mid-pass-admitted tenant's
        partial first pass covered."""
        mm = self._memmap()
        co = self.chunk_offset
        off = self._offsets[co:co + self.n_chunks]
        # per-chunk records vary with the encoding tag, so gather the first
        # meta word through the offset table instead of one fixed stride
        meta0 = mm[off[:, None] + np.arange(4)].view(np.int32)[:, 0]
        return meta0.astype(np.int64) - self.tile_row_offset

    # -- row sharding ---------------------------------------------------------
    def partition_row_bounds(self, n_shards: int) -> List[Tuple[int, int]]:
        """Nnz-balanced contiguous tile-row slab boundaries ``[tr0, tr1)``,
        one pair per shard (``n_shards`` is clamped to the tile-row count —
        callers that need the realized slab count take ``len()`` of the
        result).  A pure function of the header + chunk meta, so every
        replica of the same matrix — including the per-host store copies of
        a cluster partition plan — derives identical boundaries from its
        own file.  The greedy cumulative-nnz split is the
        contiguity-constrained analogue of ``core.partition.lpt_partition``."""
        h = self.header
        T = h["T"]
        n_tile_rows = -(-h["n_rows"] // T)
        n_shards = max(1, min(int(n_shards), n_tile_rows))
        mm = self._memmap()
        co = self.chunk_offset
        off = self._offsets[co:co + self.n_chunks]
        # offset-table gather (records vary with the encoding tag); only the
        # legacy meta words [tile_row .. nnz] are needed for the split
        meta = mm[off[:, None] + np.arange(16)].view(np.int32)
        trow = meta[:, 0].astype(np.int64) - self.tile_row_offset
        row_nnz = np.bincount(trow, weights=meta[:, 3],
                              minlength=n_tile_rows)
        cum = np.cumsum(row_nnz)
        total = float(cum[-1])
        bounds: List[Tuple[int, int]] = []
        tr0 = 0
        for s in range(n_shards):
            if s == n_shards - 1:
                tr1 = n_tile_rows
            else:
                tr1 = int(np.searchsorted(cum, total * (s + 1) / n_shards)) + 1
                tr1 = max(tr1, tr0 + 1)
                tr1 = min(tr1, n_tile_rows - (n_shards - 1 - s))
            bounds.append((tr0, tr1))
            tr0 = tr1
        return bounds

    def partition_rows(self, n_shards: int) -> List["TileStore"]:
        """Split into ``n_shards`` contiguous tile-row shard stores over the
        *same* backing file (no data is rewritten).

        Chunks are laid out in (tile_row, tile_col) order and every chunk
        belongs to exactly one tile row, so a contiguous tile-row range is a
        contiguous chunk range: each shard streams its own byte range and owns
        its own stats/buffers (thread-safe parallel scans), and concatenating
        the shards' row blocks reproduces the single-scan result bit for bit
        (identical per-row accumulation order).  Ranges are balanced by nnz
        via :meth:`partition_row_bounds`."""
        h = self.header
        T = h["T"]
        mm = self._memmap()
        co = self.chunk_offset
        off = self._offsets[co:co + self.n_chunks]
        meta = mm[off[:, None] + np.arange(16)].view(np.int32)
        trow = meta[:, 0].astype(np.int64) - self.tile_row_offset
        shards: List[TileStore] = []
        for tr0, tr1 in self.partition_row_bounds(n_shards):
            c0 = int(np.searchsorted(trow, tr0, side="left"))
            c1 = int(np.searchsorted(trow, tr1, side="left"))
            n_rows_shard = min(tr1 * T, h["n_rows"]) - tr0 * T
            hdr = dict(h, n_chunks=c1 - c0, n_rows=int(n_rows_shard))
            # type(self), not TileStore: subclasses that override the read
            # path (e.g. a throttled bench store) keep their behavior in
            # their shards.
            st = type(self)(self.path, hdr,
                            chunk_offset=self.chunk_offset + c0,
                            tile_row_offset=self.tile_row_offset + tr0,
                            row_offset=self.row_offset + tr0 * T,
                            tags=self._tags, offsets=self._offsets)
            # shards delegate mutable-graph state to the root store, so a
            # GraphHandle attached before OR after the cut reaches them
            st._delta_src = self._delta_src if self._delta_src is not None \
                else self
            shards.append(st)
        return shards


class _OptimizedWriter:
    """Incremental writer for the optimized chunk format: accepts one tile
    row of (already column-relabeled) entries at a time and emits exactly
    the bytes :meth:`TileStore.write_optimized` emits for the same matrix
    (pinned by test) — per-chunk ``encode_chunk_planes``, the meta6
    layout, and the iso-chunk U16→U24 demotion, which needs the *next*
    chunk's tag and is therefore resolved through a one-chunk delay line:
    each chunk is held back until its right neighbor's original tag is
    known (finalize closes the line with right = 0, matching the one-shot
    writer's edge padding).  Neighbor tags in the demotion test are the
    pre-demotion ones, exactly like the vectorized form."""

    def __init__(self, path: str, *, n_rows: int, n_cols: int, T: int,
                 C: int, binary: bool, pack: bool = True,
                 col_perm: Optional[np.ndarray] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.n_rows, self.n_cols, self.T, self.C = n_rows, n_cols, T, C
        self.binary, self.pack = bool(binary), bool(pack)
        self.col_perm = col_perm
        self._f = open(path + ".bin", "wb")
        self._tags: List[int] = []
        self._pend: Optional[dict] = None
        self._prev_orig = 0

    def put_tile_row(self, trow: int, rows: np.ndarray, cols: np.ndarray,
                     vals: Optional[np.ndarray]) -> None:
        """Chunk one tile row's entries (global coordinates, any order;
        duplicates kept in input order) and push them through the delay
        line.  An empty tile row emits its mandatory zero chunk."""
        T, C = self.T, self.C
        if rows.shape[0] == 0:
            meta = np.array([[trow, 0, 1, 0]], np.int32)
            rl = np.zeros((1, C), np.int32)
            cl = np.zeros((1, C), np.int32)
            vv = np.zeros((1, C), np.float32)
        else:
            tcol = cols // T
            # np.lexsort((cols, rows, tcol)) as one stable argsort of the
            # combined key (tile column, local row, local column)
            order = np.argsort((tcol * T + (rows - trow * T)) * T
                               + (cols - tcol * T), kind="stable")
            rows, cols, tcol = rows[order], cols[order], tcol[order]
            v = None if vals is None else vals[order]
            tstarts = [0, *(np.flatnonzero(np.diff(tcol)) + 1).tolist(),
                       rows.shape[0]]
            metas, rls, cls_, vvs = [], [], [], []
            for g0, g1 in zip(tstarts[:-1], tstarts[1:]):
                tc = int(tcol[g0])
                for ch0 in range(g0, g1, C):
                    ch1 = min(ch0 + C, g1)
                    nnz = ch1 - ch0
                    rl1 = np.zeros(C, np.int32)
                    cl1 = np.zeros(C, np.int32)
                    vv1 = np.zeros(C, np.float32)
                    rl1[:nnz] = rows[ch0:ch1] - trow * T
                    cl1[:nnz] = cols[ch0:ch1] - tc * T
                    if v is not None:
                        vv1[:nnz] = v[ch0:ch1]
                    metas.append([trow, tc, 0, nnz])
                    rls.append(rl1)
                    cls_.append(cl1)
                    vvs.append(vv1)
            metas[0][2] = 1
            meta = np.asarray(metas, np.int32)
            rl, cl, vv = np.stack(rls), np.stack(cls_), np.stack(vvs)
        tags, bases, rows_hi, cols_lo = encode_chunk_planes(meta, rl, cl, T)
        if not self.pack:
            tags = np.zeros_like(tags)
        meta6 = np.zeros((meta.shape[0], 6), np.int32)
        meta6[:, :4] = meta
        meta6[:, 4:6] = bases
        for i in range(meta.shape[0]):
            ch = dict(tag=int(tags[i]), meta6=meta6[i], rl=rl[i], cl=cl[i],
                      rows_hi=rows_hi[i], cols_lo=cols_lo[i], vv=vv[i])
            if self._pend is not None:
                self._write(self._pend, right=ch["tag"])
            self._pend = ch

    def _write(self, ch: dict, right: int) -> None:
        t, left = ch["tag"], self._prev_orig
        self._prev_orig = ch["tag"]
        if self.pack and (t == ENC_FLAT_U16
                          and left != ENC_FLAT_U16 and right != ENC_FLAT_U16
                          and (left == ENC_FLAT_U24 or right == ENC_FLAT_U24)):
            t = ENC_FLAT_U24
        f = self._f
        f.write(ch["meta6"].tobytes())
        if t & ENC_ROWS_U8:
            f.write(ch["rows_hi"].astype(np.uint8).tobytes())
        elif t:
            f.write(ch["rows_hi"].tobytes())
        else:
            f.write(ch["rl"].astype(np.uint16).tobytes())
        f.write(ch["cols_lo"].tobytes() if t & ENC_COLS_U8 else
                ch["cl"].astype(np.uint16).tobytes())
        if not self.binary:
            f.write(ch["vv"].astype(np.float32).tobytes())
        self._tags.append(int(t))

    def finalize(self, store_cls=None) -> TileStore:
        if self._pend is not None:
            self._write(self._pend, right=0)
            self._pend = None
        self._f.close()
        header = dict(
            n_rows=self.n_rows, n_cols=self.n_cols, T=self.T, C=self.C,
            n_chunks=len(self._tags), binary=self.binary,
            record=TileStore._record_bytes(self.C, self.binary) + 8,
            meta_ints=6, encodings=self._tags,
            col_perm=self.col_perm is not None)
        with open(self.path + ".json", "w") as f:
            json.dump(header, f)
        if self.col_perm is not None:
            np.save(self.path + ".perm.npy",
                    np.asarray(self.col_perm, np.int32))
        st = (store_cls or TileStore)(self.path, header)
        st.stats.add_write(st.nbytes)
        return st


def validate_replicas(stores: Sequence[TileStore]) -> None:
    """Check that ``stores`` hold the same logical matrix: identical headers
    (shape, tiling, chunk count, record layout) and identical backing-file
    sizes.  Replica routing silently mixing two different matrices would be
    a correctness disaster — fail loudly at open time instead."""
    if not stores:
        raise ValueError("empty replica set")
    ref = stores[0]
    ref_size = os.path.getsize(ref.path + ".bin")
    for s in stores[1:]:
        if s.header != ref.header:
            raise ValueError(
                f"replica {s.path!r} header {s.header} does not match "
                f"{ref.path!r} header {ref.header}")
        size = os.path.getsize(s.path + ".bin")
        if size != ref_size:
            raise ValueError(
                f"replica {s.path!r} backing file is {size} bytes, "
                f"expected {ref_size} ({ref.path!r})")


class DenseStore:
    """On-"SSD" dense matrix (row-major float32 memmap) with sequential
    row-block reads and write-once row-block writes."""

    def __init__(self, path: str, n_rows: int, n_cols: int,
                 mode: str = "w+"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.n_rows, self.n_cols = n_rows, n_cols
        self.stats = IOStats()
        self._mm = np.memmap(path, dtype=np.float32, mode=mode,
                             shape=(n_rows, n_cols))

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def read_cols(self, c0: int, c1: int) -> np.ndarray:
        out = np.array(self._mm[:, c0:c1])
        self.stats.add_read(out.nbytes)
        return out

    def read_rows(self, r0: int, r1: int) -> np.ndarray:
        out = np.array(self._mm[r0:r1])
        self.stats.add_read(out.nbytes)
        return out

    def write_cols(self, c0: int, block: np.ndarray) -> None:
        self._mm[:, c0:c0 + block.shape[1]] = block
        self.stats.add_write(block.nbytes)

    def write_rows(self, r0: int, block: np.ndarray) -> None:
        self._mm[r0:r0 + block.shape[0]] = block
        self.stats.add_write(block.nbytes)

    def flush(self) -> None:
        self._mm.flush()

    def to_array(self) -> np.ndarray:
        return np.array(self._mm)
