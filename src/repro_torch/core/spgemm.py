"""Semi-external SpGEMM: sparse × sparse with out-of-core output.

Every other workload in this repo is SpMM/SpMV — sparse × tall-skinny
dense, the paper's §3 kernel, whose output is dense and budgetable up
front.  SpGEMM breaks that: the product ``A @ B`` of two sparse stores is
itself sparse, its nnz is unknown until computed, and on power-law graphs
it routinely exceeds host memory (SAGE, arXiv:2308.13626; Buluç–Gilbert,
arXiv:1006.2183).  So the *output* side gets the same semi-external
discipline the input side already has:

* **A-scan** — A streams in (tile_row, tile_col) chunk order through the
  existing :meth:`TileStore.stream` path (prefetch, encodings, shard-free
  whole-store frame), exactly like an engine pass; the delta overlay of a
  mutable A is folded per tile row from the pass-pinned snapshot.
* **B-row gather** — each A entry ``(r, k)`` needs row ``k`` of B.  Rows
  are gathered a *B tile row* at a time by reading the plan-aligned chunk
  batches that cover it (``batch_plan`` boundaries, so reads are
  encoding-homogeneous and their cache keys are deterministic — hot B
  ranges are served through the runtime's ``HotChunkCache``), assembled
  into a per-tile-row CSR (B's own overlay folded in) and kept in a small
  byte-bounded LRU.
* **Partial accumulation under a budget** — the Buluç taxonomy's
  hash/sort accumulator: expanded products are buffered as
  ``(row_local * n_cols + col) -> value`` flat keys; when the held bytes
  would exceed ``partial_budget_bytes`` the buffers consolidate
  (sort + duplicate-sum), and when even the consolidated partial does not
  fit, it **spills** as a sorted run to disk.  A tile row whose partial
  overflowed finishes with the heap-merge fallback: a block-wise k-way
  merge over the spilled runs (memmap-backed, read in bounded blocks with
  a cutoff key so every round is key-disjoint — no cross-round duplicate
  can survive).
* **Spill-to-TileStore output** — each completed tile row is emitted
  through the incremental :class:`repro_torch.io.storage._OptimizedWriter`, so
  the product lands in the exact chunk format the whole serving stack
  streams, and can optionally be :meth:`TileStore.optimize`-d in place.

``peak_partial_bytes`` counts the bytes *held* by the partial accumulator
(buffers + consolidated in-memory run); the finished tile row being
handed to the writer and the transient expansion slices (bounded to a
quarter of the budget each) are output/streaming state, not partials —
the same accounting the paper applies to its write-once output blocks.

Exactness contract: partial products are summed in spill/merge order,
which differs from a dense oracle's order, so *bit*-identity to
``(A @ B)`` holds under exact arithmetic (integer-valued float32, bools —
the same contract the delta overlay documents).  All tests and benches
pin bit-identity on integer-valued inputs.

:func:`triangle_count` rides the same job: with ``B = A`` over a
symmetric store (``Aᵀ = A``), the per-tile-row product is intersected
with A's own entries instead of written out —
``tri[u] = ½ Σ_v A_uv (A·A)_uv`` — so triangle counting needs no product
store at all (the masked reduction *is* the output).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from collections import OrderedDict
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.io.storage import TileStore, _OptimizedWriter

_ENTRY_BYTES = 12          # int64 flat key + float32 value per partial slot
_MIN_BUDGET = 1 << 16      # floor: one expansion slice must fit comfortably


@dataclasses.dataclass
class SpGEMMStats:
    """Counters the CI gate and the session summary report."""

    n_rows: int = 0
    n_cols: int = 0                  # of the product (B's column count)
    tile_rows: int = 0
    partial_budget_bytes: int = 0
    a_nnz_streamed: int = 0          # base + overlay entries scanned from A
    expanded_products: int = 0       # partial products before accumulation
    product_nnz: int = 0
    spill_cycles: int = 0            # sorted runs written to disk
    spilled_bytes: int = 0
    merge_rounds: int = 0            # block-merge rounds across all rows
    peak_partial_bytes: int = 0      # max bytes held by the accumulator
    b_tile_rows_fetched: int = 0     # CSR assemblies (LRU misses)

    def summary_array(self) -> np.ndarray:
        """The wire-portable retirement payload of a SpGEMM session."""
        return np.array([self.n_rows, self.n_cols, self.product_nnz,
                         self.spill_cycles, self.peak_partial_bytes,
                         self.partial_budget_bytes, self.tile_rows],
                        np.int64)


def _consolidated(keys: np.ndarray, vals: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by flat key and sum duplicates (the hash-accumulator collapse)."""
    if keys.size == 0:
        return keys.astype(np.int64), vals.astype(np.float32)
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    return keys[starts], np.add.reduceat(vals, starts).astype(np.float32)


class _SpillAccumulator:
    """Budgeted partial-product accumulator for one tile row at a time.

    ``add`` never lets the held bytes exceed ``budget``: it consolidates
    first, and spills the consolidated run to disk when that is not
    enough.  ``finish`` returns the tile row's sorted-unique partial,
    block-merging any spilled runs under the same budget."""

    def __init__(self, budget_bytes: int, spill_dir: str, stats: SpGEMMStats):
        self.budget = max(_MIN_BUDGET, int(budget_bytes))
        self.dir = spill_dir
        self.stats = stats
        self._ks: List[np.ndarray] = []
        self._vs: List[np.ndarray] = []
        self._bytes = 0
        self._runs: List[Tuple[str, str]] = []

    @property
    def slice_cap(self) -> int:
        """Max entries per expansion slice pushed at once (≤ budget/4)."""
        return max(1024, (self.budget // 4) // _ENTRY_BYTES)

    def add(self, keys: np.ndarray, vals: np.ndarray) -> None:
        inc = keys.nbytes + vals.nbytes
        if self._bytes + inc > self.budget:
            self._consolidate_buffers()
            if self._bytes + inc > self.budget:
                self._spill()
        self._ks.append(keys)
        self._vs.append(vals)
        self._bytes += inc
        self.stats.peak_partial_bytes = max(self.stats.peak_partial_bytes,
                                            self._bytes)

    def _consolidate_buffers(self) -> None:
        if not self._ks:
            return
        k, v = _consolidated(np.concatenate(self._ks),
                             np.concatenate(self._vs))
        self._ks, self._vs = [k], [v]
        self._bytes = k.nbytes + v.nbytes

    def _spill(self) -> None:
        self._consolidate_buffers()
        if not self._ks or self._ks[0].size == 0:
            return
        k, v = self._ks[0], self._vs[0]
        os.makedirs(self.dir, exist_ok=True)
        i = len(self._runs)
        kp = os.path.join(self.dir, f"run{i}.k.npy")
        vp = os.path.join(self.dir, f"run{i}.v.npy")
        np.save(kp, k)
        np.save(vp, v)
        self._runs.append((kp, vp))
        self.stats.spill_cycles += 1
        self.stats.spilled_bytes += k.nbytes + v.nbytes
        self._ks, self._vs, self._bytes = [], [], 0

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        self._consolidate_buffers()
        mem_k = self._ks[0] if self._ks else np.zeros(0, np.int64)
        mem_v = self._vs[0] if self._vs else np.zeros(0, np.float32)
        if not self._runs:
            self.reset()
            return mem_k, mem_v
        # heap-merge fallback: memmap the sorted runs and merge in bounded
        # blocks — the partial never rematerializes whole in memory
        runs = [(np.load(kp, mmap_mode="r"), np.load(vp, mmap_mode="r"))
                for kp, vp in self._runs]
        if mem_k.size:
            runs.append((mem_k, mem_v))
        merged = self._block_merge(runs)
        del runs
        self.reset()
        return merged

    def _block_merge(self, runs) -> Tuple[np.ndarray, np.ndarray]:
        """Cutoff-bounded k-way merge: each round consumes, from every
        active run, all entries ≤ the smallest of the runs' current block
        tails — rounds are key-disjoint, so a per-round consolidation is a
        global dedup (the writer keeps duplicates, so this is what makes
        the emitted tile row bit-identical to the oracle)."""
        sizes = [r[0].shape[0] for r in runs]
        pos = [0] * len(runs)
        block = max(4096, self.budget // max(1, 2 * _ENTRY_BYTES * len(runs)))
        out_k: List[np.ndarray] = []
        out_v: List[np.ndarray] = []
        while True:
            active = [i for i in range(len(runs)) if pos[i] < sizes[i]]
            if not active:
                break
            cut = min(int(runs[i][0][min(pos[i] + block, sizes[i]) - 1])
                      for i in active)
            seg_k, seg_v = [], []
            for i in active:
                k = runs[i][0]
                lo = pos[i]
                hi = lo + int(np.searchsorted(k[lo:], cut, side="right"))
                if hi > lo:
                    seg_k.append(np.asarray(k[lo:hi]))
                    seg_v.append(np.asarray(runs[i][1][lo:hi]))
                    pos[i] = hi
            k, v = _consolidated(np.concatenate(seg_k), np.concatenate(seg_v))
            self.stats.merge_rounds += 1
            out_k.append(k)
            out_v.append(v)
        return np.concatenate(out_k), np.concatenate(out_v)

    def reset(self) -> None:
        self._ks, self._vs, self._bytes = [], [], 0
        for kp, vp in self._runs:
            for p in (kp, vp):
                if os.path.exists(p):
                    os.remove(p)
        self._runs = []


class _BRowGather:
    """Serve B's rows one *tile row* at a time.

    Reads follow ``batch_plan`` boundaries — :meth:`read_batch_raw` raises
    on encoding-mixed ranges, and plan-aligned ``(start, count)`` pairs
    are exactly the keys the streaming engine's passes populate in the
    shared :class:`HotChunkCache`, so a hot B region costs no I/O here.
    Assembled CSRs (overlay folded, columns relabeled back to user space
    for optimized B stores) live in a byte-bounded LRU."""

    def __init__(self, b: TileStore, snap, cache, batch: int,
                 row_cache_bytes: int, stats: SpGEMMStats):
        self.b = b
        h = b.header
        self.T, self.n = h["T"], h["n_rows"]
        self.ntr = -(-self.n // self.T)
        self.cache = cache
        self.stats = stats
        self.plan = b.batch_plan(batch)
        self.plan_starts = np.array([s for s, _ in self.plan], np.int64)
        self.row_chunk_lo = np.searchsorted(b.chunk_tile_rows(),
                                            np.arange(self.ntr + 1))
        perm = b.col_perm()
        self.perm = None if perm is None else perm.astype(np.int64)
        self.snap = snap   # (rows, cols, vals) user-space, row-sorted
        self._lanes = np.arange(h["C"])[None, :]
        self._lru: "OrderedDict[int, tuple]" = OrderedDict()
        self._lru_bytes = 0
        self.row_cache_budget = int(row_cache_bytes)

    def tile_row(self, tb: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR of B's tile row ``tb``: (indptr (T+1,), user cols, vals)."""
        ent = self._lru.get(tb)
        if ent is not None:
            self._lru.move_to_end(tb)
            return ent[0]
        parts_r: List[np.ndarray] = []
        parts_c: List[np.ndarray] = []
        parts_v: List[np.ndarray] = []
        c0, c1 = int(self.row_chunk_lo[tb]), int(self.row_chunk_lo[tb + 1])
        if c1 > c0:
            i = int(np.searchsorted(self.plan_starts, c0, side="right")) - 1
            while i < len(self.plan) and self.plan[i][0] < c1:
                s, cnt = self.plan[i]
                m, r, c, v = self.b._fetch(s, cnt, self.cache)
                pick = (m[:, 0] == tb)[:, None] & (self._lanes < m[:, 3:4])
                if pick.any():
                    gc = (m[:, 1:2].astype(np.int64) * self.T + c)[pick]
                    parts_r.append(r[pick].astype(np.int64))
                    parts_c.append(gc if self.perm is None else self.perm[gc])
                    parts_v.append(v[pick])
                i += 1
        if self.snap is not None:
            srows, scols, svals = self.snap
            lo = np.searchsorted(srows, tb * self.T)
            hi = np.searchsorted(srows, (tb + 1) * self.T)
            if hi > lo:
                parts_r.append((srows[lo:hi] - tb * self.T).astype(np.int64))
                parts_c.append(scols[lo:hi].astype(np.int64))
                parts_v.append(svals[lo:hi].astype(np.float32))
        if parts_r:
            rl = np.concatenate(parts_r)
            cc = np.concatenate(parts_c)
            vv = np.concatenate(parts_v)
        else:
            rl = np.zeros(0, np.int64)
            cc = np.zeros(0, np.int64)
            vv = np.zeros(0, np.float32)
        indptr = np.zeros(self.T + 1, np.int64)
        np.cumsum(np.bincount(rl, minlength=self.T), out=indptr[1:])
        order = np.argsort(rl, kind="stable")
        csr = (indptr, cc[order], vv[order])
        nbytes = indptr.nbytes + cc.nbytes + vv.nbytes
        self._lru[tb] = (csr, nbytes)
        self._lru_bytes += nbytes
        self.stats.b_tile_rows_fetched += 1
        while self._lru_bytes > self.row_cache_budget and len(self._lru) > 1:
            _, (_, nb) = self._lru.popitem(last=False)
            self._lru_bytes -= nb
        return csr


def _reject_shard(st: TileStore, name: str) -> None:
    if st.chunk_offset or st.tile_row_offset or st.row_offset:
        raise ValueError(f"spgemm needs a whole-store {name}, not a shard "
                         f"view (chunk_offset={st.chunk_offset})")


def _pin_snapshot(st: TileStore):
    """(snapshot-or-None, began-handle-or-None): pin the overlay for the
    job's lifetime when the store is handle-managed, else take a plain
    snapshot; the snapshot's rows are already (row, col)-lexsorted."""
    if st.handle is not None:
        snap = st.handle.begin_pass()
        return (snap[1], snap[2], snap[3]) if snap[1].size else None, st.handle
    dl = st.delta_log
    if dl is not None:
        _, r, c, v = dl.snapshot()
        return ((r, c, v) if r.size else None), None
    return None, None


class SpGEMMJob:
    """One semi-external SpGEMM (or masked triangle reduction) in flight.

    Drive it to completion with :meth:`run`, or incrementally — one output
    tile row per step — through the :meth:`tile_rows` generator (what the
    serving-tier session does, ``tile_rows_per_pass`` steps per shared
    pass).  After the generator is exhausted: ``product`` holds the output
    :class:`TileStore` (``mode="product"``) or ``tri`` the per-vertex
    triangle counts (``mode="triangle"``), and ``stats`` the counters."""

    def __init__(self, a: TileStore, b: Optional[TileStore] = None,
                 out_path: Optional[str] = None, *,
                 partial_budget_bytes: int = 64 << 20,
                 chunk_batch: int = 256, cache=None,
                 b_row_cache_bytes: int = 32 << 20,
                 mode: str = "product", optimize_out: bool = False,
                 spill_dir: Optional[str] = None, use_async: bool = True):
        if mode not in ("product", "triangle"):
            raise ValueError(f"unknown spgemm mode {mode!r}")
        if mode == "triangle":
            if b is not None and b is not a:
                raise ValueError("triangle mode masks the product by A "
                                 "itself; pass b=None")
            b = a
        else:
            if out_path is None:
                raise ValueError("product mode needs an out_path")
            b = a if b is None else b
        _reject_shard(a, "A")
        if b is not a:
            _reject_shard(b, "B")
        if a.header["n_cols"] != b.header["n_rows"]:
            raise ValueError(
                f"dimension mismatch: A is {a.header['n_rows']}x"
                f"{a.header['n_cols']}, B is {b.header['n_rows']}x"
                f"{b.header['n_cols']}")
        self.a, self.b = a, b
        self.mode, self.out_path = mode, out_path
        self.optimize_out = bool(optimize_out)
        self.chunk_batch, self.use_async = int(chunk_batch), bool(use_async)
        self.Ta, self.Tb = a.header["T"], b.header["T"]
        self.n_rows = a.header["n_rows"]
        self.n_out = b.header["n_cols"]
        self.ntr = -(-self.n_rows // self.Ta)
        self.stats = SpGEMMStats(
            n_rows=self.n_rows, n_cols=self.n_out, tile_rows=self.ntr,
            partial_budget_bytes=max(_MIN_BUDGET, int(partial_budget_bytes)))
        perm_a = a.col_perm()
        self._perm_a = None if perm_a is None else perm_a.astype(np.int64)
        self._a_snap, self._a_pass = _pin_snapshot(a)
        if b is a:
            self._b_snap, self._b_pass = self._a_snap, None
        else:
            self._b_snap, self._b_pass = _pin_snapshot(b)
        self._own_spill = spill_dir is None
        self._spill_dir = spill_dir or tempfile.mkdtemp(prefix="spgemm-spill-")
        self._acc = _SpillAccumulator(self.stats.partial_budget_bytes,
                                      self._spill_dir, self.stats)
        self._gather = _BRowGather(b, self._b_snap, cache, chunk_batch,
                                   b_row_cache_bytes, self.stats)
        self._writer: Optional[_OptimizedWriter] = None
        if mode == "product":
            self._writer = _OptimizedWriter(
                out_path, n_rows=self.n_rows, n_cols=self.n_out, T=self.Ta,
                C=a.header["C"], binary=False)
        self._tri = (np.zeros(self.n_rows, np.float64)
                     if mode == "triangle" else None)
        self.product: Optional[TileStore] = None
        self.tri: Optional[np.ndarray] = None
        self._finalized = False
        self._closed = False

    # -- the A-scan ----------------------------------------------------------
    def tile_rows(self) -> Iterator[int]:
        """Stream A once, yielding each output tile-row index as it is
        completed (accumulated, merged, emitted); finalizes on exhaustion."""
        lanes = np.arange(self.a.header["C"])[None, :]
        pend: dict = {}
        cur = 0
        for m, r, c, v in self.a.stream(self.chunk_batch,
                                        use_async=self.use_async):
            first = int(m[0, 0])
            while cur < first:          # tile rows below this batch: complete
                self._emit(cur, pend.pop(cur, None))
                yield cur
                cur += 1
            valid = lanes < m[:, 3:4]
            gr = m[:, 0:1].astype(np.int64) * self.Ta + r
            gc = m[:, 1:2].astype(np.int64) * self.Ta + c
            for i in range(m.shape[0]):
                vi = valid[i]
                pend.setdefault(int(m[i, 0]), []).append(
                    (gr[i][vi], gc[i][vi], v[i][vi]))
        while cur < self.ntr:
            self._emit(cur, pend.pop(cur, None))
            yield cur
            cur += 1
        self._finalize()

    def run(self) -> "SpGEMMJob":
        for _ in self.tile_rows():
            pass
        return self

    # -- one output tile row --------------------------------------------------
    def _emit(self, trow: int, parts) -> None:
        if parts:
            ar = np.concatenate([p[0] for p in parts])
            ac = np.concatenate([p[1] for p in parts])
            av = np.concatenate([p[2] for p in parts])
        else:
            ar = np.zeros(0, np.int64)
            ac = np.zeros(0, np.int64)
            av = np.zeros(0, np.float32)
        if self._perm_a is not None and ac.size:
            ac = self._perm_a[ac]       # stored col -> user col == B row
        if self._a_snap is not None:
            srows, scols, svals = self._a_snap
            lo = np.searchsorted(srows, trow * self.Ta)
            hi = np.searchsorted(srows, (trow + 1) * self.Ta)
            if hi > lo:
                ar = np.concatenate([ar, srows[lo:hi]])
                ac = np.concatenate([ac, scols[lo:hi].astype(np.int64)])
                av = np.concatenate([av, svals[lo:hi].astype(np.float32)])
        self.stats.a_nnz_streamed += ar.size
        self._expand(trow, ar, ac, av)
        keys, vals = self._acc.finish()
        self.stats.product_nnz += keys.size
        if self._writer is not None:
            self._writer.put_tile_row(trow, trow * self.Ta + keys // self.n_out,
                                      keys % self.n_out, vals)
        else:
            self._mask_reduce(trow, ar, ac, av, keys, vals)

    def _expand(self, trow: int, ar, ac, av) -> None:
        if ar.size == 0:
            return
        rl = ar - trow * self.Ta
        tb_all = ac // self.Tb
        cap = self._acc.slice_cap
        for tb in np.unique(tb_all):
            sel = tb_all == tb
            indptr, bcols, bvals = self._gather.tile_row(int(tb))
            kl = ac[sel] - tb * self.Tb
            sub_r, sub_v = rl[sel], av[sel]
            starts = indptr[kl]
            cnts = indptr[kl + 1] - starts
            csum = np.cumsum(cnts)
            lo = 0
            while lo < cnts.shape[0]:
                base = int(csum[lo - 1]) if lo else 0
                hi = int(np.searchsorted(csum, base + cap, side="left")) + 1
                hi = min(max(hi, lo + 1), cnts.shape[0])
                self._expand_slice(sub_r[lo:hi], sub_v[lo:hi], starts[lo:hi],
                                   cnts[lo:hi], bcols, bvals)
                lo = hi

    def _expand_slice(self, r, v, starts, cnts, bcols, bvals) -> None:
        total = int(cnts.sum())
        if total == 0:
            return
        ends = np.cumsum(cnts)
        idx = (np.arange(total, dtype=np.int64)
               - np.repeat(ends - cnts, cnts) + np.repeat(starts, cnts))
        keys = np.repeat(r * self.n_out, cnts) + bcols[idx]
        vals = np.repeat(v, cnts) * bvals[idx]
        self.stats.expanded_products += total
        self._acc.add(keys, vals)

    def _mask_reduce(self, trow, ar, ac, av, keys, vals) -> None:
        """tri[u] += Σ_v A_uv · (A·A)_uv over this tile row (halved at
        finalize: each triangle through u is seen from both neighbors)."""
        if keys.size == 0 or ar.size == 0:
            return
        mk, mv = _consolidated((ar - trow * self.Ta) * self.n_out + ac,
                               av.astype(np.float64))
        pos = np.minimum(np.searchsorted(keys, mk), keys.size - 1)
        hit = keys[pos] == mk
        if not hit.any():
            return
        contrib = mv[hit] * vals[pos[hit]].astype(np.float64)
        local = np.bincount(mk[hit] // self.n_out, weights=contrib,
                            minlength=self.Ta)
        r0 = trow * self.Ta
        span = min(self.Ta, self.n_rows - r0)
        self._tri[r0:r0 + span] += local[:span]

    # -- lifecycle -----------------------------------------------------------
    def _finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        if self._writer is not None:
            store = self._writer.finalize()
            self._writer = None
            if self.optimize_out:
                opt = store.optimize(self.out_path + "-opt")
                store.close()
                store = opt
            self.product = store
        if self._tri is not None:
            self.tri = self._tri / 2.0
        self.close()

    def close(self) -> None:
        """Release pass pins and spill scratch (idempotent; the product
        store, if any, stays open for the caller)."""
        if self._closed:
            return
        self._closed = True
        self._acc.reset()
        if self._a_pass is not None:
            self._a_pass.end_pass()
            self._a_pass = None
        if self._b_pass is not None:
            self._b_pass.end_pass()
            self._b_pass = None
        if self._own_spill and os.path.isdir(self._spill_dir):
            shutil.rmtree(self._spill_dir, ignore_errors=True)


def spgemm(a: TileStore, b: Optional[TileStore] = None,
           out_path: Optional[str] = None, **kw
           ) -> Tuple[TileStore, SpGEMMStats]:
    """Compute ``A @ B`` (``B = A`` when omitted) into a TileStore at
    ``out_path``; returns ``(product_store, stats)``."""
    job = SpGEMMJob(a, b, out_path, **kw)
    try:
        job.run()
    finally:
        job.close()
    return job.product, job.stats


def triangle_count(a: TileStore, **kw) -> Tuple[np.ndarray, SpGEMMStats]:
    """Per-vertex triangle counts of a symmetric store (``Aᵀ = A``):
    ``tri[u] = ½ Σ_v A_uv (A·A)_uv``; total triangles = ``tri.sum() / 3``."""
    job = SpGEMMJob(a, None, None, mode="triangle", **kw)
    try:
        job.run()
    finally:
        job.close()
    return job.tri, job.stats


def materialize_dense(store: TileStore) -> np.ndarray:
    """User-coordinate dense float32 of a (possibly optimized, possibly
    overlaid) store — the oracle-side reader the tests and benches use to
    compare products across encodings."""
    out = np.zeros((store.header["n_rows"], store.header["n_cols"]),
                   np.float32)
    perm = store.col_perm()
    for _, rows, cols, vals in store.iter_tile_row_entries():
        if rows.size == 0:
            continue
        uc = cols if perm is None else perm[cols]
        np.add.at(out, (rows, uc), vals)
    dl = store.delta_log
    if dl is not None:
        _, r, c, v = dl.snapshot()
        if r.size:
            np.add.at(out, (r, c), v.astype(np.float32))
    return out
