"""Sharded parallel scans: row-partition one TileStore, stream every shard
at once.

The paper scales SEM-SpMM on one box by balancing tile rows across worker
threads behind a shared I/O stream; here the *store itself* is partitioned
(:meth:`TileStore.partition_rows`) into contiguous tile-row shards over the
same backing file, and each shard runs its own complete streaming pass —
its own prefetch thread, its own stats, its own executor.  Partial scans
plus a row-block concatenation, with no cross-shard communication because
the row partition makes output blocks disjoint.

Because every chunk of a tile row lives in exactly one shard and shards
preserve chunk order, each output row accumulates its contributions in
exactly the order the single-scan engine uses — the concatenated result is
the single scan's, bit for bit wherever the single scan's own sums are
exact.

With more than one card, shard i runs on card ``i mod n_cards``.  On one
card the shards run as threads on it, each executor on its own compute and
copy streams, so one shard's host work (reads, staging, launches) overlaps
another's kernels.  ``devices=["cpu"]`` runs the shards on the host with
the kernels' plain versions.

Two scaling knobs compose here: ``replicas=`` spreads the shards of one
wave across N copies of the matrix (each shard streams a different
spindle), and a partitioned hot-chunk cache (``cache.shard(i)``) gives
every shard its own pin budget.
"""
from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sem import _CACHE_UNSET, SEMConfig, SEMSpMM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.io.storage import (GraphHandle, IOStats, TileStore,
                                    UpdateBatch, validate_replicas)


class _RecordingBoundary:
    """Proxy around the coordinator shard's :class:`PassBoundary` that logs
    every ``write_columns`` call so :meth:`ShardedSEMSpMM.multiply` can
    replay the same writes onto the operand the held-back shards stream.
    ``read_output``/``chunk_start`` pass straight through — the coordinator
    shard starts at global chunk 0, so both are already in global frame."""

    def __init__(self, inner, writes):
        self._inner = inner
        self._writes = writes

    @property
    def chunk_start(self):
        return self._inner.chunk_start

    def read_output(self, n_tile_rows: int, c0: int, c1: int) -> np.ndarray:
        # n_tile_rows is bounded by the coordinator's own tile rows, and
        # with >= 2 shards the coordinator's row count is a multiple of T,
        # so the inner clamp is a no-op — the read is global-exact.
        return self._inner.read_output(n_tile_rows, c0, c1)

    def write_columns(self, c0: int, cols: np.ndarray) -> None:
        cols = np.asarray(cols, np.float32)
        if cols.ndim == 1:
            cols = cols[:, None]
        self._writes.append((c0, cols))
        self._inner.write_columns(c0, cols)


def _default_devices() -> List[torch.device]:
    """Every card when there are several, else the one card (the default
    device of :func:`repro_torch.device.resolve_device`)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [resolve_device(None)]


class ShardedSEMSpMM:
    """Parallel sharded scans over row-partitioned :class:`TileStore` shards.

    Duck-types the slice of :class:`SEMSpMM` the serving scheduler consumes
    (``multiply``, ``passes``, ``io_stats``, the mutation surface) so a
    wave's pass can fan out across shards.  ``devices`` names where the
    shards run (shard i on ``devices[i % len(devices)]``); by default every
    card, or the one card with ``n_shards = 2`` threads on it.
    """

    def __init__(self, store: TileStore, n_shards: Optional[int] = None,
                 config: Optional[SEMConfig] = None, cache=None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 replicas: Optional[Sequence[TileStore]] = None):
        explicit = devices is not None
        devices = ([resolve_device(d) for d in devices] if explicit
                   else _default_devices())
        if n_shards is None:
            n_shards = len(devices) if explicit or len(devices) > 1 else 2
        self.store = store
        self.cfg = config or SEMConfig()
        # Replica-aware shard placement: shard i streams from copy i mod N.
        # Every source is partitioned identically (the split is a pure
        # function of the shared header and meta), so shard i covers the
        # same tile rows whichever copy serves it.
        sources = [store]
        if replicas:
            validate_replicas([store] + list(replicas))
            sources = [store] + list(replicas)
        per_source = [s.partition_rows(n_shards) for s in sources]
        n_shards = len(per_source[0])  # partition_rows may clamp
        self.shards = [per_source[i % len(sources)][i]
                       for i in range(n_shards)]
        # The shard views hold layout state derived from the current base
        # generation (chunk ranges, tags, offsets): pin it so a compaction
        # cannot install a new generation under them.  Pins are taken on
        # every source's handle (lazily, if mutation starts after
        # construction) and dropped in close().
        self._sources = sources
        self._mut_lock = threading.Lock()
        self._pinned: List[GraphHandle] = []
        self.pin_layout()
        self.execs: List[SEMSpMM] = [
            SEMSpMM(s, self.cfg,
                    cache=cache.shard(i) if hasattr(cache, "shard")
                    else cache,
                    device=devices[i % len(devices)])
            for i, s in enumerate(self.shards)]
        h = store.header
        self.n_rows, self.n_cols, self.T = h["n_rows"], h["n_cols"], h["T"]
        self.padded_cols = self.execs[0].padded_cols
        self.device = self.execs[0].device
        self.mode = "sem"
        self.passes = 0
        self.last_pass_version = 0
        self._pool = ThreadPoolExecutor(max_workers=len(self.execs),
                                        thread_name_prefix="shard-scan")

    @property
    def n_shards(self) -> int:
        return len(self.execs)

    # -- mutation surface (the Mutable protocol) ----------------------------
    @property
    def version(self) -> int:
        return self.store.version

    @property
    def delta_nnz(self) -> int:
        dl = self.store.delta_log
        return 0 if dl is None else dl.nnz

    @property
    def graph_handle(self) -> Optional[GraphHandle]:
        return self.store.handle

    def pin_layout(self) -> None:
        """Pin every source handle's layout (idempotent): the shard views'
        chunk ranges are derived from the current base generation, so a
        compaction install under a live sharded engine would dangle them.
        Called at construction, on first mutation, and by a caller when a
        handle appears after this engine was built."""
        with self._mut_lock:
            for s in self._sources:
                h = s.handle
                if h is not None and h not in self._pinned:
                    h.pin_layout()
                    self._pinned.append(h)

    def apply_updates(self, batch: UpdateBatch) -> int:
        """Append an edge-update batch to the graph's delta log; every
        shard's next pass sees it (the shard views delegate to the root
        store's log, and each slices the snapshot to its own row frame).
        All replica sources share one handle."""
        with self._mut_lock:
            if self.store.handle is None:
                GraphHandle(self._sources)
        self.pin_layout()
        return self.store.handle.apply_updates(batch)

    def _shard_multiply(self, i: int, x_dev: torch.Tensor, **kw) -> np.ndarray:
        """Shard ``i``'s partial scan, on its own card: a pool thread's
        current device is not the caller's."""
        ex = self.execs[i]
        with (torch.cuda.device(ex.device) if ex.device.type == "cuda"
              else contextlib.nullcontext()):
            return ex.multiply(x_dev, **kw)

    def _stage(self, x_host: np.ndarray) -> torch.Tensor:
        """Relabel a padded user-space operand into the engine's column
        space (no-op on raw stores) and stage it once for every shard,
        counted on shard 0.  The copy is complete on return: the shards'
        threads read it from their own streams."""
        x = np.ascontiguousarray(self.store.apply_col_perm(x_host))
        self.execs[0].store.stats.add_h2d(x.nbytes)
        x_dev = torch.from_numpy(x).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return x_dev

    def multiply(self, x, *, boundary_hook=None, cache=_CACHE_UNSET,
                 semiring: str = "plus_times", snapshot=None) -> np.ndarray:
        """A @ X as ``n_shards`` partial scans; the per-shard row blocks
        concatenate (in partition order) to the full result.

        ``cache`` overrides each shard executor's attached hot-chunk cache
        for this pass (``None`` = uncached), as :meth:`SEMSpMM.multiply`.

        Without a ``boundary_hook`` every shard streams concurrently.  With
        one, the hook is threaded through the *coordinator shard* — shard
        0, whose chunk space is the global prefix and whose tile rows are
        the lowest — and the remaining shards are held until the
        coordinator's scan completes, then run concurrently against the
        final (possibly hook-rewritten) operand.  That ordering makes
        mid-pass column writes compose exactly as in the unsharded elastic
        pass: a column written at coordinator boundary ``cs`` reaches
        coordinator tile rows at or after ``cs`` as the single scan would,
        and every non-coordinator tile row in full, because none of their
        chunks had streamed yet.  The hook's boundary is the coordinator
        executor's, behind a proxy that records ``write_columns`` so the
        writes can be replayed onto the held-back shards' operand."""
        x = np.asarray(x, np.float32)
        if x.shape[0] != self.padded_cols:
            x_pad = np.zeros((self.padded_cols, x.shape[1]), np.float32)
            x_pad[: x.shape[0]] = x
        else:
            x_pad = x
        x_dev = self._stage(x_pad)

        # One delta snapshot for the whole fan-out: shards stream
        # concurrently, and without a shared snapshot an update landing
        # mid-fan-out would leave row blocks at different versions inside
        # one result.  A caller-supplied snapshot pins it further up.
        snap = snapshot
        if snap is None:
            dl = self.store.delta_log
            snap = dl.snapshot() if dl is not None else None
        self.last_pass_version = snap[0] if snap is not None else 0

        # Per-pass cache override, shard-partitioned like the attached one.
        def shard_cache(i):
            if cache is _CACHE_UNSET or not hasattr(cache, "shard"):
                return cache
            return cache.shard(i)

        def fan_out(first: int, x_dev: torch.Tensor) -> List[np.ndarray]:
            futures = [self._pool.submit(
                self._shard_multiply, i, x_dev, cache=shard_cache(i),
                semiring=semiring, snapshot=snap)
                for i in range(first, self.n_shards)]
            return [f.result() for f in futures]

        if boundary_hook is None:
            blocks = fan_out(0, x_dev)
        else:
            writes: List[tuple] = []

            def recording_hook(b):
                boundary_hook(_RecordingBoundary(b, writes))

            head = self._shard_multiply(0, x_dev,
                                        boundary_hook=recording_hook,
                                        cache=shard_cache(0),
                                        semiring=semiring, snapshot=snap)
            if writes:
                x_host = np.array(x_pad)   # replay in write order
                for c0, cols in writes:
                    x_host[: cols.shape[0], c0:c0 + cols.shape[1]] = cols
                    x_host[cols.shape[0]:, c0:c0 + cols.shape[1]] = 0.0
                x_dev = self._stage(x_host)
            blocks = [head] + fan_out(1, x_dev)
        self.passes += 1
        return np.concatenate(blocks, axis=0)

    def column_bytes(self) -> int:
        """Memory cost of one dense column (input slice + output slice) —
        the single engine's: shards share the operand and their output
        blocks partition the same n rows."""
        return 4 * (self.n_rows + self.padded_cols)

    # -- aggregated accounting -----------------------------------------------
    @property
    def io_stats(self) -> IOStats:
        """Point-in-time sum of the shard stores' counters."""
        return IOStats.aggregate(ex.store.stats for ex in self.execs)

    def close(self) -> None:
        """Release the scan thread pool, the layout pins, the executors'
        staging buffers and the shard views' file mappings.  Idempotent."""
        self._pool.shutdown(wait=True)
        for h in self._pinned:
            h.unpin_layout()
        self._pinned = []
        for ex in self.execs:
            ex.close()

    def __enter__(self) -> "ShardedSEMSpMM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
