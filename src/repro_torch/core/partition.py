"""Load-balanced partitioning of tile rows.

The paper uses a *dynamic* fine-grain task queue (threads pull tile rows,
granularity shrinks near the end) to balance power-law nnz distributions.
Here, as in the JAX package, the queue is replaced by *static* greedy LPT
(longest-processing-time) bin packing at format-build time: tile rows
sorted by nnz, each assigned to the currently lightest partition.  The
deliverable is the same — near-equal work per worker on power-law graphs —
decided at conversion time instead of at run time.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.formats import ChunkedTiles


@dataclasses.dataclass
class Partitioning:
    assignment: np.ndarray  # int32 (n_tile_rows,) -> partition id
    loads: np.ndarray       # int64 (n_parts,) nnz per partition

    @property
    def imbalance(self) -> float:
        """max/mean load - 1 (0 = perfect balance)."""
        mean = self.loads.mean()
        return float(self.loads.max() / mean - 1.0) if mean > 0 else 0.0


def lpt_partition(tile_row_nnz: np.ndarray, n_parts: int) -> Partitioning:
    """Greedy LPT: heaviest tile rows first, each into the lightest bin."""
    order = np.argsort(tile_row_nnz)[::-1]
    loads = np.zeros(n_parts, dtype=np.int64)
    assignment = np.zeros(tile_row_nnz.shape[0], dtype=np.int32)
    # Heap-free O(n * log n_parts) via argmin on a small array: n_parts is
    # small (threads/devices), so a plain argmin is fine and vectorizes well.
    for trow in order:
        p = int(np.argmin(loads))
        assignment[trow] = p
        loads[p] += int(tile_row_nnz[trow])
    return Partitioning(assignment, loads)


def block_partition(tile_row_nnz: np.ndarray, n_parts: int) -> Partitioning:
    """Contiguous equal-*row-count* partitioning (the naive baseline the
    paper's load balancer is compared against in Fig 12)."""
    n = tile_row_nnz.shape[0]
    assignment = np.minimum((np.arange(n) * n_parts) // max(n, 1),
                            n_parts - 1).astype(np.int32)
    loads = np.bincount(assignment, weights=tile_row_nnz,
                        minlength=n_parts).astype(np.int64)
    return Partitioning(assignment, loads)


def tile_row_nnz(ct: ChunkedTiles) -> np.ndarray:
    return np.bincount(ct.meta[:, 0], weights=ct.meta[:, 3],
                       minlength=ct.n_tile_rows).astype(np.int64)


def split_chunks(ct: ChunkedTiles, part: Partitioning, n_parts: int
                 ) -> Tuple[np.ndarray, ...]:
    """Chunk index lists per partition, preserving (tile_row, tile_col) order
    inside each partition (keeps the write-once output discipline)."""
    chunk_part = part.assignment[ct.meta[:, 0]]
    return tuple(np.nonzero(chunk_part == p)[0] for p in range(n_parts))
