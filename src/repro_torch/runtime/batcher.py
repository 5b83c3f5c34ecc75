"""Request queue + column packer for the multi-tenant serving runtime.

The paper's headline crossover (Fig 5: SEM-SpMM reaches ~100% of in-memory
throughput once the dense matrix has >= 4 columns) is a *batching* theorem in
disguise: many concurrent single-vector queries against the same on-SSD graph
should be packed into columns of one shared ``X`` and served by a single
streaming pass — converting I/O-bound SpMV into compute-bound SpMM.

The batcher owns admission control.  Its column budget per wave is
``SEMSpMM.columns_that_fit`` — the paper's §3.6 memory-budget policy (spend
memory on dense columns first) reused as the admission limit: a request is
admitted when its columns still fit the wave; otherwise it waits in FIFO
order.  Admission is work-conserving but order-preserving (no overtaking:
a wide tenant at the head of the queue is never starved by narrow ones
behind it).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from repro_torch.runtime.session import Session


@dataclasses.dataclass
class WaveEntry:
    """One admitted tenant's column span inside the packed X."""
    session: Session
    col_offset: int
    width: int


@dataclasses.dataclass
class Wave:
    """A packed wave: shared dense matrix + scatter map back to tenants."""
    x: np.ndarray                 # (n_cols_of_A, total_width) float32
    entries: List[WaveEntry]

    @property
    def width(self) -> int:
        return self.x.shape[1]


class Batcher:
    """FIFO request queue + column packer up to a per-wave column budget.

    Submission is thread-safe: in a serving fleet, the front-door dispatcher
    enqueues from its caller's thread while this batcher's wave thread pops
    at pass (and chunk-batch) boundaries — the lock keeps the deque walk in
    ``pending_columns`` consistent with a concurrent append, and admission
    atomic with respect to new arrivals."""

    def __init__(self, n_operand_rows: int):
        self.n_operand_rows = n_operand_rows  # n_cols of the sparse operator
        self._queue: Deque[Session] = deque()
        self._lock = threading.Lock()
        self.admitted_total = 0

    def submit(self, session: Session) -> Session:
        x = session.x_columns()
        if x.shape[0] != self.n_operand_rows:
            raise ValueError(
                f"session operand has {x.shape[0]} rows, operator expects "
                f"{self.n_operand_rows}")
        if session.width < 1:
            raise ValueError("session contributes no columns; a zero-width "
                             "tenant can never be served")
        with self._lock:
            self._queue.append(session)
        return session

    @property
    def pending(self) -> int:
        return len(self._queue)

    def pending_columns(self) -> int:
        with self._lock:
            return sum(s.width for s in self._queue)

    def pending_sessions(self) -> List[Session]:
        """Consistent snapshot of the queued sessions (front-door failure
        accounting: a dead wave's loss manifest is its active set plus this
        queue, taken under the same lock a concurrent submit uses)."""
        with self._lock:
            return list(self._queue)

    def peek(self) -> Session:
        """The queue head (the only admission candidate — FIFO, no
        overtaking; the elastic scheduler admits it mid-pass)."""
        return self._queue[0]

    def pop(self) -> Session:
        with self._lock:
            return self._queue.popleft()

    def admit(self, active: List[Session], col_budget: int) -> List[Session]:
        """Move queued sessions into ``active`` while the wave still has
        column budget.  FIFO, no overtaking — except that a session wider
        than the whole budget is admitted *alone* (the scheduler then serves
        it with vertical partitioning, paper §3.3)."""
        with self._lock:
            while self._queue:
                head = self._queue[0]
                used = sum(s.width for s in active)
                if head.width > col_budget and not active:
                    active.append(self._queue.popleft())
                    self.admitted_total += 1
                    break  # oversized tenant gets a dedicated (sliced) wave
                if used + head.width > col_budget:
                    break
                active.append(self._queue.popleft())
                self.admitted_total += 1
        return active

    @staticmethod
    def pack(active: List[Session]) -> Optional[Wave]:
        """Build the shared X from every active tenant's current columns."""
        if not active:
            return None
        entries: List[WaveEntry] = []
        blocks: List[np.ndarray] = []
        off = 0
        for s in active:
            x = s.x_columns()
            x = x[:, None] if x.ndim == 1 else x
            entries.append(WaveEntry(s, off, x.shape[1]))
            blocks.append(np.asarray(x, np.float32))
            off += x.shape[1]
        return Wave(np.concatenate(blocks, axis=1), entries)
