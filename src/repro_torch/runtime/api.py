"""Typed surface of the serving stack: Executor and Submitter protocols.

Five layers historically duck-typed an executor surface (``SEMSpMM``,
``ShardedSEMSpMM``, ``ReplicaSet``) and three more each grew their own
submit convention (``SharedScanScheduler`` took live ``Session`` objects,
``ServingFleet`` the same, ``ClusterFrontDoor`` took ``SessionSpec``).
This module pins both surfaces down:

* :class:`Executor` — anything that can run one shared scan pass over the
  operator: ``multiply(x, *, boundary_hook=None, cache=...)``,
  ``column_bytes()``, ``io_stats``, ``close()`` / context manager.
* :class:`Submitter` — anything that accepts work as a portable
  :class:`~repro_torch.runtime.session.SessionSpec` and returns a
  :class:`Ticket`: ``submit(spec)``, ``deliver(timeout)``,
  ``drain(timeout)``, ``stats()``, ``close()``.

Both protocols are ``runtime_checkable`` so the conformance suite
(``tests/test_torch_fleet.py``) can assert ``isinstance`` against every
implementation.  Tickets and specs are pure control-plane objects wrapping
the existing engines: they add no device work.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.core.sem import _CACHE_UNSET

# Public alias for the engine's "cache kwarg not supplied" sentinel:
# ``multiply(x, cache=None)`` explicitly disables the cache for that pass,
# while omitting the kwarg keeps the executor's own cache.
CACHE_UNSET = _CACHE_UNSET

__all__ = [
    "CACHE_UNSET",
    "Executor",
    "Mutable",
    "Submitter",
    "SubmitterClosed",
    "Ticket",
    "spec_ticket",
]


class SubmitterClosed(RuntimeError):
    """Raised by every Submitter when ``submit`` is called after ``close``.

    Subclasses ``RuntimeError`` so call sites that guarded against the old
    per-implementation errors keep working.
    """


@runtime_checkable
class Executor(Protocol):
    """One shared scan pass over the streamed operator.

    Implementations: ``SEMSpMM`` (single engine), ``ShardedSEMSpMM``
    (nnz-balanced parallel shards), ``ReplicaSet`` (routed store copies).
    ``multiply`` agrees across all three for the same operand: bit for bit
    on the CPU and on integer-valued operands; on the card the kernel adds
    by atomics, so float sums agree within rounding of their order.
    """

    def multiply(self, x, *, boundary_hook=None, cache=CACHE_UNSET): ...

    def column_bytes(self) -> int: ...

    @property
    def io_stats(self): ...

    def close(self) -> None: ...

    def __enter__(self): ...

    def __exit__(self, *exc): ...


@runtime_checkable
class Mutable(Protocol):
    """The mutation surface of a versioned graph.

    Implementations: ``SEMSpMM``, ``ShardedSEMSpMM``, ``ReplicaSet``,
    ``ServingFleet`` (engine-local), and ``ClusterFrontDoor`` (fan-out to
    every host).  ``apply_updates`` appends one
    :class:`~repro_torch.io.storage.UpdateBatch` of edge inserts/deletes to the
    graph's log-structured delta overlay and returns the new monotonic
    version; in-flight passes keep the snapshot they started with, so the
    flip is only observable at a pass boundary.  ``version`` is 0 for a
    frozen (never-mutated) graph and host-identical for replicas that
    applied the same update sequence.
    """

    def apply_updates(self, batch) -> int: ...

    @property
    def version(self) -> int: ...


@runtime_checkable
class Submitter(Protocol):
    """Spec-in, ticket-out serving surface.

    Implementations: ``SharedScanScheduler`` (one elastic wave, caller
    drives passes), ``ServingFleet`` (N threaded waves), and
    ``ClusterFrontDoor`` (RPC over per-host fleets).  ``submit`` after
    ``close`` raises :class:`SubmitterClosed` on every implementation.
    """

    def submit(self, spec): ...

    def deliver(self, timeout: Optional[float] = None): ...

    def drain(self, timeout: Optional[float] = None): ...

    def stats(self) -> Dict[str, Any]: ...

    def close(self) -> None: ...


class Ticket:
    """Handle for one submitted :class:`~repro_torch.runtime.session.SessionSpec`.

    Thread-safe: completion may fire on a wave thread or the front door's
    event loop while the submitter's caller waits.  ``wait`` re-raises the
    stored ``error`` (host loss that exhausted failover, a rejected spec)
    so failures surface at the call site instead of as ``None`` results.
    """

    def __init__(self, spec=None, session=None):
        self.spec = spec
        self.session = session
        tenant = ""
        if spec is not None:
            tenant = spec.tenant_id
        elif session is not None:
            tenant = session.tenant_id
        self.tenant_id = tenant
        self.iterations = 0
        self.result = None
        self.error: Optional[Exception] = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: List[Callable[["Ticket"], None]] = []

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def add_done_callback(self, fn: Callable[["Ticket"], None]) -> None:
        """Run ``fn(ticket)`` on completion (immediately if already done)."""
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _complete(self) -> None:
        with self._lock:
            if self._done.is_set():
                return
            callbacks, self._callbacks = self._callbacks, []
            self._done.set()
        for fn in callbacks:
            fn(self)

    def wait(self, timeout: Optional[float] = None):
        """Block until served; return the result or re-raise the error."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"tenant {self.tenant_id!r} not served within {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return self.result

    def __repr__(self):
        state = "done" if self.done else "pending"
        return f"Ticket(tenant_id={self.tenant_id!r}, {state})"


def spec_ticket(spec, completed: Optional[queue.Queue] = None):
    """Build ``(session, ticket)`` for a spec on a local submitter.

    The live session's retirement hook is chained so the ticket captures
    ``iterations``/``result`` and completes exactly when the scheduler
    retires the session; ``completed`` (a queue) receives the ticket for
    ``deliver``-style streaming.
    """
    session = spec.build()
    ticket = Ticket(spec=spec, session=session)
    prev = session.on_retire

    def _retired(s):
        if prev is not None:
            prev(s)
        ticket.iterations = s.iterations
        ticket.result = s.result
        ticket._complete()

    session.on_retire = _retired
    if completed is not None:
        ticket.add_done_callback(completed.put)
    return session, ticket
