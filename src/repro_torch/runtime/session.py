"""Per-tenant session state for the shared-scan serving runtime.

A :class:`Session` is the unit of multi-tenancy: it contributes columns to
the packed wave (``x_columns``), receives its slice of the shared ``A @ X``
(``consume``), and advances its own iterate.  Iterative workloads (PageRank,
power iteration, label propagation) advance one operator application per
shared streaming pass; a converged tenant reports ``done`` and the scheduler
retires it, freeing its columns mid-workload for queued tenants (and growing
the hot-chunk cache's leftover budget).

Sessions hold *no* reference to the operator — the scheduler owns the single
shared ``SEMSpMM``; a session only describes what to multiply next and what
to do with the product.  That is what makes N tenants one streaming pass.

That statelessness is also what makes a session *portable*: everything a
session is — its kind, its operand columns, its hyperparameters, its
iteration state — is plain numpy plus scalars.  :class:`SessionSpec` is
that closure captured as data: the cross-host tier ships specs over the
wire (``to_wire``/``from_wire``), a :class:`~repro_torch.net.host.HostServer`
rebuilds the live session with :meth:`SessionSpec.build`, and on host
death the front door re-submits the *same spec* to a survivor — sessions
are deterministic functions of (spec, matrix bytes), so the replayed
tenant retires with bit-identical results.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class Session:
    """Base tenant: contribute columns, consume the product, maybe finish."""

    # The ring the shared pass must apply for this tenant's columns.  Almost
    # every session rides plus-times (BFS included — its or-and collapses to
    # a threshold in ``consume``); a session that genuinely needs another
    # ring (SSSP: min-plus) overrides this, and the scheduler serves it in a
    # ring-homogeneous wave — rings can't share one accumulator.
    semiring: str = "plus_times"

    def __init__(self, tenant_id: str = ""):
        self.tenant_id = tenant_id
        self.iterations = 0
        self.done = False
        self.result: Optional[np.ndarray] = None
        # Time-to-first-result accounting, stamped by the scheduler: wall
        # clocks at submission and at the first delivered product, plus the
        # same two instants on the scheduler's chunk-batch boundary clock
        # (deterministic — what the elastic-admission benchmarks assert on).
        self.t_submit: Optional[float] = None
        self.t_first_result: Optional[float] = None
        self.submit_clock: Optional[int] = None
        self.first_result_clock: Optional[int] = None
        # Which serving wave the fleet dispatcher routed this session to
        # (None when served by a lone scheduler) — the observable the
        # routing tests and per-wave load reports key on.
        self.wave_id: Optional[int] = None
        # Retirement callback, invoked by the scheduler's delivery path the
        # moment ``done`` flips true.  This is how a HostServer streams an
        # iterative session's result back over the wire as it retires,
        # without polling N tenants from a watcher thread.  Runs on the
        # serving wave's thread — keep it cheap and thread-safe.
        self.on_retire: Optional[Callable[["Session"], None]] = None

    @property
    def width(self) -> int:
        x = self.x_columns()
        return 1 if x.ndim == 1 else x.shape[1]

    def x_columns(self) -> np.ndarray:
        """Current operand columns, shape (n,) or (n, k)."""
        raise NotImplementedError

    def consume(self, y: np.ndarray) -> None:
        """Receive this tenant's slice of A @ X (shape (m, k)); advance."""
        raise NotImplementedError


class MultiplyRequest(Session):
    """One-shot A @ x query — done after a single shared pass."""

    def __init__(self, x: np.ndarray, tenant_id: str = ""):
        super().__init__(tenant_id)
        self._x = np.asarray(x, np.float32)
        if self._x.ndim == 1:
            self._x = self._x[:, None]
        self._squeeze = np.asarray(x).ndim == 1

    def x_columns(self) -> np.ndarray:
        return self._x

    def consume(self, y: np.ndarray) -> None:
        # copy: y is a view into the shared wave output; retaining it would
        # keep the whole (n, wave_width) array alive per tenant
        self.result = np.ascontiguousarray(y[:, 0] if self._squeeze else y)
        self.iterations = 1
        self.done = True


class PowerIterationSession(Session):
    """Dominant eigenvector by power iteration: x' = A x / ||A x||."""

    def __init__(self, x0: np.ndarray, *, tol: float = 1e-6,
                 max_iter: int = 100, tenant_id: str = ""):
        super().__init__(tenant_id)
        x0 = np.asarray(x0, np.float32)
        self.x = (x0 / np.linalg.norm(x0)).astype(np.float32)
        self.tol, self.max_iter = tol, max_iter
        self.eigenvalue = 0.0
        self.residuals: List[float] = []

    def x_columns(self) -> np.ndarray:
        return self.x[:, None]

    def consume(self, y: np.ndarray) -> None:
        y = y[:, 0]
        self.eigenvalue = float(self.x @ y)  # Rayleigh quotient
        norm = float(np.linalg.norm(y))
        x_new = (y / norm).astype(np.float32) if norm > 0 else self.x
        resid = float(np.abs(x_new - self.x).max())
        self.residuals.append(resid)
        self.x = x_new
        self.iterations += 1
        if resid < self.tol or self.iterations >= self.max_iter:
            self.result = self.x
            self.done = True


class PageRankSession(Session):
    """PageRank-as-a-service: one damped update per shared pass.

    The operator behind the scheduler must be the column-stochastic
    ``P = A^T D^{-1}`` (:func:`repro_torch.sparse.graph.pagerank_operator`); the
    update ``x' = d (P x + dangling/N) + (1-d)/N`` matches
    :func:`repro_torch.apps.pagerank.pagerank` step for step, so a session served
    through the shared scan returns the same scores as a dedicated run.
    """

    def __init__(self, n: int, dangling_mask: np.ndarray, *,
                 damping: float = 0.85, tol: float = 1e-8,
                 max_iter: int = 30, tenant_id: str = ""):
        super().__init__(tenant_id)
        self.n = n
        self.dangling_mask = dangling_mask
        self.damping, self.tol, self.max_iter = damping, tol, max_iter
        self.x = np.full(n, 1.0 / n, np.float32)
        self.residuals: List[float] = []

    def x_columns(self) -> np.ndarray:
        return self.x[:, None]

    def consume(self, y: np.ndarray) -> None:
        y = y[:, 0]
        dangling = float(self.x[self.dangling_mask].sum()) / self.n
        x_new = (self.damping * (y + dangling)
                 + (1.0 - self.damping) / self.n)
        resid = float(np.abs(x_new - self.x).sum())
        self.residuals.append(resid)
        self.x = x_new.astype(np.float32)
        self.iterations += 1
        if resid < self.tol or self.iterations >= self.max_iter:
            self.result = self.x
            self.done = True


class LabelPropagationSession(Session):
    """Seeded label propagation: X is (n, n_labels); each pass computes
    ``A @ X``, renormalizes rows, and clamps seed rows back to their labels.
    Converges when the label distribution stops moving.  A multi-column
    tenant — it is the in-runtime example of the paper's point that wider
    dense matrices amortize the stream better."""

    def __init__(self, seeds: np.ndarray, seed_labels: np.ndarray,
                 n: int, n_labels: int, *, tol: float = 1e-4,
                 max_iter: int = 50, tenant_id: str = ""):
        super().__init__(tenant_id)
        self.seeds = np.asarray(seeds)
        self.seed_labels = np.asarray(seed_labels)
        self.tol, self.max_iter = tol, max_iter
        self.x = np.zeros((n, n_labels), np.float32)
        self.x[self.seeds, self.seed_labels] = 1.0

    def x_columns(self) -> np.ndarray:
        return self.x

    def consume(self, y: np.ndarray) -> None:
        row_sum = y.sum(axis=1, keepdims=True)
        x_new = np.where(row_sum > 0, y / np.maximum(row_sum, 1e-12), self.x)
        x_new[self.seeds] = 0.0
        x_new[self.seeds, self.seed_labels] = 1.0
        delta = float(np.abs(x_new - self.x).max())
        self.x = x_new.astype(np.float32)
        self.iterations += 1
        if delta < self.tol or self.iterations >= self.max_iter:
            self.result = self.x
            self.labels = self.x.argmax(axis=1)
            self.done = True


class BFSSession(Session):
    """Breadth-first search served through the shared scan: one frontier
    expansion per pass, retirement when the frontier converges (empties).

    BFS is SpMV over the boolean or-and semiring
    (:data:`repro_torch.core.semiring.OR_AND`): ``frontier' = A ⊻.∧ frontier``.
    The shared executor computes plus-times, but over a non-negative
    operator and a 0/1 frontier the two coincide under a threshold —
    ``y_i = Σ_j A_ij · frontier_j`` is a sum of non-negative terms with at
    least one term ≥ the smallest live entry whenever the or-and result is
    true, so ``y_i > 0  ⇔  (A ⊻.∧ frontier)_i`` even when the float32 sum
    rounds (adding positives never cancels to zero).  That is how a
    *non-numeric* workload rides the same wave as PageRank tenants with no
    second engine: the semiring lives in ``consume``.

    The operator convention matches every other session here: a vertex
    ``v`` is reached from frontier vertex ``u`` when ``A[v, u] != 0``
    (edges are followed operator-row-ward).  ``result`` is the hop-count
    vector (int32, ``-1`` for unreachable); multi-source BFS is just a
    multi-vertex ``sources``.  The operator must be non-negative — signed
    values could cancel a reachable row to 0.0, which is a property of
    plus-times, not of this adapter.
    """

    def __init__(self, sources: np.ndarray, n: int, *,
                 max_depth: Optional[int] = None, tenant_id: str = ""):
        super().__init__(tenant_id)
        self.n = n
        self.sources = np.atleast_1d(np.asarray(sources, np.int64))
        self.max_depth = n if max_depth is None else max_depth
        self.distance = np.full(n, -1, np.int32)
        self.distance[self.sources] = 0
        self.visited = np.zeros(n, bool)
        self.visited[self.sources] = True
        self.frontier = np.zeros(n, np.float32)
        self.frontier[self.sources] = 1.0
        self.depth = 0

    @property
    def frontier_size(self) -> int:
        return int(self.frontier.sum())

    def x_columns(self) -> np.ndarray:
        return self.frontier[:, None]

    def consume(self, y: np.ndarray) -> None:
        self.depth += 1
        self.iterations += 1
        reached = (y[:, 0] != 0) & ~self.visited   # the or-and threshold
        self.distance[reached] = self.depth
        self.visited |= reached
        self.frontier = np.zeros(self.n, np.float32)
        self.frontier[reached] = 1.0
        if not reached.any() or self.depth >= self.max_depth:
            self.result = self.distance
            self.done = True


class SSSPSession(Session):
    """Single- (or multi-) source shortest paths served through the shared
    scan: one Bellman-Ford relaxation wave per pass, over the min-plus
    semiring (:data:`repro_torch.core.semiring.MIN_PLUS`).

    Unlike BFS, min-plus does NOT collapse to a plus-times threshold — the
    engine itself must relax (``y_i = min_j (A_ij + dist_j)``), so this is
    the first session kind that exercises the executor's ``semiring=``
    parameter end to end: the scheduler groups min-plus tenants into their
    own ring-homogeneous wave.  Edge weights are path lengths (the operator
    convention matches BFS: vertex ``v`` is relaxed from ``u`` via
    ``A[v, u]``); a binary store serves unit weights, making SSSP on it a
    weighted restatement of BFS — the oracle test pins exactly that.
    Converges when a relaxation wave changes no distance (Bellman-Ford
    terminates after at most n-1 productive waves on negative-cycle-free
    weights).  ``result`` is the float32 distance vector, ``inf`` for
    unreachable vertices.
    """

    semiring = "min_plus"

    def __init__(self, sources: np.ndarray, n: int, *,
                 max_iters: Optional[int] = None, tenant_id: str = ""):
        super().__init__(tenant_id)
        self.n = n
        self.sources = np.atleast_1d(np.asarray(sources, np.int64))
        self.max_iters = n if max_iters is None else max_iters
        self.dist = np.full(n, np.inf, np.float32)
        self.dist[self.sources] = 0.0

    def x_columns(self) -> np.ndarray:
        return self.dist[:, None]

    def consume(self, y: np.ndarray) -> None:
        new = np.minimum(self.dist, y[:, 0])
        self.iterations += 1
        settled = bool(np.array_equal(new, self.dist))
        self.dist = new.astype(np.float32)
        if settled or self.iterations >= self.max_iters:
            self.result = self.dist
            self.done = True


class SpGEMMSession(Session):
    """Semi-external SpGEMM as a long-running tenant: the serving store is
    A, the product streams to a tenant-owned output ``TileStore`` path.

    This is the one session kind whose work is *not* a function of the
    shared wave product — SpGEMM consumes the store itself, not ``A @ X``.
    It still rides the wave for scheduling: it contributes one zero column
    (so admission, elasticity, retirement, failover and the wire protocol
    all apply unchanged) and advances ``tile_rows_per_pass`` output tile
    rows of the underlying :class:`repro_torch.core.spgemm.SpGEMMJob` per shared
    pass, so a giant product trickles out across passes instead of
    stalling the wave.  ``needs_store`` makes the scheduler hand it the
    executor's store at submit time (``bind_store``) — the spec stays
    portable, and a failover replay on a survivor host rewrites the same
    product bits to the same tenant-owned path (the job is deterministic).

    ``result`` is the stats summary (int64: n_rows, n_cols, product_nnz,
    spill_cycles, peak_partial_bytes, budget, tile_rows) for product mode,
    or the per-vertex float64 triangle counts for ``mode="triangle"`` —
    both plain ndarrays, so retirement streams over the wire unchanged.
    """

    needs_store = True

    def __init__(self, out_path: Optional[str] = None,
                 b_path: Optional[str] = None, *, mode: str = "product",
                 budget_bytes: int = 64 << 20, tile_rows_per_pass: int = 8,
                 chunk_batch: int = 64, b_cache_bytes: int = 0,
                 optimize_out: bool = False, tenant_id: str = ""):
        super().__init__(tenant_id)
        if mode == "product" and not out_path:
            raise ValueError("spgemm session needs a tenant-owned out_path")
        self.out_path = out_path
        self.b_path = b_path
        self.mode = mode
        self.budget_bytes = int(budget_bytes)
        self.tile_rows_per_pass = int(tile_rows_per_pass)
        self.chunk_batch = int(chunk_batch)
        self.b_cache_bytes = int(b_cache_bytes)
        self.optimize_out = bool(optimize_out)
        self.stats = None
        self._store = None
        self._b_store = None   # opened here iff b_path was given
        self._job = None
        self._steps = None

    def bind_store(self, store) -> None:
        """Scheduler hook: receive the executor's serving store (A)."""
        self._store = store

    def x_columns(self) -> np.ndarray:
        if self._store is None:
            raise RuntimeError("spgemm session was not bound to a store — "
                               "submit it through a store-backed scheduler")
        return np.zeros((self._store.header["n_cols"], 1), np.float32)

    def _start(self) -> None:
        from repro_torch.core.spgemm import SpGEMMJob
        from repro_torch.io.storage import TileStore
        from repro_torch.runtime.cache import HotChunkCache
        if self._store is None:
            raise RuntimeError("spgemm session was not bound to a store")
        b = None
        if self.b_path:
            self._b_store = b = TileStore.open(self.b_path)
        cache = (HotChunkCache(self.b_cache_bytes)
                 if self.b_cache_bytes > 0 else None)
        # use_async=False: no prefetch thread parked across pass boundaries
        self._job = SpGEMMJob(
            self._store, b, self.out_path, mode=self.mode,
            partial_budget_bytes=self.budget_bytes,
            chunk_batch=self.chunk_batch, cache=cache,
            optimize_out=self.optimize_out, use_async=False)
        self._steps = self._job.tile_rows()

    def consume(self, y: np.ndarray) -> None:
        # y is the wave product of our zero column — cadence, not data
        if self._steps is None:
            self._start()
        self.iterations += 1
        advanced = 0
        try:
            while True:
                next(self._steps)
                advanced += 1
                if 0 < self.tile_rows_per_pass <= advanced:
                    return
        except StopIteration:
            self._finish()

    def _finish(self) -> None:
        job = self._job
        self.stats = job.stats
        self.result = (job.tri if self.mode == "triangle"
                       else job.stats.summary_array())
        job.close()
        if self._b_store is not None:
            self._b_store.close()
            self._b_store = None
        self.done = True


# ---------------------------------------------------------------------------
# Portable session specs (the cross-host tier's unit of work)
# ---------------------------------------------------------------------------
def _build_multiply(spec: "SessionSpec") -> Session:
    req = MultiplyRequest(spec.arrays["x"], tenant_id=spec.tenant_id)
    ring = spec.params.get("semiring")
    if ring:
        req.semiring = str(ring)   # instance override of the class attr
    return req


def _build_power_iteration(spec: "SessionSpec") -> Session:
    p = spec.params
    return PowerIterationSession(
        spec.arrays["x0"], tol=float(p.get("tol", 1e-6)),
        max_iter=int(p.get("max_iter", 100)), tenant_id=spec.tenant_id)


def _build_pagerank(spec: "SessionSpec") -> Session:
    p = spec.params
    return PageRankSession(
        int(p["n"]), spec.arrays["dangling_mask"].astype(bool),
        damping=float(p.get("damping", 0.85)), tol=float(p.get("tol", 1e-8)),
        max_iter=int(p.get("max_iter", 30)), tenant_id=spec.tenant_id)


def _build_labelprop(spec: "SessionSpec") -> Session:
    p = spec.params
    return LabelPropagationSession(
        spec.arrays["seeds"], spec.arrays["seed_labels"], int(p["n"]),
        int(p["n_labels"]), tol=float(p.get("tol", 1e-4)),
        max_iter=int(p.get("max_iter", 50)), tenant_id=spec.tenant_id)


def _build_bfs(spec: "SessionSpec") -> Session:
    p = spec.params
    max_depth = p.get("max_depth")
    return BFSSession(spec.arrays["sources"], int(p["n"]),
                      max_depth=None if max_depth is None else int(max_depth),
                      tenant_id=spec.tenant_id)


def _build_sssp(spec: "SessionSpec") -> Session:
    p = spec.params
    max_iters = p.get("max_iters")
    return SSSPSession(spec.arrays["sources"], int(p["n"]),
                       max_iters=None if max_iters is None else int(max_iters),
                       tenant_id=spec.tenant_id)


def _spgemm_kwargs(spec: "SessionSpec") -> dict:
    p = spec.params
    return dict(budget_bytes=int(p.get("budget_bytes", 64 << 20)),
                tile_rows_per_pass=int(p.get("tile_rows_per_pass", 8)),
                chunk_batch=int(p.get("chunk_batch", 64)),
                b_cache_bytes=int(p.get("b_cache_bytes", 0)),
                tenant_id=spec.tenant_id)


def _build_spgemm(spec: "SessionSpec") -> Session:
    p = spec.params
    return SpGEMMSession(out_path=str(p["out"]), b_path=p.get("b"),
                         mode="product",
                         optimize_out=bool(p.get("optimize_out", False)),
                         **_spgemm_kwargs(spec))


def _build_triangle_count(spec: "SessionSpec") -> Session:
    return SpGEMMSession(mode="triangle", **_spgemm_kwargs(spec))


SESSION_KINDS: Dict[str, Callable[["SessionSpec"], Session]] = {
    "multiply": _build_multiply,
    "power_iteration": _build_power_iteration,
    "pagerank": _build_pagerank,
    "labelprop": _build_labelprop,
    "bfs": _build_bfs,
    "sssp": _build_sssp,
    "spgemm": _build_spgemm,
    "triangle_count": _build_triangle_count,
}


@dataclasses.dataclass
class SessionSpec:
    """A session as data: kind, operand planes, hyperparameters, and (for a
    resumed tenant) iteration state — everything needed to rebuild the live
    session on any host holding the same matrix bytes.

    ``params`` must be JSON-safe scalars; ``arrays`` holds every ndarray
    (operands, masks, seeds, a mid-stream iterate used as the next ``x0``).
    ``build`` constructs the session through the :data:`SESSION_KINDS`
    registry — a closed set, so a spec arriving over the wire can never
    name arbitrary code.  Because sessions are deterministic, submitting
    one spec to two hosts (or to a survivor after a host died) produces
    bit-identical retirements — the property the front door's failover
    leans on."""

    kind: str
    tenant_id: str = ""
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    arrays: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # Slab scoping for partitioned cross-host queries: a slab-scoped spec
    # asks the serving host to run this work against tile-row slab ``slab``
    # of ``TileStore.partition_rows(n_slabs)`` instead of the full operator.
    # Both are None for ordinary whole-matrix sessions.
    slab: Optional[int] = None
    n_slabs: Optional[int] = None

    def with_slab(self, slab: int, n_slabs: int) -> "SessionSpec":
        """Copy of this spec scoped to one tile-row slab of the cluster
        partition plan.  The split is a pure function of the shared store
        header + meta, so every host derives identical slab boundaries from
        its own copy of the matrix."""
        return dataclasses.replace(self, slab=int(slab), n_slabs=int(n_slabs))

    def build(self) -> Session:
        if self.kind not in SESSION_KINDS:
            raise ValueError(f"unknown session kind {self.kind!r} "
                             f"(have: {sorted(SESSION_KINDS)})")
        return SESSION_KINDS[self.kind](self)

    # -- wire form -----------------------------------------------------------
    def to_wire(self) -> Tuple[dict, List[np.ndarray]]:
        """(JSON-safe header, ndarray planes in header['arrays'] order)."""
        names = sorted(self.arrays)
        header = {"kind": self.kind, "tenant_id": self.tenant_id,
                  "params": dict(self.params), "arrays": names}
        if self.slab is not None:
            header["slab"] = int(self.slab)
            header["n_slabs"] = int(self.n_slabs)
        return header, [self.arrays[n] for n in names]

    @classmethod
    def from_wire(cls, header: dict, planes: List[np.ndarray]
                  ) -> "SessionSpec":
        names = header.get("arrays", [])
        if len(names) != len(planes):
            raise ValueError(
                f"spec names {len(names)} planes {len(planes)} mismatch")
        slab = header.get("slab")
        n_slabs = header.get("n_slabs")
        return cls(kind=header["kind"], tenant_id=header.get("tenant_id", ""),
                   params=dict(header.get("params", {})),
                   arrays=dict(zip(names, planes)),
                   slab=None if slab is None else int(slab),
                   n_slabs=None if n_slabs is None else int(n_slabs))

    # -- convenience constructors -------------------------------------------
    @classmethod
    def multiply(cls, x: np.ndarray, tenant_id: str = "",
                 semiring: str = "plus_times") -> "SessionSpec":
        params = {} if semiring == "plus_times" else {"semiring": semiring}
        return cls("multiply", tenant_id, params, {"x": np.asarray(x)})

    @classmethod
    def power_iteration(cls, x0: np.ndarray, *, tol: float = 1e-6,
                        max_iter: int = 100, tenant_id: str = ""
                        ) -> "SessionSpec":
        return cls("power_iteration", tenant_id,
                   {"tol": tol, "max_iter": max_iter}, {"x0": np.asarray(x0)})

    @classmethod
    def pagerank(cls, n: int, dangling_mask: np.ndarray, *,
                 damping: float = 0.85, tol: float = 1e-8, max_iter: int = 30,
                 tenant_id: str = "") -> "SessionSpec":
        return cls("pagerank", tenant_id,
                   {"n": n, "damping": damping, "tol": tol,
                    "max_iter": max_iter},
                   {"dangling_mask": np.asarray(dangling_mask, np.uint8)})

    @classmethod
    def bfs(cls, sources: np.ndarray, n: int, *,
            max_depth: Optional[int] = None, tenant_id: str = ""
            ) -> "SessionSpec":
        return cls("bfs", tenant_id, {"n": n, "max_depth": max_depth},
                   {"sources": np.atleast_1d(np.asarray(sources, np.int64))})

    @classmethod
    def sssp(cls, sources: np.ndarray, n: int, *,
             max_iters: Optional[int] = None, tenant_id: str = ""
             ) -> "SessionSpec":
        return cls("sssp", tenant_id, {"n": n, "max_iters": max_iters},
                   {"sources": np.atleast_1d(np.asarray(sources, np.int64))})

    @classmethod
    def spgemm(cls, out: str, b: Optional[str] = None, *,
               budget_bytes: int = 64 << 20, tile_rows_per_pass: int = 8,
               chunk_batch: int = 64, b_cache_bytes: int = 0,
               optimize_out: bool = False, tenant_id: str = ""
               ) -> "SessionSpec":
        """Semi-external ``A @ B`` into the tenant-owned store at ``out``.
        ``b`` is a store *path* on the serving host (``None`` → B = the
        serving store itself, i.e. A·A); no ndarray planes travel — the
        matrices already live host-side, which is the whole point."""
        return cls("spgemm", tenant_id,
                   {"out": out, "b": b, "budget_bytes": budget_bytes,
                    "tile_rows_per_pass": tile_rows_per_pass,
                    "chunk_batch": chunk_batch,
                    "b_cache_bytes": b_cache_bytes,
                    "optimize_out": optimize_out}, {})

    @classmethod
    def triangle_count(cls, *, budget_bytes: int = 64 << 20,
                       tile_rows_per_pass: int = 8, chunk_batch: int = 64,
                       b_cache_bytes: int = 0, tenant_id: str = ""
                       ) -> "SessionSpec":
        """Per-vertex triangle counts of the (symmetric) serving store:
        the masked A·A reduction — retires with the float64 count vector."""
        return cls("triangle_count", tenant_id,
                   {"budget_bytes": budget_bytes,
                    "tile_rows_per_pass": tile_rows_per_pass,
                    "chunk_batch": chunk_batch,
                    "b_cache_bytes": b_cache_bytes}, {})
