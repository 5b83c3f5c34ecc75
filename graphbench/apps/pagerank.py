"""PageRank's window through the port: ``repro_torch.apps.pagerank.pagerank``
over a ``SEMOperator`` (a valued ``TileStore`` written in set-up) or an
``IMOperator`` (the chunk planes on the card).

Set-up is the port's own ingest: ``build_operator`` (P = A^T D^-1),
``dangling_vertices``, ``to_chunked`` and, for SEM, ``TileStore.write``.
A solve runs a fixed number of iterations from the uniform vector
(``tol=0``) and returns the scores on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from repro_torch.apps.common import IMOperator, SEMOperator
from repro_torch.apps.pagerank import (build_operator, dangling_vertices,
                                       pagerank)
from repro_torch.core.formats import COO, to_chunked
from repro_torch.core.sem import SEMConfig
from repro_torch.io.storage import TileStore

from graphbench import roofline


@dataclasses.dataclass
class State:
    op: object           # the wrapped operator the window uses
    ops: list            # the port's operators, for the counters
    dangling: np.ndarray
    damping: float
    device: object


def setup(s) -> State:
    cfg, st = s.config, s.config["store"]
    adj = COO(s.n, s.n, s.rows, s.cols, None)
    P = build_operator(adj)
    dangling = dangling_vertices(adj)
    ct = to_chunked(P, T=st["T"], C=st["C"])
    if s.operator == "sem":
        store = TileStore.write(str(s.tmpdir / "P"), ct, binary=st["binary"])
        op = SEMOperator(store, SEMConfig(chunk_batch=st["chunk_batch"]),
                         device=s.device)
        work = roofline.store_work(store.header, P.nnz)
    else:
        op = IMOperator(ct, device=s.device)
        work = roofline.raw_store_work(ct.n_rows, ct.n_cols, P.nnz,
                                       ct.n_chunks, st["binary"])
    return State(s.wrap(op, work), [op], dangling,
                 float(cfg["params"]["damping"]), s.device)


def solve(state: State, iterations: int) -> np.ndarray:
    return pagerank(state.op, state.dangling, damping=state.damping,
                    max_iter=iterations, tol=0.0, device=state.device).scores


def to_host(out: np.ndarray) -> np.ndarray:
    return out


def guarantees(state: State, counters: dict) -> dict:
    """Every SEM pass read the whole store: the bytes read over the
    window equal the passes times the store's size."""
    if not any(hasattr(op, "sem") for op in state.ops):
        return {}
    return {"bytes_read_gap": abs(counters["bytes_read"]
                                  - counters["pass_bytes"])}


def close(state: State) -> None:
    for op in state.ops:
        if hasattr(op, "sem"):
            op.sem.close()
    state.ops.clear()
