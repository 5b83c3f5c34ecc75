"""NMF's window through the port: ``repro_torch.apps.nmf.nmf`` over two
``SEMOperator``s, one on A's binary ``TileStore`` and one on A^T's.

Set-up is the port's own ingest: ``to_chunked`` of A and of A^T and
``TileStore.write`` of each.  A solve runs a fixed number of Lee-Seung
updates from the seeded start (``apps/nmf.py`` draws it from
``default_rng(seed)``), loss tracking off, and returns W and H as they
are on the card; they come to the host once the window has closed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from repro_torch.apps.common import SEMOperator
from repro_torch.apps.nmf import nmf
from repro_torch.core.formats import COO, to_chunked
from repro_torch.core.sem import SEMConfig
from repro_torch.io.storage import TileStore

from graphbench import roofline


@dataclasses.dataclass
class State:
    op_a: object         # wrapped operators the window uses
    op_at: object
    ops: list            # the port's operators, for the counters
    k: int
    seed: int


def setup(s) -> State:
    cfg, st = s.config, s.config["store"]
    if s.operator != "sem":
        raise ValueError("the NMF cells run over SEM operators only")
    adj = COO(s.n, s.n, s.rows, s.cols, None)
    ops, wrapped = [], []
    for name, m in (("A", adj), ("At", adj.transpose())):
        ct = to_chunked(m, T=st["T"], C=st["C"])
        store = TileStore.write(str(s.tmpdir / name), ct, binary=st["binary"])
        del ct
        op = SEMOperator(store, SEMConfig(chunk_batch=st["chunk_batch"]),
                         device=s.device)
        ops.append(op)
        wrapped.append(s.wrap(op, roofline.store_work(store.header, m.nnz)))
    return State(wrapped[0], wrapped[1], ops, int(cfg["params"]["k"]),
                 s.seed)


def solve(state: State, iterations: int):
    res = nmf(state.op_a, state.op_at, state.k, n_iter=iterations,
              seed=state.seed, track_loss=False)
    return res.W, res.H


def to_host(out) -> tuple:
    return tuple(t.cpu().numpy() for t in out)


def guarantees(state: State, counters: dict) -> dict:
    """Every pass read its whole store."""
    return {"bytes_read_gap": abs(counters["bytes_read"]
                                  - counters["pass_bytes"])}


def close(state: State) -> None:
    for op in state.ops:
        op.sem.close()
    state.ops.clear()
