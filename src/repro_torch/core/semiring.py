"""Generalized SpMM over semirings, in PyTorch.

The paper notes PageRank-style graph algorithms are "generalized sparse
matrix multiplication" [4].  A semiring supplies (multiply, add, zero);
``plus_times`` is ordinary SpMM, ``or_and`` gives BFS frontiers, ``min_plus``
gives shortest-path relaxation, ``max_times`` gives widest-path/belief-style
updates.  These plain implementations are the oracle path; the CUDA kernel
specializes plus-times.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    mul: Callable
    add_segment: Callable  # (data, segment_ids, num_segments) -> reduced
    zero: float
    # the cross-chunk combine, named as in the JAX package (``add``, ``min``
    # or ``max``): chunks of one tile row land in separate segment
    # reductions and are folded into the accumulator with this combine
    scatter: str = "add"

    def is_plus_times(self) -> bool:
        return self.name == "plus_times"


def _segment_sum(data, seg, n):
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, seg, data)


def _make_segment_reduce(zero, reduce: str):
    def seg_reduce(data, seg, n):
        out = torch.full((n,) + tuple(data.shape[1:]), zero, dtype=data.dtype,
                         device=data.device)
        idx = seg.to(torch.int64).reshape((-1,) + (1,) * (data.dim() - 1))
        return out.scatter_reduce_(0, idx.expand_as(data), data, reduce,
                                   include_self=True)
    return seg_reduce


# Each reducer starts at the ring's additive identity, so empty rows come out
# as the identity in every execution path.
PLUS_TIMES = Semiring("plus_times", lambda a, x: a * x, _segment_sum, 0.0,
                      scatter="add")
OR_AND = Semiring("or_and",
                  lambda a, x: ((a != 0) & (x != 0)).to(x.dtype),
                  _make_segment_reduce(0.0, "amax"), 0.0, scatter="max")
MIN_PLUS = Semiring("min_plus", lambda a, x: a + x,
                    _make_segment_reduce(math.inf, "amin"), math.inf,
                    scatter="min")
MAX_TIMES = Semiring("max_times", lambda a, x: a * x,
                     _make_segment_reduce(-math.inf, "amax"), -math.inf,
                     scatter="max")

SEMIRINGS = {s.name: s for s in (PLUS_TIMES, OR_AND, MIN_PLUS, MAX_TIMES)}
