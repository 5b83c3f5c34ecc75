"""Multi-tenant graph-query serving runtime over the SEM-SpMM executor.

Packs concurrent queries into columns of one shared dense matrix and serves
them with shared streaming passes (batcher + scheduler) — elastically:
tenants can be admitted at chunk-batch boundaries *inside* an in-flight
pass and delivered from stitched partial passes (scheduler).  Iterative
per-tenant sessions advance one operator application per pass (session),
leftover memory budget pins hot chunk batches (cache, per-shard budget
slices when the scan is sharded), and replica routing (replica) spreads
waves across copies of the on-SSD matrix with failure fallback.  When
traffic outgrows one wave, a ServingFleet (fleet) runs N elastic waves
concurrently over one ReplicaSet with a least-backlog front-door
dispatcher and cross-wave arbitration of the column + hot-chunk budgets.

The runtime is host control code in numpy around the executor: the
device work is the executor's pass (:class:`repro_torch.core.sem.SEMSpMM`,
whose plus-times step is the gather kernel on the card).
"""
from repro_torch.runtime.api import (CACHE_UNSET, Executor, Mutable,
                                     Submitter, SubmitterClosed, Ticket)
from repro_torch.runtime.batcher import Batcher, Wave, WaveEntry
from repro_torch.runtime.cache import (CacheStats, HotChunkCache,
                                       PartitionedHotChunkCache)
from repro_torch.runtime.fleet import FleetWave, ServingFleet, WaveError
from repro_torch.runtime.replica import (ReplicaRouter, ReplicaSet,
                                         ReplicaState)
from repro_torch.runtime.scheduler import (MidPassState, PassReport,
                                           SharedScanScheduler)
from repro_torch.runtime.session import (SESSION_KINDS, BFSSession,
                                         LabelPropagationSession,
                                         MultiplyRequest, PageRankSession,
                                         PowerIterationSession, Session,
                                         SessionSpec, SSSPSession)

__all__ = [
    "CACHE_UNSET", "Executor", "Mutable", "Submitter", "SubmitterClosed",
    "Ticket",
    "Batcher", "Wave", "WaveEntry", "CacheStats", "HotChunkCache",
    "PartitionedHotChunkCache", "FleetWave", "ServingFleet", "WaveError",
    "ReplicaRouter", "ReplicaSet", "ReplicaState",
    "MidPassState", "PassReport", "SharedScanScheduler",
    "SESSION_KINDS", "BFSSession", "LabelPropagationSession",
    "MultiplyRequest", "PageRankSession", "PowerIterationSession",
    "Session", "SessionSpec", "SSSPSession",
]
