"""The harness: finds a cell's files by name, makes its inputs from the
seed, runs its window through the port, reduces the trace, reads the
metrics and decides ``correct``.

Everything that belongs to one configuration, cell, traffic mix,
application or metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the graph, the store, the application and its
  parameters, the guarantees and the limits of the comparison;
- ``workloads/<cell>.json``: the configuration, the operator (``sem`` or
  ``im``), the traffic mix and the chips;
- ``traffic/<traffic>.json``: the mix's parameters;
- ``gen/<generator>.py``: the input generator the configuration names;
- ``apps/<app>.py``: ingest through the port, the warm-up, one solve and
  the guarantees a run can show;
- ``reference/<app>.py``: the plain reference and the comparison;
- ``metrics/<metric>.py``: one reader per metric, end to end or per layer.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level modules that may not be loaded in the process that prints a
# result: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SOLVE = "gb.solve"
KINDS = {"configs": ".json", "workloads": ".json", "traffic": ".json",
         "gen": ".py", "apps": ".py", "reference": ".py", "metrics": ".py"}


# -- finding files by name -------------------------------------------------
def find(kind: str, name: str, base: Path = BENCH) -> Path:
    """``<base>/<kind>/<name><suffix>``; a missing file raises."""
    path = Path(base) / kind / f"{name}{KINDS[kind]}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r}: {path}")
    return path


_MODULES: Dict[Path, object] = {}


def load_module(path: Path):
    """Import a file of the benchmark by its path, once a process."""
    path = Path(path).resolve()
    mod = _MODULES.get(path)
    if mod is None:
        stem = "".join(ch if ch.isalnum() else "_" for ch in path.stem)
        name = f"graphbench_{path.parent.name}_{stem}"
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Optional[Path] = None) -> dict:
    return load_json(path or ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # workloads/<cell>.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    bench: dict          # the whole manifest
    base: Path


def resolve(name: str, bench: dict, base: Path = BENCH) -> Cell:
    """The cell ``name`` of ``bench`` with its files; a cell whose file and
    manifest entry disagree raises."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[name]
    wl = load_json(find("workloads", name, base))
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {wl[key]!r} in its file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    return Cell(name, entry, wl, load_json(find("configs", wl["config"], base)),
                load_json(find("traffic", wl["traffic"], base)), bench, base)


def metrics_for(cell: Cell, trace: bool) -> List[dict]:
    """The manifest's metrics this cell reports: its end-to-end metrics in
    an untraced run, the per-layer metrics that list it (or, without a
    ``workloads`` key, that move one of its end-to-end metrics) in a
    traced one."""
    e2e = [m for m in cell.bench["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in cell.bench["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


# -- what the readers see ------------------------------------------------------
@dataclasses.dataclass
class Run:
    """One run's window as the metric readers see it.  ``counters`` are
    the window's deltas of the port's counters (``IOStats`` of every SEM
    store, ``SEMSpMM.passes``); ``products`` holds one
    ``(span, bytes, flops)`` per operator product of the window."""
    cell: str
    operator: str
    setup_s: float
    window_s: float
    iterations: int
    solves: int
    counters: Dict[str, int]
    products: List[Tuple[str, int, int]]
    trace: Optional["Trace"] = None


class Spanned:
    """An operator whose every ``dot`` is a span of the trace (when
    traced) and records the product's work; everything else is the
    operator's own."""

    def __init__(self, op, kind: str, work, products: list, tracing: bool):
        self._op, self._span, self._work = op, f"gb.dot.{kind}", work
        self._products, self._tracing = products, tracing

    def __getattr__(self, name):
        return getattr(self._op, name)

    def dot(self, x):
        p = 1 if x.ndim == 1 else int(x.shape[1])
        self._products.append((self._span,) + self._work.product(p))
        with _span(self._span, self._tracing):
            return self._op.dot(x)


@dataclasses.dataclass
class Setup:
    """What an application's ``setup`` gets: the configuration, the
    operator kind, the device, a scratch directory for its stores, the
    seed, the graph (host int64 edge lists, sorted, no duplicates) and
    ``wrap(op, work)``, which returns the operator the window must use."""
    config: dict
    operator: str
    device: torch.device
    tmpdir: Path
    seed: int
    n: int
    rows: np.ndarray
    cols: np.ndarray
    wrap: Callable


# -- the trace -------------------------------------------------------------------
def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Trace:
    """A ``torch.profiler`` trace of the window reduced to what the
    readers need: the benchmark's spans (``gb.*``), each device operation
    with the host time of its launch, and the host operations."""

    def __init__(self, events):
        self.dev = []        # (start, end, name, launch or None) in ns
        self.host = []       # (start, end, name)
        self.span_map: Dict[str, List[Tuple[int, int]]] = {}
        runtime, ops, dev = {}, {}, []
        for e in events:
            s, t, name = e.start_ns(), e.end_ns(), e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name.startswith("gb."):
                    continue        # the device's copy of a benchmark span
                dev.append((s, t, name, e.correlation_id(),
                            e.linked_correlation_id()))
                continue
            if name.startswith("gb."):
                self.span_map.setdefault(name, []).append((s, t))
                continue
            self.host.append((s, t, name))
            if name.startswith("cu"):
                runtime[e.correlation_id()] = s
            else:
                ops[e.correlation_id()] = s
        linked = 0
        for s, t, name, corr, link in dev:
            launch = runtime.get(corr)
            if launch is None and link:
                launch = ops.get(link)
            linked += launch is not None
            self.dev.append((s, t, name, launch))
        self.linked = linked
        for v in self.span_map.values():
            v.sort()
        self.host.sort()
        self.host_starts = [h[0] for h in self.host]
        solves = self.span_map.get(SOLVE, [])
        self.window = ((solves[0][0], max(t for _, t in solves)) if solves
                       else (0, 0))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def spans(self, name: str) -> List[Tuple[int, int]]:
        return self.span_map.get(name, [])

    def span_s(self, name: str) -> List[float]:
        return [(t - s) / 1e9 for s, t in self.spans(name)]

    def kernel_s_in(self, name: str) -> float:
        """Device seconds of every kernel (no copy, no memset) launched
        inside a span ``name``: by the host time of its launch, or, where
        the trace links none, by its start on the device."""
        spans = self.spans(name)
        starts = [s for s, _ in spans]
        total = 0
        for s, t, op, launch in self.dev:
            if _is_copy(op):
                continue
            at = s if launch is None else launch
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += t - s
        return total / 1e9

    def _busy(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the window."""
        lo, hi = self.window
        out: List[List[int]] = []
        for s, t, _, _ in sorted(self.dev):
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self._busy()) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time, summed by name."""
        by: Dict[str, int] = {}
        for s, t, name, _ in self.dev:
            by[name[:120]] = by.get(name[:120], 0) + (t - s)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, at: int) -> str:
        """The innermost host operation running at ``at``, else the
        innermost benchmark span."""
        i = bisect.bisect_right(self.host_starts, at) - 1
        for j in range(i, max(i - 4096, -1), -1):
            if self.host[j][1] >= at:
                return self.host[j][2]
        best = None
        for name, spans in self.span_map.items():
            for s, t in spans:
                if s <= at <= t and (best is None or s > best[0]):
                    best = (s, name)
        return "idle host" if best is None else best[1]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time inside the window, summed by what the
        host was doing at the middle of each gap."""
        lo, hi = self.window
        by: Dict[str, int] = {}
        prev = lo
        for s, t in self._busy() + [(hi, hi)]:
            if s > prev:
                name = self._host_at((prev + s) // 2)
                by[name] = by.get(name, 0) + (s - prev)
            prev = max(prev, t)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def _span(name: str, on: bool):
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def _profiled(on: bool, device: torch.device):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _flush(path: str) -> None:
    """Write a store the port has just written through to the disk, so
    that the kernel's write-back of it (30 s after the write, by default)
    does not fall into the window."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters(state) -> Dict[str, int]:
    """The port's counters over every SEM operator of ``state``: bytes
    read from the stores and staged to the card (``IOStats``), passes,
    and the bytes those passes had to read (passes times store size)."""
    sems = [op.sem for op in state.ops if hasattr(op, "sem")]
    return {"bytes_read": sum(s.io_stats.bytes_read for s in sems),
            "h2d_bytes": sum(s.io_stats.h2d_bytes for s in sems),
            "passes": sum(s.passes for s in sems),
            "pass_bytes": sum(s.passes * s.store.nbytes for s in sems)}


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of ``FORBIDDEN`` modules among ``names`` (this
    process's modules by default), each compared whole: ``repro_torch``
    is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _number(v) -> Optional[float]:
    v = float(v)
    return v if math.isfinite(v) else None


def decide(per_output: List[Dict[str, float]], guarantees: Dict[str, float],
           limits: Dict[str, float]) -> Tuple[bool, int, Dict[str, float]]:
    """``correct``, the number of failed outputs and the numbers compared:
    each output's comparison and each guarantee held to its limit, every
    number read as the worst over the outputs.  No output is no pass."""
    numbers = {k: float(v) for k, v in guarantees.items()}
    for d in per_output:
        for k, v in d.items():
            v = float(v)
            numbers[k] = (v if k not in numbers or not math.isfinite(v)
                          else max(numbers[k], v))

    def within(k, v):
        return math.isfinite(v) and v <= limits[k]
    failed = sum(not all(within(k, v) for k, v in d.items())
                 for d in per_output)
    correct = (failed == 0 and len(per_output) > 0
               and all(within(k, v) for k, v in numbers.items()))
    return correct, failed, numbers


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, *, start: float,
             shrink: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """Run ``cell`` once: inputs from ``seed``, set-up, a window of
    ``seconds``, the check.  Returns the result object and the lines that
    compare each number with its limit.  ``shrink`` replaces parts of the
    configuration (``graph`` and ``store`` keys), for the CPU tests."""
    cfg = json.loads(json.dumps(cell.config))
    for key, part in (shrink or {}).items():
        cfg[key].update(part)
    g = cfg["graph"]
    app = load_module(find("apps", cfg["app"], cell.base))
    ref = load_module(find("reference", cfg["app"], cell.base))
    gen = load_module(find("gen", g["generator"], cell.base))
    iters = int(cfg["params"]["iterations"])
    tmp = Path(tempfile.mkdtemp(prefix="graphbench_"))
    products: list = []
    marks = [("start", start), ("imports", time.perf_counter())]
    try:
        rows, cols = gen.rmat(g["scale"], g["edge_factor"], a=g["a"],
                              b=g["b"], c=g["c"], seed=seed, device=device)
        rows, cols = rows.cpu().numpy(), cols.cpu().numpy()
        n = 1 << g["scale"]
        if device.type == "cuda":
            # the draw's temporaries are freed: the peak is the program's
            torch.cuda.reset_peak_memory_stats(device)
        marks.append(("generate", time.perf_counter()))

        def wrap(op, work):
            return Spanned(op, cell.workload["operator"], work, products,
                           trace)
        state = app.setup(Setup(cfg, cell.workload["operator"], device, tmp,
                                seed, n, rows, cols, wrap))
        for op in state.ops:
            if hasattr(op, "sem"):
                _flush(op.sem.store.path + ".bin")
        marks.append(("ingest", time.perf_counter()))
        app.solve(state, int(cell.traffic["warmup_iterations"]))
        _sync(device)
        marks.append(("warm-up", time.perf_counter()))
        before = _counters(state)
        products.clear()
        outputs, iterations = [], 0
        with _profiled(trace, device) as prof:
            t0 = time.perf_counter()
            setup_s = t0 - start
            ends = []
            while True:
                with _span(SOLVE, trace):
                    outputs.append(app.solve(state, iters))
                iterations += iters
                ends.append(time.perf_counter())
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
            window_s = time.perf_counter() - t0
        marks.append(("window", time.perf_counter()))
        print("graphbench: solves end at " + ", ".join(
            f"{t - t0:.3f}" for t in ends) + " s", file=sys.stderr)
        after = _counters(state)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        tr = Trace(prof.profiler.kineto_results.events()) if trace else None
        if tr is not None:
            marks.append(("trace", time.perf_counter()))
            print(f"graphbench: trace of {len(tr.dev)} device and "
                  f"{len(tr.host)} host operations, {tr.linked} device "
                  "operations linked to their launch", file=sys.stderr,
                  flush=True)
        counters = {k: after[k] - before[k] for k in after}
        run = Run(cell.name, cell.workload["operator"], setup_s, window_s,
                  iterations, len(outputs), counters, list(products), tr)
        guarantees = app.guarantees(state, counters)
        outputs = [app.to_host(o) for o in outputs]
        app.close(state)
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    expected = ref.solve(cfg, n, rows, cols, seed, device)
    per_output = [ref.compare(o, expected) for o in outputs]
    marks.append(("check", time.perf_counter()))
    print("graphbench: " + ", ".join(
        f"{name} {t - marks[i][1]:.3f} s"
        for i, (name, t) in enumerate(marks[1:])), file=sys.stderr,
        flush=True)
    limits = cfg["limits"]
    correct, failed, numbers = decide(per_output, guarantees, limits)
    metrics = {}
    for m in metrics_for(cell, trace):
        value = load_module(find("metrics", m["name"], cell.base)).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(outputs),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": _number(v), "limit": limits[k]}
                        for k, v in numbers.items()}
    lines = [f"check {k}: {v!r} (limit {limits[k]!r})"
             for k, v in numbers.items()]
    return result, lines
