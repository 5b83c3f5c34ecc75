#!/usr/bin/env python3
"""Run the port's main path on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0] [--scale 22]

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name, the device count, its power limit;
2. build: the CUDA kernel from ``src/repro_torch/kernels/csrc`` (seconds and
   the registers ``-Xptxas -v`` reports);
3. set-up: an R-MAT graph (edge factor 16) made from ``--seed``, its
   PageRank operator written as a valued TileStore (T = 16384, C = 2048),
   the same pattern as a binary store, and an ``.optimize()``d copy of that;
4. kernels: the chunk-batch kernel (K1a) and the one-shot kernel (K2)
   against their plain versions on the card, at the main path's shapes
   (256-chunk batches of the real stores, p = 8): bit for bit on
   integer-valued data, to 1e-5 on normal data; times from CUDA events;
5. engine: ``SEMSpMM.multiply`` (p = 8, integer operand) on the raw and the
   optimized binary store, equal to a float64 scipy product, with the exact
   IOStats counts and one kernel launch per batch; a third pass of each runs
   under ``torch.profiler`` for the kernel's summed device time and the
   card's idle share;
6. PageRank: 30 iterations over the SEM operator (the main path, K1a) and
   over the IM operator (K2), against a float64 scipy power iteration.

The last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs a CUDA card: without
one it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
T, C, BATCH, P = 16384, 2048, 256, 8
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
FLOAT_TOL = 1e-5                # kernel vs plain on non-integer data


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` with ``reps`` calls captured in
    one CUDA graph and replayed: back-to-back on the card, with no host
    launch cost between them (``cuda_ms`` includes it when a call costs
    the host more than the card)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def planes_on(batch, dev):
    """A host batch as contiguous device tensors (uint16 as int16 bits)."""
    out = []
    for a in batch:
        if a is None:
            out.append(None)
            continue
        a = np.array(a)
        out.append(torch.from_numpy(
            a.view(np.int16) if a.dtype == np.uint16 else a).to(dev))
    return out


def operand(n_cols: int, p: int, rng, integer: bool, dev) -> torch.Tensor:
    n_pad = -(-n_cols // T) * T
    x = torch.zeros((n_pad, p), dtype=torch.float32, device=dev)
    vals = (rng.integers(-4, 5, (n_cols, p)) if integer
            else rng.standard_normal((n_cols, p)))
    x[:n_cols] = torch.from_numpy(vals.astype(np.float32)).to(dev)
    return x


def bound(nbytes: int, flops: int):
    """Least time on the card (ms) and what sets it: the bytes over the HBM
    rate or the float32 operations over the peak rate, whichever is
    longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lane_work(meta, n_valid, rows, cols, vals, T_=T):
    """What the kernel must touch for the valid chunks of a batch: the plane
    bytes it reads, the distinct X rows it gathers, the distinct output rows
    it updates, and the live lanes.  A raw or decoded index plane and the
    value plane are read only below each chunk's nnz; a delta plane is read
    in full, since its prefix sum runs over every lane; meta is read for
    the valid chunks, n_valid once."""
    from repro_torch.kernels.sem_spmm import _decode_lanes
    nv = int(n_valid.reshape(-1)[0])
    m = meta[:nv].to(torch.int64)
    r, c = _decode_lanes(meta[:nv], rows[:nv], cols[:nv], T_)
    live = torch.arange(r.shape[1], device=r.device)[None, :] < m[:, 3:4]
    n_live = int(live.sum())
    out_rows = torch.unique((m[:, 0:1] * T_ + r)[live]).numel()
    in_rows = torch.unique((m[:, 1:2] * T_ + c)[live]).numel()
    delta = cols.dtype == torch.uint8
    idx_lanes = nv * rows.shape[1] if delta else n_live
    plane_bytes = (meta.element_size() * meta.shape[1] * nv
                   + n_valid.element_size()
                   + idx_lanes * (rows.element_size() + cols.element_size())
                   + (0 if vals is None else n_live * vals.element_size()))
    return plane_bytes, in_rows, out_rows, n_live


def batch_bound(meta, n_valid, rows, cols, vals, p, T_=T):
    """Least time for one batch (K1a): the planes' live bytes, each X row
    the live lanes name read once, each accumulator row they update read
    and written once; 2 flops per live lane and column."""
    plane_bytes, in_rows, out_rows, n_live = lane_work(
        meta, n_valid, rows, cols, vals, T_)
    return bound(plane_bytes + 4 * p * (in_rows + 2 * out_rows),
                 2 * n_live * p)


# -- phase 3: set-up --------------------------------------------------------
def build_stores(scale: int, seed: int, tmp: Path):
    from repro_torch.apps.pagerank import build_operator
    from repro_torch.core.formats import to_chunked
    from repro_torch.io.storage import TileStore
    from repro_torch.sparse.generate import rmat
    t0 = time.perf_counter()
    adj = rmat(scale, 16, seed=seed)
    pr_op = build_operator(adj)
    ct = to_chunked(pr_op, T=T, C=C)
    stores = {"val": TileStore.write(str(tmp / "val"), ct),
              "bin": TileStore.write(str(tmp / "bin"), ct, binary=True)}
    stores["binopt"] = stores["bin"].optimize(str(tmp / "binopt"))
    log(f"set-up: scale {scale}, {adj.n_rows} vertices, {pr_op.nnz} edges, "
        f"{ct.n_chunks} chunks; stores val {stores['val'].nbytes} B, "
        f"bin {stores['bin'].nbytes} B, binopt {stores['binopt'].nbytes} B; "
        f"{time.perf_counter() - t0:.1f} s")
    return adj, pr_op, ct, stores


# -- phase 4: kernels against their plain versions --------------------------
def kernel_cases(stores, dev):
    """``(name, batch planes, integer operand?, n_valid)`` at the main
    path's shapes: one 256-chunk batch of each plane type, a padded tail."""
    from repro_torch.core.sem import SEMConfig, SEMSpMM
    from repro_torch.core.formats import ENC_FLAT_U16, ENC_FLAT_U24
    cases = []
    val, binst, opt = stores["val"], stores["bin"], stores["binopt"]
    mid = (val.n_chunks // 2 // BATCH) * BATCH
    n = min(BATCH, val.n_chunks - mid)
    cases.append(("raw u16, valued", val.read_batch_raw(mid, n), False, n))
    cases.append(("raw u16, binary", binst.read_batch_raw(mid, n), True, n))
    cases.append(("i32 (IM mode)", binst.read_batch(mid, n), True, n))
    tags = np.asarray(opt.header["encodings"])
    for tag, label in ((ENC_FLAT_U16, "u8 16-bit deltas"),
                       (ENC_FLAT_U24, "u16/u8 24-bit deltas")):
        full = [(s, n) for s, n in opt.batch_plan(BATCH)
                if tags[s] == tag]
        if full:
            s, n = max(full, key=lambda sn: sn[1])
            cases.append((f"optimized {label} ({n} chunks)",
                          opt.read_batch_raw(s, n), True, n))
    # the tail batch, padded by the engine's own rule
    s, n = binst.batch_plan(BATCH)[-1]
    if n == BATCH:
        s, n = s + 37, n - 37
    sem = SEMSpMM(binst, SEMConfig(chunk_batch=BATCH), device=dev)
    (padded, nv), = sem._pad_tail(iter([binst.read_batch_raw(s, n)]))
    check(nv == n < padded[0].shape[0], "tail batch is padded")
    cases.append((f"tail batch, {nv} real + {padded[0].shape[0] - nv} pads",
                  padded, True, nv))
    return cases


def run_kernel_phase(stores, ct, rng, dev):
    from repro_torch.kernels import sem_spmm
    header = stores["bin"].header
    n_acc = -(-header["n_rows"] // T) * T
    records = {}
    for name, batch, integer, n_valid in kernel_cases(stores, dev):
        meta, rows, cols, vals = planes_on(batch, dev)
        nv = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        x_pad = operand(header["n_cols"], P, rng, integer, dev)
        acc0 = torch.zeros((n_acc, P), device=dev)
        got = acc0.clone()
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, got, T=T)
        want = sem_spmm.spmm_tiles_acc_plain(meta, nv, rows, cols, vals,
                                             x_pad, acc0.clone(), T=T)
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        if integer:
            check(torch.equal(got, want), f"K1a {name}: bitwise")
        else:
            check(torch.allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL),
                  f"K1a {name}: within {FLOAT_TOL}")
        log(f"K1a {name}: max |kernel - plain| = {diff} "
            f"({'bitwise' if integer else f'tol {FLOAT_TOL}'})")
        if name == "raw u16, valued":   # the main path's plane type
            records["K1a"] = time_k1a(meta, nv, rows, cols, vals, x_pad,
                                      acc0, diff)
    # untouched tile rows keep their sentinels
    binst = stores["bin"]
    s = (binst.n_chunks // 3 // BATCH) * BATCH
    n = min(BATCH, binst.n_chunks - s)
    meta, rows, cols, vals = planes_on(binst.read_batch_raw(s, n), dev)
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    x_pad = operand(header["n_cols"], P, rng, True, dev)
    sentinel = torch.full((n_acc, P), 1.0e6, device=dev)
    got = sentinel.clone()
    sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, got, T=T)
    want = sem_spmm.spmm_tiles_acc_plain(meta, nv, rows, cols, vals, x_pad,
                                         sentinel.clone(), T=T)
    check(torch.equal(got, want), "K1a sentinel accumulator: bitwise")
    touched = torch.zeros(n_acc // T, dtype=torch.bool, device=dev)
    touched[meta[:, 0].long()] = True
    blocks = got.view(-1, T, P)
    check(bool((blocks[~touched] == 1.0e6).all()),
          "K1a leaves untouched tile rows' sentinels alone")
    log(f"K1a sentinel accumulator: {int((~touched).sum())} untouched tile "
        "rows kept bit for bit")
    records["K2"] = run_k2(ct, rng, dev)
    return records


def time_k1a(meta, nv, rows, cols, vals, x_pad, acc0, diff):
    from repro_torch.kernels import sem_spmm
    acc = acc0.clone()

    def launch():
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, acc, T=T)
    ms = graph_ms(launch, reps=50)
    call_ms = cuda_ms(launch, reps=50)
    log(f"K1a per call: {ms} ms on the card (graph replay), {call_ms} ms "
        "through the wrapper one launch at a time")
    plain_ms = cuda_ms(lambda: sem_spmm.spmm_tiles_acc_plain(
        meta, nv, rows, cols, vals, x_pad, acc, T=T), reps=5, warmup=1)
    # yardstick: cuSPARSE through torch.sparse.mm on the same batch as a
    # prebuilt CSR over the tile rows it touches (never used by the port)
    r, c = sem_spmm._decode_lanes(meta, rows, cols, T)
    m = meta.to(torch.int64)
    live = torch.arange(C, device=meta.device)[None, :] < m[:, 3:4]
    t_lo = int(m[:, 0].min())
    grow = (m[:, 0:1] * T + r)[live] - t_lo * T
    gcol = (m[:, 1:2] * T + c)[live]
    gval = vals[live]
    n_span = (int(m[:, 0].max()) + 1 - t_lo) * T
    csr = torch.sparse_coo_tensor(torch.stack([grow, gcol]), gval,
                                  (n_span, x_pad.shape[0]),
                                  check_invariants=False
                                  ).coalesce().to_sparse_csr()
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x_pad), reps=20)
    bound_ms, bound_by = batch_bound(meta, nv, rows, cols, vals, P)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_diff=diff)


def run_k2(ct, rng, dev):
    """K2 over the whole ChunkedTiles (the binary pattern: integer data)."""
    from repro_torch.kernels import sem_spmm
    lanes = np.arange(C)[None, :]
    pattern = (lanes < ct.meta[:, 3:4]).astype(np.float32)
    meta = torch.from_numpy(ct.meta).to(dev)
    rows = torch.from_numpy(ct.row_local).to(dev)
    cols = torch.from_numpy(ct.col_local).to(dev)
    vals = torch.from_numpy(pattern).to(dev)
    x_pad = operand(ct.n_cols, P, rng, True, dev)
    ntr = ct.n_tile_rows
    got = sem_spmm.spmm_tiles(meta, rows, cols, vals, x_pad, T=T,
                              n_tile_rows=ntr)
    acc = torch.zeros_like(got)
    nv = torch.tensor([ct.n_chunks], dtype=torch.int32, device=dev)
    want = sem_spmm.spmm_tiles_acc_plain(meta, nv, rows, cols, vals, x_pad,
                                         acc, T=T)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    check(torch.equal(got, want), "K2 whole ChunkedTiles: bitwise")
    log(f"K2 whole ChunkedTiles ({ct.n_chunks} chunks): max |kernel - plain| "
        f"= {diff} (bitwise)")
    ms = cuda_ms(lambda: sem_spmm.spmm_tiles(
        meta, rows, cols, vals, x_pad, T=T, n_tile_rows=ntr), reps=10)
    plain_ms = cuda_ms(lambda: sem_spmm.spmm_tiles_acc_plain(
        meta, nv, rows, cols, vals, x_pad, acc.zero_(), T=T), reps=2,
        warmup=1)
    m = meta.to(torch.int64)
    live = torch.arange(C, device=dev)[None, :] < m[:, 3:4]
    grow = (m[:, 0:1] * T + rows.to(torch.int64))[live]
    gcol = (m[:, 1:2] * T + cols.to(torch.int64))[live]
    csr = torch.sparse_coo_tensor(torch.stack([grow, gcol]), vals[live],
                                  (ntr * T, x_pad.shape[0]),
                                  check_invariants=False
                                  ).coalesce().to_sparse_csr()
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x_pad), reps=10)
    del grow, gcol, live, csr
    # the one-shot product writes its whole output once
    plane_bytes, in_rows, _, n_live = lane_work(meta, nv, rows, cols, vals)
    bound_ms, bound_by = bound(plane_bytes + 4 * P * (in_rows + ntr * T),
                               2 * n_live * P)
    del rows, cols, vals
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_diff=diff)


# -- phase 5: the engine ----------------------------------------------------
def expected_h2d(store, p: int) -> int:
    """Bytes a pass ships, from the shapes alone: the padded operand, then
    per batch meta, n_valid and the index planes at their stored widths
    (no values for a binary store), each batch padded as the engine pads."""
    from repro_torch.core.formats import ENC_COLS_U8, ENC_ROWS_U8
    h = store.header
    tags = np.asarray(h.get("encodings", [0] * h["n_chunks"]))
    plan = store.batch_plan(BATCH)
    fragmented = len(plan) > -(-h["n_chunks"] // BATCH)
    total = -(-h["n_cols"] // T) * T * p * 4
    for s, n in plan:
        tgt = BATCH
        if fragmented and n < BATCH:
            tgt = 1 << (n - 1).bit_length() if n < 32 else min(
                -(-n // 32) * 32, BATCH)
        tag = int(tags[s])
        width = (1 if tag & ENC_ROWS_U8 else 2) + (1 if tag & ENC_COLS_U8
                                                   else 2)
        total += tgt * (4 * store.meta_ints + width * C
                        + (0 if h["binary"] else 4 * C)) + 4
    return total


def run_engine_phase(stores, pr_op, rng, dev, card):
    import scipy.sparse as sp
    from repro_torch.core.sem import SEMConfig, SEMSpMM
    from repro_torch.kernels import sem_spmm
    x = rng.integers(-4, 5, (pr_op.n_cols, P)).astype(np.float32)
    a = sp.csr_matrix((np.ones(pr_op.nnz), (pr_op.rows, pr_op.cols)),
                      shape=(pr_op.n_rows, pr_op.n_cols))
    want = a @ x.astype(np.float64)
    check(np.abs(want).max() < 2 ** 24, "integer sums stay exact in f32")
    for name in ("bin", "binopt"):
        store = stores[name]
        sem = SEMSpMM(store, SEMConfig(chunk_batch=BATCH), device=dev)
        for rep in range(3):        # cold, warm, warm under the profiler
            traced = rep == 2
            before = dataclasses.replace(store.stats)
            sem_spmm.reset_launches()
            with (profile(activities=[ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                got = sem.multiply(x)
                secs = time.perf_counter() - t0
            launches = sem_spmm.LAUNCHES["spmm_tiles_acc"]
            st = store.stats
            check(np.array_equal(got, want.astype(np.float32)),
                  f"engine {name}: equal to scipy")
            check(st.bytes_read - before.bytes_read == store.nbytes,
                  f"engine {name}: bytes_read == store.nbytes")
            check(st.h2d_bytes - before.h2d_bytes == expected_h2d(store, P),
                  f"engine {name}: h2d_bytes from the shapes")
            check(st.overlap_batches - before.overlap_batches
                  == sem.n_batches - 1, f"engine {name}: overlap_batches")
            check(launches == sem.n_batches,
                  f"engine {name}: one launch per batch")
            log(f"engine {name} pass {rep}: equal to scipy; "
                f"{sem.n_batches} batches = {launches} launches; "
                f"bytes_read {st.bytes_read - before.bytes_read}, "
                f"h2d {st.h2d_bytes - before.h2d_bytes}, overlap "
                f"{st.overlap_batches - before.overlap_batches}; "
                f"{secs:.3f} s/pass, {pr_op.nnz / secs:.4g} edges/s"
                f"{' (traced)' if traced else ''} [{card}]")
            if traced:
                log(f"engine {name} trace: " + device_time(prof, secs, warm))
            warm = secs


def device_time(prof, secs: float, warm: float) -> str:
    """What a torch.profiler trace of one pass shows of the card: the
    kernel's summed device time, the copies', and the union of all device
    activity against the pass's wall time (traced, and the untraced warm
    pass before it), as the share the card sat idle."""
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return "no device activity recorded: idle share not measured"
    kernel_us = sum(e.time_range.elapsed_us() for e in spans
                    if "chunk_gather_kernel" in e.name)
    n_kernel = sum("chunk_gather_kernel" in e.name for e in spans)
    copies = {}
    for e in spans:
        if e.name.startswith("Memcpy"):
            copies[e.name] = copies.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, end = 0.0, float("-inf")
    for e in sorted(spans, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return (f"{n_kernel} kernel launches summing {kernel_us / 1e3:.3f} ms "
            f"on the card, copies "
            + ", ".join(f"{k}: {v / 1e3:.3f} ms" for k, v in copies.items())
            + f"; device busy "
            f"{busy_us / 1e3:.3f} ms of {secs * 1e3:.1f} ms traced "
            f"(idle {1 - busy_us / 1e6 / secs:.4f}) and of "
            f"{warm * 1e3:.1f} ms untraced (idle "
            f"{1 - busy_us / 1e6 / warm:.4f})")


# -- phase 6: PageRank ------------------------------------------------------
def pagerank_f64(pr_op, dangling, iters: int, damping: float = 0.85):
    import scipy.sparse as sp
    n = pr_op.n_rows
    deg = np.bincount(pr_op.cols, minlength=n).astype(np.float64)
    a = sp.csr_matrix((1.0 / deg[pr_op.cols], (pr_op.rows, pr_op.cols)),
                      shape=(n, n))
    x = np.full(n, 1.0 / n)
    for _ in range(iters):
        x = damping * (a @ x + x[dangling].sum() / n) + (1.0 - damping) / n
    return x


def run_pagerank_phase(stores, ct, adj, pr_op, dev, card):
    from repro_torch.apps.common import IMOperator, SEMOperator
    from repro_torch.apps.pagerank import dangling_vertices, pagerank
    from repro_torch.kernels import sem_spmm
    iters = 30
    dangling = dangling_vertices(adj)
    ref = pagerank_f64(pr_op, dangling, iters)
    launches = {}
    for label, make, kernel in (
            ("SEM", lambda: SEMOperator(stores["val"], device=dev),
             "spmm_tiles_acc"),
            ("IM", lambda: IMOperator(ct, device=dev), "spmm_tiles")):
        op = make()
        sem_spmm.reset_launches()
        t0 = time.perf_counter()
        res = pagerank(op, dangling, max_iter=iters, tol=0.0, device=dev)
        secs = time.perf_counter() - t0
        launches[kernel] = sem_spmm.LAUNCHES[kernel]
        per_pass = (op.sem.n_batches if label == "SEM" else 1)
        check(launches[kernel] == iters * per_pass,
              f"PageRank {label}: {kernel} launched once per batch")
        l1 = float(np.abs(res.scores - ref).sum())
        rel = float((np.abs(res.scores - ref) / ref).max())
        # float32 against float64: scores near 1/n carry ~7 digits, and each
        # of the 30 contracting iterations rounds every row sum once more,
        # so a score's relative error is typically ~1e-6 and the L1 distance
        # of the two probability vectors ~1e-6 as well; the largest of 4M
        # relative errors is some 10x the typical one, ~1e-5.  The limits
        # give those 10x room; an accumulation in a narrower type (bf16,
        # ~3 digits) would fail both.
        check(np.isfinite(res.scores).all() and l1 < 1e-5 and rel < 1e-4,
              f"PageRank {label}: within tolerance of float64")
        log(f"PageRank {label}: {res.iterations} iterations, final residual "
            f"{res.residuals[-1]:.3e}, L1 to float64 {l1:.3e}, max rel "
            f"{rel:.3e}, max abs {np.abs(res.scores - ref).max():.3e}; "
            f"{secs / iters:.4f} s/iteration [{card}]")
        del op
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import build
    dev = torch.device("cuda", torch.cuda.current_device())
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    log(f"device: {kind}, count {count}, nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch.sparse warns about its own beta state; the yardstick is timed
    # only, its result is not used
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    # one profiler cycle per traced pass: nothing is lost
    warnings.filterwarnings("ignore", message="Warning: Profiler clears")

    info = build("sem_spmm")
    regs = [ln.split(":", 1)[1].strip() for ln in info.ptxas.splitlines()
            if "Used" in ln]
    log(f"build: {info.path.name} in {info.seconds:.1f} s; ptxas, per "
        f"instantiation: " + " | ".join(regs))

    rng = np.random.default_rng(args.seed)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        adj, pr_op, ct, stores = build_stores(args.scale, args.seed, tmp)
        records = run_kernel_phase(stores, ct, rng, dev)
        run_engine_phase(stores, pr_op, rng, dev, card)
        launches = run_pagerank_phase(stores, ct, adj, pr_op, dev, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = "src/repro_torch/kernels/csrc/sem_spmm.cu"
    meta = {
        "K1a": dict(name="spmm_tiles_acc (K1a, gather)",
                    replaces="src/repro/kernels/sem_spmm.py:299",
                    launches=launches["spmm_tiles_acc"]),
        "K2": dict(name="spmm_tiles (K2, gather)",
                   replaces="src/repro/kernels/sem_spmm.py:253",
                   launches=launches["spmm_tiles"]),
    }
    kernels = []
    for key in ("K1a", "K2"):
        r = records[key]
        kernels.append(dict(
            meta[key], route="cuda", source=src,
            # both names: the record's readers use either
            max_abs_diff=r["max_abs_diff"], max_abs_err=r["max_abs_diff"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    check(all(k["launches"] > 0 for k in kernels),
          "every kernel ran on its path")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
