#!/usr/bin/env python3
"""Run the port's paths on one CUDA card and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py [--seed 0] [--scale 22] [--mxu-scale 20]

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name, the device count, its power limit;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, started together (seconds and the registers
   ``-Xptxas -v`` reports);
3. set-up: an R-MAT graph (edge factor 16) made from ``--seed`` at
   ``--scale``, its PageRank operator written as a valued TileStore
   (T = 16384, C = 2048), the same pattern (Aᵀ's) as a binary store and an
   ``.optimize()``d copy of that; A's pattern as a binary store; the
   symmetrised pattern A + Aᵀ as a binary store; and the densify cell: the
   same kinds of stores of an R-MAT graph at ``--mxu-scale`` with T = 2048,
   C = 256;
4. kernels: the gather chunk-batch kernel (K1a) and its one-shot use (K2)
   against their plain versions at the main path's shapes (256-chunk
   batches of the real stores, p = 8): bit for bit on integer-valued data,
   to 1e-5 on normal data; times from CUDA events;
4b. densify kernels: the same for the densify kernel (K1b) and its one-shot
   use (K2 mxu) on the densify cell's stores at p = 16;
4c. crossover: K1a and K1b on one 256-chunk batch at T in {256 .. 4096} and
   p in {1, 8, 16}, the table ``kernels/ops.py::pick_variant`` follows;
5. engine: ``SEMSpMM.multiply`` (p = 8, integer operand) on the raw and the
   optimized binary store, equal to a float64 scipy product, with the exact
   IOStats counts and one kernel launch per batch; a third pass of each runs
   under ``torch.profiler`` for the kernel's summed device time and the
   card's idle share;
6. PageRank: 30 iterations over the SEM operator (K1a) and over the IM
   operator (K2), against a float64 scipy power iteration;
7. NMF (k = 16, 3 iterations): over SEM stores of A and Aᵀ against IM, at
   ``--scale`` with the gather kernel, and on the densify cell's stores with
   the densify kernel (SEM: K1b, IM: K2 mxu) against the gather kernel;
8. eigensolver: thick-restart Lanczos (k = 4) over the SEM operator of the
   symmetrised graph, its basis on the card, against scipy's ``eigsh`` in
   float64; then the same with the basis in a DenseStore (SEM-min).

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
TM, CM, PM = 2048, 256, 16      # the densify cell: tile, chunk, operand width
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # H100 SXM, TF32 on the tensor cores, dense
# Kernel vs plain on non-integer data, relative to the terms' magnitude:
# see check_float.
FLOAT_TOL = 1e-5
CROSS_T, CROSS_P = (256, 512, 1024, 2048, 4096), (1, 8, 16)
CROSS_ROWS = 1 << 16            # the crossover batches' leading row block
NMF_K, NMF_ITERS = 16, 3
# NMF SEM vs IM and densify vs gather: the reference's own test tolerance
# (tests/test_apps.py::test_nmf_sem_matches_im); both sides sum float32 in
# other orders, and three multiplicative updates keep that noise small.
NMF_RTOL, NMF_ATOL = 1e-4, 1e-5
# A Lee–Seung loss never increases in exact arithmetic; its float32 value
# (a sum over n*k products, cancelling against ||A||^2) carries relative
# noise near 1e-6, so a step may rise by at most 1e-5 of the loss.
LOSS_SLACK = 1e-5
EIG_K, EIG_RESTARTS = 4, 5
# Ritz values of a float32 Krylov basis against float64 ARPACK: at scales
# 14 and 17 five restarts came within 3.3e-7 relative (2.4e-6 at 13); the
# limit gives 4x room over the worst, and a value a restart or more short
# of convergence (8.5e-5 and more at 17) fails.
EIG_RTOL = 1e-5


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


def operand(n_cols: int, p: int, rng, integer: bool, dev,
            T_: int = T) -> torch.Tensor:
    n_pad = -(-n_cols // T_) * T_
    x = torch.zeros((n_pad, p), dtype=torch.float32, device=dev)
    vals = (rng.integers(-4, 5, (n_cols, p)) if integer
            else rng.standard_normal((n_cols, p)))
    x[:n_cols] = torch.from_numpy(vals.astype(np.float32)).to(dev)
    return x


def check_float(variant, what, meta, nv, rows, cols, vals, x_pad, got,
                want, T_=T) -> float:
    """Kernel against plain version on non-integer data.  Each sums an
    output element's terms in float32, in orders that differ (atomics on
    both sides), so the two differ by rounding of the order of the terms'
    magnitudes, not of the result's: where terms cancel, the result is small
    and the difference is not.  So the bound is elementwise FLOAT_TOL times
    |A|·|x|, the sum of the terms' magnitudes; a reordered float32 sum of n
    terms is typically off by sqrt(n)·2**-24 of it (2e-6 at a thousand
    terms), and a dropped or doubled term is off by far more.  Returns the
    largest difference over that scale."""
    from repro_torch.kernels import sem_spmm
    scale = sem_spmm._PLAIN[variant](
        meta, nv, rows, cols, None if vals is None else vals.abs(),
        x_pad.abs(), torch.zeros_like(got), T=T_)
    err = (got - want).abs()
    check(bool((err <= FLOAT_TOL * scale).all()),
          f"{what}: within {FLOAT_TOL} of |A|·|x|")
    return float((err / scale.clamp_min(1e-30)).max())


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


def binary_tiles(ct):
    """The same ChunkedTiles with value 1 on every live lane (a pattern)."""
    lanes = np.arange(ct.C)[None, :]
    return dataclasses.replace(
        ct, vals=(lanes < ct.meta[:, 3:4]).astype(np.float32))


def build_wide_stores(adj, tmp: Path):
    """Set-up of the wide-operand phases at ``--scale``: A's binary store
    and its ChunkedTiles (NMF; the PageRank stores hold Aᵀ's pattern), and
    the symmetrised pattern A + Aᵀ as a binary store (the eigensolver)."""
    from repro_torch.core.formats import COO, to_chunked
    from repro_torch.io.storage import TileStore
    t0 = time.perf_counter()
    ct_a = to_chunked(adj, T=T, C=C)
    a = TileStore.write(str(tmp / "a"), ct_a, binary=True)
    log(f"set-up: A's binary store, {ct_a.n_chunks} chunks, {a.nbytes} B, "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sym = COO(adj.n_rows, adj.n_cols, np.concatenate([adj.rows, adj.cols]),
              np.concatenate([adj.cols, adj.rows]), None).dedup()
    t1 = time.perf_counter()
    ct_s = to_chunked(sym, T=T, C=C)
    t2 = time.perf_counter()
    sym_store = TileStore.write(str(tmp / "sym"), ct_s, binary=True)
    log(f"set-up: A + Aᵀ binary store, {sym.nnz} entries, {ct_s.n_chunks} "
        f"chunks, {sym_store.nbytes} B, {time.perf_counter() - t0:.1f} s "
        f"(union {t1 - t0:.1f} s, chunking {t2 - t1:.1f} s, writing "
        f"{time.perf_counter() - t2:.1f} s)")
    return dict(ct_a=ct_a, a=a, sym=sym, sym_store=sym_store)


def build_cell(scale: int, seed: int, tmp: Path):
    """The densify cell: an R-MAT graph at ``scale``, its PageRank operator
    chunked at T = 2048, C = 256 and written valued, binary (Aᵀ's pattern)
    and optimized; A's pattern written binary for NMF."""
    from repro_torch.apps.pagerank import build_operator
    from repro_torch.core.formats import to_chunked
    from repro_torch.io.storage import TileStore
    from repro_torch.sparse.generate import rmat
    t0 = time.perf_counter()
    adj = rmat(scale, 16, seed=seed)
    pr_op = build_operator(adj)
    ct = to_chunked(pr_op, T=TM, C=CM)
    stores = {"val": TileStore.write(str(tmp / "m_val"), ct),
              "bin": TileStore.write(str(tmp / "m_bin"), ct, binary=True)}
    stores["binopt"] = stores["bin"].optimize(str(tmp / "m_binopt"))
    log(f"set-up: densify cell, scale {scale}, {adj.n_rows} vertices, "
        f"{pr_op.nnz} edges, {ct.n_chunks} chunks (fill "
        f"{pr_op.nnz / (ct.n_chunks * CM):.4f}); stores val "
        f"{stores['val'].nbytes} B, bin {stores['bin'].nbytes} B, binopt "
        f"{stores['binopt'].nbytes} B; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ct_a = to_chunked(adj, T=TM, C=CM)
    stores["a"] = TileStore.write(str(tmp / "m_a"), ct_a, binary=True)
    log(f"set-up: densify cell, A's binary store, {ct_a.n_chunks} chunks, "
        f"{stores['a'].nbytes} B, {time.perf_counter() - t0:.1f} s")
    return dict(scale=scale, adj=adj, pr_op=pr_op, ct=ct, ct_a=ct_a,
                ct_at=binary_tiles(ct), stores=stores)


# -- phase 4: kernels against their plain versions --------------------------
def kernel_cases(stores, dev):
    """``(name, batch planes, integer operand?, n_valid)`` from the given
    stores: one 256-chunk batch of each plane type, a padded tail."""
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
            how = "bitwise"
        else:
            rel = check_float("gather", f"K1a {name}", meta, nv, rows, cols,
                              vals, x_pad, got, want, T)
            how = f"at most {rel} of |A|·|x|, limit {FLOAT_TOL}"
        log(f"K1a {name}: max |kernel - plain| = {diff} ({how})")
        if name == "raw u16, valued":   # the main path's plane type
            records["K1a"] = time_batch("gather", meta, nv, rows, cols,
                                        vals, x_pad, acc0, diff)
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


def time_batch(variant, meta, nv, rows, cols, vals, x_pad, acc0, diff,
               T_=T, label="K1a"):
    """Times of one chunk-batch kernel on one batch: device time from 50
    launches replayed in a CUDA graph, the wrapper one launch at a time, the
    plain version, and cuSPARSE on the same batch as a yardstick."""
    from repro_torch.kernels import sem_spmm
    acc = acc0.clone()
    p, C_ = x_pad.shape[1], rows.shape[1]

    def launch():
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, acc, T=T_,
                                variant=variant)
    ms = graph_ms(launch, reps=50)
    call_ms = cuda_ms(launch, reps=50)
    log(f"{label} per call: {ms} ms on the card (graph replay), {call_ms} ms "
        "through the wrapper one launch at a time")
    plain_ms = cuda_ms(lambda: sem_spmm._PLAIN[variant](
        meta, nv, rows, cols, vals, x_pad, acc, T=T_), reps=5, warmup=1)
    # yardstick: cuSPARSE through torch.sparse.mm on the same batch as a
    # prebuilt CSR over the tile rows it touches (never used by the port)
    r, c = sem_spmm._decode_lanes(meta, rows, cols, T_)
    m = meta.to(torch.int64)
    live = torch.arange(C_, device=meta.device)[None, :] < m[:, 3:4]
    t_lo = int(m[:, 0].min())
    grow = (m[:, 0:1] * T_ + r)[live] - t_lo * T_
    gcol = (m[:, 1:2] * T_ + c)[live]
    gval = (torch.ones_like(grow, dtype=torch.float32) if vals is None
            else vals[live])
    n_span = (int(m[:, 0].max()) + 1 - t_lo) * T_
    csr = torch.sparse_coo_tensor(torch.stack([grow, gcol]), gval,
                                  (n_span, x_pad.shape[0]),
                                  check_invariants=False
                                  ).coalesce().to_sparse_csr()
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x_pad), reps=20)
    bound_ms, bound_by = batch_bound(meta, nv, rows, cols, vals, p, T_)
    if variant == "mxu":
        # the route's own tensor-core work: two products, two TF32 terms
        n16 = int(((m[:, 3].clamp(max=C_) + 15) // 16 * 16).sum())
        route_ms = 1e3 * 2 * 2 * 2 * n16 * T_ * p / TF32_FLOPS_PER_S
        log(f"{label} densify work: {n16} live lanes (rounded to 16) x T x p"
            f" x 8 flops = {route_ms} ms at 495 TF32 TFLOP/s")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_diff=diff)


def run_k2(ct, rng, dev, variant="gather", T_=T, p=P, reps=10,
           plain_reps=2, label="K2"):
    """The one-shot kernel over the whole ChunkedTiles (the binary pattern:
    integer data)."""
    from repro_torch.kernels import sem_spmm
    C_ = ct.C
    meta = torch.from_numpy(ct.meta).to(dev)
    rows = torch.from_numpy(ct.row_local).to(dev)
    cols = torch.from_numpy(ct.col_local).to(dev)
    vals = torch.from_numpy(binary_tiles(ct).vals).to(dev)
    x_pad = operand(ct.n_cols, p, rng, True, dev, T_)
    ntr = ct.n_tile_rows
    got = sem_spmm.spmm_tiles(meta, rows, cols, vals, x_pad, T=T_,
                              n_tile_rows=ntr, variant=variant)
    acc = torch.zeros_like(got)
    nv = torch.tensor([ct.n_chunks], dtype=torch.int32, device=dev)
    want = sem_spmm._PLAIN[variant](meta, nv, rows, cols, vals, x_pad, acc,
                                    T=T_)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    check(torch.equal(got, want), f"{label} whole ChunkedTiles: bitwise")
    log(f"{label} whole ChunkedTiles ({ct.n_chunks} chunks, T = {T_}, "
        f"p = {p}): max |kernel - plain| = {diff} (bitwise)")
    del got, want
    ms = cuda_ms(lambda: sem_spmm.spmm_tiles(
        meta, rows, cols, vals, x_pad, T=T_, n_tile_rows=ntr,
        variant=variant), reps=reps)
    plain_ms = cuda_ms(lambda: sem_spmm._PLAIN[variant](
        meta, nv, rows, cols, vals, x_pad, acc.zero_(), T=T_),
        reps=plain_reps, warmup=1)
    m = meta.to(torch.int64)
    live = torch.arange(C_, device=dev)[None, :] < m[:, 3:4]
    grow = (m[:, 0:1] * T_ + rows.to(torch.int64))[live]
    gcol = (m[:, 1:2] * T_ + cols.to(torch.int64))[live]
    csr = torch.sparse_coo_tensor(torch.stack([grow, gcol]), vals[live],
                                  (ntr * T_, x_pad.shape[0]),
                                  check_invariants=False
                                  ).coalesce().to_sparse_csr()
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x_pad), reps=10)
    del grow, gcol, live, csr
    # the one-shot product writes its whole output once
    plane_bytes, in_rows, _, n_live = lane_work(meta, nv, rows, cols, vals,
                                                T_)
    bound_ms, bound_by = bound(plane_bytes + 4 * p * (in_rows + ntr * T_),
                               2 * n_live * p)
    del rows, cols, vals
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_diff=diff)


# -- phase 4b: the densify kernels -------------------------------------------
def run_mxu_phase(cell, rng, dev):
    """K1b against its plain version on the densify cell's batches (every
    plane type, a padded tail, sentinel and -0.0 accumulators), then K2 mxu
    over the cell's whole matrix."""
    from repro_torch.kernels import sem_spmm
    stores = cell["stores"]
    header = stores["bin"].header
    n_acc = -(-header["n_rows"] // TM) * TM
    worst, timed = 0.0, None
    for name, batch, integer, n_valid in kernel_cases(stores, dev):
        meta, rows, cols, vals = planes_on(batch, dev)
        nv = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        x_pad = operand(header["n_cols"], PM, rng, integer, dev, TM)
        acc0 = torch.zeros((n_acc, PM), device=dev)
        got = acc0.clone()
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, got, T=TM,
                                variant="mxu")
        want = sem_spmm.spmm_tiles_acc_mxu_plain(meta, nv, rows, cols, vals,
                                                 x_pad, acc0.clone(), T=TM)
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        worst = max(worst, diff)
        if integer:
            check(torch.equal(got, want), f"K1b {name}: bitwise")
            how = "bitwise"
        else:
            rel = check_float("mxu", f"K1b {name}", meta, nv, rows, cols,
                              vals, x_pad, got, want, TM)
            how = f"at most {rel} of |A|·|x|, limit {FLOAT_TOL}"
        log(f"K1b {name}: max |kernel - plain| = {diff} ({how})")
        if name == "raw u16, binary":   # what NMF's densify path streams
            timed = (meta, nv, rows, cols, vals, x_pad, acc0)
    # untouched tile rows keep their sentinels; a visited tile row's rows
    # without entries take + 0.0, so -0.0 there turns +0.0 as in the plain
    # version (and the reference)
    binst = stores["bin"]
    s = (binst.n_chunks // 3 // BATCH) * BATCH
    n = min(BATCH, binst.n_chunks - s)
    meta, rows, cols, vals = planes_on(binst.read_batch_raw(s, n), dev)
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    x_pad = operand(header["n_cols"], PM, rng, True, dev, TM)
    touched = torch.zeros(n_acc // TM, dtype=torch.bool, device=dev)
    touched[meta[:, 0].long()] = True
    for fill in (1.0e6, -0.0):
        start = torch.full((n_acc, PM), fill, device=dev)
        got = start.clone()
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, got, T=TM,
                                variant="mxu")
        want = sem_spmm.spmm_tiles_acc_mxu_plain(meta, nv, rows, cols, vals,
                                                 x_pad, start.clone(), T=TM)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K1b accumulator filled with {fill}: bitwise, signs included")
        blocks = got.view(-1, TM, PM)
        check(torch.equal(blocks[~touched].view(torch.int32),
                          start.view(-1, TM, PM)[~touched].view(torch.int32)),
              f"K1b leaves untouched tile rows' {fill} alone")
        log(f"K1b accumulator filled with {fill}: bitwise with signs, "
            f"{int((~touched).sum())} untouched tile rows kept")
    records = {"K1b": time_batch("mxu", *timed, worst, T_=TM, label="K1b")}
    records["K2 mxu"] = run_k2(cell["ct_at"], rng, dev, "mxu", TM, PM,
                               reps=3, plain_reps=1, label="K2 mxu")
    return records


# -- phase 4c: where the densify kernel beats the gather kernel --------------
def run_crossover_phase(cell, rng, dev, card):
    """K1a and K1b on one 256-chunk batch (the middle one) of the densify
    cell's graph, rows [0, CROSS_ROWS), chunked at each T with C = 256;
    device time from graph replay.  Returns the table's rows."""
    from repro_torch.core.formats import COO, to_chunked
    from repro_torch.kernels import sem_spmm
    op = cell["pr_op"]
    keep = op.rows < CROSS_ROWS
    block = COO(CROSS_ROWS, op.n_cols, op.rows[keep], op.cols[keep], None)
    log(f"crossover: rows [0, {CROSS_ROWS}) of the scale-{cell['scale']} "
        f"PageRank pattern, {block.nnz} entries, C = {CM}, middle 256-chunk "
        f"batch at each T [{card}]")
    rows_out = []
    for T_ in CROSS_T:
        ct = to_chunked(block, T=T_, C=CM)
        s = (ct.n_chunks // 2 // BATCH) * BATCH
        n = min(BATCH, ct.n_chunks - s)
        meta = torch.from_numpy(ct.meta[s:s + n]).to(dev)
        # as the SEM path ships them: uint16 lanes as int16 bits
        rows = torch.from_numpy(ct.row_local[s:s + n].astype(np.int16)).to(dev)
        cols = torch.from_numpy(ct.col_local[s:s + n].astype(np.int16)).to(dev)
        nv = torch.tensor([n], dtype=torch.int32, device=dev)
        fill = float(ct.meta[s:s + n, 3].sum()) / (n * CM)
        for p in CROSS_P:
            x_pad = operand(block.n_cols, p, rng, True, dev, T_)
            acc = torch.zeros((ct.n_tile_rows * T_, p), device=dev)
            outs = []
            for v in sem_spmm.VARIANTS:
                out = acc.clone()
                sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, None, x_pad,
                                        out, T=T_, variant=v)
                outs.append(out)
            check(torch.equal(*outs), f"crossover T={T_} p={p}: the two "
                  "kernels agree bit for bit")
            ms = [graph_ms(lambda v=v: sem_spmm.spmm_tiles_acc(
                meta, nv, rows, cols, None, x_pad, acc, T=T_, variant=v),
                reps=20) for v in sem_spmm.VARIANTS]
            rows_out.append((T_, p, fill, *ms))
            log(f"crossover T={T_} p={p} fill {fill:.4f}: K1a {ms[0]} ms, "
                f"K1b {ms[1]} ms, K1b/K1a {ms[1] / ms[0]:.3f}, "
                f"{'densify' if ms[1] < ms[0] else 'gather'} wins")
    return rows_out


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


# -- phase 7: NMF -------------------------------------------------------------
def nmf_run(label, op_a, op_at, a_sq: float, card: str):
    """One NMF run, checked (loss, signs) and timed; returns the result,
    the kernel launches it made, and the launches a SEM run should make
    (one per batch of every pass)."""
    from repro_torch.apps.nmf import nmf
    from repro_torch.kernels import sem_spmm
    sems = [op.sem for op in (op_a, op_at) if hasattr(op, "sem")]
    passes0 = [s.passes for s in sems]
    sem_spmm.reset_launches()
    t0 = time.perf_counter()
    res = nmf(op_a, op_at, NMF_K, n_iter=NMF_ITERS, a_sq_sum=a_sq)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / NMF_ITERS
    launches = dict(sem_spmm.LAUNCHES)
    losses = np.asarray(res.losses)
    check(np.isfinite(losses).all() and len(losses) == NMF_ITERS,
          f"NMF {label}: finite losses")
    check(bool(np.all(np.diff(losses) <= LOSS_SLACK * losses[:-1])),
          f"NMF {label}: the loss does not increase")
    check(bool((res.W >= 0).all()) and bool((res.H >= 0).all()),
          f"NMF {label}: W, H >= 0")
    passes = [s.passes - p0 for s, p0 in zip(sems, passes0)]
    log(f"NMF {label}: losses {[float(x) for x in losses]}, "
        f"{secs:.4f} s/iteration, "
        + (f"{sum(passes)} passes, " if sems else "")
        + f"launches {({k: v for k, v in launches.items() if v})} [{card}]")
    return res, launches, sum(n * s.n_batches for n, s in zip(passes, sems))


def close_factors(x, y) -> bool:
    return (torch.allclose(x.W, y.W, rtol=NMF_RTOL, atol=NMF_ATOL)
            and torch.allclose(x.H, y.H, rtol=NMF_RTOL, atol=NMF_ATOL))


def run_nmf_phase(scale, adj, ct, stores, wide, cell, dev, card):
    """NMF at ``--scale`` over SEM stores of A and Aᵀ (gather) against IM,
    then on the densify cell: SEM with the densify kernel (K1b's path)
    against SEM with the gather kernel and IM with the densify one-shot
    kernel (K2 mxu's path).  Returns the launches of the two densify
    paths."""
    from repro_torch.apps.common import IMOperator, SEMOperator
    from repro_torch.core.sem import SEMConfig
    from repro_torch.io.storage import TileStore

    def sem_pair(a, at, variant):
        cfg = SEMConfig(chunk_batch=BATCH, kernel_variant=variant)
        return (SEMOperator(TileStore.open(a.path), cfg, device=dev),
                SEMOperator(TileStore.open(at.path), cfg, device=dev))

    a_sq = float(adj.nnz)        # binary matrix: ||A||_F^2 = nnz
    sem_a, sem_at = sem_pair(wide["a"], stores["bin"], "gather")
    sem, n, batches = nmf_run(f"scale {scale} SEM gather", sem_a,
                              sem_at, a_sq, card)
    check(n["spmm_tiles_acc"] == batches,
          "NMF SEM: one gather launch per batch")
    im = IMOperator(wide["ct_a"], device=dev), IMOperator(
        binary_tiles(ct), device=dev)
    res_im, _, _ = nmf_run(f"scale {scale} IM gather", *im, a_sq,
                           card)
    check(close_factors(sem, res_im), "NMF SEM equals IM within "
          f"rtol {NMF_RTOL}, atol {NMF_ATOL}")
    log(f"NMF scale {scale}: SEM equals IM within rtol {NMF_RTOL}, "
        f"atol {NMF_ATOL}; max |W_sem - W_im| "
        f"{float((sem.W - res_im.W).abs().max())}")
    del sem, res_im, im
    torch.cuda.empty_cache()

    cs = cell["stores"]
    a_sq = float(cell["adj"].nnz)
    launches = {}
    mxu_a, mxu_at = sem_pair(cs["a"], cs["bin"], "mxu")
    mxu, n, batches = nmf_run(f"scale {cell['scale']} T={TM} SEM densify",
                              mxu_a, mxu_at, a_sq, card)
    check(n["spmm_tiles_acc_mxu"] == batches and n["spmm_tiles_acc"] == 0,
          "NMF SEM densify: one densify launch per batch, no gather")
    launches["spmm_tiles_acc_mxu"] = n["spmm_tiles_acc_mxu"]
    im = (IMOperator(cell["ct_a"], device=dev, variant="mxu"),
          IMOperator(cell["ct_at"], device=dev, variant="mxu"))
    res_im, n, _ = nmf_run(f"scale {cell['scale']} T={TM} IM densify", *im,
                           a_sq, card)
    check(n["spmm_tiles_mxu"] == 3 * NMF_ITERS and n["spmm_tiles"] == 0,
          "NMF IM densify: one one-shot densify launch per product")
    launches["spmm_tiles_mxu"] = n["spmm_tiles_mxu"]
    gat_a, gat_at = sem_pair(cs["a"], cs["bin"], "gather")
    gat, _, _ = nmf_run(f"scale {cell['scale']} T={TM} SEM gather", gat_a,
                        gat_at, a_sq, card)
    check(close_factors(mxu, gat), "NMF densify equals gather")
    check(close_factors(mxu, res_im), "NMF densify SEM equals IM")
    log(f"NMF scale {cell['scale']} T={TM}: densify equals gather and SEM "
        f"equals IM within rtol {NMF_RTOL}, atol {NMF_ATOL}; max "
        f"|W_mxu - W_gather| {float((mxu.W - gat.W).abs().max())}")
    return launches


# -- phase 8: the eigensolver -------------------------------------------------
def run_eigen_phase(wide, dev, card):
    """Lanczos over the SEM operator of A + Aᵀ against float64 ARPACK, the
    basis on the card (SEM-max), then in a DenseStore (SEM-min)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh
    from repro_torch.apps.common import SEMOperator
    from repro_torch.apps.eigensolver import lanczos_eigsh
    from repro_torch.core.sem import SEMConfig
    sym = wide["sym"]
    t0 = time.perf_counter()
    a = sp.csr_matrix((np.ones(sym.nnz), (sym.rows, sym.cols)),
                      shape=(sym.n_rows, sym.n_cols))
    # ARPACK to 1e-10 relative, far inside the comparison's EIG_RTOL
    ref = np.sort(eigsh(a, k=EIG_K, which="LM", ncv=24, tol=1e-10,
                        return_eigenvectors=False))
    del a
    log(f"eigensolver: scipy eigsh (float64, k = {EIG_K}) {ref.tolist()} in "
        f"{time.perf_counter() - t0:.1f} s")
    op = SEMOperator(wide["sym_store"], SEMConfig(chunk_batch=BATCH),
                     device=dev)
    results = {}
    for label, on_disk in (("SEM-max", False), ("SEM-min", True)):
        passes0 = op.sem.passes
        t0 = time.perf_counter()
        res = lanczos_eigsh(op, k=EIG_K, max_restarts=EIG_RESTARTS, tol=0.0,
                            sem_subspace=on_disk)
        secs = time.perf_counter() - t0
        got = np.sort(res.eigenvalues)
        rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        check(np.isfinite(got).all() and rel < EIG_RTOL,
              f"eigensolver {label}: within {EIG_RTOL} of float64 eigsh")
        results[label] = got
        log(f"eigensolver {label}: {got.tolist()}, max rel to eigsh {rel:.3e}"
            f", {res.restarts + 1} cycles, {res.iterations} iterations = "
            f"{op.sem.passes - passes0} passes, "
            f"{secs / res.iterations:.4f} s/iteration [{card}]")
    rel = float(np.max(np.abs(results["SEM-min"] - results["SEM-max"])
                       / np.abs(results["SEM-max"])))
    check(rel < EIG_RTOL, "eigensolver SEM-min equals SEM-max")
    log(f"eigensolver: SEM-min equals SEM-max within {rel:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--mxu-scale", type=int, default=20,
                    help="scale of the densify cell's graph (T = 2048)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import build_all
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

    t0 = time.perf_counter()
    for name, info in build_all().items():
        regs = [ln.split(":", 1)[1].strip() for ln in info.ptxas.splitlines()
                if "Used" in ln]
        log(f"build: {info.path.name} in {info.seconds:.1f} s; ptxas, per "
            f"instantiation: " + " | ".join(regs))
    log(f"build: both sources in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(args.seed)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    tempfile.tempdir = str(tmp)    # the eigensolver's DenseStore goes here
    phases = []

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases.append(f"{name} {time.perf_counter() - t0:.1f} s")
        return out
    try:
        adj, pr_op, ct, stores = phase("set-up", build_stores, args.scale,
                                       args.seed, tmp)
        wide = phase("set-up wide", build_wide_stores, adj, tmp)
        cell = phase("set-up cell", build_cell, args.mxu_scale, args.seed,
                     tmp)
        records = phase("kernels", run_kernel_phase, stores, ct, rng, dev)
        records.update(phase("densify kernels", run_mxu_phase, cell, rng,
                             dev))
        phase("crossover", run_crossover_phase, cell, rng, dev, card)
        phase("engine", run_engine_phase, stores, pr_op, rng, dev, card)
        launches = phase("pagerank", run_pagerank_phase, stores, ct, adj,
                         pr_op, dev, card)
        launches.update(phase("nmf", run_nmf_phase, args.scale, adj, ct,
                              stores, wide, cell, dev, card))
        phase("eigensolver", run_eigen_phase, wide, dev, card)
    finally:
        tempfile.tempdir = None
        shutil.rmtree(tmp, ignore_errors=True)
    log("phases: " + ", ".join(phases))

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "K1a": dict(name="spmm_tiles_acc (K1a, gather)",
                    source=src + "sem_spmm.cu",
                    replaces="src/repro/kernels/sem_spmm.py:299",
                    launches=launches["spmm_tiles_acc"]),
        "K1b": dict(name="spmm_tiles_acc (K1b, mxu)",
                    source=src + "sem_spmm_mxu.cu",
                    replaces="src/repro/kernels/sem_spmm.py:299",
                    launches=launches["spmm_tiles_acc_mxu"]),
        "K2": dict(name="spmm_tiles (K2, gather)",
                   source=src + "sem_spmm.cu",
                   replaces="src/repro/kernels/sem_spmm.py:253",
                   launches=launches["spmm_tiles"]),
        "K2 mxu": dict(name="spmm_tiles (K2, mxu)",
                       source=src + "sem_spmm_mxu.cu",
                       replaces="src/repro/kernels/sem_spmm.py:253",
                       launches=launches["spmm_tiles_mxu"]),
    }
    kernels = []
    for key in ("K1a", "K1b", "K2", "K2 mxu"):
        r = records[key]
        kernels.append(dict(
            meta[key], route="cuda",
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
