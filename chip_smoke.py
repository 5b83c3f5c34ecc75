#!/usr/bin/env python3
"""Run the port's paths on one CUDA card and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py [--seed 0] [--scale 22] [--mxu-scale 20]

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name, the device count, its power limit;
2. build: the four CUDA sources in ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, started together (seconds, and the registers and spills
   ``-Xptxas -v`` reports);
3. set-up: an R-MAT graph (edge factor 16) made from ``--seed`` at
   ``--scale``, its PageRank operator written as a valued TileStore
   (T = 16384, C = 2048), the same pattern (Aᵀ's) as a binary store and an
   ``.optimize()``d copy of that; the densify cell: the same kinds of
   stores of an R-MAT graph at ``--mxu-scale`` with T = 2048, C = 256; A's
   pattern as a binary store; and the densify cell graph's symmetrised
   pattern A + Aᵀ as a binary store at the main path's T and C;
4. kernels: the gather chunk-batch kernel (K1a) and its one-shot use (K2)
   against their plain versions at the main path's shapes (256-chunk
   batches of the real stores, p = 8): bit for bit on integer-valued data,
   to 1e-5 on normal data; the main store's middle batch on sentinel and
   -0.0 accumulators, bit for bit with signs; times from CUDA events at
   p = 8 and at PageRank's p = 1, with their times before the kernel's
   redesign beside them; K1a and K2 within their limits at p = 8 and
   faster than ``torch.sparse.mm``;
4b. densify kernels: the same for the densify kernel (K1b) and its one-shot
   use (K2 mxu) on the densify cell's stores at p = 16, with their times
   before the kernel's redesign beside the new ones; K1b within its limit
   and faster than ``torch.sparse.mm``; K1a and K1b on an operand holding
   an inf and a NaN, NaN for NaN equal to the plain gather version;
4c. crossover: K1a and K1b on one 256-chunk batch at T in {256 .. 16384}
   (C = 256) and on a batch of the main path's store (T = 16384, C = 2048),
   p in {1, 8, 16}: the table ``kernels/ops.py::pick_variant`` follows;
5. engine: ``SEMSpMM.multiply`` (p = 8, integer operand) on the raw and the
   optimized binary store with the kernel ``pick_variant`` picks, equal to a
   float64 scipy product, with the exact IOStats counts and one kernel
   launch per batch; a third pass of each runs under ``torch.profiler`` for
   the kernel's summed device time and the card's idle share;
6. PageRank: 10 iterations over the SEM operator (K1a) and over the IM
   operator (K2), both with the gather kernel named, against a float64
   scipy power iteration;
6b. rings and a mutable graph, on phase 3's stores: SSSP by min-plus
   Bellman-Ford waves from the vertex of largest out-degree over the raw
   binary store of Aᵀ's pattern (p = 1), to a fixed point within 64 waves,
   equal to scipy's BFS distances, one wave traced; one or-and and one
   max-times pass (p = 4) equal to their numpy oracles; 200,000 weighted
   inserts and 20,000 deletes through ``apply_updates``, then a
   plus-times pass (p = 8) on the raw and the optimized binary store, each
   equal to float64 (A + Δ) @ X bit for bit with exact h2d and one K1a
   launch per batch, beside the frozen pass; ``ShardedSEMSpMM`` with 2
   shards as threads on the card over that overlay, bit for bit the single
   engine's; a min-plus pass over 50,000 new weighted edges equal to its
   oracle, and its refusal of a log with deletions;
6c. serving, on phase 3's stores: the shared-scan scheduler's waves (8
   PageRank tenants and 8 queries in 6 passes, then with the hot-chunk
   cache, an elastic wave admitting queries mid-pass, SSSP and BFS tenants
   beside queries, a two-wave fleet over two copies and a replica failing
   mid-pass), and label propagation, SpGEMM and triangle-count sessions on
   small graphs, each against its float64 or scipy oracle;
6d. the cross-host tier, on phase 3's stores and 6c's copies: two
   in-process ``HostServer``s on the card (one wave each, a copy each)
   behind a ``ClusterFrontDoor`` over loopback: (a) 4 PageRank tenants and
   4 integer queries routed over the valued store's copies, within phase
   6's limits and 1e-5 of |P|·|x|; (b) a partitioned integer query over
   the binary store's copies, a slab a host, equal to float64 bit for bit;
   (c) one host killed mid-pass while a BFS and 4 queries run: evicted,
   every result replayed bit for bit; (d) ``python -m
   repro_torch.net.host`` as its own process on the card, one query bit
   for bit, exit 0 on ``shutdown``; bytes and K1a launches a whole number
   of passes throughout, and the time to ship a 4,194,304-float result
   plane over loopback;
7. NMF (k = 16, 3 iterations): over SEM stores of A and Aᵀ against IM, at
   ``--scale`` with the gather kernel, and on the densify cell's stores with
   the densify kernel (SEM: K1b, IM: K2 mxu) against the gather kernel;
8. eigensolver: thick-restart Lanczos (k = 4) over the SEM operator of the
   symmetrised graph at ``--mxu-scale`` (scipy's float64 ``eigsh``, the
   reference, takes most of a minute at ``--scale``), its basis on the
   card, against ``eigsh``; then the same with the basis in a DenseStore
   (SEM-min);
9. Zamba2-7B at full width (81 layers, d_model 3584), float32 weights made
   from ``--seed`` on the card: a plain prefill (B = 2, L = 2048, both
   kernels' plain versions) in which every flash-attention (K3) and SSD
   (K4) call also runs the kernel on the same inputs, held elementwise to
   FLOAT_TOL of that call's error scale; both kernels timed on the first
   calls' inputs, with their bounds (on the tensor cores, at float32
   accuracy, and on the CUDA cores), their times before their redesigns,
   and SDPA as K3's yardstick; then the main path, the serving prefill
   ``model_api.forward(..., logits_last_only=True)`` through the kernels:
   13 K3 and 81 K4 launches (calls; K4 runs four kernels a call), each
   attention sublayer and Mamba layer held, per token, within 2e-4 in
   relative L2 of the same sublayer with the plain versions on the same
   input; finite logits no farther from the plain prefill's than twice the
   plain prefill's own spread (the same prefill with K4 at Q = 128), and a
   traced prefill's device time by kind of kernel;
10. decode against prefill at full width: 64 steps of
   ``model_api.decode_step`` over a 64-token prompt with every layer's
   input and output recorded; each layer's decode inputs then run through
   the same layer as a prefill with the plain versions, and the decode
   increments are held to the prefill's, per token within 2e-2 in relative
   L2 and elementwise within the reference's decode tolerance; the last
   logits aligned with the kernel prefill's; then a ``BatchServer``
   answers 4 requests (4 slots, prompts of 16 tokens, 16 new tokens each);
11. Mamba2-130M at full width: the same prefill checks (24 K4 launches)
   and the same serving check;
12. the attention families at full width, each made, run and freed in
   turn, every K3 call of a plain prefill checked against the kernel, the
   kernel prefill's K3 launches counted from 0 and its attention
   sublayers held to the plain ones as in phase 9: Yi-9B at full depth
   (48 layers, prefill B = 2, L = 2048: 48 K3 launches at hd 128 and
   G = 8, K3 timed against its bound and SDPA; decode as in phase 10, per
   token only; a ``BatchServer`` answering 4 requests); Yi-9B at one layer
   end to end, where float32 rounding leaves logits comparable: the kernel
   prefill's last logits within 2e-4 of the plain prefill's, and 64
   decode steps' logits within the reference's decode tolerance of the
   plain prefill's; OLMoE-1B-7B (16 K3, each MoE layer's dropped share
   logged; 4 requests served); Gemma2-27B at 4 of its 46 layers (2 global
   ones run K3 with softcap 50); InternVL2-2B (256 patches before 2048
   tokens: K3 at L = 2304); Whisper-medium (1,500 frames, a decoder of
   L = 384: 24 K3); Llama4-Scout at 2 of its 48 layers (top-1 routing, a
   shared expert);
13. training: MiniCPM-2B at one layer, full width: its K3 call at
   MiniCPM's shape (2, 2048, 36, 36, 64) checked as in phase 9 and timed
   against its bound and SDPA, then one ``loss_fn`` step's loss and every
   gradient through the kernels within 2e-4 (relative L2) of the plain
   step's, then 4 ``Trainer`` steps (B = 2, L = 2048, WSD with the
   launcher's defaults; 2 K3 launches each) with a falling loss;
   Mamba2-130M at full width: 4 steps (48 K4 launches each), a trainer
   restored from the step-2 checkpoint equal to the uninterrupted run bit
   for bit, and a non-finite loss twice in a row from step 4 rolled back
   to that checkpoint and run on to step 6, equal to a clean run;
   MiniCPM-2B at full width and depth in a ``Trainer`` (float32
   parameters and AdamW moments on the card): each of its 40 layers,
   teacher-forced with its input and upstream gradient from a plain step,
   through the kernels against the plain versions (output per token,
   input and parameter gradients within 2e-4, every wq/wk/wv gradient
   nonzero); then 4 steps with 80 K3 launches each (the forward pass and
   its recompute) and finite losses (a falling one unless the first
   gradient norm shows the reference init's explosion at depth:
   ``run_minicpm_training``), s a step, tokens/s, peak memory and the
   AdamW update's ms logged; and ``python -m repro_torch.launch.train
   --arch mamba2-130m --full --steps 2`` as its own process (from the
   phase's start until before MiniCPM-2B's full-depth timed parts), exit
   0 and a falling loss;
14. the distributed and launch tooling on a one-rank NCCL group: (a)
   ``hierarchical_psum``, ``chunked_psum`` and ``compressed_pod_psum``
   over a (1, 1, 1) ("pod", "data", "model") mesh on MiniCPM-2B's
   full-width float32 trees (the embedding, then one layer): the first
   two bit for bit, the int8 one within half a step with its error state
   exact, each timed, the NCCL kernels of a traced call listed; (b)
   ``moe_block_a2a`` at OLMoE-1B-7B's width (B = 2, L = 2048) against
   ``moe_block`` on the same weights, neither dropping (per token within
   1e-5, aux within 1e-6); (c) GPipe over a ("stage",) mesh with
   MiniCPM-2B's 40 layers through K3 as the stage, 2 micro-batches of (1,
   2048): against the layers micro-batch by micro-batch, and at one layer
   against B = 2 at once (outputs per token and every gradient within
   2e-4, no zero wq/wk/wv gradient, K3's launches counted), with the B = 2
   forward's divergence at each depth logged; (d) the cost counter's flops
   on the 40 layers' forward against ``FlopCounterMode``'s on the plain
   version (within 1%); (e) ``python -m repro_torch.launch.dryrun`` of
   minicpm-2b x decode_32k as its own process (the card hidden) from the
   phase's start, exit 0 with status ok, and the roofline report's row.

The last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs a CUDA card: without
one it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
T, C, BATCH, P = 16384, 2048, 256, 8
TM, CM, PM = 2048, 256, 16      # the densify cell: tile, chunk, operand width
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # H100 SXM, dense TF32 on the tensor cores
# Each chunk-batch kernel's times before its redesign (PERF.md section 6,
# the kernel table's "before" times; NVIDIA H100 80GB HBM3 at 700 W): K1b
# per 256-chunk batch of the densify cell, K2 mxu over its whole matrix;
# K1a per middle raw valued batch of the main store and K2 over the main
# path's whole matrix, at p = 8 (this script's last run before the gather
# kernel's redesign) and p = 1 (kernels/tune_gather.py --source on the
# kernel before it).
BEFORE_MS = {"K1b": 0.13048640251159668, "K2 mxu": 55.707275390625,
             "K1a": 0.020927999019622803, "K2": 4.263827133178711,
             "K1a p=1": 0.013077759742736816, "K2 p=1": 4.082860946655273}
# K3's time per call before its redesign (the CUDA-core kernel, PERF.md
# section 6; NVIDIA H100 80GB HBM3 at 700 W), at the same shape.
K3_BEFORE_MS = 4.009308624267578
# K4's time per call before its redesign (one block per batch and head on
# the CUDA cores; this script's last run before it, PERF.md section 6;
# NVIDIA H100 80GB HBM3 at 700 W), at Zamba2-7B's first Mamba layer.
K4_BEFORE_MS = 1.4603327751159667
# K1b's limit per 256-chunk batch of the densify cell (a quarter of the
# before time, PERF.md section 6); it must also beat torch.sparse.mm.
K1B_LIMIT_MS = 0.033
# K1a's limit per middle raw valued batch of the main store and K2's over
# the main path's whole matrix, both at p = 8: three quarters of the times
# before the gather kernel's redesign; each must also beat torch.sparse.mm.
K1A_LIMIT_MS = 0.0157
K2_LIMIT_MS = 3.20
# Kernel vs plain on non-integer data, relative to the terms' magnitude:
# see check_float.
FLOAT_TOL = 1e-5
CROSS_T, CROSS_P = (256, 512, 1024, 2048, 4096, 8192, 16384), (1, 8, 16)
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


def bound(nbytes: int, flops: int, rate: float = FP32_FLOPS_PER_S):
    """Least time on the card (ms) and what sets it: the bytes over the HBM
    rate or the operations over their peak rate (float32 on the CUDA cores
    unless given), whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
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
    """Least time for one batch (K1a and K1b alike): the planes' live bytes,
    each X row the live lanes name read once, every element of the tile
    rows the valid chunks visit read once (the +0.0 rule reads them all),
    each accumulator row the lanes update written once; 2 flops per live
    lane and column."""
    plane_bytes, in_rows, out_rows, n_live = lane_work(
        meta, n_valid, rows, cols, vals, T_)
    nv = int(n_valid.reshape(-1)[0])
    visited = int(torch.unique(meta[:nv, 0]).numel())
    return bound(plane_bytes + 4 * p * (in_rows + visited * T_ + out_rows),
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


def build_wide_stores(adj, cell_adj, tmp: Path):
    """Set-up of the wide-operand phases: A's binary store at ``--scale``
    and its ChunkedTiles (NMF; the PageRank stores hold Aᵀ's pattern), and
    the symmetrised pattern A + Aᵀ of the densify cell's graph
    (``cell_adj``) as a binary store at the main path's T and C (the
    eigensolver)."""
    from repro_torch.core.formats import COO, to_chunked
    from repro_torch.io.storage import TileStore
    t0 = time.perf_counter()
    ct_a = to_chunked(adj, T=T, C=C)
    a = TileStore.write(str(tmp / "a"), ct_a, binary=True)
    log(f"set-up: A's binary store, {ct_a.n_chunks} chunks, {a.nbytes} B, "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sym = COO(cell_adj.n_rows, cell_adj.n_cols,
              np.concatenate([cell_adj.rows, cell_adj.cols]),
              np.concatenate([cell_adj.cols, cell_adj.rows]), None).dedup()
    t1 = time.perf_counter()
    ct_s = to_chunked(sym, T=T, C=C)
    t2 = time.perf_counter()
    sym_store = TileStore.write(str(tmp / "sym"), ct_s, binary=True)
    log(f"set-up: A + Aᵀ binary store of the densify cell's graph, "
        f"{sym.n_rows} vertices, {sym.nnz} entries, {ct_s.n_chunks} "
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
            # PageRank's width, on the same batch
            x1 = operand(header["n_cols"], 1, rng, False, dev)
            a1 = torch.zeros((n_acc, 1), device=dev)
            got = sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x1,
                                          a1.clone(), T=T)
            want = sem_spmm.spmm_tiles_acc_plain(meta, nv, rows, cols, vals,
                                                 x1, a1.clone(), T=T)
            rel = check_float("gather", "K1a p = 1", meta, nv, rows, cols,
                              vals, x1, got, want, T)
            records["K1a p=1"] = time_batch(
                "gather", meta, nv, rows, cols, vals, x1, a1,
                float((got - want).abs().max()), label="K1a p = 1")
            log(f"K1a p = 1: at most {rel} of |A|·|x|, limit {FLOAT_TOL}")
    # untouched tile rows keep their content; a visited tile row's rows
    # without entries take + 0.0, so -0.0 there turns +0.0 as in the plain
    # version (and the reference): the main store's middle batch
    binst = stores["bin"]
    s = (binst.n_chunks // 2 // BATCH) * BATCH
    n = min(BATCH, binst.n_chunks - s)
    meta, rows, cols, vals = planes_on(binst.read_batch_raw(s, n), dev)
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    x_pad = operand(header["n_cols"], P, rng, True, dev)
    touched = torch.zeros(n_acc // T, dtype=torch.bool, device=dev)
    touched[meta[:, 0].long()] = True
    for fill in (1.0e6, -0.0):
        start = torch.full((n_acc, P), fill, device=dev)
        got = start.clone()
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x_pad, got, T=T)
        want = sem_spmm.spmm_tiles_acc_plain(meta, nv, rows, cols, vals,
                                             x_pad, start.clone(), T=T)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K1a accumulator filled with {fill}: bitwise, signs included")
        blocks = got.view(-1, T, P)
        check(torch.equal(blocks[~touched].view(torch.int32),
                          start.view(-1, T, P)[~touched].view(torch.int32)),
              f"K1a leaves untouched tile rows' {fill} alone")
        log(f"K1a accumulator filled with {fill}: bitwise with signs, "
            f"{int((~touched).sum())} untouched tile rows kept, "
            f"{int(touched.sum())} visited")
    records["K2"] = run_k2(ct, rng, dev)
    records["K2 p=1"] = run_k2(ct, rng, dev, p=1, label="K2 p = 1")
    for key, limit in (("K1a", K1A_LIMIT_MS), ("K2", K2_LIMIT_MS)):
        r = records[key]
        check(r["ms"] <= limit and r["ms"] < r["library_ms"],
              f"{key} within {limit} ms at p = {P} and faster than "
              f"torch.sparse.mm: {r['ms']} ms against {r['library_ms']} ms")
    for key in ("K1a", "K1a p=1", "K2", "K2 p=1"):
        r = records[key]
        log(f"{key}: {r['ms']} ms (before the redesign: {BEFORE_MS[key]} ms,"
            f" {BEFORE_MS[key] / r['ms']:.2f}x), torch.sparse.mm "
            f"{r['library_ms']} ms ({r['ms'] / r['library_ms']:.3f}x its "
            f"time), bound {r['bound_ms']} ms ({r['ms'] / r['bound_ms']:.1f}x"
            f" the bound)")
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
        log(f"{label} work: " + densify_work(m, r, live, p, T_))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_diff=diff)


def densify_work(m, r, live, p, T_):
    """What the densify kernel does for the valid chunks ``m`` (meta as
    int64) with decoded rows ``r``: X bytes gathered and reductions (one per
    run of a row's lanes and 4 columns, plus the +0.0 sweep of each visited
    tile row once), against what its design before the redesign did (the
    whole X[tile_col] staged and T*p scalar atomics a chunk)."""
    n_live = int(live.sum())
    opens = live.clone()
    opens[:, 1:] &= r[:, 1:] != r[:, :-1]
    runs = int(opens.sum())
    tile_rows = int(torch.unique(m[:, 0]).numel())
    n = m.shape[0]
    reds = runs * -(-p // 4) + tile_rows * T_ * p // 4
    return (f"{n} chunks, {n_live} live lanes, {runs} row runs, "
            f"{tile_rows} tile rows; {4 * p * n_live} B of X gathered "
            f"(before: {4 * p * T_ * n} B staged), {reds} reductions "
            f"(before: {n * T_ * p} scalar atomics)")


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
    check_non_finite(meta, nv, rows, cols, vals, x_pad, n_acc)
    records = {"K1b": time_batch("mxu", *timed, worst, T_=TM, label="K1b")}
    r = records["K1b"]
    check(r["ms"] <= K1B_LIMIT_MS and r["ms"] < r["library_ms"],
          f"K1b within {K1B_LIMIT_MS} ms a batch and faster than "
          f"torch.sparse.mm: {r['ms']} ms against {r['library_ms']} ms")
    records["K2 mxu"] = run_k2(cell["ct_at"], rng, dev, "mxu", TM, PM,
                               reps=3, plain_reps=1, label="K2 mxu")
    for key, r in records.items():
        log(f"{key}: {r['ms']} ms (before the redesign: {BEFORE_MS[key]} ms,"
            f" {BEFORE_MS[key] / r['ms']:.2f}x), torch.sparse.mm "
            f"{r['library_ms']} ms ({r['ms'] / r['library_ms']:.3f}x its "
            f"time), bound {r['bound_ms']} ms ({r['ms'] / r['bound_ms']:.1f}x"
            f" the bound)")
    return records


def check_non_finite(meta, nv, rows, cols, vals, x_pad, n_acc):
    """K1a and K1b on one densify-cell batch with a non-finite operand (an
    inf and a NaN in X rows the batch names) against the gather plain
    version, NaN for NaN: NaN and inf reach only the rows whose live lanes
    meet them, as in the reference's default path."""
    from repro_torch.kernels import sem_spmm
    x = x_pad.clone()
    _, c = sem_spmm._decode_lanes(meta, rows, cols, TM)
    x[int(meta[0, 1]) * TM + int(c[0, 0]), 0] = math.inf
    x[int(meta[-1, 1]) * TM + int(c[-1, 0]), 3] = math.nan
    want = sem_spmm.spmm_tiles_acc_plain(
        meta, nv, rows, cols, vals, x, torch.zeros((n_acc, PM),
                                                   device=x.device), T=TM)
    bad = int((~want.isfinite()).sum())
    check(0 < bad < TM, "non-finite operand: a few rows take NaN or inf")
    for variant, label in (("gather", "K1a"), ("mxu", "K1b")):
        got = torch.zeros_like(want)
        sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, vals, x, got, T=TM,
                                variant=variant)
        same = (torch.equal(got.isnan(), want.isnan())
                and torch.equal(got.nan_to_num(nan=0.0, posinf=math.inf,
                                               neginf=-math.inf),
                                want.nan_to_num(nan=0.0, posinf=math.inf,
                                                neginf=-math.inf)))
        check(same, f"{label} on a non-finite operand: NaN for NaN")
        log(f"{label} on a non-finite operand (an inf and a NaN in X): "
            f"equal to the plain gather version NaN for NaN, {bad} "
            "non-finite elements")


# -- phase 4c: where the densify kernel beats the gather kernel --------------
def run_crossover_phase(cell, stores, rng, dev, card):
    """K1a and K1b on one 256-chunk batch (the middle one) of the densify
    cell's graph, rows [0, CROSS_ROWS), chunked at each T with C = 256, and
    on the middle batch of the main path's binary store (T = 16384,
    C = 2048); device time from graph replay.  Returns the table's rows."""
    from repro_torch.core.formats import COO, to_chunked
    from repro_torch.kernels import sem_spmm
    op = cell["pr_op"]
    keep = op.rows < CROSS_ROWS
    block = COO(CROSS_ROWS, op.n_cols, op.rows[keep], op.cols[keep], None)
    log(f"crossover: rows [0, {CROSS_ROWS}) of the scale-{cell['scale']} "
        f"PageRank pattern, {block.nnz} entries, C = {CM}, middle 256-chunk "
        f"batch at each T; then the main path's store [{card}]")

    def cell_batch(T_):
        ct = to_chunked(block, T=T_, C=CM)
        s = (ct.n_chunks // 2 // BATCH) * BATCH
        n = min(BATCH, ct.n_chunks - s)
        # as the SEM path ships them: uint16 lanes as int16 bits
        return (T_, CM, ct.n_tile_rows, block.n_cols,
                ct.meta[s:s + n], ct.row_local[s:s + n].astype(np.int16),
                ct.col_local[s:s + n].astype(np.int16))

    def main_batch():
        st = stores["bin"]
        h = st.header
        s = (st.n_chunks // 2 // BATCH) * BATCH
        meta, rows, cols, _ = st.read_batch_raw(s, min(BATCH,
                                                       st.n_chunks - s))
        return (T, C, -(-h["n_rows"] // T), h["n_cols"], np.array(meta),
                np.array(rows).view(np.int16), np.array(cols).view(np.int16))

    rows_out = []
    for T_, C_, ntr, n_cols, meta, rows, cols in (
            *(cell_batch(T_) for T_ in CROSS_T), main_batch()):
        n = meta.shape[0]
        fill = float(meta[:, 3].sum()) / (n * C_)
        meta = torch.from_numpy(meta).to(dev)
        rows = torch.from_numpy(rows).to(dev)
        cols = torch.from_numpy(cols).to(dev)
        nv = torch.tensor([n], dtype=torch.int32, device=dev)
        for p in CROSS_P:
            x_pad = operand(n_cols, p, rng, True, dev, T_)
            acc = torch.zeros((ntr * T_, p), device=dev)
            outs = []
            for v in sem_spmm.VARIANTS:
                out = acc.clone()
                sem_spmm.spmm_tiles_acc(meta, nv, rows, cols, None, x_pad,
                                        out, T=T_, variant=v)
                outs.append(out)
            check(torch.equal(*outs), f"crossover T={T_} C={C_} p={p}: the "
                  "two kernels agree bit for bit")
            ms = [graph_ms(lambda v=v: sem_spmm.spmm_tiles_acc(
                meta, nv, rows, cols, None, x_pad, acc, T=T_, variant=v),
                reps=20) for v in sem_spmm.VARIANTS]
            rows_out.append((T_, C_, p, fill, *ms))
            log(f"crossover T={T_} C={C_} p={p} fill {fill:.4f}: K1a "
                f"{ms[0]} ms, "
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
    from repro_torch.kernels.ops import pick_variant
    variant = pick_variant(T)
    key = "spmm_tiles_acc" + ("_mxu" if variant == "mxu" else "")
    kernel_name = f"chunk_{variant}_kernel"
    x = rng.integers(-4, 5, (pr_op.n_cols, P)).astype(np.float32)
    a = sp.csr_matrix((np.ones(pr_op.nnz), (pr_op.rows, pr_op.cols)),
                      shape=(pr_op.n_rows, pr_op.n_cols))
    want = a @ x.astype(np.float64)
    check(np.abs(want).max() < 2 ** 24, "integer sums stay exact in f32")
    for name in ("bin", "binopt"):
        store = stores[name]
        sem = SEMSpMM(store, SEMConfig(chunk_batch=BATCH), device=dev)
        # cold, warm, warm under the profiler; the optimized store (7,484
        # batches, seconds a pass) without the warm untraced pass
        reps = 3 if name == "bin" else 2
        for rep in range(reps):
            traced = rep == reps - 1
            before = dataclasses.replace(store.stats)
            sem_spmm.reset_launches()
            with (profile(activities=[ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                got = sem.multiply(x)
                secs = time.perf_counter() - t0
            launches = sem_spmm.LAUNCHES[key]
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
            log(f"engine {name} pass {rep} ({variant}): equal to scipy; "
                f"{sem.n_batches} batches = {launches} launches; "
                f"bytes_read {st.bytes_read - before.bytes_read}, "
                f"h2d {st.h2d_bytes - before.h2d_bytes}, overlap "
                f"{st.overlap_batches - before.overlap_batches}; "
                f"{secs:.3f} s/pass, {pr_op.nnz / secs:.4g} edges/s"
                f"{' (traced)' if traced else ''} [{card}]")
            if traced:
                log(f"engine {name} trace: "
                    + device_time(prof, secs, warm, kernel_name))
            warm = secs


def device_time(prof, secs: float, warm: float, kernel_name, n_batches=None
                ) -> str:
    """What a torch.profiler trace of one pass shows of the card: the
    kernel's summed device time (every kernel's when ``kernel_name`` is
    None, by name, and per batch when ``n_batches`` is given), the
    copies', and the union of all device activity against the pass's wall
    time (traced, and the untraced warm pass before it), as the share the
    card sat idle."""
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return "no device activity recorded: idle share not measured"
    kernels = [e for e in spans if (kernel_name in e.name if kernel_name
                                    else not e.name.startswith(
                                        ("Memcpy", "Memset")))]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
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
    per_batch = ""
    if n_batches:
        names = {}
        for e in kernels:
            names[e.name[:60]] = names.get(e.name[:60], 0) + 1
        per_batch = (f" ({len(kernels) / n_batches:.2f} launches and "
                     f"{kernel_us / 1e3 / n_batches:.4f} ms a batch over "
                     f"{n_batches} batches; by kernel: "
                     + "; ".join(f"{k} x{v}" for k, v in sorted(
                         names.items(), key=lambda kv: -kv[1])) + ")")
    return (f"{len(kernels)} kernel launches summing {kernel_us / 1e3:.3f} "
            f"ms on the card{per_batch}, copies "
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


# PageRank's iterations: each SEM iteration is a pass over the store (about
# a second), and 10 run every path of the phase
PAGERANK_ITERS = 10


def run_pagerank_phase(stores, ct, adj, pr_op, dev, card):
    from repro_torch.apps.common import IMOperator, SEMOperator
    from repro_torch.apps.pagerank import dangling_vertices, pagerank
    from repro_torch.core.sem import SEMConfig
    from repro_torch.kernels import sem_spmm
    iters = PAGERANK_ITERS
    dangling = dangling_vertices(adj)
    ref = pagerank_f64(pr_op, dangling, iters)
    launches = {}
    for label, make, kernel in (
            ("SEM", lambda: SEMOperator(
                stores["val"], SEMConfig(kernel_variant="gather"),
                device=dev), "spmm_tiles_acc"),
            ("IM", lambda: IMOperator(ct, device=dev, variant="gather"),
             "spmm_tiles")):
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
        # of the contracting iterations rounds every row sum once more,
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


# -- phase 6b: rings and a mutable graph -----------------------------------
SSSP_MAX_WAVES = 64
N_INSERTS, N_DELETES, N_RING_INSERTS = 200_000, 20_000, 50_000


def padded_delta(n: int) -> int:
    """Length the engine pads a pass's delta snapshot to (its
    ``DELTA_PAD_FLOOR``, doubled until it holds ``n`` entries)."""
    from repro_torch.core.sem import SEMSpMM
    tgt = SEMSpMM.DELTA_PAD_FLOOR
    while tgt < n:
        tgt *= 2
    return tgt


def row_reduce(csr, terms, ufunc, empty: float) -> np.ndarray:
    """``ufunc`` over each row's ``terms`` (one row of terms per stored
    entry, in CSR order), the ring's identity ``empty`` for a row without
    entries."""
    out = np.full((csr.shape[0], terms.shape[1]), empty, np.float32)
    rows = np.flatnonzero(np.diff(csr.indptr))
    out[rows] = ufunc.reduceat(terms, csr.indptr[rows], axis=0)
    return out


def timed_pass(sem, x, **kw):
    t0 = time.perf_counter()
    y = sem.multiply(x, **kw)
    return y, time.perf_counter() - t0


def run_sssp(stores, adj, dev, card):
    """Bellman-Ford over min-plus on the raw binary store of Aᵀ's pattern
    from the vertex of largest out-degree, to a fixed point; the second
    wave traced.  The distances must be scipy's BFS distances exactly.
    Returns the source and those distances (phase 6c's oracle)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path
    from repro_torch.core.sem import SEMConfig, SEMSpMM
    from repro_torch.io.storage import TileStore
    n = adj.n_rows
    src = int(np.argmax(np.bincount(adj.rows, minlength=n)))
    sem = SEMSpMM(TileStore.open(stores["bin"].path),
                  SEMConfig(chunk_batch=BATCH), device=dev)
    dist = np.full(n, np.inf, np.float32)
    dist[src] = 0.0
    secs, trace = [], ""
    for wave in range(1, SSSP_MAX_WAVES + 1):
        traced = wave == 2
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            relaxed, t = timed_pass(sem, dist[:, None], semiring="min_plus")
        if traced:
            trace = device_time(prof, t, float(np.mean(secs)), None,
                                sem.n_batches)
        else:
            secs.append(t)
        new = np.minimum(dist, relaxed[:, 0])
        if np.array_equal(new, dist):
            break
        dist = new
    else:
        check(False, f"SSSP: a fixed point within {SSSP_MAX_WAVES} waves")
    a = sp.csr_matrix((np.ones(adj.nnz, np.float32), (adj.rows, adj.cols)),
                      shape=(n, n))
    t0 = time.perf_counter()
    want = shortest_path(a, unweighted=True, indices=src)
    t_scipy = time.perf_counter() - t0
    check(np.array_equal(dist.astype(np.float64), want),
          "SSSP: distances equal scipy's BFS distances")
    reached = np.isfinite(want)
    log(f"SSSP from vertex {src} (out-degree "
        f"{int(np.sum(adj.rows == src))}): {wave} waves (the last one "
        f"changes nothing), {int(reached.sum())} vertices reached, farthest "
        f"{int(want[reached].max())}; equal to scipy's BFS distances "
        f"({t_scipy:.1f} s in scipy); {np.mean(secs):.4f} s/wave untraced "
        f"(min {min(secs):.4f}, max {max(secs):.4f}) [{card}]")
    log(f"SSSP wave 2 trace: {trace}")
    sem.close()
    return src, want


def run_rings_phase(stores, adj, pr_op, rng, dev, card):
    """Phase 6b: SSSP (min-plus), one or-and and one max-times pass, the
    plus-times overlay on the raw and the optimized binary store, the
    min-plus overlay and its refusal of deletions, and the sharded scan
    over the overlay.  Returns K1a's launches on the last overlay pass
    (the optimized store's) and SSSP's source and BFS distances."""
    import scipy.sparse as sp
    from repro_torch.core.sem import SEMConfig, SEMSpMM
    from repro_torch.distributed.shard_scan import ShardedSEMSpMM
    from repro_torch.io.storage import TileStore, UpdateBatch
    from repro_torch.kernels import sem_spmm
    n = pr_op.n_rows
    cfg = SEMConfig(chunk_batch=BATCH)
    t0 = time.perf_counter()
    at = sp.csr_matrix((np.ones(pr_op.nnz, np.float32),
                        (pr_op.rows, pr_op.cols)), shape=(n, n))
    at.sum_duplicates()      # canonical: sorted column indices per row
    keys = (np.repeat(np.arange(n, dtype=np.int64), np.diff(at.indptr)) * n
            + at.indices)
    log(f"rings: Aᵀ's pattern as CSR, {at.nnz} entries, "
        f"{time.perf_counter() - t0:.1f} s")
    bfs = run_sssp(stores, adj, dev, card)

    # or-and and max-times, one pass each, p = 4
    sem = SEMSpMM(TileStore.open(stores["bin"].path), cfg, device=dev)
    x = rng.integers(-4, 5, (n, 4)).astype(np.float32)
    got, t_or = timed_pass(sem, x, semiring="or_and")
    want = ((at @ (x != 0).astype(np.float64)) > 0).astype(np.float32)
    check(np.array_equal(got, want), "or_and: equal to boolean reachability")
    got, t_max = timed_pass(sem, x, semiring="max_times")
    want = row_reduce(at, at.data[:, None] * x[at.indices], np.maximum,
                      -np.inf)
    check(np.array_equal(got, want), "max_times: equal to the row max")
    log(f"or_and pass {t_or:.4f} s, max_times pass {t_max:.4f} s (p = 4): "
        f"each equal to its numpy oracle [{card}]")
    sem.close()

    # plus-times overlay: inserts with weights in [1, 4], deletes of edges
    ins_key = rng.integers(0, n * n, N_INSERTS)
    ins_w = rng.integers(1, 5, N_INSERTS).astype(np.float32)
    del_key = keys[rng.choice(keys.size, N_DELETES, replace=False)]
    batches = (UpdateBatch.insert(ins_key // n, ins_key % n, ins_w),
               UpdateBatch.delete(del_key // n, del_key % n))
    delta = (sp.csr_matrix((ins_w.astype(np.float64),
                            (ins_key // n, ins_key % n)), shape=(n, n))
             - sp.csr_matrix((np.ones(N_DELETES), (del_key // n,
                                                    del_key % n)),
                             shape=(n, n)))
    x = rng.integers(-4, 5, (n, P)).astype(np.float32)
    want = (at.astype(np.float64) + delta) @ x.astype(np.float64)
    check(np.abs(want).max() < 2 ** 24, "overlay sums stay exact in f32")
    want = want.astype(np.float32)
    frozen = (at @ x.astype(np.float64)).astype(np.float32)
    launches = 0
    for name in ("bin", "binopt"):
        store = TileStore.open(stores[name].path)
        sem = SEMSpMM(store, cfg, device=dev)
        # the frozen passes, cold then warm (the one compared), on the raw
        # store only: the optimized store's take seconds each
        for _ in range(2 if name == "bin" else 0):
            frozen_y, t_frozen = timed_pass(sem, x)
            check(np.array_equal(frozen_y, frozen),
                  f"overlay {name}: the frozen pass equals scipy")
        for b in batches:
            sem.apply_updates(b)
        n_delta = store.delta_log.snapshot()[1].size
        reps = 2 if name == "bin" else 1
        for rep in range(reps):
            before = dataclasses.replace(store.stats)
            sem_spmm.reset_launches()
            got, t_over = timed_pass(sem, x)
            st = store.stats
            check(np.array_equal(got, want),
                  f"overlay {name}: equal to float64 (A + Δ) @ X")
            check(sem.last_pass_version == 2, f"overlay {name}: version 2")
            check(st.bytes_read - before.bytes_read == store.nbytes,
                  f"overlay {name}: bytes_read == store.nbytes")
            check(st.h2d_bytes - before.h2d_bytes == expected_h2d(store, P)
                  + 12 * padded_delta(n_delta),
                  f"overlay {name}: h2d_bytes from the shapes and the delta")
            check(sem_spmm.LAUNCHES["spmm_tiles_acc"] == sem.n_batches,
                  f"overlay {name}: one K1a launch per batch")
            launches = sem_spmm.LAUNCHES["spmm_tiles_acc"]
            log(f"overlay {name} pass {rep}: equal to float64 (A + Δ) @ X, "
                f"version 2, {n_delta} delta entries (padded to "
                f"{padded_delta(n_delta)}), {sem.n_batches} batches = "
                f"{launches} K1a launches; {t_over:.4f} s/pass"
                + (f" against {t_frozen:.4f} s frozen (warm)"
                   if name == "bin" else "") + f" [{card}]")
        if name == "bin":
            overlay_store, overlay_sem, overlay_y = store, sem, got
        else:
            sem.close()

    # the sharded scan over that overlay: 2 shards as threads on the card
    t_single = timed_pass(overlay_sem, x)[1]
    with ShardedSEMSpMM(overlay_store, n_shards=2, config=cfg) as sh:
        check(all(ex.device == dev for ex in sh.execs),
              "sharded: both shards on the card")
        for rep in range(2):
            got, t_sh = timed_pass(sh, x)
            check(np.array_equal(got.view(np.int32),
                                 overlay_y.view(np.int32)),
                  "sharded: bit for bit the single engine's result")
            check(sh.io_stats.bytes_read == (rep + 1) * overlay_store.nbytes,
                  "sharded: bytes_read == store.nbytes a pass")
            log(f"sharded overlay pass {rep} (2 shards, threads on one "
                f"card): equal to the single engine bit for bit; "
                f"{t_sh:.4f} s/pass against {t_single:.4f} s single "
                f"[{card}]")

    # min-plus overlay: 50,000 new edges at distinct coordinates
    cand = np.unique(rng.integers(0, n * n, 2 * N_RING_INSERTS))
    pos = np.searchsorted(keys, cand).clip(max=keys.size - 1)
    cand = cand[keys[pos] != cand]
    new_key = rng.choice(cand, N_RING_INSERTS, replace=False)
    new_w = rng.integers(1, 5, N_RING_INSERTS).astype(np.float32)
    fresh = TileStore.open(stores["bin"].path)
    sem = SEMSpMM(fresh, cfg, device=dev)
    sem.apply_updates(UpdateBatch.insert(new_key // n, new_key % n, new_w))
    x = rng.integers(0, 9, (n, 4)).astype(np.float32)
    got, t_mp = timed_pass(sem, x, semiring="min_plus")
    merged = at + sp.csr_matrix((new_w, (new_key // n, new_key % n)),
                                shape=(n, n))
    check(merged.nnz == at.nnz + N_RING_INSERTS, "min_plus: new edges only")
    check(np.array_equal(got, row_reduce(
        merged, merged.data[:, None] + x[merged.indices], np.minimum,
        np.inf)),
          "min_plus overlay: equal to the oracle over the merged edges")
    log(f"min_plus overlay ({N_RING_INSERTS} new edges, p = 4): equal to "
        f"the oracle over the merged edge lists; {t_mp:.4f} s/pass [{card}]")
    sem.close()
    try:
        overlay_sem.multiply(x, semiring="min_plus")
    except ValueError as e:
        check("delet" in str(e), "min_plus refusal: names the deletions")
        log(f"min_plus over the log with deletes refused: {e}")
    else:
        check(False, "min_plus over a log with deletes must raise")
    overlay_sem.close()
    return launches, bfs


# -- phase 6c: serving ------------------------------------------------------
SERVE_DAMPINGS = tuple(round(0.80 + 0.02 * i, 2) for i in range(8))
# iterations, the fewest that show each wave's point, for the script's
# time: the shared wave's 6 (8 tenants a pass from the second pass on, pass
# 2 traced); the cached wave's, the fleet's and the elastic wave's (a warm
# pass after the cold one; a second pass per wave; admission in pass 2,
# completion in pass 3)
SERVE_ITERS, SERVE_CACHED_ITERS, SERVE_ELASTIC_ITERS = 6, 5, 3
SERVE_MIDPASS_AT = 170       # the boundary of pass 2 where queries arrive
# (f): label propagation on a scale-16 graph; SpGEMM and triangle counts on
# a scale-13 one (host numpy: their expanded products grow about 2.8x a
# scale, and scale 13's take seconds; the job prints its count)
LP_SCALE, SPGEMM_SCALE, LP_ITERS, LP_LABELS = 16, 13, 20, 4


def csr64(rows, cols, vals, n: int, dev):
    """An n x n float64 CSR matrix on the card, summing duplicates: the
    oracles' operator.  Its products are torch.sparse's in float64, never
    the port's kernels (at scale 22 scipy takes minutes for them)."""
    idx = torch.stack([torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                       for a in (rows, cols)])
    v = (torch.ones(idx.shape[1], dtype=torch.float64, device=dev)
         if vals is None else torch.from_numpy(
             np.asarray(vals, np.float64)).to(dev))
    return torch.sparse_coo_tensor(idx, v, (n, n)).coalesce().to_sparse_csr()


def pagerank_f64_multi(p64, dangling, dampings, keep):
    """Float64 power iterations at several dampings at once, one product
    with a column per damping each iteration; returns the iterates (host
    arrays) after each count in ``keep``."""
    n, dev = p64.shape[0], p64.device
    mask = torch.from_numpy(np.asarray(dangling, bool)).to(dev)
    d = torch.tensor(dampings, dtype=torch.float64, device=dev)[None, :]
    x = torch.full((n, d.shape[1]), 1.0 / n, dtype=torch.float64,
                   device=dev)
    out = {}
    for it in range(1, max(keep) + 1):
        x = d * (p64 @ x + x[mask].sum(dim=0) / n) + (1.0 - d) / n
        if it in keep:
            out[it] = x.cpu().numpy()
    return out


def check_pagerank(label, sessions, oracle) -> str:
    """Each PageRank tenant against its damping's float64 column, within
    phase 6's limits (L1 < 1e-5, max rel < 1e-4)."""
    worst_l1 = worst_rel = 0.0
    for s, col in zip(sessions, oracle.T):
        err = np.abs(s.result - col)
        l1, rel = float(err.sum()), float((err / col).max())
        check(s.done and np.isfinite(s.result).all() and l1 < 1e-5
              and rel < 1e-4, f"serving {label}: PageRank at damping "
              f"{s.damping} within tolerance of float64")
        worst_l1, worst_rel = max(worst_l1, l1), max(worst_rel, rel)
    return (f"{len(sessions)} PageRank tenants within tolerance of float64 "
            f"(worst L1 {worst_l1:.3e}, max rel {worst_rel:.3e})")


def query_oracle(a64, xs):
    """Float64 products of the queries' operands, one column each:
    ``A @ X`` and ``|A| @ |X|`` (every operator here is nonnegative)."""
    x = torch.from_numpy(np.stack(xs, axis=1).astype(np.float64)).to(
        a64.device)
    return (a64 @ x).cpu().numpy(), (a64 @ x.abs()).cpu().numpy()


def check_queries(label, results, want, scale=None) -> str:
    """One-shot tenants against their float64 products (columns of
    ``want``): bit for bit where every sum is exact (integer operands on a
    binary store, ``scale`` None), else within FLOAT_TOL of |A|·|x|
    (check_float's rule: P's values are 1/out-degree)."""
    worst = 0.0
    for i, got in enumerate(results):
        if scale is None:
            check(np.array_equal(got, want[:, i].astype(np.float32)),
                  f"serving {label}: query equal to float64 bit for bit")
            continue
        err = np.abs(got - want[:, i])
        check(bool((err <= FLOAT_TOL * scale[:, i]).all()),
              f"serving {label}: query within {FLOAT_TOL} of |A|·|x|")
        worst = max(worst, float((err / np.maximum(scale[:, i], 1e-30))
                                 .max()))
    return (f"{len(results)} queries " + (
        "equal to float64 bit for bit" if scale is None else
        f"within {FLOAT_TOL} of |A|·|x| of float64 (worst {worst:.3e} of "
        f"it)"))


def serve_passes(sched, sem, trace_pass=None):
    """Drive ``sched`` until it is idle; returns the wall seconds of each
    pass and, if ``trace_pass`` is given, that pass's device-time line."""
    secs, trace = [], ""
    while not sched.idle:
        traced = len(secs) == trace_pass
        with (profile(activities=[ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            check(sched.run_pass() is not None, "serving: a pass ran")
            t = time.perf_counter() - t0
        if traced:
            trace = device_time(prof, t, float(np.mean(secs[1:])),
                                "chunk_gather_kernel", sem.n_batches)
        secs.append(t)
    return secs, trace


def store_csr(store):
    """A product store's entries as a float64 scipy CSR matrix."""
    import scipy.sparse as sp
    parts = [(r, c, v) for _, r, c, v in store.iter_tile_row_entries()
             if r.size]
    h = store.header
    return sp.csr_matrix(
        (np.concatenate([p[2] for p in parts]).astype(np.float64),
         (np.concatenate([p[0] for p in parts]),
          np.concatenate([p[1] for p in parts]))),
        shape=(h["n_rows"], h["n_cols"]))


def run_serving_phase(stores, adj, pr_op, sssp_ref, seed, rng, dev, card,
                      tmp):
    """Phase 6c: the serving runtime over phase 3's stores — (a) a shared
    wave of 8 PageRank tenants and 8 queries, (b) the same with the
    hot-chunk cache, (c) an elastic wave admitting queries mid-pass, (d)
    SSSP and BFS tenants beside queries on the binary store, (e) a
    two-wave fleet over two copies and a replica's failure mid-pass; then
    (f) label propagation, SpGEMM and triangle-count sessions on small
    graphs.  ``sssp_ref`` is phase 6b's SSSP source and scipy's BFS
    distances from it.  Returns K1a's launches over (a)-(e) and the
    oracles phase 6d reuses: PageRank after SERVE_CACHED_ITERS iterations,
    the 8 integer operands and their float64 products (A @ X and |A| @ |X|
    on the valued store, A @ X on the binary one)."""
    import scipy.sparse as sp
    from repro_torch.apps.labelprop import build_operator as lp_operator
    from repro_torch.apps.labelprop import labelprop_session
    from repro_torch.apps.pagerank import dangling_vertices, pagerank_session
    from repro_torch.core.formats import COO, to_chunked
    from repro_torch.core.sem import SEMConfig, SEMSpMM
    from repro_torch.io.storage import TileStore
    from repro_torch.kernels import sem_spmm
    from repro_torch.runtime import (BFSSession, MultiplyRequest,
                                     ReplicaSet, ServingFleet, SessionSpec,
                                     SharedScanScheduler, SSSPSession)
    from repro_torch.sparse.generate import rmat
    n = pr_op.n_rows
    cfg = SEMConfig(memory_budget_bytes=4 << 30, kernel_variant="gather")
    val = stores["val"]
    t0 = time.perf_counter()
    deg = np.bincount(pr_op.cols, minlength=n).astype(np.float64)
    p64 = csr64(pr_op.rows, pr_op.cols, 1.0 / deg[pr_op.cols], n, dev)
    oracle = pagerank_f64_multi(p64, dangling_vertices(adj), SERVE_DAMPINGS,
                                (SERVE_ELASTIC_ITERS, SERVE_CACHED_ITERS,
                                 SERVE_ITERS))
    xs = [rng.integers(-3, 4, n).astype(np.float32) for _ in range(8)]
    want, scale = query_oracle(p64, xs)
    del p64
    at64 = csr64(pr_op.rows, pr_op.cols, None, n, dev)
    want_bin = query_oracle(at64, xs)[0]
    del at64
    torch.cuda.empty_cache()
    log(f"serving: float64 oracles on the card (PageRank at dampings "
        f"{SERVE_DAMPINGS}, {SERVE_ITERS} iterations; the queries' products "
        f"on the valued and the binary store), "
        f"{time.perf_counter() - t0:.1f} s")
    launches = 0

    def k1a():
        return sem_spmm.LAUNCHES["spmm_tiles_acc"]

    def pr_tenants(sched, iters, k=8):
        return [sched.submit(pagerank_session(
            adj, damping=d, max_iter=iters, tol=0.0, tenant_id=f"pr{d}"))
            for d in SERVE_DAMPINGS[:k]]

    # (a) the shared wave: SERVE_ITERS passes serve 8 x SERVE_ITERS + 8
    # tenant-passes
    sem = SEMSpMM(TileStore.open(val.path), cfg, device=dev)
    sched = SharedScanScheduler(sem, use_cache=False)
    prs = pr_tenants(sched, SERVE_ITERS)
    qs = [sched.submit(MultiplyRequest(x, tenant_id=f"q{i}"))
          for i, x in enumerate(xs)]
    sem_spmm.reset_launches()
    secs, trace = serve_passes(sched, sem, trace_pass=2)
    launches += k1a()
    served = sum(r.tenants for r in sched.reports)
    check(sched.total_scan_passes() == SERVE_ITERS == len(secs),
          f"serving (a): {SERVE_ITERS} passes, not {8 * SERVE_ITERS + 8}")
    check(served == 8 * SERVE_ITERS + 8,
          f"serving (a): {8 * SERVE_ITERS + 8} tenant-passes")
    check(sem.io_stats.bytes_read == SERVE_ITERS * val.nbytes,
          "serving (a): bytes_read == passes x nbytes")
    check(k1a() == SERVE_ITERS * sem.n_batches,
          "serving (a): one K1a launch per batch and pass")
    log(f"serving (a) shared wave: "
        f"{check_pagerank('(a)', prs, oracle[SERVE_ITERS])}"
        f"; {check_queries('(a)', [q.result for q in qs], want, scale)}")
    untraced = secs[:2] + secs[3:]
    log(f"serving (a): {SERVE_ITERS} passes for {served} tenant-passes "
        f"({served / SERVE_ITERS:.2f} tenants/pass; {served - SERVE_ITERS} "
        f"passes saved against one pass each), {sem.n_batches} batches = "
        f"{k1a() // SERVE_ITERS} K1a launches a pass; first pass (16 "
        f"columns) {secs[0]:.4f} s, the 8-column passes "
        f"{np.mean(untraced[1:]):.4f} s/pass (min {min(untraced[1:]):.4f}, "
        f"max {max(untraced[1:]):.4f}) [{card}]")
    log(f"serving (a) pass 3 trace: {trace}")
    del sched, prs, qs
    sem.close()

    # (b) the same wave with the hot-chunk cache, 10 passes
    st = TileStore.open(val.path)
    sem = SEMSpMM(st, cfg, device=dev)
    sched = SharedScanScheduler(sem, use_cache=True)
    prs = pr_tenants(sched, SERVE_CACHED_ITERS)
    qs = [sched.submit(MultiplyRequest(x, tenant_id=f"q{i}"))
          for i, x in enumerate(xs)]
    sem_spmm.reset_launches()
    secs, trace = serve_passes(sched, sem, trace_pass=2)
    launches += k1a()
    reps = sched.reports
    check(len(reps) == SERVE_CACHED_ITERS,
          f"serving (b): {SERVE_CACHED_ITERS} passes")
    check(st.stats.bytes_read + st.stats.cache_hit_bytes
          == SERVE_CACHED_ITERS * val.nbytes,
          "serving (b): bytes_read + cache_hit_bytes == passes x nbytes")
    check(reps[0].bytes_read == val.nbytes and reps[0].cache_budget
          >= val.nbytes, "serving (b): the cold pass reads the store and "
          "the leftover budget holds it")
    check(all(r.bytes_read == 0 for r in reps[1:]),
          "serving (b): the later passes read 0 bytes")
    warm = secs[1:2] + secs[3:]
    log(f"serving (b) cached wave: "
        f"{check_pagerank('(b)', prs, oracle[SERVE_CACHED_ITERS])}"
        f"; {check_queries('(b)', [q.result for q in qs], want, scale)}"
        f"; cache budget {reps[0].cache_budget} B, {len(sched.cache)} "
        f"batches pinned ({sched.cache.pinned_bytes} B), cache_hit_bytes "
        f"{st.stats.cache_hit_bytes}; cold pass {secs[0]:.4f} s, warm "
        f"{np.mean(warm):.4f} s/pass (min {min(warm):.4f}, max "
        f"{max(warm):.4f}) [{card}]")
    log(f"serving (b) pass 3 trace (batches from the cache): {trace}")
    del sched, prs, qs
    sem.close()

    # (c) elastic: 4 queries arrive at boundary 170 of pass 2
    sem = SEMSpMM(TileStore.open(val.path), cfg, device=dev)
    box = []

    def probe(sched, b):
        if not box and sched.boundary_clock >= (sem.n_batches
                                                + SERVE_MIDPASS_AT):
            box.extend(sched.submit(MultiplyRequest(x, tenant_id=f"m{i}"))
                       for i, x in enumerate(xs[:4]))
    sched = SharedScanScheduler(sem, use_cache=False, elastic=True,
                                capacity=16, boundary_probe=probe)
    prs = pr_tenants(sched, SERVE_ELASTIC_ITERS, k=4)
    sem_spmm.reset_launches()
    secs, _ = serve_passes(sched, sem)
    launches += k1a()
    reps = sched.reports
    check(len(box) == 4 and all(q.done for q in box),
          "serving (c): the mid-pass queries were served")
    check(sum(r.admitted_midpass for r in reps) == 4
          and reps[1].admitted_midpass == 4,
          "serving (c): 4 queries admitted inside pass 2")
    check(sum(r.completed_midpass for r in reps) == 4,
          "serving (c): 4 stitched deliveries")
    check(k1a() == len(reps) * sem.n_batches,
          "serving (c): one K1a launch per batch and pass")
    waited = [q.first_result_clock - q.submit_clock for q in box]
    log(f"serving (c) elastic wave: "
        f"{check_pagerank('(c)', prs, oracle[SERVE_ELASTIC_ITERS][:, :4])}"
        f"; mid-pass "
        f"{check_queries('(c)', [q.result for q in box], want, scale)}"
        f"; admitted at clock {box[0].submit_clock}, delivered after "
        f"{min(waited)}-{max(waited)} boundaries (a pass is "
        f"{sem.n_batches}); {len(reps)} passes, {np.mean(secs):.4f} s/pass "
        f"[{card}]")
    del sched, prs, box
    sem.close()

    # (d) a ring mini-wave (SSSP) beside BFS and queries on the binary
    # store, from phase 6b's source, against its scipy BFS distances
    src, dist = sssp_ref
    sem = SEMSpMM(TileStore.open(stores["bin"].path), cfg, device=dev)
    sched = SharedScanScheduler(sem, use_cache=False)
    sssp = sched.submit(SSSPSession(np.array([src]), n, tenant_id="sssp"))
    bfs = sched.submit(BFSSession(np.array([src]), n, tenant_id="bfs"))
    qs = [sched.submit(MultiplyRequest(x, tenant_id=f"b{i}"))
          for i, x in enumerate(xs[:4])]
    sem_spmm.reset_launches()
    t0 = time.perf_counter()
    sched.drain()
    t_d = time.perf_counter() - t0
    launches += k1a()
    rings = [r for r in sched.reports if r.semiring == "min_plus"]
    plus = [r for r in sched.reports if r.semiring == "plus_times"]
    check(sssp.done and np.array_equal(sssp.result.astype(np.float64), dist),
          "serving (d): SSSP distances equal scipy's BFS distances")
    check(bfs.done and np.array_equal(
        bfs.result, np.where(np.isfinite(dist), dist, -1).astype(np.int32)),
          "serving (d): BFS levels equal scipy's BFS distances")
    check(k1a() == len(plus) * sem.n_batches,
          "serving (d): one K1a launch per batch of each plus-times pass")
    log(f"serving (d) rings: SSSP from vertex {src} and BFS equal to "
        f"phase 6b's scipy BFS distances; "
        f"{check_queries('(d)', [q.result for q in qs], want_bin)}"
        f"; {len(rings)} min-plus and {len(plus)} plus-times passes in "
        f"{t_d:.1f} s ({t_d / len(sched.reports):.4f} s/pass) [{card}]")
    del sched, sssp, bfs, qs
    sem.close()

    # (e) two waves over two copies of the valued store, then a failure
    copy = str(tmp / "val_copy")
    for ext in (".bin", ".json"):
        shutil.copyfile(val.path + ext, copy + ext)
    rs = ReplicaSet([val.path, copy], cfg, devices=[dev, dev])
    sem_spmm.reset_launches()
    t0 = time.perf_counter()
    with ServingFleet(rs, n_waves=2, use_cache=False) as fleet:
        prs = [fleet.submit(pagerank_session(
            adj, damping=d, max_iter=SERVE_CACHED_ITERS, tol=0.0))
            for d in SERVE_DAMPINGS]
        qs = [fleet.query(x, tenant_id=f"f{i}") for i, x in enumerate(xs)]
        fleet.drain(timeout=900)
        t_e = time.perf_counter() - t0
        passes = fleet.total_scan_passes()
        per_wave = [w.passes_served for w in fleet.waves]
        check(fleet.io_stats.bytes_read == passes * val.nbytes,
              "serving (e): the fleet reads the store once a pass")
        check(k1a() == passes * rs.n_batches,
              "serving (e): one K1a launch per batch and pass")
        log(f"serving (e) fleet: "
            f"{check_pagerank('(e)', prs, oracle[SERVE_CACHED_ITERS])}; "
            f"{check_queries('(e)', [q.result for q in qs], want, scale)}"
            f"; 2 waves, passes {per_wave} ({passes} in all) in {t_e:.1f} s"
            f"; replica scans "
            f"{[s.scans for s in rs.router.states]} [{card}]")
    launches += k1a()
    del prs, qs
    # a replica's read fails mid-pass: on the binary store, whose integer
    # sums are exact, so the retried pass must give the oracle's bits
    bcopy = str(tmp / "bin_copy")
    for ext in (".bin", ".json"):
        shutil.copyfile(stores["bin"].path + ext, bcopy + ext)
    rs = ReplicaSet([stores["bin"].path, bcopy], cfg, devices=[dev, dev])
    x8 = np.stack(xs, axis=1)
    want_x8 = want_bin.astype(np.float32)
    victim = rs.router.ranked()[0]
    real = rs.execs[victim].store.read_batch_raw
    calls = {"n": 0}

    def dying(start, count):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("replica removed mid-pass")
        return real(start, count)
    rs.execs[victim].store.read_batch_raw = dying
    sem_spmm.reset_launches()
    check(np.array_equal(rs.multiply(x8), want_x8),
          "serving (e): the retried pass gives the oracle's bits")
    state = rs.router.states[victim]
    check(not state.healthy and state.failures == 1
          and "OSError" in (state.last_error or ""),
          "serving (e): the router marks the victim unhealthy")
    rs.execs[victim].store.read_batch_raw = real
    rs.router.restore(victim)
    rs.router.fail(1 - victim, OSError("set aside for the check"))
    check(np.array_equal(rs.multiply(x8), want_x8) and state.scans == 1,
          "serving (e): the restored replica serves the same bits")
    launches += k1a()
    log(f"serving (e) failover: replica {victim}'s read failed on its third "
        f"batch; the pass retried on the copy equal to float64 bit for bit "
        f"(p = 8); restored, it served the same bits; {k1a()} K1a launches "
        f"(two whole passes and the abandoned one's first) [{card}]")
    rs.close()

    # (f) host-side sessions on small graphs: label propagation (engine
    # passes on the card), SpGEMM and triangle counts (host numpy)
    adj16 = rmat(LP_SCALE, 16, seed=seed)
    lop = lp_operator(adj16)
    lp_store = TileStore.write(str(tmp / "lp"), to_chunked(lop, T=4096,
                                                           C=1024))
    n16 = adj16.n_rows
    seeds = rng.choice(n16, 8 * LP_LABELS, replace=False)
    seed_labels = np.repeat(np.arange(LP_LABELS), 8)
    sched = SharedScanScheduler(SEMSpMM(lp_store, SEMConfig(),
                                        device=dev))
    t0 = time.perf_counter()
    lp = sched.submit(labelprop_session(adj16, seeds, seed_labels,
                                        LP_LABELS, tol=0.0,
                                        max_iter=LP_ITERS))
    sched.drain()
    t_lp = time.perf_counter() - t0
    a16 = sp.csr_matrix((np.asarray(lop.vals, np.float64),
                         (lop.rows, lop.cols)), shape=(n16, n16))
    x = np.zeros((n16, LP_LABELS))
    x[seeds, seed_labels] = 1.0
    for _ in range(LP_ITERS):
        y = a16 @ x
        row_sum = y.sum(axis=1, keepdims=True)
        x = np.where(row_sum > 0, y / np.maximum(row_sum, 1e-12), x)
        x[seeds] = 0.0
        x[seeds, seed_labels] = 1.0
    top2 = np.sort(x, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    dx = float(np.abs(lp.result - x).max())
    check(lp.done and lp.iterations == LP_ITERS and dx < 1e-4,
          "serving (f): label distributions within 1e-4 of float64")
    check(np.array_equal(lp.labels[clear], x.argmax(axis=1)[clear]),
          "serving (f): labels equal float64's wherever its margin > 1e-3")
    log(f"serving (f) label propagation: scale {LP_SCALE}, {lop.nnz} "
        f"entries, {LP_LABELS} labels, {LP_ITERS} passes in {t_lp:.1f} s; "
        f"within {dx:.3e} of float64, labels equal on {int(clear.sum())} "
        f"of {n16} vertices with a margin > 1e-3 [{card}]")

    g = rmat(SPGEMM_SCALE, 16, seed=seed)
    n13 = g.n_rows
    a13 = sp.csr_matrix((np.ones(g.nnz), (g.rows, g.cols)),
                        shape=(n13, n13))
    a_store = TileStore.write(str(tmp / "g13"), to_chunked(g, T=4096,
                                                           C=1024),
                              binary=True)
    out = str(tmp / "g13_aa")
    with SharedScanScheduler(SEMSpMM(a_store, SEMConfig(),
                                     device=dev)) as sched:
        t0 = time.perf_counter()
        tk = sched.submit(SessionSpec.spgemm(out, budget_bytes=256 << 20,
                                             tile_rows_per_pass=1))
        sched.drain()
        t_g = time.perf_counter() - t0
        check(tk.done and tk.error is None, "serving (f): SpGEMM retired")
    with TileStore.open(out) as prod:
        got = store_csr(prod)
    aa = a13 @ a13
    check(got.nnz == aa.nnz and (got != aa).nnz == 0,
          "serving (f): SpGEMM product equal to scipy's A @ A")
    sym = COO(n13, n13, np.concatenate([g.rows, g.cols]),
              np.concatenate([g.cols, g.rows]), None)
    keep = sym.rows != sym.cols
    sym = COO(n13, n13, sym.rows[keep], sym.cols[keep], None).dedup()
    s_store = TileStore.write(str(tmp / "s13"), to_chunked(sym, T=4096,
                                                           C=1024),
                              binary=True)
    with SharedScanScheduler(SEMSpMM(s_store, SEMConfig(),
                                     device=dev)) as sched:
        t0 = time.perf_counter()
        tri = sched.submit(SessionSpec.triangle_count(
            budget_bytes=256 << 20, tile_rows_per_pass=1))
        sched.drain()
        t_t = time.perf_counter() - t0
    s64 = sp.csr_matrix((np.ones(sym.nnz), (sym.rows, sym.cols)),
                        shape=(n13, n13))
    want_tri = np.asarray((s64 @ s64).multiply(s64).sum(axis=1)).ravel() / 2
    check(tri.done and np.array_equal(tri.result, want_tri),
          "serving (f): triangle counts equal the masked scipy product")
    # partial products A @ A expands: sum over k of in-degree x out-degree
    expands = {s: int((np.bincount(a.cols, minlength=a.n_rows) * np.bincount(
        a.rows, minlength=a.n_rows).astype(np.int64)).sum())
        for s, a in ((LP_SCALE, adj16), (SPGEMM_SCALE, g))}
    check(expands[SPGEMM_SCALE] == tk.session.stats.expanded_products,
          "serving (f): the job expanded every partial product once")
    log(f"serving (f) SpGEMM: scale {SPGEMM_SCALE}, {g.nnz} edges, A @ A "
        f"with {got.nnz} entries equal to scipy's, "
        f"{expands[SPGEMM_SCALE]} partial products (scale {LP_SCALE}'s "
        f"A @ A would expand {expands[LP_SCALE]}), {int(tk.result[3])} "
        f"spills, {t_g:.1f} s; triangle counts "
        f"({int(want_tri.sum() / 3)} triangles, "
        f"{tri.session.stats.expanded_products} partial products) equal to "
        f"the masked scipy product, {t_t:.1f} s [{card}]")
    return launches, dict(pagerank=oracle[SERVE_CACHED_ITERS], xs=xs,
                          want=want, scale=scale, want_bin=want_bin)


# -- phase 6d: the cross-host tier -------------------------------------------
NET_HEARTBEAT_S, NET_MISS_LIMIT = 0.2, 3
NET_PR_TENANTS, NET_QUERIES = 4, 4   # (a): PageRank at 5 iterations, as 6c's
NET_PLANE = 1 << 22                  # a scale-22 result plane, float32
NET_WAIT_S = 300                     # bound on any one wait of the phase


def store_copy(path: str, copy: Path) -> str:
    """``path``'s store copied to ``copy`` (6c's copy when it is there)."""
    for ext in (".bin", ".json"):
        if not Path(str(copy) + ext).exists():
            shutil.copyfile(path + ext, str(copy) + ext)
    return str(copy)


def plane_seconds(n: int, reps: int = 5):
    """Seconds of a WireClient call whose reply carries one n-float32
    plane over loopback (the request is a bare header); the first call,
    which connects, is not counted."""
    import asyncio
    from repro_torch.net import WireClient, WireServer
    plane = np.arange(n, dtype=np.float32)

    async def go():
        async def serve(op, header, planes):
            return {}, [plane]
        server = WireServer(serve)
        client = WireClient("127.0.0.1", await server.start(), deadline=60)
        secs = []
        try:
            for _ in range(reps + 1):
                t0 = time.perf_counter()
                _, got = await client.call("plane")
                secs.append(time.perf_counter() - t0)
            check(np.array_equal(got[0], plane),
                  "cross-host: the plane arrived intact")
        finally:
            await client.close()
            await server.close()
        return secs[1:]
    return asyncio.run(asyncio.wait_for(go(), NET_WAIT_S))


def net_cluster(paths, dev):
    """Two in-process hosts on the card, a copy and one wave each, behind
    one front door; returns (hosts, front door, host keys)."""
    from repro_torch.core.sem import SEMConfig
    from repro_torch.net import ClusterFrontDoor, HostServer
    from repro_torch.runtime import ReplicaSet, ServingFleet
    hosts = [HostServer(ServingFleet(ReplicaSet(
        [p], SEMConfig(memory_budget_bytes=4 << 30, kernel_variant="gather"),
        devices=[dev]), n_waves=1, use_cache=False)) for p in paths]
    ports = [h.start() for h in hosts]
    fd = ClusterFrontDoor(heartbeat_interval=NET_HEARTBEAT_S,
                          miss_limit=NET_MISS_LIMIT)
    return hosts, fd, [fd.add_host("127.0.0.1", p) for p in ports]


def host_passes(label, hosts, nbytes: int, n_batches: int, launches: int,
                before=None):
    """Each host's fleet read its store once a pass, and K1a ran once a
    batch of every pass since ``before`` (the hosts' earlier pass counts);
    returns the hosts' passes since then."""
    passes = [h.fleet.total_scan_passes() for h in hosts]
    for h, n in zip(hosts, passes):
        check(h.fleet.io_stats.bytes_read == n * nbytes,
              f"cross-host {label}: a host's bytes_read == passes x nbytes")
    new = [a - b for a, b in zip(passes, before or [0] * len(hosts))]
    check(launches == sum(new) * n_batches,
          f"cross-host {label}: one K1a launch per batch and pass")
    return new


def run_net_phase(stores, adj, sssp_ref, oracles, dev, card, tmp):
    """Phase 6d: the cross-host tier over phase 3's scale-22 stores, with
    6c's copies and oracles (see the module docstring).  Returns K1a's
    launches over (a)-(c)."""
    import os
    import queue
    import threading
    from types import SimpleNamespace
    from repro_torch.apps.pagerank import dangling_vertices
    from repro_torch.kernels import sem_spmm
    from repro_torch.net import ClusterFrontDoor
    from repro_torch.runtime import SessionSpec
    t_phase = time.perf_counter()
    val, bin_ = stores["val"], stores["bin"]
    n = adj.n_rows
    xs, want, scale = oracles["xs"], oracles["want"], oracles["scale"]
    want_bin = oracles["want_bin"].astype(np.float32)
    src, dist = sssp_ref
    launches = 0

    def k1a():
        return sem_spmm.LAUNCHES["spmm_tiles_acc"]

    secs = plane_seconds(NET_PLANE)
    log(f"cross-host: a {NET_PLANE}-float32 result plane "
        f"({4 * NET_PLANE} B) over loopback in {np.median(secs):.4f} s "
        f"(median of {len(secs)}; min {min(secs):.4f}, max "
        f"{max(secs):.4f}) [{card}]")

    # (a) routed tenants on the valued store's two copies
    hosts, fd, keys = net_cluster(
        [val.path, store_copy(val.path, tmp / "val_copy")], dev)
    dampings = SERVE_DAMPINGS[:NET_PR_TENANTS]
    mask = dangling_vertices(adj)
    try:
        sem_spmm.reset_launches()
        t0 = time.perf_counter()
        prs = [fd.submit(SessionSpec.pagerank(
            n, mask, damping=d, tol=0.0, max_iter=SERVE_CACHED_ITERS,
            tenant_id=f"pr{d}")) for d in dampings]
        qs = [fd.submit(SessionSpec.multiply(x, tenant_id=f"q{i}"))
              for i, x in enumerate(xs[:NET_QUERIES])]
        fd.drain(prs + qs, timeout=NET_WAIT_S)
        t_a = time.perf_counter() - t0
        check({t.host_key for t in prs + qs} == set(keys),
              "cross-host (a): both hosts served")
        ewma = [h.fleet.stats()["ewma_pass_s"] for h in hosts]
    finally:
        fd.close()
        for h in hosts:
            h.stop()
    launches += k1a()
    passes = host_passes("(a)", hosts, val.nbytes, hosts[0].fleet.replicas
                         .n_batches, k1a())
    pr = check_pagerank("net (a)", [SimpleNamespace(
        done=t.done, result=t.result, damping=d)
        for t, d in zip(prs, dampings)],
        oracles["pagerank"][:, :NET_PR_TENANTS])
    q = check_queries("net (a)", [t.result for t in qs],
                      want[:, :NET_QUERIES], scale[:, :NET_QUERIES])
    log(f"cross-host (a) routed: {pr}; {q}; passes per host {passes}, "
        f"s/pass (stats EWMA) {[round(e, 4) for e in ewma]}; {t_a:.1f} s "
        f"for the mix [{card}]")

    # (b) a partitioned query and (c) a host killed mid-pass, on the
    # binary store's two copies
    hosts, fd, keys = net_cluster(
        [bin_.path, store_copy(bin_.path, tmp / "bin_copy")], dev)
    nb = hosts[0].fleet.replicas.n_batches
    try:
        sem_spmm.reset_launches()
        t0 = time.perf_counter()
        part = fd.submit(SessionSpec.multiply(xs[0], tenant_id="part"),
                         partitioned=True)
        (got,) = fd.drain([part], timeout=NET_WAIT_S)
        t_b = time.perf_counter() - t0
        check(np.array_equal(got, want_bin[:, 0]),
              "cross-host (b): the partitioned query equals float64 bit "
              "for bit")
        slabs = [rs for h in hosts for rs in h._slabs.values()]
        check(len(slabs) == 2 and all(h.slab_scans == 1 for h in hosts),
              "cross-host (b): a slab on each host")
        check(all(ex.device.type == "cuda" for rs in slabs
                  for ex in rs.execs), "cross-host (b): slabs on the card")
        check(sum(rs.io_stats.bytes_read for rs in slabs) == bin_.nbytes,
              "cross-host (b): the slabs read the store once")
        slab_batches = [rs.n_batches for rs in slabs]
        check(k1a() == sum(slab_batches),
              "cross-host (b): one K1a launch per slab batch")
        launches += k1a()
        log(f"cross-host (b) partitioned: p = 1 equal to float64 bit for "
            f"bit; slabs of {slab_batches} batches ({nb} in the store), "
            f"{k1a()} K1a launches, {t_b:.2f} s [{card}]")

        sem_spmm.reset_launches()
        before = [h.fleet.total_scan_passes() for h in hosts]
        bfs = fd.submit(SessionSpec.bfs(np.array([src]), n, tenant_id="bfs"))
        cqs = [fd.submit(SessionSpec.multiply(x, tenant_id=f"c{i}"))
               for i, x in enumerate(xs[:NET_QUERIES])]
        vi = keys.index(bfs.host_key)
        victim = hosts[vi]
        deadline = time.monotonic() + NET_WAIT_S
        while (victim.fleet.total_scan_passes() - before[vi] < 1
               or not victim.fleet.waves[0].in_pass):
            check(time.monotonic() < deadline,
                  "cross-host (c): the victim began its second pass")
            time.sleep(0.002)
        kill_pass = victim.fleet.total_scan_passes() - before[vi] + 1
        t_kill = time.perf_counter()
        victim._loop.call_soon_threadsafe(victim._shutdown.set)
        while not fd.evicted:
            check(time.monotonic() < deadline,
                  "cross-host (c): the killed host was evicted")
            time.sleep(0.002)
        t_evict = time.perf_counter() - t_kill
        # fewer misses than the limit: the deliver stream's lost
        # connection evicted the host before its heartbeat did
        misses = fd.hosts[keys[vi]].heartbeat.misses
        # the dead host's compute ends too: its wave finishes the pass in
        # flight and stops (the endpoint is already gone)
        victim.stop()
        fd.drain([bfs] + cqs, timeout=NET_WAIT_S)
        t_done = time.perf_counter() - t_kill
        check(fd.evicted == [keys[vi]],
              "cross-host (c): the evicted host is the killed one")
        check(bfs.resubmits >= 1 and bfs.host_key != keys[vi],
              "cross-host (c): the BFS was replayed on the survivor")
        check(np.array_equal(bfs.result, np.where(
            np.isfinite(dist), dist, -1).astype(np.int32)),
              "cross-host (c): BFS levels equal phase 6b's distances")
        replayed = sum(t.resubmits for t in [bfs] + cqs)
    finally:
        fd.close()
        for h in hosts:
            h.stop()
    launches += k1a()
    passes = host_passes("(c)", hosts, bin_.nbytes, nb, k1a(), before)
    q = check_queries("net (c)", [t.result for t in cqs],
                      want_bin[:, :NET_QUERIES])
    log(f"cross-host (c) failover: host {vi} killed in its pass "
        f"{kill_pass} of the BFS, evicted after {t_evict:.3f} s (heartbeat "
        f"{NET_HEARTBEAT_S} s, {misses} of {NET_MISS_LIMIT} misses by "
        f"then), the last result {t_done:.2f} s after the kill; "
        f"{replayed} tenants replayed; BFS equal to phase 6b's distances, "
        f"{q}; passes per host {passes} [{card}]")

    # (d) the CLI as its own process, on the card by default
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.net.host", "--store",
           bin_.path, "--store", store_copy(bin_.path, tmp / "bin_copy"),
           "--waves", "1"]
    errs = open(tmp / "host_cli.err", "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=errs,
                            text=True, env=env)
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()
        try:
            line = lines.get(timeout=NET_WAIT_S)
        except queue.Empty:
            line = ""
        if not line.startswith("LISTENING "):
            errs.seek(0)
            check(False, f"cross-host (d): the CLI host printed its port "
                  f"({line!r}; its stderr ends: {errs.read()[-2000:]})")
        t_up = time.perf_counter() - t0
        with ClusterFrontDoor(heartbeat_interval=NET_HEARTBEAT_S,
                              miss_limit=NET_MISS_LIMIT) as fd:
            key = fd.add_host("127.0.0.1", int(line.split()[1]))
            t1 = time.perf_counter()
            (got,) = fd.drain([fd.submit(SessionSpec.multiply(
                xs[1], tenant_id="cli"))], timeout=NET_WAIT_S)
            t_q = time.perf_counter() - t1
            check(np.array_equal(got, want_bin[:, 1]),
                  "cross-host (d): the CLI host's query equals float64 bit "
                  "for bit")
            # the host's own gauges, as its heartbeat replies carry them:
            # once a beat reports the pass, the idle host's next beats
            # hold still
            deadline = time.monotonic() + NET_WAIT_S
            while fd.hosts[key].gauges.get("scan_passes", 0) < 1:
                check(time.monotonic() < deadline,
                      "cross-host (d): a heartbeat reported the pass")
                time.sleep(0.02)
            time.sleep(3 * NET_HEARTBEAT_S)
            g = fd.hosts[key].gauges
            fd.shutdown_hosts()
        t1 = time.perf_counter()
        rc = proc.wait(timeout=60)
        t_exit = time.perf_counter() - t1
        check(rc == 0, f"cross-host (d): the CLI host exited {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        errs.close()
    cli_k1a = g["kernel_launches"]["spmm_tiles_acc"]
    check(g["scan_passes"] >= 1 and g["io_stats"]["bytes_read"]
          == g["scan_passes"] * bin_.nbytes,
          "cross-host (d): the CLI host read its store once a pass")
    check(cli_k1a == g["scan_passes"] * nb,
          "cross-host (d): the CLI host ran K1a once a batch and pass "
          "(on the card)")
    log(f"cross-host (d) CLI host: listening after {t_up:.1f} s, a query "
        f"p = 1 equal to float64 bit for bit in {t_q:.2f} s "
        f"({g['scan_passes']} pass, {cli_k1a} K1a launches in its process, "
        f"s/pass EWMA {g['ewma_pass_s']:.4f}), exit 0 {t_exit:.2f} s after "
        f"shutdown [{card}]")
    log(f"cross-host: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
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
    im = IMOperator(wide["ct_a"], device=dev, variant="gather"), IMOperator(
        binary_tiles(ct), device=dev, variant="gather")
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


# -- phases 9-11: the models ----------------------------------------------------
PREFILL_B, PREFILL_L = 2, 2048      # the serving prefill at full width
# decode against prefill: prompt length (each step is tens of ms at full
# width, and each layer's decode inputs are replayed as a prefill)
DECODE_L = 64
# the serving check: 4 requests of 16 prompt tokens and 16 new ones (a
# prompt is fed through decode_step a token at a time, so its length adds
# steps, not paths)
SERVE_REQ, SERVE_PROMPT, SERVE_NEW = 4, 16, 16
# Decode against prefill: the reference's test_decode_matches_forward_prefix
# tolerance.
DECODE_RTOL, DECODE_ATOL = 2e-2, 2e-3
# A kernel prefill's logits against the plain prefill's, end to end: the
# forward tolerance of tests/test_torch_models.py.
LOGIT_TOL = 2e-4


@contextlib.contextmanager
def kernel_impl(which: str):
    """Both model toggles (attention, SSD) set to "kernel" or "plain"."""
    from repro_torch.models import layers, ssm
    prev = layers.set_flash_impl(which), ssm.set_ssd_impl(which)
    try:
        yield
    finally:
        layers.set_flash_impl(prev[0])
        ssm.set_ssd_impl(prev[1])


@contextlib.contextmanager
def patched(mod, name, make):
    """``mod.name`` replaced by ``make(original)`` for the block."""
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def rel_l2(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm())


def row_rel(got, want) -> torch.Tensor:
    """Per token (row of the last axis), ``|got - want| / |want|`` in L2."""
    return ((got - want).double().norm(dim=-1)
            / want.double().norm(dim=-1))


def prefill(model, cfg, batch):
    """One serving prefill, ``forward(..., logits_last_only=True)``, with
    its wall time (synchronised)."""
    from repro_torch.models import model_api
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model_api.forward(model, cfg, batch, logits_last_only=True)
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


def attention_scale(q, k, v, causal: bool, softcap: float = 0.0):
    """First-order error scale of attention at these inputs, per output
    element, in float64: ``E = sum_j p_j (S_j |v_j - o| + |v_j|)`` with p the
    softmax, o the output and ``S_j = scale * sum_d |q_d| |k_jd|`` the
    magnitude of score j's terms.  A float32 score carries a rounding error
    of the order of 2**-24 * sqrt(hd) * S_j, and an error d_j in score j
    moves the output by ``sum_j p_j d_j (v_j - o)``; the weighted sum rounds
    by the order of 2**-24 * sum_j p_j |v_j|.  So two float32 computations
    that sum in other orders differ by a small multiple of 1e-7 * E, and
    FLOAT_TOL * E leaves room; a dropped, doubled or wrongly masked key moves
    the output by the size of v.  A softcap ``tanh(s / cap) * cap`` shapes
    p and moves no score's error up (its slope is at most 1).  Also returns
    the float64 output and the underflow term ``U = tiny * sum_j |v_j|``
    over the keys a query sees (``tiny``: float32's smallest normal,
    2**-126): a weight below it may be held as zero (flushed) in one
    computation and as a subnormal in the other, which moves the output by
    at most ``tiny * |v_j|`` a key, however small E is.  The comparison's
    limit is ``FLOAT_TOL * E + U``: U is some 1e-34 of the size of v, so it
    only bears on outputs in float32's subnormal range."""
    B, L, H, hd = q.shape
    G = H // k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    E = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    out = torch.empty_like(E)
    U = torch.empty_like(E)
    tiny = torch.finfo(torch.float32).tiny
    future = torch.triu(torch.ones((L, L), dtype=torch.bool, device=q.device),
                        1)
    for b in range(B):
        for h in range(H):
            qh = q[b, :, h].double() * scale
            kh, vh = k[b, :, h // G].double(), v[b, :, h // G].double()
            s = qh @ kh.T
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            if causal:
                s.masked_fill_(future, float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = p @ vh
            w = p * (qh.abs() @ kh.abs().T)
            e = p @ vh.abs()
            # the (L, L, 32) weighted gaps in float32: a scale, not a result
            w32, v32, o32 = w.float(), vh.float(), o.float()
            for d0 in range(0, hd, 32):
                sl = slice(d0, d0 + 32)
                e[:, sl] += (w32[..., None] * (v32[None, :, sl]
                                               - o32[:, None, sl]).abs()
                             ).sum(1).double()
            E[b, :, h], out[b, :, h] = e, o
            U[b, :, h] = tiny * (vh.abs().cumsum(0) if causal
                                 else vh.abs().sum(0, keepdim=True))
            del s, p, w, w32
    return E, out, U


def ssd_scale(plain, x, dt, A, Bm, Cm, D, Q: int):
    """First-order error scale of the SSD scan at these inputs, for y and
    the final state: the plain scan on the terms' magnitudes (|x|, |B|,
    |C|, |D|; dt > 0 and the decay weights are positive), times
    ``1 + 2 * lam``.  ``lam`` is the largest |sum of dt*A| over a chunk:
    each weight exp(cum_i - cum_j) comes from two cumulative sums of
    magnitude up to lam, whose float32 rounding (of the order of 2**-24 *
    lam, and the kernel's scan and the plain cumsum add in other orders)
    makes the weight uncertain by that much relative, on top of the
    rounding of the sums themselves.  A dropped or misplaced term, a
    wrong decay or a wrong head moves y by the size of the terms."""
    B, L, H, _ = x.shape
    ty, ts = plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), D.abs(), Q=Q)
    a = (dt * A[None, None, :]).reshape(B, L // Q, Q, H)
    lam = float(a.sum(2).abs().max())
    return ty * (1 + 2 * lam), ts * (1 + 2 * lam), lam


@contextlib.contextmanager
def checked_calls(stats: dict):
    """Every call of K3's and K4's plain versions (as a plain prefill makes
    them) also runs the kernel on the same inputs and holds it against the
    plain result elementwise, within FLOAT_TOL of the call's error scale
    (``attention_scale``, ``ssd_scale``), as check_float holds the SpMM
    kernels.  ``stats`` gathers, per kernel, the calls, the largest
    difference and its share of the limit, and the first call's inputs (for
    timing).  K3's limit adds ``attention_scale``'s underflow term."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ssd_chunk as k4

    def note(name, args, kw, diff, share, worst=None):
        st = stats.setdefault(name, dict(calls=0, max_abs_diff=0.0,
                                         share=0.0))
        if not st["calls"]:
            st["first"] = ([a.clone() for a in args], dict(kw))
        st["calls"] += 1
        st["max_abs_diff"] = max(st["max_abs_diff"], diff)
        if share >= st["share"] and worst is not None:
            st["worst"] = worst
        st["share"] = max(st["share"], share)

    def k3_make(plain):
        def wrapped(q, k, v, **kw):
            want = plain(q, k, v, **kw)
            got = k3.flash_attention(q, k, v, **kw)
            scale, _, under = attention_scale(q, k, v, kw["causal"],
                                              kw.get("softcap", 0.0))
            err = (got - want).abs().double()
            limit = FLOAT_TOL * scale + under
            i = int((err / limit).argmax())
            note("K3", (q, k, v), kw, float(err.max()),
                 float(err.flatten()[i] / limit.flatten()[i]),
                 worst=tuple(float(t.flatten()[i])
                             for t in (got, want, limit)))
            return want
        return wrapped

    def k4_make(plain):
        def wrapped(*args, **kw):
            want = plain(*args, **kw)
            got = k4.ssd_chunked(*args, **kw)
            *scales, lam = ssd_scale(plain, *args, **kw)
            share = max(float(((g - w).abs() / (FLOAT_TOL * e)).max())
                        for g, w, e in zip(got, want, scales))
            diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
            note("K4", args, kw, diff, share)
            stats["K4"]["lam"] = max(stats["K4"].get("lam", 0.0), lam)
            return want
        return wrapped
    with patched(k3, "flash_attention_plain", k3_make), \
            patched(k4, "ssd_chunked_plain", k4_make):
        yield


def time_k3(first, label, card):
    """K3's times on the first attention layer's prefill inputs, its bound
    and SDPA's time as the yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3
    (q, k, v), kw = first
    B, L, H, hd = q.shape
    ms = cuda_ms(lambda: k3.flash_attention(q, k, v, **kw), reps=10)
    plain_ms = cuda_ms(lambda: k3.flash_attention_plain(q, k, v, **kw),
                       reps=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=H != k.shape[2]), reps=10)
    # causal: every query meets the keys up to its own, two products
    flops = 4 * B * H * hd * L * (L + 1) // 2
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    core_ms, _ = bound(nbytes, flops)
    # at float32 accuracy on the tensor cores: the three-term TF32 split
    # does each product three times
    bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    before = (f"; before the redesign {K3_BEFORE_MS} ms, "
              f"{K3_BEFORE_MS / ms:.2f}x" if label == "zamba2-7b" else "")
    log(f"K3 {label} per call at {tuple(q.shape)} over {tuple(k.shape)}: "
        f"{ms} ms (CUDA events, 10 calls), plain {plain_ms} ms, SDPA "
        f"{library_ms} ms ({ms / library_ms:.3f}x SDPA's time{before}); "
        f"bound on the tensor "
        f"cores {bound_ms} ms ({bound_by}: 3 x {flops / 1e9:.2f} GFLOP "
        f"TF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, {nbytes} B), on the "
        f"CUDA cores {core_ms} ms (float32 at {FP32_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def ssd_flops(B, L, H, dh, N, Q) -> int:
    """Float32 operations the SSD function needs: per (batch, chunk) the
    causal half of C B^T, which every head shares; per (batch, head, chunk)
    the causal half of the weighted product, the carried-in state's
    contribution, the state update and D x."""
    tri = Q * (Q + 1) // 2
    nc = L // Q
    return (B * nc * 2 * N * tri
            + B * H * nc * (2 * dh * tri + 4 * Q * N * dh + 2 * Q * dh))


def time_k4(first, label, card):
    """K4's times on the first Mamba layer's prefill inputs, its bounds on
    the tensor cores (the record's) and on the CUDA cores."""
    from repro_torch.kernels import ssd_chunk as k4
    args, kw = first
    x, dt, A, Bm, Cm, D = args
    ms = cuda_ms(lambda: k4.ssd_chunked(*args, **kw), reps=10)
    plain_ms = cuda_ms(lambda: k4.ssd_chunked_plain(*args, **kw), reps=3,
                       warmup=1)
    B, L, H, dh = x.shape
    N = Bm.shape[-1]
    flops = ssd_flops(B, L, H, dh, N, kw["Q"])
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + Bm.numel()
                  + Cm.numel() + D.numel() + B * H * dh * N)
    core_ms, _ = bound(nbytes, flops)
    # at float32 accuracy on the tensor cores: the three-term TF32 split
    # does each product three times
    bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    before = (f"; before the redesign {K4_BEFORE_MS} ms, "
              f"{K4_BEFORE_MS / ms:.2f}x" if label == "zamba2-7b" else "")
    log(f"K4 {label} per call at x {tuple(x.shape)}, N = {N}, Q = "
        f"{kw['Q']}: {ms} ms (CUDA events, 10 calls){before}, plain "
        f"{plain_ms} ms; no single PyTorch call computes SSD; bound on the "
        f"tensor cores {bound_ms} ms ({bound_by}: 3 x {flops / 1e9:.2f} GFLOP"
        f" TF32 at {TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, {nbytes} B), on the"
        f" CUDA cores {core_ms} ms (float32 at {FP32_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by)


def make_model(arch: str, seed: int, dev, depth: int = 0):
    """The model of ``arch`` at full width (and full depth, or ``depth``
    layers), float32 weights made from ``seed`` on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model_api
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls run in full float32 (TF32 off)")
    t0 = time.perf_counter()
    model = model_api.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                                  dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    check(n == model_api.n_params(cfg), f"{arch}: every parameter made")
    log(f"model {arch}: {n} parameters, {4 * n} B float32 on the card, made "
        f"from seed {seed} in {time.perf_counter() - t0:.1f} s; "
        f"{cfg.n_layers} layers" + (f" (of {get_config(arch).n_layers})"
                                    if depth else "")
        + f", d_model {cfg.d_model}")
    return cfg, model


DISPATCH_KERNELS = ("scatter", "gather", "index", "scan", "sort", "radix",
                    "one_hot", "cumsum")


def prefill_breakdown(prof, secs: float) -> str:
    """Device time of a traced prefill by kind of kernel (K3, K4, matrix
    products, gathers/scatters/scans/sorts (the MoE dispatch, and the
    embedding lookup), the rest), the card's busy time and its idle share.
    K4's launches on the card are its four kernels' (ssd_chunk_cbt,
    _states, _pass, _scan): four a call."""
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return "no device activity recorded: breakdown not measured"
    kinds = {}
    for e in spans:
        name = e.name.lower()
        kind = ("K3" if "flash_fwd_kernel" in name
                else "K4" if "ssd_chunk_" in name
                else "matmul" if "gemm" in name or "cutlass" in name
                else "gather/scatter/scan/sort" if any(
                    w in name for w in DISPATCH_KERNELS)
                else "other")
        n, us = kinds.get(kind, (0, 0.0))
        kinds[kind] = (n + 1, us + e.time_range.elapsed_us())
    busy_us, end = 0.0, float("-inf")
    for e in sorted(spans, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return (", ".join(f"{k}: {n} launches, {us / 1e3:.3f} ms"
                      for k, (n, us) in sorted(kinds.items()))
            + " (K4: four kernels a call)"
            + f"; device busy {busy_us / 1e3:.3f} ms of {secs * 1e3:.1f} ms"
            f" (idle {1 - busy_us / 1e6 / secs:.4f})")


def prefill_batch(cfg, rng, dev, L: int = PREFILL_L, B: int = PREFILL_B):
    """Tokens (B, L) from ``rng``, then vlm's patches (B, n_patches, D) and
    audio's frames (B, enc_frames, D), standard normal."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (B, L))).to(dev)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            (B, cfg.n_patches, cfg.d_model),
            generator=torch.Generator(dev).manual_seed(1), device=dev)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            (B, cfg.enc_frames, cfg.d_model),
            generator=torch.Generator(dev).manual_seed(2), device=dev)
    return batch


@contextlib.contextmanager
def moe_drops(shares: list):
    """Each MoE layer's dropped share of its (token, k) pairs, read from
    ``moe_block``'s own capacity assignment, appended to ``shares`` as the
    forward runs."""
    from repro_torch.models import moe

    def make(slots):
        def wrapped(*a, **kw):
            slot, keep = slots(*a, **kw)
            shares.append(1.0 - float(keep.float().mean()))
            return slot, keep
        return wrapped
    with patched(moe, "capacity_slots", make):
        yield


# The layer functions ``layer_io`` records: (function name in
# models/transformer.py, kind).
LAYER_FNS = (("_attn_mlp_layer", "dense"), ("_shared_attn_apply", "attn"),
             ("_mamba_apply", "mamba"))
# An attention sublayer's or a Mamba layer's output through the kernels
# against the plain one on the same input, per token in relative L2: the
# forward tolerance of tests/test_torch_models.py.
LAYER_ROW_TOL = 2e-4


@contextlib.contextmanager
def held_layers(worst: dict):
    """Teacher-forced: during a prefill through the kernels, every
    attention sublayer (``layers.attention``: projections, RoPE, the K3
    dispatch, the output projection) and every Mamba layer (K4) also runs
    with the plain versions on the same input, and each token's outputs
    (a Mamba layer's: its increments) are held to each other
    (``row_rel``).  The rest of a layer (norms, MLP, MoE block) is the same
    code in both.  Per kind, ``worst`` gathers the calls, the largest ratio
    and the tokens over LAYER_ROW_TOL."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    def note(kind, r):
        n, top, over = worst.get(kind, (0, 0.0, 0))
        worst[kind] = (n + 1, max(top, float(r.max())),
                       over + int((r > LAYER_ROW_TOL).sum()))

    def attn(fn):
        def wrapped(p, x, **kw):
            out = fn(p, x, **kw)
            with kernel_impl("plain"):
                want = fn(p, x, **kw)[0]
            note("attention", row_rel(out[0], want))
            return out
        return wrapped

    def mamba(fn):
        def wrapped(cfg, lp, x, *a, **kw):
            out = fn(cfg, lp, x, *a, **kw)
            with kernel_impl("plain"):
                want = fn(cfg, lp, x, *a, **kw)[0]
            note("mamba", row_rel(out[0] - x, want - x))
            return out
        return wrapped
    with patched(layers, "attention", attn), patched(tf, "_mamba_apply",
                                                     mamba):
        yield


def run_prefill_phase(arch, cfg, model, rng, dev, card, n_k3, n_k4,
                      L: int = PREFILL_L, timed: bool = True):
    """A plain prefill in which every K3 and K4 call is checked against the
    kernel on the same inputs; the kernels timed on the first calls' inputs
    (``timed``); then the main path, the kernel prefill, its launches
    counted and each attention sublayer and Mamba layer held to the plain
    one on the same input (``held_layers``).  A model with K4 also
    holds its kernel logits to the plain prefill's beside the plain
    prefill's own spread (the same prefill with K4 at Q = 128, equal in
    exact arithmetic).  ``L``: the tokens a sequence (a vlm's patches come
    before them).  Returns the kernel records, the launches and the plain
    prefill's logits."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ssd_chunk as k4
    batch = prefill_batch(cfg, rng, dev, L)
    n_tok = PREFILL_B * (L + cfg.n_patches)
    stats, drops = {}, []
    with kernel_impl("plain"), checked_calls(stats), moe_drops(drops):
        want, plain_s = prefill(model, cfg, batch)
    log(f"{arch} plain prefill (B = {PREFILL_B}, L = {L}"
        + (f" + {cfg.n_patches} patches" if cfg.n_patches else "")
        + (f", {cfg.enc_frames} frames" if cfg.is_encdec else "")
        + f"), every kernel call checked: {plain_s:.3f} s")
    if drops:
        log(f"{arch} MoE: dropped share of (token, k) pairs by layer "
            f"(capacity factor 1.25): {[round(d, 5) for d in drops]}")
    records = {}
    for key in ("K3", "K4"):
        if key not in stats:
            continue
        st = stats[key]
        log(f"{arch} {key} on the prefill's inputs: {st['calls']} calls, max "
            f"|kernel - plain| {st['max_abs_diff']}, at most {st['share']} of "
            f"the limit ({FLOAT_TOL} of the error scale"
            + (f"; largest |sum of dt*A| over a chunk {st['lam']})"
               if key == "K4" else " plus the underflow term; the worst "
               "element: kernel {}, plain {}, limit {})".format(
                   *st["worst"])))
        check(st["share"] <= 1.0, f"{arch} {key}: every call of the prefill "
              "within its limit of the plain version")
        if timed:
            t = (time_k3(st["first"], arch, card) if key == "K3"
                 else time_k4(st["first"], arch, card))
            records[key] = dict(t, max_abs_diff=st["max_abs_diff"])
    check(stats.get("K3", {}).get("calls", 0) == n_k3
          and stats.get("K4", {}).get("calls", 0) == n_k4,
          f"{arch}: the plain prefill made {n_k3} K3 and {n_k4} K4 calls")
    del stats
    held = {}
    with kernel_impl("kernel"):
        k3.reset_launches()
        k4.reset_launches()
        with held_layers(held):
            got, _ = prefill(model, cfg, batch)
        launches = (k3.LAUNCHES["flash_attention"],
                    k4.LAUNCHES["ssd_chunked"])
        _, secs = prefill(model, cfg, batch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, traced = prefill(model, cfg, batch)
    log(f"{arch} prefill trace (a third prefill, traced, {traced:.3f} s): "
        + prefill_breakdown(prof, traced))
    dist = rel_l2(got, want)
    log(f"{arch} prefill: K3 launches {launches[0]}, K4 launches "
        f"{launches[1]}; each attention sublayer and Mamba layer through the "
        f"kernels against the plain one on the same input, per token, "
        f"relative L2 (limit {LAYER_ROW_TOL}): "
        + ", ".join(f"{k} {n} calls, at most {top}, {over} tokens over"
                    for k, (n, top, over) in sorted(held.items()))
        + f"; logits against the plain prefill: relative L2 {dist}, max "
        f"|diff| {float((got - want).abs().max())}, max |logit| "
        f"{float(want.abs().max())}; {secs:.3f} s a prefill (the second), "
        f"{n_tok / secs:.1f} tokens/s [{card}]")
    check(launches == (n_k3, n_k4), f"{arch} prefill: {n_k3} K3 and {n_k4} "
          f"K4 launches, got {launches}")
    check(got.shape == (PREFILL_B, 1, cfg.vocab_padded)
          and bool(torch.isfinite(got).all()), f"{arch} prefill: finite "
          "logits of the expected shape")
    check(held and all(over == 0 for _, _, over in held.values()),
          f"{arch} prefill: every attention sublayer's and Mamba layer's "
          f"tokens through the kernels within {LAYER_ROW_TOL} of the plain "
          "one's on the same input")
    if n_k4:
        with patched(k4, "ssd_chunked_plain",
                     lambda plain: lambda *a, **kw: plain(*a, Q=128)), \
                kernel_impl("plain"):
            spread = rel_l2(prefill(model, cfg, batch)[0], want)
        log(f"{arch} prefill: the plain prefill at Q = 128 against Q = 256: "
            f"relative L2 {spread}")
        check(dist <= 2 * spread + 1e-4, f"{arch} prefill: kernel logits no "
              "farther from the plain prefill's than twice its own spread")
    return records, launches, want


@contextlib.contextmanager
def layer_io(seen: list):
    """Record each layer call of a forward or decode step: (kind, layer
    module, x in, x out)."""
    from repro_torch.models import transformer as tf

    def make(kind, fn):
        def wrapped(cfg, lp, x, *a, **kw):
            out = fn(cfg, lp, x, *a, **kw)
            seen.append((kind, lp, x.clone(), out[0].clone()))
            return out
        return wrapped
    with contextlib.ExitStack() as stack:
        for name, kind in LAYER_FNS:
            stack.enter_context(patched(
                tf, name, lambda fn, kind=kind: make(kind, fn)))
        yield


def plain_layer(cfg, kind, lp, x):
    """The layer of ``kind`` over the whole sequence x (B, L, D), as a
    prefill runs it, with the plain versions."""
    from repro_torch.models import transformer as tf
    pos = torch.arange(x.shape[1], device=x.device)
    with kernel_impl("plain"):
        if kind == "dense":
            return tf._attn_mlp_layer(cfg, lp, x, pos, lp.window,
                                      kv_chunk=x.shape[1])[0]
        if kind == "attn":
            return tf._shared_attn_apply(cfg, lp, x, pos,
                                         kv_chunk=x.shape[1])[0]
        return tf._mamba_apply(cfg, lp, x)[0]


def run_decode_phase(arch, cfg, model, rng, dev, card):
    """Decode against prefill at full width, through ``model_api.
    decode_step``: a DECODE_L-token prompt, one token a step, with every
    layer call's input and output recorded.  Each layer's decode inputs,
    stacked over the steps, then run through the same layer as a prefill
    with the plain versions (causal: position t sees the inputs up to t,
    as the caches held them), and the decode increments (output minus
    input) are held to the prefill's, each token's within DECODE_RTOL in
    relative L2; a hybrid's layers also elementwise within the reference's
    decode tolerance (rtol DECODE_RTOL, atol DECODE_ATOL).  Then the same
    steps without the hooks, timed, and their last logits against the
    kernel prefill's."""
    from repro_torch.models import model_api
    toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (PREFILL_B, DECODE_L))).to(dev)
    seen = []
    cache = model_api.init_cache(cfg, PREFILL_B, DECODE_L,
                                 dtype=torch.float32, device=dev)
    with kernel_impl("kernel"), layer_io(seen):
        for t in range(DECODE_L):
            model_api.decode_step(model, cfg, cache, toks[:, t:t + 1], t)
    n = len(seen) // DECODE_L
    worst, bad = {}, []
    for i in range(n):
        steps = seen[i::n]
        kind, lp = steps[0][:2]
        x = torch.cat([s[2] for s in steps], dim=1)
        out = torch.cat([s[3] for s in steps], dim=1)
        want = plain_layer(cfg, kind, lp, x)
        rows = float(row_rel(out - x, want - x).max())
        inc_pre = want - x
        share = float(((out - want).abs()
                       / (DECODE_ATOL + DECODE_RTOL * inc_pre.abs())).max())
        w_rows, w_share = worst.get(kind, (0.0, 0.0))
        worst[kind] = (max(w_rows, rows), max(w_share, share))
        if rows > DECODE_RTOL or (cfg.family == "hybrid" and share > 1.0):
            bad.append((i, kind, rows, share))
    del seen
    names = {"attn": "shared attention", "mamba": "Mamba",
             "dense": "attention + MLP"}
    log(f"{arch} decode vs prefill, layer by layer ({n} layer calls a step, "
        f"{DECODE_L} steps, B = {PREFILL_B}; decode_step's layer inputs "
        f"through the plain layer as a prefill): per token, relative L2 of "
        f"the increments at most "
        + ", ".join(f"{v[0]} ({names[k]})" for k, v in sorted(worst.items()))
        + f" (limit {DECODE_RTOL}); elementwise, of the limit rtol "
        f"{DECODE_RTOL}, atol {DECODE_ATOL}: "
        + ", ".join(f"{v[1]} ({names[k]})" for k, v in sorted(worst.items()))
        + (" (held)" if cfg.family == "hybrid" else " (not held)")
        + f"; over: {bad[:5]}")
    check(not bad, f"{arch}: every layer's decode within {DECODE_RTOL} of "
          "the plain prefill's layer on the same inputs, per token"
          + (f" and elementwise within rtol {DECODE_RTOL}, atol "
             f"{DECODE_ATOL}" if cfg.family == "hybrid" else ""))
    with kernel_impl("kernel"):
        want, _ = prefill(model, cfg, {"tokens": toks})
    cache = model_api.init_cache(cfg, PREFILL_B, DECODE_L,
                                 dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DECODE_L):
        logits, cache = model_api.decode_step(model, cfg, cache,
                                              toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / DECODE_L
    dist = rel_l2(logits, want)
    cos = float(torch.nn.functional.cosine_similarity(
        logits.flatten().double(), want.flatten().double(), dim=0))
    log(f"{arch} decode vs prefill, end to end: last logits relative L2 "
        f"{dist}, cosine {cos}, max |diff| {float((logits - want).abs().max())}"
        f"; {secs * 1e3:.2f} ms a decode step (B = {PREFILL_B}) [{card}]")
    check(bool(torch.isfinite(logits).all()), f"{arch}: decode logits finite")
    if cfg.family == "hybrid":
        check(cos > 0.5, f"{arch}: decode logits aligned with the prefill's")


def run_e2e_phase(arch, cfg, model, rng, dev, card):
    """End to end at a depth where float32 rounding stays small: the
    kernel prefill's last logits (B = 2, L = PREFILL_L) within LOGIT_TOL of
    the plain prefill's, and DECODE_L steps of ``model_api.decode_step``,
    every step's logits within the reference's decode tolerance of the
    plain prefill's logits at that position."""
    from repro_torch.models import model_api
    batch = prefill_batch(cfg, rng, dev)
    with kernel_impl("plain"):
        want, _ = prefill(model, cfg, batch)
    with kernel_impl("kernel"):
        got, _ = prefill(model, cfg, batch)
    fwd = float((got - want).abs().max())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (PREFILL_B, DECODE_L))).to(dev)
    with kernel_impl("plain"):
        full, _ = model_api.forward(model, cfg, {"tokens": toks})
    cache = model_api.init_cache(cfg, PREFILL_B, DECODE_L,
                                 dtype=torch.float32, device=dev)
    with kernel_impl("kernel"):
        steps = torch.cat([model_api.decode_step(
            model, cfg, cache, toks[:, t:t + 1], t)[0]
            for t in range(DECODE_L)], dim=1)
    dec = float(((steps - full).abs()
                 / (DECODE_ATOL + DECODE_RTOL * full.abs())).max())
    log(f"{arch} end to end: kernel prefill's last "
        f"logits against the plain prefill's (B = {PREFILL_B}, L = "
        f"{PREFILL_L}): max |diff| {fwd} (limit {LOGIT_TOL}), relative L2 "
        f"{rel_l2(got, want)}, max |logit| {float(want.abs().max())}; "
        f"{DECODE_L} decode steps against the plain prefill's logits: max "
        f"|diff| {float((steps - full).abs().max())}, at most {dec} of the "
        f"limit (rtol {DECODE_RTOL}, atol {DECODE_ATOL}) [{card}]")
    check(fwd <= LOGIT_TOL, f"{arch}: kernel prefill within {LOGIT_TOL} of "
          "the plain prefill")
    check(dec <= 1.0, f"{arch}: every decode step's logits within the "
          "reference's decode tolerance of the prefill's")


def run_serve_phase(arch, cfg, model, rng, dev, card):
    """The BatchServer answers SERVE_REQ requests with as many slots."""
    from repro_torch.launch.serve import BatchServer, Request
    server = BatchServer(cfg, slots=SERVE_REQ,
                         max_seq=SERVE_PROMPT + SERVE_NEW + 1, model=model,
                         device=dev)
    reqs = [Request(i, rng.integers(0, cfg.vocab, SERVE_PROMPT)
                    .astype(np.int32), SERVE_NEW) for i in range(SERVE_REQ)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = server.submit_all(reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(sorted(results) == list(range(SERVE_REQ))
          and all(len(v) == SERVE_NEW for v in results.values())
          and all(0 <= t < cfg.vocab for v in results.values() for t in v),
          f"{arch} serve: every request completes with tokens below vocab")
    steps = server.stats["prefill_tokens"] + server.stats["decode_steps"]
    n_new = sum(len(v) for v in results.values())
    log(f"{arch} serve: {SERVE_REQ} requests, {SERVE_REQ} slots, prompts of "
        f"{SERVE_PROMPT}, {n_new} new tokens in {secs:.3f} s: {steps} decode "
        f"steps ({secs / steps * 1e3:.2f} ms each), "
        f"{(server.stats['prefill_tokens'] + n_new) / secs:.1f} tokens/s, "
        f"{n_new / secs:.2f} new tokens/s; stats {server.stats}; first "
        f"request {results[0][:8]} [{card}]")


def run_model_phases(seed, rng, dev, card):
    """Zamba2-7B at full width: prefill (K3, K4), decode, serve; then
    Mamba2-130M: prefill (K4) and serve."""
    records, launches = {}, {}
    cfg, model = make_model("zamba2-7b", seed, dev)
    n_super = cfg.n_layers // cfg.attn_every
    recs, (launches["K3"], launches["K4"]), _ = run_prefill_phase(
        "zamba2-7b", cfg, model, rng, dev, card, n_super, cfg.n_layers)
    records.update(recs)
    run_decode_phase("zamba2-7b", cfg, model, rng, dev, card)
    run_serve_phase("zamba2-7b", cfg, model, rng, dev, card)
    del model
    torch.cuda.empty_cache()
    cfg, model = make_model("mamba2-130m", seed, dev)
    run_prefill_phase("mamba2-130m", cfg, model, rng, dev, card, 0,
                      cfg.n_layers)
    run_serve_phase("mamba2-130m", cfg, model, rng, dev, card)
    del model
    torch.cuda.empty_cache()
    return records, launches


# The attention families (phase 12): (arch, depth (0: full), tokens a
# sequence, what runs besides the prefill).  Depth is cut where float32
# weights do not fit the card's 80 GB beside the prefill (gemma2-27b: 108
# GB at 46 layers; llama4-scout: 431 GB at 48), to two local and two global
# layers and to two layers.  Yi-9B runs again at one layer for the
# end-to-end logits checks: from two layers on, float32 rounding alone (the
# kernel's or another summation order's) moves its logits beyond their
# tolerances, and at full depth by their own size.
ATTENTION_MODELS = (("yi-9b", 0, PREFILL_L, ("decode", "serve")),
                    ("yi-9b", 1, PREFILL_L, ("e2e",)),
                    ("olmoe-1b-7b", 0, PREFILL_L, ("serve",)),
                    ("gemma2-27b", 4, PREFILL_L, ()),
                    ("internvl2-2b", 0, PREFILL_L, ()),
                    ("whisper-medium", 0, 384, ()),
                    ("llama4-scout-17b-a16e", 2, PREFILL_L, ()))


def run_attention_phase(seed, rng, dev, card, models=ATTENTION_MODELS):
    """Phase 12: each attention family's model at full width, its prefill
    with every K3 call checked, its launches counted from 0 and its layers
    held to the plain ones, Yi-9B's K3 timed; decode, serve and the
    end-to-end checks where listed.  Returns the K3 records and each full
    model's K3 launches."""
    from repro_torch.models import transformer as tf
    records, launches = {}, {}
    for arch, depth, L, extra in models:
        t0 = time.perf_counter()
        cfg, model = make_model(arch, seed, dev, depth)
        n_k3 = tf.layer_windows(cfg).count(0)
        label = f"{arch} at depth {depth}" if "e2e" in extra else arch
        recs, (k3_launches, _), _ = run_prefill_phase(
            label, cfg, model, rng, dev, card, n_k3, 0, L=L,
            timed=(arch, depth) == ("yi-9b", 0))
        if "e2e" not in extra:
            launches[arch] = k3_launches
        records.update({f"{k} {arch}": r for k, r in recs.items()})
        if "decode" in extra:
            run_decode_phase(arch, cfg, model, rng, dev, card)
        if "serve" in extra:
            run_serve_phase(arch, cfg, model, rng, dev, card)
        if "e2e" in extra:
            run_e2e_phase(label, cfg, model, rng, dev, card)
        del model              # before the next model is made
        torch.cuda.empty_cache()
        log(f"{label}: {time.perf_counter() - t0:.1f} s in all [{card}]")
    return records, launches


# -- phase 13: training -------------------------------------------------------
TRAIN_B, TRAIN_L, TRAIN_STEPS = 2, 2048, 4
# A kernel step's loss and gradients, and a layer's output (per token) and
# gradients, against the plain ones on the same inputs, in relative L2: the
# forward tolerance of tests/test_torch_models.py.
TRAIN_TOL = 2e-4
# A first gradient norm above this (the clip norm is 1) marks the reference
# init's explosion at depth, under which neither package's trainer makes the
# loss fall in a few steps (tests/test_torch_train_depth.py); at or below it
# the full-depth loss must fall.
STALL_NORM = 1e9
# non-finite steps in a row before the Mamba2 trainer rolls back
NAN_PATIENCE = 2
# the launcher's own process: bound on its run
LAUNCHER_TIMEOUT_S = 300


def ptxas_entry(ptxas: str, tag: str) -> str:
    """What ``-Xptxas -v`` reported for the kernel whose mangled name holds
    ``tag``: its registers, stack and spills."""
    out, on = [], False
    for ln in ptxas.splitlines():
        if "Compiling entry function" in ln:
            on = tag in ln
        elif on and ("Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return "; ".join(out) or "not found"


def train_batch(cfg, seed: int, dev):
    """The first batch of the synthetic token stream from ``seed`` (B =
    TRAIN_B, L = TRAIN_L) on the card."""
    from repro_torch.train.data import DataConfig, TokenStream
    raw = next(TokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_L,
                                      global_batch=TRAIN_B, seed=seed)))
    return {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}


def grads_of(model, cfg, batch, impl: str):
    """Loss and every parameter's gradient of one step's backward with K3
    and K4 as ``impl`` ("kernel" or "plain"), and the K3 launches."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.models import model_api
    model.zero_grad(set_to_none=True)
    k3.reset_launches()
    with kernel_impl(impl):
        loss, _ = model_api.loss_fn(model, cfg, batch)
        loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, k3.LAUNCHES["flash_attention"]


def run_one_layer_check(seed, dev, card, k3_regs):
    """MiniCPM-2B at one layer, full width: its K3 call (MiniCPM's shape)
    checked against the plain version within the attention_scale limit;
    one step's loss and every gradient through the kernels against the
    plain step's (check (a)); then TRAIN_STEPS steps of a ``Trainer`` at
    one layer, where the loss must fall.  Returns the K3 call's inputs
    and its largest difference, for timing."""
    from repro_torch.models import model_api
    t0 = time.perf_counter()
    cfg, model = make_model("minicpm-2b", seed, dev, depth=1)
    batch = train_batch(cfg, seed, dev)
    stats = {}
    with kernel_impl("plain"), checked_calls(stats), torch.no_grad():
        model_api.forward(model, cfg, {"tokens": batch["tokens"]},
                          logits_last_only=True)
    st = stats["K3"]
    log(f"minicpm-2b K3 at {tuple(st['first'][0][0].shape)}: max |kernel - "
        f"plain| {st['max_abs_diff']}, {st['share']} of the limit "
        f"({FLOAT_TOL} of the error scale plus the underflow term); its "
        f"hd-64 float32 instantiation: {k3_regs} [{card}]")
    check(st["share"] <= 1.0, "minicpm-2b K3 within its limit of the plain "
          "version")
    model.requires_grad_(True)
    want_loss, want, _ = grads_of(model, cfg, batch, "plain")
    got_loss, got, n_k3 = grads_of(model, cfg, batch, "kernel")
    worst = max((rel_l2(got[k], want[k]), k) for k in want)
    dloss = abs(got_loss - want_loss) / abs(want_loss)
    log(f"minicpm-2b at one layer, one step (B = {TRAIN_B}, L = {TRAIN_L})"
        f" through the kernels against the plain step: loss {got_loss} vs "
        f"{want_loss} (relative {dloss}), gradients at most {worst[0]} "
        f"relative L2 ({worst[1]}; limit {TRAIN_TOL}); {n_k3} K3 launches "
        f"[{card}]")
    check(n_k3 == 2, "minicpm-2b one layer: K3 in the forward pass and its "
          "recompute")
    check(dloss <= TRAIN_TOL and worst[0] <= TRAIN_TOL, "minicpm-2b one "
          f"layer: loss and every gradient within {TRAIN_TOL} of the plain "
          "step's")
    del model, want, got
    torch.cuda.empty_cache()
    tr, launches, _ = train_steps(cfg, seed, dev)
    log_steps("minicpm-2b at one layer", tr.metrics_log, launches, "K3", [],
              0, card)
    check(launches == [2] * TRAIN_STEPS, "minicpm-2b one layer: 2 K3 "
          "launches a step")
    check_losses("minicpm-2b at one layer", tr.metrics_log, falls=True)
    del tr
    torch.cuda.empty_cache()
    log(f"minicpm-2b at one layer: {time.perf_counter() - t0:.1f} s [{card}]")
    return st["first"], st["max_abs_diff"]


def train_steps(cfg, seed, dev, trainer=None, adamw_ms=None):
    """TRAIN_STEPS steps of ``trainer`` (by default a new one for ``cfg``
    with the launcher's settings), each with K3's launches counted from 0;
    returns the trainer, the launches a step and the peak memory of the
    steps."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.train.loop import TrainConfig, Trainer
    if trainer is None:
        oc, dc = launcher_opt(cfg, seed)
        trainer = Trainer(cfg, TrainConfig(steps=TRAIN_STEPS, seed=seed), oc,
                          dc, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches = []
    with adamw_timed([] if adamw_ms is None else adamw_ms):
        for _ in range(TRAIN_STEPS):
            k3.reset_launches()
            trainer.run(1)
            launches.append(k3.LAUNCHES["flash_attention"])
    return trainer, launches, torch.cuda.max_memory_allocated()


def run_layer_grads_check(cfg, model, seed, dev, card):
    """Check (b), full depth, teacher-forced: a plain step records each
    layer's input and the gradient of the loss with respect to its output;
    then each layer alone, on that input and with that upstream gradient,
    through the kernels against the plain versions: its output per token,
    its input's and its parameters' gradients in relative L2, every
    ``wq``/``wk``/``wv`` gradient nonzero."""
    from repro_torch.models import model_api
    from repro_torch.models import transformer as tf
    batch = train_batch(cfg, seed + 1, dev)
    ins, outs, recording = [], [], [True]

    def record(fn):
        def wrapped(cfg_, lp, x, *a, **kw):
            out = fn(cfg_, lp, x, *a, **kw)
            if recording[0]:          # not the backward's recompute
                ins.append((lp, x.detach()))
                outs.append(out[0])
            return out
        return wrapped
    with kernel_impl("plain"), patched(tf, "_attn_mlp_layer", record):
        loss, _ = model_api.loss_fn(model, cfg, batch)
        recording[0] = False
        ups = torch.autograd.grad(loss, outs)
    del outs
    check(len(ins) == cfg.n_layers, f"minicpm-2b: {cfg.n_layers} layers "
          "recorded")
    L = batch["tokens"].shape[1]
    pos = torch.arange(L, device=dev)
    worst = dict(out=(0.0, -1), x=(0.0, -1), params=(0.0, -1, ""))
    zero = []
    for i, ((lp, x), up) in enumerate(zip(ins, ups)):
        res = {}
        names = [n for n, _ in lp.named_parameters()]
        for impl in ("plain", "kernel"):
            xi = x.clone().requires_grad_(True)
            with kernel_impl(impl):
                out = tf._attn_mlp_layer(cfg, lp, xi, pos, lp.window,
                                         kv_chunk=min(1024, L))[0]
                res[impl] = (out.detach(), torch.autograd.grad(
                    out, [xi] + list(lp.parameters()), up))
        (po, pg), (ko, kg) = res["plain"], res["kernel"]
        r = float(row_rel(ko, po).max())
        worst["out"] = max(worst["out"], (r, i))
        worst["x"] = max(worst["x"], (rel_l2(kg[0], pg[0]), i))
        for n, a, b in zip(names, kg[1:], pg[1:]):
            worst["params"] = max(worst["params"], (rel_l2(a, b), i, n))
            if n.split(".")[-1] in ("wq", "wk", "wv") and not bool(
                    (a != 0).any()):
                zero.append((i, n))
        del res
    log(f"minicpm-2b, {cfg.n_layers} layers teacher-forced (each layer's "
        f"input and upstream gradient from a plain step, B = {TRAIN_B}, L = "
        f"{L}), kernels against plain: output per token at most "
        f"{worst['out'][0]} (layer {worst['out'][1]}), input gradient "
        f"{worst['x'][0]} (layer {worst['x'][1]}), parameter gradients "
        f"{worst['params'][0]} (layer {worst['params'][1]} "
        f"{worst['params'][2]}), relative L2 (limit {TRAIN_TOL}); zero "
        f"wq/wk/wv gradients: {zero} [{card}]")
    check(max(worst["out"][0], worst["x"][0], worst["params"][0])
          <= TRAIN_TOL, f"minicpm-2b: every layer's output and gradients "
          f"through the kernels within {TRAIN_TOL} of the plain ones")
    check(not zero, "minicpm-2b: every wq, wk, wv gradient through K3 is "
          "nonzero")


@contextlib.contextmanager
def adamw_timed(ms: list):
    """The trainer's AdamW update timed by CUDA events, each call's ms
    appended to ``ms``."""
    from repro_torch.train import loop

    def make(fn):
        def wrapped(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
            return out
        return wrapped
    with patched(loop, "adamw_update", make):
        yield


def k3_backward_ms(first, fwd_ms: float, card) -> float:
    """Milliseconds of K3's backward (its plain version recomputed and
    differentiated) at ``first``'s inputs: a forward and backward through
    the autograd Function, less the forward alone (``fwd_ms``)."""
    from repro_torch.kernels import flash_attention as k3
    (q, k, v), kw = first
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    go = torch.randn_like(q)
    both = cuda_ms(lambda: torch.autograd.backward(
        k3.flash_attention(*ins, **kw), go), reps=3, warmup=1)
    log(f"K3 minicpm-2b forward and backward through the autograd Function "
        f"{both} ms, so the backward's plain recompute {both - fwd_ms} ms a "
        f"call (CUDA events, 3 calls) [{card}]")
    return both - fwd_ms


def launcher_opt(cfg, seed: int):
    """The launcher's data and AdamW settings for TRAIN_STEPS steps (WSD,
    lr 3e-3, warmup a tenth of the steps), at B = TRAIN_B, L = TRAIN_L."""
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import AdamWConfig
    return (AdamWConfig(lr=3e-3, schedule="wsd",
                        warmup_steps=max(TRAIN_STEPS // 10, 1),
                        total_steps=TRAIN_STEPS),
            DataConfig(vocab=cfg.vocab, seq_len=TRAIN_L,
                       global_batch=TRAIN_B, seed=seed))


def run_minicpm_training(seed, dev, card, launcher, k3_call):
    """MiniCPM-2B at full width and depth through ``Trainer``: check (b)
    on its model; once the launcher's process has ended, K3 timed on
    ``k3_call`` (the one-layer model's call: its inputs and largest
    difference); then TRAIN_STEPS steps, each with its K3 launches counted
    from 0 (the forward pass and the recompute: 2 a layer), their losses
    finite.  At 40 layers the reference's init makes the gradients grow
    some 2.5x a layer towards the embedding (a global norm near 1e17), so
    clipping leaves the upper layers' gradients below AdamW's eps and the
    loss does not fall in a few steps, as under the reference's own
    trainer (``tests/test_torch_train_depth.py`` holds both packages to
    that at 40 layers); so the last loss must fall only when the first
    gradient norm is at most STALL_NORM.  The falling loss is held at one
    layer (run_one_layer_check) and on Mamba2-130M.  Returns K3's record
    and the launches a step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model_api
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = get_config("minicpm-2b")
    oc, dc = launcher_opt(cfg, seed)
    t0 = time.perf_counter()
    tr = Trainer(cfg, TrainConfig(steps=TRAIN_STEPS, seed=seed), oc, dc,
                 device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tr.params.values())
    check(n == model_api.n_params(cfg), "minicpm-2b: every parameter made")
    log(f"minicpm-2b trainer: {n} float32 parameters and two AdamW moments "
        f"made on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"[{card}]")
    run_layer_grads_check(cfg, tr.model, seed, dev, card)
    log(f"minicpm-2b check (b): {time.perf_counter() - t0:.1f} s [{card}]")
    wait_launcher(launcher, card)
    first, diff = k3_call
    record = dict(time_k3(first, "minicpm-2b", card), max_abs_diff=diff)
    record["backward_ms"] = k3_backward_ms(first, record["ms"], card)
    adamw_ms = []
    t0 = time.perf_counter()
    tr, launches, peak = train_steps(cfg, seed, dev, tr, adamw_ms)
    log_steps("minicpm-2b", tr.metrics_log, launches, "K3", adamw_ms, peak,
              card)
    check(launches == [2 * cfg.n_layers] * TRAIN_STEPS, f"minicpm-2b: "
          f"{2 * cfg.n_layers} K3 launches a step, got {launches}")
    gnorm = tr.metrics_log[0]["grad_norm"]
    stalls = gnorm > STALL_NORM
    log(f"minicpm-2b: first gradient norm {gnorm} "
        f"{'above' if stalls else 'at most'} {STALL_NORM}: the last loss "
        f"{'need not' if stalls else 'must'} fall [{card}]")
    check_losses("minicpm-2b", tr.metrics_log, falls=not stalls)
    del tr
    torch.cuda.empty_cache()
    log(f"minicpm-2b steps: {time.perf_counter() - t0:.1f} s [{card}]")
    return record, launches


def log_steps(arch, metrics, launches, kernel, adamw_ms, peak, card):
    tokens = TRAIN_B * TRAIN_L
    log(f"{arch} training (B = {TRAIN_B}, L = {TRAIN_L}, WSD, the "
        f"launcher's defaults): losses {[m['loss'] for m in metrics]}, s a "
        f"step {[round(m['step_time'], 4) for m in metrics]}, tokens/s "
        f"{[round(tokens / m['step_time'], 1) for m in metrics]}, grad "
        f"norms {[round(m['grad_norm'], 4) for m in metrics]}, lr "
        f"{[m['lr'] for m in metrics]}; {kernel} launches a step {launches}"
        + (f"; AdamW update ms {[round(t, 3) for t in adamw_ms]}; peak "
           f"memory {peak / 2**30:.2f} GiB ({peak} B, "
           "torch.cuda.max_memory_allocated)" if adamw_ms else "")
        + f" [{card}]")


def check_losses(arch, metrics, falls: bool):
    losses = [m["loss"] for m in metrics]
    check(all(math.isfinite(x) for x in losses), f"{arch}: finite losses: "
          f"{losses}")
    if falls:
        check(losses[-1] < losses[0], f"{arch}: the last loss below the "
              f"first: {losses}")


def same_state(a, b) -> Tuple[bool, float]:
    """Whether two trainers hold the same parameters, moments and step bit
    for bit, and the largest parameter difference."""
    same = int(a.opt_state.step) == int(b.opt_state.step)
    diff = 0.0
    for k, p in a.params.items():
        d = float((p.detach() - b.params[k].detach()).abs().max())
        diff = max(diff, d)
        same = same and d == 0.0 and torch.equal(
            a.opt_state.mu[k], b.opt_state.mu[k]) and torch.equal(
            a.opt_state.nu[k], b.opt_state.nu[k])
    return same, diff


@contextlib.contextmanager
def saves_off(tr):
    """``tr`` takes its steps without writing checkpoints (each run of a
    trainer with a checkpoint directory ends with a 2 GB save here)."""
    tc = tr.tc
    tr.tc = dataclasses.replace(tc, ckpt_dir=None)
    try:
        yield
    finally:
        tr.tc = tc


def run_mamba_training(seed, dev, card, tmp):
    """Mamba2-130M at full width: an uninterrupted run of TRAIN_STEPS steps
    in two runs of two (K4 launches counted, 2 a layer a step), a second
    trainer restored from the first one's step-2 checkpoint taking the same
    last two steps; then a non-finite loss NAN_PATIENCE times in a row
    from step 4, rolled back to the newest checkpoint (step 2) and run on
    to step 6, against the second trainer's clean steps 5-6.  Returns the
    K4 launches of the uninterrupted run."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_chunk as k4
    from repro_torch.models import model_api
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = get_config("mamba2-130m")
    oc, dc = launcher_opt(cfg, seed)
    ck = tmp / "mamba2_ckpt"
    t0 = time.perf_counter()

    def trainer():
        return Trainer(cfg, TrainConfig(steps=TRAIN_STEPS, ckpt_every=1000,
                                        ckpt_dir=str(ck), seed=seed,
                                        nan_patience=NAN_PATIENCE),
                       oc, dc, device=dev)

    def steps(tr, n):
        k4.reset_launches()
        t = time.perf_counter()
        tr.run(n)
        return k4.LAUNCHES["ssd_chunked"], time.perf_counter() - t

    a = trainer()
    n1, s1 = steps(a, 2)
    t = time.perf_counter()
    b = trainer()
    s_restore = time.perf_counter() - t
    check(b.step == 2 and b.data.next_index == 2, "mamba2-130m: a new "
          "trainer restores the step-2 checkpoint and the stream position")
    with saves_off(a), saves_off(b):
        n2, s2 = steps(a, 2)
        steps(b, 2)
    same, diff = same_state(a, b)
    la = [m["loss"] for m in a.metrics_log]
    lb = [m["loss"] for m in b.metrics_log]
    log(f"mamba2-130m checkpoint/restart: two steps and a 2.0 GB "
        f"checkpoint in {s1:.2f} s, a new trainer restored from it in "
        f"{s_restore:.2f} s taking steps 3-4 against the uninterrupted "
        f"run's ({s2:.2f} s): losses {lb} vs {la[2:]}; parameters, moments "
        f"and step {'bit for bit equal' if same else 'differ'} (largest "
        f"parameter difference {diff}) [{card}]")
    check(same and lb == la[2:], "mamba2-130m: the restored run equals the "
          "uninterrupted one bit for bit")
    log_steps("mamba2-130m", a.metrics_log, [n1 // 2, n2 // 2], "K4", [], 0,
              card)
    check([n1, n2] == [2 * 2 * cfg.n_layers] * 2, f"mamba2-130m: "
          f"{2 * cfg.n_layers} K4 launches a step, got {n1}, {n2} a run of 2")
    check_losses("mamba2-130m", a.metrics_log, falls=True)

    poisoned = []

    def nan_loss(fn):
        def wrapped(*args, **kw):
            loss, m = fn(*args, **kw)
            if len(poisoned) < NAN_PATIENCE:
                poisoned.append(1)
                loss = loss * float("nan")
                m = dict(m, loss=loss)
            return loss, m
        return wrapped
    with patched(model_api, "loss_fn", nan_loss):
        a.run(2)
    with saves_off(b):
        b.run(2)
    same, diff = same_state(a, b)
    tail = [(m["step"], m["loss"]) for m in a.metrics_log[TRAIN_STEPS:]]
    log(f"mamba2-130m rollback: {NAN_PATIENCE} non-finite losses in a row "
        f"(patience {NAN_PATIENCE}) from step 4, back to the step-2 "
        f"checkpoint and on to step 6: steps and losses {tail}; against a "
        f"trainer that took steps 5-6 cleanly: "
        f"{'bit for bit equal' if same else 'differ'} (largest parameter "
        f"difference {diff}) [{card}]")
    check([s for s, _ in tail] == [5, 3, 4, 5, 6] and math.isnan(tail[0][1])
          and a.step == 6, "mamba2-130m: the trainer rolled back to its "
          "step-2 checkpoint")
    check(same, "mamba2-130m: after the rollback, the state of a clean run")
    log(f"mamba2-130m: {time.perf_counter() - t0:.1f} s [{card}]")
    del a, b
    torch.cuda.empty_cache()
    return n1 + n2


def start_launcher():
    """``python -m repro_torch.launch.train --arch mamba2-130m --full
    --steps 2`` as its own process, on the card by default."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-130m", "--full", "--steps", "2"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait_launcher(proc, card):
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=LAUNCHER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, "the train launcher ended within its time")
    lines = out.strip().splitlines()
    log(f"launcher (its own process, waited {time.perf_counter() - t0:.1f} "
        f"s): exit {proc.returncode}; " + " | ".join(lines[-3:])
        + f" [{card}]")
    done = [ln for ln in lines if "done:" in ln]
    ok = proc.returncode == 0 and len(done) == 1
    if ok:
        first, last = (float(v) for v in done[0].split("loss ")[1]
                       .split(" -> "))
        ok = math.isfinite(last) and last < first
    check(ok, "python -m repro_torch.launch.train --arch mamba2-130m --full "
          "--steps 2 exits 0 with a falling loss")


def run_training_phase(seed, dev, card, tmp, k3_regs):
    """Phase 13: MiniCPM-2B at one layer (check (a)), Mamba2-130M (steps,
    checkpoint/restart, rollback), MiniCPM-2B at full depth (check (b),
    then TRAIN_STEPS timed steps), and the launcher as its own process,
    run beside the first two and waited for before MiniCPM-2B's timed
    parts.  Returns the K3 record at MiniCPM's shape and the training
    launches of K3 and K4."""
    t0 = time.perf_counter()
    launcher = start_launcher()
    try:
        k3_call = run_one_layer_check(seed, dev, card, k3_regs)
        k4_launches = run_mamba_training(seed, dev, card, tmp)
        record, k3_launches = run_minicpm_training(seed, dev, card,
                                                   launcher, k3_call)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.communicate()
    log(f"training: {time.perf_counter() - t0:.1f} s [{card}]")
    return record, sum(k3_launches), k4_launches


# -- phase 14: distributed and launch tooling ---------------------------------
# OLMoE-1B-7B's MoE layer at full width (phase 14 (b)): B, L; capacity
# factors that drop nothing (the dense block: C = 4096 slots an expert, all
# of T; the all-to-all's per-expert Ce = 4608 >= T)
A2A_B, A2A_L, A2A_CF, DENSE_CF = 2, 2048, 3.0, 8.0
# MoE output per token and aux against the dense block (phase 14 (b))
A2A_TOL, AUX_TOL = 1e-5, 1e-6
# GPipe against the plain stack (phase 14 (c)): phase 13's limits
PIPE_TOL = 2e-4
# the cost counter's flops against FlopCounterMode's (phase 14 (d))
FLOP_TOL = 0.01
# the dry run's own process (phase 14 (e)): bound on its run
DRYRUN_TIMEOUT_S = 600


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The dry run's cell on the card's machine (phase 14 (e)): a decode cell,
# since minicpm-2b x train_4k took 66.8 s there (more than the 40 s the
# phase allows it; PERF.md section 6), its prefill_32k 58.2 s.
DRYRUN_CELL = ("minicpm-2b", "decode_32k")


def start_dryrun(out: Path):
    """``python -m repro_torch.launch.dryrun --arch minicpm-2b --shape
    decode_32k --mesh single`` as its own process, with the card hidden
    (the dry run runs on placeholder ranks and touches no device)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    arch, shape = DRYRUN_CELL
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(out)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def wait_dryrun(proc, out: Path, t_start: float, card: str) -> float:
    """Check (e): the dry run of DRYRUN_CELL exits 0 with ``status:
    "ok"``, and the roofline report over its output prints its row.
    Returns its wall time."""
    try:
        text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, "the dry run ended within its time")
    secs = time.perf_counter() - t_start
    lines = [ln for ln in text.splitlines() if "[dryrun]" in ln]
    log(f"dry run (its own process, {secs:.1f} s from the phase's start): "
        f"exit {proc.returncode}; " + " | ".join(lines) + f" [{card}]")
    arch, shape = DRYRUN_CELL
    check(proc.returncode == 0, f"python -m repro_torch.launch.dryrun --arch "
          f"{arch} --shape {shape} --mesh single exits 0")
    rec = json.loads((out / f"{arch}__{shape}__single.json").read_text())
    check(rec["status"] == "ok", f"dry run: status ok ({rec.get('error')})")
    log(f"dry run record: {rec['flops_per_device']:.6e} flops, "
        f"{rec['bytes_per_device']:.6e} bytes, collectives "
        f"{json.dumps(rec['collective_bytes'])}, memory "
        f"{json.dumps(rec['memory'])}, terms {json.dumps(rec['terms'])} "
        f"(counts over H100 SXM constants, not measurements)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    rows = [ln for ln in roof.stdout.splitlines()
            if ln.startswith(f"| {arch} | {shape} | single")]
    log("roofline: " + " ".join(rows))
    check(roof.returncode == 0 and len(rows) == 1, "python -m "
          "repro_torch.launch.roofline prints the dry run's row")
    return secs


def nccl_kernels(prof) -> str:
    names = sorted({e.key for e in prof.key_averages()
                    if "nccl" in e.key.lower()})
    return ", ".join(names) or "none seen"


def run_collectives_check(dev, card):
    """Check (a): the three collectives over a one-rank (1, 1, 1) ("pod",
    "data", "model") mesh on MiniCPM-2B's full-width float32 trees."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import collectives as co
    from repro_torch.models import model_api
    from repro_torch.models.params import leaves
    mesh = init_device_mesh(dev.type, (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    cfg = get_config("minicpm-2b")
    g = torch.Generator(dev).manual_seed(1)
    pd = model_api.pdefs(cfg)
    layer = {".".join(p): torch.randn(d.shape[1:], generator=g, device=dev)
             for p, d in leaves(pd["layers"])}
    trees = {"embedding": {"embed": torch.randn(pd["embed"].shape,
                                                generator=g, device=dev)},
             "one layer": layer}
    for name, tree in trees.items():
        nbytes = sum(4 * t.numel() for t in tree.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            hier = co.hierarchical_psum(tree, mesh)
            torch.cuda.synchronize()
        check(all(torch.equal(hier[k], v) for k, v in tree.items()),
              f"hierarchical_psum over one rank returns the {name} bit for "
              f"bit")
        ms_h = cuda_ms(lambda: co.hierarchical_psum(tree, mesh), 3, 1)
        ch = co.chunked_psum(tree, mesh, ("pod", "data"))
        check(all(torch.equal(ch[k], v) for k, v in tree.items()),
              f"chunked_psum over one rank returns the {name} bit for bit")
        ms_c = cuda_ms(lambda: co.chunked_psum(tree, mesh, ("pod", "data")),
                       3, 1)
        err0 = co.init_error_state(tree, mesh)
        red, err = co.compressed_pod_psum(tree, mesh, err0)
        worst = 0.0
        for k, v in tree.items():
            q, s = co.quantize_int8(v.reshape(-1))
            half = float(s) / 2        # (amax + 1e-12) / 254
            gap = float((red[k] - v).abs().max())
            worst = max(worst, gap / half)
            # float32 rounds x / scale before the rounding to an integer,
            # and q * scale after it: each moves the result by up to an
            # ulp of 127 (2**-17 of a step), so the limit has 2**-14 of
            # half a step beyond it (a wrong integer costs a whole step)
            check(gap <= half * (1 + 2 ** -14), f"compressed_pod_psum: "
                  f"{name} {k} within half an int8 step ({gap} > {half})")
            check(torch.equal(err[k], v.reshape(-1)
                              - co.dequantize_int8(q, s)),
                  f"compressed_pod_psum: {name} {k}'s error state is carry "
                  f"- dequantised exactly")
        ms_q = cuda_ms(lambda: co.compressed_pod_psum(tree, mesh, err0), 3,
                       1)
        log(f"collectives, {name} ({len(tree)} leaves, {nbytes} B float32, "
            f"one NCCL rank): hierarchical_psum {ms_h:.3f} ms, chunked_psum "
            f"{ms_c:.3f} ms, compressed_pod_psum {ms_q:.3f} ms (its largest "
            f"gap {worst:.4f} of half a step); NCCL kernels traced: "
            f"{nccl_kernels(prof)} [{card}]")
        del hier, ch, red, err, err0
    del trees, layer
    torch.cuda.empty_cache()


def run_moe_a2a_check(seed, dev, card):
    """Check (b): ``moe_block_a2a`` at OLMoE-1B-7B's width on a one-rank
    (1, 1) ("data", "model") mesh against ``models/moe.py::moe_block``,
    same weights, neither dropping a pair."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.moe_a2a import moe_block_a2a
    from repro_torch.models.moe import moe_block
    mesh = init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    cfg = get_config("olmoe-1b-7b")
    D, E, F, K = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.top_k
    g = torch.Generator(dev).manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) / math.sqrt(
            shape[-2])
    p = {"router": w(D, E), "w_gate": w(E, D, F), "w_in": w(E, D, F),
         "w_out": w(E, F, D)}
    x = torch.randn(A2A_B, A2A_L, D, generator=g, device=dev)
    with torch.no_grad():
        def a2a():
            return moe_block_a2a(p, x, mesh, n_experts=E, top_k=K,
                                 capacity_factor=A2A_CF)

        def dense():
            return moe_block(p, x, n_experts=E, top_k=K,
                             capacity_factor=DENSE_CF)
        (y, aux), (want, want_aux) = a2a(), dense()
        ms, ms_d = cuda_ms(a2a, 3, 1), cuda_ms(dense, 3, 1)
        # the dense block dropped nothing: every (token, k) pair's expert
        # took at most its capacity
        idx = torch.topk(torch.softmax((x.reshape(-1, D) @ p["router"]),
                                       -1), K).indices
        most = int(torch.bincount(idx.reshape(-1), minlength=E).max())
    C = math.ceil(A2A_B * A2A_L * K / E * DENSE_CF)
    rel = float(row_rel(y.to_local(), want).max())
    daux = abs(float(aux) - float(want_aux))
    log(f"moe_block_a2a, OLMoE-1B-7B width (d {D}, {E} experts of d_ff {F}, "
        f"top-{K}; B = {A2A_B}, L = {A2A_L}; one NCCL rank): {ms:.3f} ms "
        f"against the dense block's {ms_d:.3f} ms; per token at most {rel} "
        f"relative L2 (limit {A2A_TOL}); aux {float(aux)} vs "
        f"{float(want_aux)} ({daux}; limit {AUX_TOL}); the busiest expert "
        f"took {most} pairs of the dense block's {C} slots [{card}]")
    check(most <= C, "moe_block (dense) dropped no pair")
    check(rel <= A2A_TOL and daux <= AUX_TOL, "moe_block_a2a within its "
          "limits of moe_block")
    del p, x, y, want
    torch.cuda.empty_cache()


class LayerStack(torch.nn.Module):
    """Some of a dense model's layers as one module (remat on, as the
    trainer runs them): (B, L, D) -> (B, L, D)."""

    def __init__(self, model, layers=None):
        super().__init__()
        self.cfg = model.cfg
        self.layers = model.layers if layers is None else layers

    def forward(self, x, taps=None):
        from repro_torch.models.transformer import _attn_mlp_layer, remat_call
        positions = torch.arange(x.shape[1], device=x.device)
        body = remat_call(_attn_mlp_layer, True, self)
        for i, lp in enumerate(self.layers):
            x, _, _ = body(self.cfg, lp, x, positions, lp.window,
                           kv_chunk=1024)
            if taps is not None:
                taps.append(x)
        return x


def pipeline_against(stack, mesh, x, cot, batched: bool):
    """GPipe (one stage: ``stack``; x (nm, 1, L, D), a micro-batch each)
    against ``stack`` without the pipeline: on the whole batch at once
    (``batched``) or micro-batch by micro-batch.  Both backpropagate
    sum(y * cot).  Returns the largest per-token output difference, the
    largest parameter gradient difference (and its name) and the input
    gradient's, in relative L2, the pipelined step's K3 launches and both
    steps' seconds."""
    from torch.func import functional_call
    from repro_torch.distributed.pipeline import make_pipelined_apply
    from repro_torch.kernels import flash_attention as k3
    nm, _, L, D = x.shape
    stack.requires_grad_(True)
    xr = x.reshape(nm, L, D).clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if batched:
        want = stack(xr)
        (want * cot).sum().backward()
    else:
        want = []
        for m in range(nm):
            want.append(stack(xr[m:m + 1]))
            (want[-1] * cot[m:m + 1]).sum().backward()
        want = torch.cat(want)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    want_g = {k: p.grad.clone() for k, p in stack.named_parameters()}
    stack.zero_grad(set_to_none=True)

    apply = make_pipelined_apply(
        lambda params, z, s: functional_call(stack, params, (z,)), mesh)
    xp = x.clone().requires_grad_(True)
    k3.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = apply({k: p[None] for k, p in stack.named_parameters()}, xp)
    (y.reshape(nm, L, D) * cot).sum().backward()
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    n_k3 = k3.LAUNCHES["flash_attention"]
    out_rel = float(row_rel(y.detach().reshape(nm, L, D),
                            want.detach()).max())
    got_g = {k: p.grad for k, p in stack.named_parameters()}
    worst = max((rel_l2(got_g[k], want_g[k]), k) for k in want_g)
    gx = rel_l2(xp.grad.reshape(xr.grad.shape), xr.grad)
    zero = [k for k in got_g if k.split(".")[-1] in ("wq", "wk", "wv")
            and not bool(got_g[k].abs().max() > 0)]
    stack.zero_grad(set_to_none=True)
    stack.requires_grad_(False)
    return out_rel, worst, gx, zero, n_k3, t_pipe, t_plain


def run_pipeline_check(seed, dev, card):
    """Checks (c) and (d): ``make_pipelined_apply`` over a one-rank
    ("stage",) mesh with MiniCPM-2B's layers at full width as the stage
    (through K3) and 2 micro-batches of (1, 2048).  At all 40 layers it is
    held against the same layers run micro-batch by micro-batch (the same
    products: what the pipeline schedules); at B = 2 in one batch only
    at one layer, since the reference's init makes the stack amplify
    float32 rounding layer by layer (phases 12 and 13), which the log
    shows: the B = 2 forward's divergence from the micro-batched one at
    each depth.  Outputs per token and the gradients of sum(y * cot) for
    every parameter and the input within PIPE_TOL, no zero wq/wk/wv
    gradient.  Then (d): the cost counter around the 40 layers' forward at
    B = 2 against FlopCounterMode on the same forward with K3's plain
    version.  Returns K3's launches in the 40-layer pipelined step."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import cost_analysis
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("stage",))
    cfg, model = make_model("minicpm-2b", seed, dev)
    stack = LayerStack(model)
    D = cfg.d_model
    g = torch.Generator(dev).manual_seed(seed + 1)
    x = torch.randn(2, 1, PREFILL_L, D, generator=g, device=dev)
    cot = torch.randn(2, PREFILL_L, D, generator=g, device=dev)
    results = {}
    for label, st, batched in (
            (f"{cfg.n_layers} layers, micro-batch by micro-batch", stack,
             False),
            ("1 layer, B = 2 at once",
             LayerStack(model, model.layers[:1]), True)):
        r = pipeline_against(st, mesh, x, cot, batched)
        results[label] = r
        out_rel, worst, gx, zero, n_k3, t_pipe, t_plain = r
        log(f"GPipe, one stage of MiniCPM-2B at full width through K3, 2 "
            f"micro-batches of (1, {PREFILL_L}), against the {label} "
            f"without it: outputs per token at most {out_rel}, parameter "
            f"gradients at most {worst[0]} ({worst[1]}), the input's {gx} "
            f"relative L2 (limit {PIPE_TOL}); zero wq/wk/wv gradients: "
            f"{zero or 'none'}; K3 launches {n_k3}; a step {t_pipe:.3f} s "
            f"pipelined, {t_plain:.3f} s not [{card}]")
        check(out_rel <= PIPE_TOL and worst[0] <= PIPE_TOL
              and gx <= PIPE_TOL, f"GPipe against the {label}: outputs and "
              f"gradients within their limits")
        check(not zero, "no zero wq/wk/wv gradient through the pipeline")
        check(n_k3 > 0, "K3 launched in the pipelined step")
    torch.cuda.empty_cache()

    xb = x.reshape(2, PREFILL_L, D)
    with torch.no_grad():
        # the B = 2 forward against the micro-batched one, layer by layer
        taps2, taps1 = [], [[], []]
        stack(xb, taps2)
        for m in range(2):
            stack(xb[m:m + 1], taps1[m])
        drift = [float(row_rel(taps2[i], torch.cat([taps1[0][i],
                                                    taps1[1][i]])).max())
                 for i in range(cfg.n_layers)]
        del taps2, taps1
        log("B = 2 in one batch against micro-batch by micro-batch, the "
            "largest per-token difference after layer " + ", ".join(
                f"{i + 1}: {drift[i]:.3g}" for i in (0, 1, 3, 7, 15, 39)
                if i < cfg.n_layers) + f" [{card}]")
        # (d) the cost counter on the forward
        with cost_analysis.CostCounter() as counter:
            stack(xb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack(xb)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with kernel_impl("plain"), FlopCounterMode(display=False) as fc:
            stack(xb)
    got, want_f = counter.flops, fc.get_total_flops()
    log(f"cost counter on MiniCPM-2B's {cfg.n_layers} layers' forward (B = "
        f"2, L = {PREFILL_L}) through K3: {got / 1e12:.4f} TFLOP counted "
        f"(K3 reported {counter.kernel_calls}), FlopCounterMode on the plain "
        f"version {want_f / 1e12:.4f} TFLOP; {counter.bytes:.6e} bytes; "
        f"the forward measured {secs:.3f} s, {got / secs / 1e12:.2f} "
        f"TFLOP/s [{card}]")
    check(abs(got - want_f) <= FLOP_TOL * want_f, "cost counter flops "
          f"within {FLOP_TOL:.0%} of FlopCounterMode's")
    del model, stack
    torch.cuda.empty_cache()
    return results[f"{cfg.n_layers} layers, micro-batch by micro-batch"][4]


def run_distributed_phase(seed, dev, card, tmp):
    """Phase 14: a one-rank NCCL group on the card for the collectives
    (a), the MoE all-to-all (b), GPipe (c) and the cost counter (d); the
    dry run (e) as its own process from the phase's start.  Destroys the
    group at the end.  Returns K3's launches in (c)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    out = tmp / "dryrun"
    dry = start_dryrun(out)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, device_id=dev)
    try:
        run_collectives_check(dev, card)
        run_moe_a2a_check(seed, dev, card)
        n_k3 = run_pipeline_check(seed, dev, card)
        wait_dryrun(dry, out, t0, card)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
        dist.destroy_process_group()
    log(f"distributed: {time.perf_counter() - t0:.1f} s [{card}]")
    return n_k3


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
    builds = build_all()
    # K3's hd-64 float32 instantiation (KS = 8): MiniCPM-2B's
    k3_regs = ptxas_entry(builds["flash_attention"].ptxas,
                          "flash_fwd_kernelILi8EfE")
    for name, info in builds.items():
        regs = [ln.split(":", 1)[1].strip() for ln in info.ptxas.splitlines()
                if "Used" in ln]
        spills = sorted({ln.strip() for ln in info.ptxas.splitlines()
                         if "spill" in ln})
        log(f"build: {info.path.name} in {info.seconds:.1f} s; ptxas, per "
            f"instantiation: " + " | ".join(regs) + "; spills: "
            + " | ".join(spills))
    log(f"build: all sources in {time.perf_counter() - t0:.1f} s")

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
        cell = phase("set-up cell", build_cell, args.mxu_scale, args.seed,
                     tmp)
        wide = phase("set-up wide", build_wide_stores, adj, cell["adj"],
                     tmp)
        records = phase("kernels", run_kernel_phase, stores, ct, rng, dev)
        records.update(phase("densify kernels", run_mxu_phase, cell, rng,
                             dev))
        phase("crossover", run_crossover_phase, cell, stores, rng, dev,
              card)
        phase("engine", run_engine_phase, stores, pr_op, rng, dev, card)
        launches = phase("pagerank", run_pagerank_phase, stores, ct, adj,
                         pr_op, dev, card)
        overlay_launches, sssp_ref = phase("rings", run_rings_phase, stores,
                                           adj, pr_op, rng, dev, card)
        serving_launches, oracles = phase(
            "serving", run_serving_phase, stores, adj, pr_op, sssp_ref,
            args.seed, rng, dev, card, tmp)
        net_launches = phase("cross-host", run_net_phase, stores, adj,
                             sssp_ref, oracles, dev, card, tmp)
        launches.update(phase("nmf", run_nmf_phase, args.scale, adj, ct,
                              stores, wide, cell, dev, card))
        phase("eigensolver", run_eigen_phase, wide, dev, card)
        del adj, pr_op, ct, stores, wide, cell
        torch.cuda.empty_cache()
        model_records, model_launches = phase("models", run_model_phases,
                                              args.seed, rng, dev, card)
        records.update(model_records)
        launches.update(model_launches)
        attn_records, attn_launches = phase(
            "attention models", run_attention_phase, args.seed, rng, dev,
            card)
        records.update(attn_records)
        torch.cuda.empty_cache()
        train_record, k3_train, k4_train = phase(
            "training", run_training_phase, args.seed, dev, card, tmp,
            k3_regs)
        records["K3 minicpm-2b"] = train_record
        torch.cuda.empty_cache()
        k3_pipeline = phase("distributed", run_distributed_phase, args.seed,
                            dev, card, tmp)
    finally:
        tempfile.tempdir = None
        shutil.rmtree(tmp, ignore_errors=True)
    log("phases: " + ", ".join(phases))

    src = "src/repro_torch/kernels/csrc/"
    # K1a and K2 are timed at the engine cell's p = 8 (the row's numbers)
    # and at PageRank's p = 1 (under "p1"); their launches are PageRank's
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
        "K3": dict(name="flash_attention (K3)",
                   source=src + "flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention.py:85",
                   launches=launches["K3"]),
        "K4": dict(name="ssd_chunked (K4)", source=src + "ssd_chunk.cu",
                   replaces="src/repro/kernels/ssd_chunk.py:73",
                   launches=launches["K4"]),
        # K3 at the slice's model, Yi-9B (hd 128, G = 8), its own record
        "K3 yi-9b": dict(name="flash_attention (K3), Yi-9B prefill",
                         source=src + "flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:85",
                         launches=attn_launches["yi-9b"]),
        # K3 at MiniCPM-2B's training shape (hd 64, G = 1): its launches
        # are the training run's (phase 13)
        "K3 minicpm-2b": dict(
            name="flash_attention (K3), MiniCPM-2B training",
            source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:85",
            launches=k3_train),
    }
    kernels = []
    for key in ("K1a", "K1b", "K2", "K2 mxu", "K3", "K4", "K3 yi-9b",
                "K3 minicpm-2b"):
        r = records[key]
        kernels.append(dict(
            meta[key], route="cuda",
            # both names: the record's readers use either
            max_abs_diff=r["max_abs_diff"], max_abs_err=r["max_abs_diff"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if f"{key} p=1" in records:
            r1 = records[f"{key} p=1"]
            kernels[-1].update(p=P, p1={k: r1[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_diff")})
    kernels[0]["launches_overlay"] = overlay_launches
    kernels[0]["launches_serving"] = serving_launches
    kernels[0]["launches_net"] = net_launches
    by_key = dict(zip(("K1a", "K1b", "K2", "K2 mxu", "K3", "K4", "K3 yi-9b",
                       "K3 minicpm-2b"), kernels))
    # K3's launches in each attention family's prefill (phase 12)
    by_key["K3 yi-9b"]["launches_by_model"] = attn_launches
    # the kernels' launches in training (phase 13): MiniCPM-2B's 4 steps
    # (K3), Mamba2-130M's uninterrupted 4 steps (K4)
    for key in ("K3", "K3 yi-9b", "K3 minicpm-2b"):
        by_key[key]["launches_train"] = k3_train
    by_key["K4"]["launches_train"] = k4_train
    # K3's launches in phase 14's pipelined MiniCPM-2B step (forward and
    # backward of 2 micro-batches)
    by_key["K3 minicpm-2b"]["launches_pipeline"] = k3_pipeline
    # K3's backward (its plain version recomputed) at MiniCPM-2B's shape
    by_key["K3 minicpm-2b"]["backward_ms"] = records["K3 minicpm-2b"][
        "backward_ms"]
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
