"""Where the densify kernel's time goes, and how its block shape was chosen:
``csrc/sem_spmm_mxu.cu`` built in variants and timed on the densify cell.

    PYTHONPATH=src python -m repro_torch.kernels.tune_densify [--scale 20]

Needs a CUDA card.  The cell is ``chip_smoke.py``'s: an R-MAT graph (edge
factor 16) made from ``--seed`` at ``--scale``, its PageRank operator's
pattern chunked at T = 2048, C = 256, an integer operand of p = 16
columns.  Each variant's source is the kernel's with one thing changed:

* ``warps N``: N warps a chunk in every launch (the kernel picks 4 for a
  launch of at most ``kManyChunks`` chunks and 1 above);
* ``no reductions``: the rows' reductions skipped (a test no value passes);
* ``no sweep``: the +0.0 sweep of visited tile rows skipped.

For each it prints the one-shot product over the whole matrix (K2 mxu, CUDA
events over 10 calls) and one 256-chunk batch of uint16 lanes (K1b, 50
launches replayed in a CUDA graph), each checked against the shipped kernel
bit for bit where the variant keeps the function.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, sem_spmm

T, C, P, BATCH = 2048, 256, 16, 256

_SHAPES = ("constexpr int kWarpsFew = 4;", "constexpr int kWarpsMany = 1;")
_REDUCE = "        if (live && col < p)\n"
_SWEEP = ("  sweep_zero<kThreads>(nb_row, tile_row, ob, tile_elems, "
          "vec_out);\n\n")


def variants(src: str) -> dict:
    """Variant name -> (source, whether it computes the same function)."""
    for anchor in (*_SHAPES, _REDUCE, _SWEEP):
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/sem_spmm_mxu.cu changed: {anchor!r}")
    out = {"shipped": (src, True)}
    for w in (1, 2, 4, 8):
        out[f"warps {w}"] = (src.replace(_SHAPES[0], f"constexpr int "
                                         f"kWarpsFew = {w};").replace(
            _SHAPES[1], f"constexpr int kWarpsMany = {w};"), True)
    out["no reductions"] = (src.replace(
        _REDUCE, "        if (live && col < p && v4[0] == 1.5e30f)\n"), False)
    out["no sweep"] = (src.replace(_SWEEP, "\n"), False)
    return out


def build(name: str, text: str, out: Path) -> ctypes.CDLL:
    slug = name.replace(" ", "_")
    src = _build.CSRC / f"_tune_{slug}.cu"     # beside its headers
    lib = out / f"lib{slug}.so"
    src.write_text(text)
    try:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(lib), str(src)], capture_output=True,
                              text=True)
    finally:
        src.unlink()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.sem_spmm_mxu_batch.argtypes = _build._BATCH
    dll.sem_spmm_mxu_batch.restype = ctypes.c_int
    return dll


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return events_ms(graph.replay, 1) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_densify: needs a CUDA card")
    from repro_torch.apps.pagerank import build_operator
    from repro_torch.core.formats import to_chunked
    from repro_torch.sparse.generate import rmat
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ct = to_chunked(build_operator(rmat(args.scale, 16, seed=args.seed)),
                    T=T, C=C)
    live = np.arange(C)[None, :] < ct.meta[:, 3:4]
    meta = torch.from_numpy(ct.meta).to(dev)
    rows = torch.from_numpy(ct.row_local).to(dev)
    cols = torch.from_numpy(ct.col_local).to(dev)
    ones = torch.from_numpy(live.astype(np.float32)).to(dev)
    rng = np.random.default_rng(args.seed)
    x_pad = torch.zeros((ct.padded_cols, P), device=dev)
    x_pad[: ct.n_cols] = torch.from_numpy(
        rng.integers(-4, 5, (ct.n_cols, P)).astype(np.float32)).to(dev)
    s = (ct.n_chunks // 2 // BATCH) * BATCH
    batch = (meta[s:s + BATCH],
             torch.tensor([BATCH], dtype=torch.int32, device=dev),
             rows[s:s + BATCH].to(torch.int16).contiguous(),
             cols[s:s + BATCH].to(torch.int16).contiguous(), None)
    acc = torch.zeros((ct.padded_rows, P), device=dev)
    print(f"densify cell: scale {args.scale}, {ct.n_chunks} chunks, "
          f"T = {T}, C = {C}, p = {P} [{card}]", flush=True)

    def one_shot():
        return sem_spmm.spmm_tiles(meta, rows, cols, ones, x_pad, T=T,
                                   n_tile_rows=ct.n_tile_rows, variant="mxu")

    def one_batch(out):
        return sem_spmm.spmm_tiles_acc(*batch, x_pad, out, T=T,
                                       variant="mxu")

    src = (_build.CSRC / "sem_spmm_mxu.cu").read_text()
    todo = variants(src)
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        libs = dict(zip(todo, pool.map(
            lambda kv: build(kv[0], kv[1][0], Path(tmp)), todo.items())))
        library = sem_spmm.library
        want = None
        try:
            for name, (_, same) in todo.items():
                sem_spmm.library = lambda _name, lib=libs[name]: lib
                got = (one_shot(), one_batch(torch.zeros_like(acc)))
                if want is None:
                    want = got
                elif same and not all(map(torch.equal, got, want)):
                    raise SystemExit(f"variant {name} disagrees")
                print(f"{name}: K2 mxu {events_ms(one_shot, 10)} ms, K1b "
                      f"{graph_ms(lambda: one_batch(acc), 50)} ms [{card}]",
                      flush=True)
        finally:
            sem_spmm.library = library


if __name__ == "__main__":
    main()
