"""Where the gather kernel's time goes: ``csrc/sem_spmm.cu`` (K1a, and K2
through it) built in variants and timed at the main path's shapes.

    PYTHONPATH=src python -m repro_torch.kernels.tune_gather [--scale 22]
        [--source path/to/sem_spmm.cu]

Needs a CUDA card.  The cell is ``chip_smoke.py``'s main path: an R-MAT
graph (edge factor 16) made from ``--seed`` at ``--scale``, its PageRank
operator chunked at T = 16384, C = 2048.  Timed on it:

* K1a: the middle 256-chunk batch as a raw valued store ships it (uint16
  lanes, float32 values) on a zeroed accumulator, at p = 1 and p = 8; 50
  launches replayed in a CUDA graph;
* K2: the one-shot product over the whole matrix (int32 lanes, the
  pattern's values), at p = 1 and p = 8; CUDA events over 10 calls;

each the median of 5 such timings.

Each variant is the source with one thing changed (a variant whose anchor
the source lacks is skipped, so ``--source`` can time an earlier version of
the kernel, for instance the parent commit's):

* ``store``: a plain store of each contribution in place of its atomic
  reduction (a wrong sum; the atomics' cost);
* ``no gather``: a constant in place of each X load (the gather's cost);
* ``threads N``: N threads a block;
* ``blocks/SM N``: dynamic shared memory padded so that at most N blocks
  are resident on an SM;
* ``launch only`` / ``decode only``: the blocks return right after reading
  ``n_valid`` / after decoding their lanes (the floors under the work);

and for the redesigned kernel: ``stores`` and ``constant X`` (as above),
``no run sums`` (a reduction per lane), ``scalar`` (no 16-byte loads or
vector reductions), ``no sweep`` (the +0.0 rule skipped), ``batch threads
N`` / ``whole threads N`` (the two launch shapes' block sizes), ``block a
chunk`` / ``slabs always`` (one shape for every launch) and ``floor`` (the
lane blocks return at once).  A variant that keeps the function is checked
against the source as given: K2 bit for bit (integer data), K1a's largest
difference shown (its values are 1 / degree).  Before the variants, how the
batch's live lanes fall across rows and tile rows, from the planes on the
host.
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

T, C, BATCH = 16384, 2048, 256

# (name, keeps the function?, [(anchor, replacement), ...]); a variant runs
# where its anchors are all present.  The first group edits the kernel
# before its redesign (one block per chunk, a scalar atomic per lane and
# column; the parent commit's source, by --source), the second the
# redesigned one.
_OLD_STORE = ("atomicAdd(ob + static_cast<size_t>(r_s[lane]) * p + j, "
              "contrib);")
_OLD_X = ("const float xv = to_float(xb[static_cast<size_t>(c_s[lane]) * p "
          "+ j]);")
_OLD_SMEM = "const size_t smem = 2 * static_cast<size_t>(C) * sizeof(int);"
_ADD = "if (n > 0) add4(orow + j0 + 4 * q, s[k][q], n, vec_out);"
_LOAD = ("load4(xb + static_cast<size_t>(ln.c[k]) * p + j0 + 4 * q, n,\n"
         "                vec_x, s[k][q]);")
VARIANTS = [
    ("store", False, [(_OLD_STORE, "ob[static_cast<size_t>(r_s[lane]) * p "
                                   "+ j] = contrib;")]),
    ("no gather", False, [(_OLD_X, "const float xv = 1.0f;")]),
    *((f"threads {n}", True, [("constexpr int kThreads = 512;",
                               f"constexpr int kThreads = {n};")])
      for n in (128, 256, 1024)),
    *((f"blocks/SM {n}", True, [(_OLD_SMEM, f"const size_t smem = "
                                            f"{228 // n - 2} * 1024;")])
      for n in (1, 2)),
    ("launch only", False, [("if (g >= __ldg(n_valid)) return;",
                             "if (g >= 0) return;")]),
    ("decode only", False, [("const int work = nnz * p;",
                             "const int work = 0;")]),
    # the redesigned kernel
    ("stores", False, [(_ADD, "if (n > 0) for (int e = 0; e < n; ++e) "
                              "orow[j0 + 4 * q + e] = s[k][q][e];")]),
    ("constant X", False, [(_LOAD, "for (int e = 0; e < 4; ++e) "
                                   "s[k][q][e] = 1.0f;")]),
    *((f"lanes {n}", True, [("constexpr int kLanes = 2;",
                             f"constexpr int kLanes = {n};")])
      for n in (1, 4)),
    ("two groups a pass", True, [("constexpr int kOneGroupMaxP = 4;",
                                  "constexpr int kOneGroupMaxP = 0;")]),
    ("no run sums", True, [("head = !live || lane == 0 || prev != r;",
                            "head = true;")]),
    ("scalar", True, [(
        "const int vec_x = x_at % (4 * sizeof(XT)) == 0 && p % 4 == 0;",
        "const int vec_x = 0;"), (
        "const int vec_out = acc_at % 16 == 0 && p % 4 == 0;",
        "const int vec_out = 0;")]),
    ("no sweep", False, [("const int sweep_blocks = fresh ? 0 :",
                          "const int sweep_blocks = 1 ? 0 :")]),
    *((f"batch threads {n}", True, [(
        "constexpr int kBatchThreads = 256;",
        f"constexpr int kBatchThreads = {n};")]) for n in (128, 512)),
    *((f"whole threads {n}", True, [(
        "constexpr int kWholeThreads = 128;",
        f"constexpr int kWholeThreads = {n};")]) for n in (64, 256, 512)),
    ("block a chunk", True, [("constexpr int kManyChunks = 4096;",
                              "constexpr int kManyChunks = 0;")]),
    ("slabs always", True, [("constexpr int kManyChunks = 4096;",
                             "constexpr int kManyChunks = 1 << 30;")]),
    ("floor", False, [("if (g >= nv || lo >= hi) return;",
                       "if (g >= 0) return;")]),
]


def variants(src: str) -> dict:
    """Variant name -> (source, whether it computes the same function)."""
    out = {"as given": (src, True)}
    for name, same, edits in VARIANTS:
        if all(src.count(a) == 1 for a, _ in edits):
            text = src
            for a, b in edits:
                text = text.replace(a, b)
            out[name] = (text, same)
    return out


class _Entry:
    """The library's entry point under the wrapper's calling convention; a
    source from before the ``fresh`` argument takes all but that one."""

    def __init__(self, fn, takes_fresh: bool):
        self.fn, self.takes_fresh = fn, takes_fresh

    def sem_spmm_batch(self, *args):
        return self.fn(*(args if self.takes_fresh
                         else args[:-2] + args[-1:]))


def build(name: str, text: str, out: Path) -> _Entry:
    slug = name.replace(" ", "_").replace("/", "_")
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
    fn = ctypes.CDLL(str(lib)).sem_spmm_batch
    takes_fresh = "int fresh" in text
    fn.argtypes = (_build._ENTRIES["sem_spmm"][1] if takes_fresh
                   else _build._BATCH)
    fn.restype = ctypes.c_int
    return _Entry(fn, takes_fresh)


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


def lane_layout(meta: np.ndarray, rows: np.ndarray, mid: int) -> str:
    """How live lanes fall across rows and tile rows: per 256-chunk batch
    the distinct tile rows, lanes per distinct row within a chunk and within
    a batch, and the largest row's lanes; over every batch, and for the
    batch at ``mid``."""
    live = np.arange(rows.shape[1])[None, :] < meta[:, 3:4]
    key = meta[:, 0:1].astype(np.int64) * T + rows

    def one(s):
        m, k, lv = meta[s:s + BATCH], key[s:s + BATCH], live[s:s + BATCH]
        n_live = int(lv.sum())
        opens = lv.copy()
        opens[:, 1:] &= k[:, 1:] != k[:, :-1]
        _, counts = np.unique(k[lv], return_counts=True)
        run_len = np.diff(np.flatnonzero(np.append(opens[lv], True)))
        return (np.unique(m[:, 0]).size, n_live / max(int(opens.sum()), 1),
                n_live / max(counts.size, 1),
                int(run_len.max(initial=0)), int(counts.max(initial=0)),
                n_live)

    stats = np.array([one(s) for s in range(0, meta.shape[0], BATCH)])
    names = ("tile rows", "lanes/row in a chunk", "lanes/row in a batch",
             "largest row in a chunk", "largest row in a batch",
             "live lanes")
    lines = [f"  {n}: min {stats[:, i].min():.4g}, median "
             f"{np.median(stats[:, i]):.4g}, max {stats[:, i].max():.4g}"
             for i, n in enumerate(names)]
    m = one(mid)
    lines.append("  middle batch: " + ", ".join(
        f"{n} {v:.4g}" for n, v in zip(names, m)))
    return f"lane layout over {stats.shape[0]} batches:\n" + "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", type=Path,
                    default=_build.CSRC / "sem_spmm.cu",
                    help="kernel source to time (default: the shipped one)")
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_gather: needs a CUDA card")
    from repro_torch.apps.pagerank import build_operator
    from repro_torch.core.formats import to_chunked
    from repro_torch.sparse.generate import rmat
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ct = to_chunked(build_operator(rmat(args.scale, 16, seed=args.seed)),
                    T=T, C=C)
    mid = (ct.n_chunks // 2 // BATCH) * BATCH
    print(f"main path: scale {args.scale}, {ct.n_chunks} chunks, T = {T}, "
          f"C = {C}; source {args.source} [{card}]", flush=True)
    print(lane_layout(ct.meta, ct.row_local, mid), flush=True)

    live = np.arange(C)[None, :] < ct.meta[:, 3:4]
    meta = torch.from_numpy(ct.meta).to(dev)
    rows = torch.from_numpy(ct.row_local).to(dev)
    cols = torch.from_numpy(ct.col_local).to(dev)
    ones = torch.from_numpy(live.astype(np.float32)).to(dev)
    rng = np.random.default_rng(args.seed)
    # integers: the pattern's one-shot sums are exact in any order
    x = {p: torch.from_numpy(np.vstack([
        rng.integers(-4, 5, (ct.n_cols, p)).astype(np.float32),
        np.zeros((ct.padded_cols - ct.n_cols, p), np.float32)])).to(dev)
        for p in (1, 8)}
    batch = (meta[mid:mid + BATCH],
             torch.tensor([BATCH], dtype=torch.int32, device=dev),
             rows[mid:mid + BATCH].to(torch.int16).contiguous(),
             cols[mid:mid + BATCH].to(torch.int16).contiguous(),
             torch.from_numpy(ct.vals[mid:mid + BATCH]).to(dev))
    accs = {p: torch.zeros((ct.padded_rows, p), device=dev) for p in (1, 8)}

    def one_shot(p):
        return sem_spmm.spmm_tiles(meta, rows, cols, ones, x[p], T=T,
                                   n_tile_rows=ct.n_tile_rows)

    def one_batch(p, out):
        return sem_spmm.spmm_tiles_acc(*batch, x[p], out, T=T)

    src = args.source.read_text()
    todo = variants(src)
    if args.only:
        keep = {"as given", *args.only.split(",")}
        todo = {k: v for k, v in todo.items() if k in keep}
    print("variants: " + ", ".join(todo), flush=True)
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        libs = dict(zip(todo, pool.map(
            lambda kv: build(kv[0], kv[1][0], Path(tmp)), todo.items())))
        library = sem_spmm.library
        want = {}
        try:
            for name, (_, same) in todo.items():
                sem_spmm.library = lambda _name, lib=libs[name]: lib
                cells = []
                for p in (1, 8):
                    got = (one_shot(p), one_batch(p, torch.zeros_like(
                        accs[p])))
                    if name == "as given":
                        want[p] = got
                    elif same:
                        # K2 sums integers: exact in any order; K1a's values
                        # (1 / degree) are not, so its difference is shown
                        if not torch.equal(got[0], want[p][0]):
                            raise SystemExit(f"variant {name}: K2 differs")
                        cells.append("K1a max |diff| " + str(float(
                            (got[1] - want[p][1]).abs().max())))
                    # medians of 5 timings: K2's spread between single
                    # timings of one build reached 15%
                    k1a = np.median([graph_ms(lambda: one_batch(p, accs[p]),
                                              50) for _ in range(5)])
                    k2 = np.median([events_ms(lambda: one_shot(p), 10)
                                    for _ in range(5)])
                    cells.append(f"p = {p}: K1a {k1a} ms, K2 {k2} ms")
                print(f"{name}: " + "; ".join(cells) + f" [{card}]",
                      flush=True)
        finally:
            sem_spmm.library = library


if __name__ == "__main__":
    main()
