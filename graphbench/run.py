#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The inputs come from ``--seed``; set-up
(imports, CUDA init, kernel load, generation, the port's ingest, a warm-up
iteration) is timed as ``setup_s``; then solves run back to back for
``--seconds`` and every one that started is finished; the outputs are
compared with the plain reference.  The last line of standard output is
the result object; the last lines of standard error are the numbers
compared, each beside its limit.  ``--trace 1`` profiles the window and
reports the cell's per-layer metrics instead of its end-to-end ones.

Exits non-zero, with no result, without a CUDA card (or with fewer than
the cell asks for), when the port cannot be imported, and when JAX or the
JAX package is loaded in this process once the window has closed.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    # (the port's own nvcc builds go to build/torch_ext/ there)
    cache = ROOT / "build" / "caches"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    import torch
    if not torch.cuda.is_available():
        print("graphbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from graphbench import harness
    cell = harness.resolve(args.workload, harness.manifest())
    chips = int(cell.entry["chips"])
    if torch.cuda.device_count() < chips:
        print(f"graphbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace),
                                     torch.device("cuda", 0), start=START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"graphbench: this process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
