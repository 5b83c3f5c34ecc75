#!/usr/bin/env python3
"""The control of a cell's comparison, at the cell's own size.

    python3 graphbench/control.py --workload <cell> --seeds 11,12,13

For each seed: the cell's inputs as ``run.py`` makes them, the reference
(float64) and the control (the same reference in bfloat16, the precision
below the configuration's float32) put in the program's place, and the
numbers the cell's comparison reads from the control, each beside its
limit, and ``correct`` as the run's own decision (``harness.decide``)
takes it.  A control that reads ``correct`` true is a comparison that
cannot fail.  One JSON line a seed; the benchmark's own runs never run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, str(ROOT))
    from graphbench import harness
    cell = harness.resolve(args.workload, harness.manifest())
    cfg, g = cell.config, cell.config["graph"]
    gen = harness.load_module(harness.find("gen", g["generator"]))
    ref = harness.load_module(harness.find("reference", cfg["app"]))
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        rows, cols = gen.rmat(g["scale"], g["edge_factor"], a=g["a"],
                              b=g["b"], c=g["c"], seed=seed, device=device)
        rows, cols = rows.cpu().numpy(), cols.cpu().numpy()
        n = 1 << g["scale"]
        t0 = time.perf_counter()
        want = ref.solve(cfg, n, rows, cols, seed, device)
        t1 = time.perf_counter()
        low = ref.solve(cfg, n, rows, cols, seed, device,
                        precision="bfloat16")
        correct, failed, numbers = harness.decide(
            [ref.compare(low, want)], {}, cfg["limits"])
        print(json.dumps({
            "workload": cell.name, "seed": seed, "edges": int(rows.size),
            "reference_s": t1 - t0, "correct": correct, "failed": failed,
            "control": {k: {"value": v, "limit": cfg["limits"][k]}
                        for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
