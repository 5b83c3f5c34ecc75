"""Roofline report: aggregate the dry-run JSONs into the roofline table, as
the JAX package's ``launch/roofline.py`` does, over the H100 SXM's
constants.

Reads ``results/dryrun_torch/*.json`` (written by
``repro_torch.launch.dryrun``) and emits a markdown table with, per (arch,
shape, mesh, policy):

  compute_s   = FLOPs_per_rank / peak_FLOP/s        (989 TF/s bf16 dense)
  memory_s    = bytes_per_rank / HBM_bw             (3.35 TB/s)
  collective_s= collective_bytes_per_rank / link_bw (50 GB/s InfiniBand)
  dominant    = argmax of the three
  MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode)
  useful      = MODEL_FLOPS / (FLOPs_per_rank × n_ranks)
  roofline    = ideal_time / dominant_time, ideal = MODEL_FLOPS/(cards·peak)

These are counts over constants, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline
      [--dir results/dryrun_torch] [--csv out.csv] [--policy <tag>|-]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def load_records(dir_: str) -> List[dict]:
    recs = []
    if not os.path.isdir(dir_):
        return recs
    for fn in sorted(os.listdir(dir_)):
        if fn.endswith(".json"):
            with open(os.path.join(dir_, fn)) as f:
                rec = json.load(f)
            rec["_file"] = fn
            recs.append(rec)
    return recs


def fmt_seconds(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}µs"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


COLUMNS = ("arch", "shape", "mesh", "pol", "compute", "memory", "coll",
           "dom", "useful", "roofline", "what moves the dominant term")

HINTS = {
    ("compute", "train"): "more cards / lower-precision matmuls",
    ("compute", "prefill"): "prefill-only last-token logits; fuse attention",
    ("compute", "decode"): "batch more requests per step",
    ("memory", "train"): "fuse the layer-body elementwise chains (a CUDA "
                         "kernel); bf16 intermediates; less remat recompute",
    ("memory", "prefill"): "the flash-attention CUDA kernel keeps scores in "
                           "shared memory; avoid full-logit materialization",
    ("memory", "decode"): "weights are the floor: quantize or batch more",
    ("collective", "train"): "hierarchical RS->AR->AG, overlap with bwd, "
                             "int8 cross-pod compression",
    ("collective", "prefill"): "shard seq not batch; defer AG to layer entry",
    ("collective", "decode"): "keep KV model-sharded; all-gather only logits",
}


def row(rec: dict) -> Optional[List[str]]:
    if rec.get("status") == "skipped":
        return [rec["arch"], rec["shape"], rec["mesh"],
                ",".join(rec.get("policy", []) or []) or "-",
                "skip", "skip", "skip", "-", "-", "-",
                rec.get("reason", "")[:50]]
    if rec.get("status") != "ok":
        return [rec["arch"], rec["shape"], rec["mesh"],
                ",".join(rec.get("policy", []) or []) or "-",
                "ERR", "ERR", "ERR", "-", "-", "-",
                rec.get("error", "")[:50]]
    t = rec["terms"]
    hint = HINTS.get((t["dominant"], rec.get("kind", "train")), "")
    return [rec["arch"], rec["shape"], rec["mesh"],
            ",".join(rec.get("policy", []) or []) or "-",
            fmt_seconds(t["compute_s"]), fmt_seconds(t["memory_s"]),
            fmt_seconds(t["collective_s"]), t["dominant"],
            f"{t['useful_flop_ratio']:.2f}",
            f"{t['roofline_fraction']:.3f}", hint]


def markdown_table(recs: List[dict]) -> str:
    lines = ["| " + " | ".join(COLUMNS) + " |",
             "|" + "|".join("---" for _ in COLUMNS) + "|"]
    for rec in recs:
        r = row(rec)
        if r:
            lines.append("| " + " | ".join(r) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--policy", default=None,
                    help="only records with this policy tag ('-' = baseline)")
    args = ap.parse_args(argv)

    recs = load_records(args.dir)
    if args.policy is not None:
        want = [] if args.policy == "-" else sorted(args.policy.split(","))
        recs = [r for r in recs if sorted(r.get("policy", []) or []) == want]
    recs.sort(key=lambda r: (r.get("arch", ""), r.get("shape", ""),
                             r.get("mesh", ""), ",".join(r.get("policy") or [])))
    print(markdown_table(recs))
    ok = [r for r in recs if r.get("status") == "ok"]
    err = [r for r in recs if r.get("status") == "error"]
    skip = [r for r in recs if r.get("status") == "skipped"]
    print(f"\n{len(ok)} ok / {len(skip)} skipped / {len(err)} errors "
          f"of {len(recs)} records")
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(COLUMNS)
            for rec in recs:
                r = row(rec)
                if r:
                    w.writerow(r)
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())
