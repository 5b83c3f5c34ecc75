"""Every cell on file, as the tests run them: the manifest's cells, and a
cell kept on file without a manifest entry (``nmf22-sem``, PERF.md),
entered as a later PR would enter it."""
import json

from graphbench import harness

BENCH = harness.manifest()


def with_all_cells(bench=BENCH, base=harness.BENCH) -> dict:
    """``bench`` with an entry for each workload file it lacks, listed by
    every metric that lists a manifest cell of the same operator."""
    bench = json.loads(json.dumps(bench))
    have = {w["name"]: w for w in bench["workloads"]}
    for path in sorted((base / "workloads").glob("*.json")):
        name = path.stem
        if name in have:
            continue
        wl = harness.load_json(path)
        bench["workloads"].append(dict(name=name, **{
            k: wl[k] for k in ("config", "traffic", "chips", "why")}))
        twins = {n for n in have if harness.load_json(harness.find(
            "workloads", n, base))["operator"] == wl["operator"]}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twins & set(m.get("workloads", ())):
                m["workloads"].append(name)
    return bench


ALL = with_all_cells()
CELLS = [w["name"] for w in ALL["workloads"]]
