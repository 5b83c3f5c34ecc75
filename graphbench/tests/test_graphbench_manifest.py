"""The manifest and the files it names: every cell, configuration, traffic
mix and metric resolves by name, the names keep the contract's alphabet,
and a cell added as files plus a manifest entry is found with no edit."""
import json
import re
import shutil

import pytest
import torch

from gb_cells import ALL, CELLS
from graphbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_manifest_shape_and_names():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "graphbench/run.py"]
    assert BENCH["paths"] == ["graphbench"]
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"graphbench/configs/{c['name']}.json"
        assert 0 < len(c["source"]) <= 200 and 0 < len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {p[0] for p in pairs}
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH).encode()) <= 64 << 10


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    c = harness.resolve(cell, ALL)
    assert c.config["name"] == c.workload["config"]
    for kind, name in (("apps", c.config["app"]),
                       ("reference", c.config["app"]),
                       ("gen", c.config["graph"]["generator"])):
        assert harness.find(kind, name).is_file()
    reported = {m["name"] for m in harness.metrics_for(c, False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.metrics_for(c, True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_matches_manifest(metric):
    mod = harness.load_module(harness.find("metrics", metric["name"]))
    assert (mod.NAME, mod.UNIT) == (metric["name"], metric["unit"])
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = e2e[metric["moves"]].get("workloads")
        assert moved is None or set(metric["workloads"]) <= set(moved)


def test_cell_on_file_without_an_entry_is_refused():
    """A workload file alone is no cell: a run of it stops before set-up."""
    off = sorted(set(CELLS) - {w["name"] for w in BENCH["workloads"]})
    assert off
    for cell in off:
        with pytest.raises(KeyError):
            harness.resolve(cell, BENCH)


def test_new_cell_found_without_edits(tmp_path):
    """A later PR adds a workload file and a manifest entry; the harness
    finds and runs the cell, and no file that was there changes."""
    base = tmp_path / "graphbench"
    shutil.copytree(harness.BENCH, base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    wl = {"config": "rmat22-pagerank", "operator": "sem",
          "traffic": "closed_solves-later", "chips": 1, "why": "a later cell"}
    (base / "workloads" / "pr22-sem-later.json").write_text(json.dumps(wl))
    shutil.copy(base / "traffic" / "closed_solves.json",
                base / "traffic" / "closed_solves-later.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="pr22-sem-later", **{
        k: wl[k] for k in ("config", "traffic", "chips", "why")}))
    for m in bench["end_to_end"]:
        if m["name"] == "sem_iter_s":
            m["workloads"].append("pr22-sem-later")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    cell = harness.resolve("pr22-sem-later", bench, base)
    result, _ = harness.run_cell(
        cell, 7, 0, False, torch.device("cpu"), start=0.0,
        shrink={"graph": {"scale": 9},
                "store": {"T": 256, "C": 64, "chunk_batch": 16}})
    assert result["correct"]
    assert set(result["metrics"]) == {"sem_iter_s", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
