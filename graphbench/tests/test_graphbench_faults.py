"""A run with the timed path broken underneath reads ``correct`` false:
the whole run (set-up, window, check) on the CPU at a small size, with
each fault a cell can have planted in the port.  The exchange between
chips is not among them: every cell runs on one chip."""
import dataclasses
import itertools

import pytest
import torch

from gb_cells import ALL as BENCH, CELLS
from graphbench import harness
import repro_torch.kernels.ops as ops

SHRINK = {"graph": {"scale": 9}, "store": {"T": 256, "C": 64,
                                          "chunk_batch": 16}}


def run(cell, seed=3, device="cpu"):
    result, lines = harness.run_cell(
        harness.resolve(cell, BENCH), seed, 0, False, torch.device(device),
        start=0.0, shrink=SHRINK)
    return result


def stale(monkeypatch):
    """Every product's step returns its accumulator unchanged."""
    monkeypatch.setattr(ops, "spmm_tiles_acc",
                        lambda *a, **k: a[6])
    monkeypatch.setattr(ops, "spmm_tiles", lambda meta, r, c, v, x, *, T,
                        n_tile_rows, variant="gather": torch.zeros(
                            (n_tile_rows * T, x.shape[1]), dtype=x.dtype,
                            device=x.device))


def half(monkeypatch):
    """Half of each product's chunks left out, the rest counted twice."""
    acc_fn, tiles_fn, calls = ops.spmm_tiles_acc, ops.spmm_tiles, \
        itertools.count()

    def acc(*a, **k):
        if next(calls) % 2:
            return a[6]
        acc_fn(*a, **k)
        return acc_fn(*a, **k)

    def tiles(meta, r, c, v, x, **k):
        keep = slice(0, None, 2)
        out = tiles_fn(meta[keep].contiguous(), r[keep].contiguous(),
                       c[keep].contiguous(),
                       None if v is None else v[keep].contiguous(), x, **k)
        return 2 * out
    monkeypatch.setattr(ops, "spmm_tiles_acc", acc)
    monkeypatch.setattr(ops, "spmm_tiles", tiles)


def altered(monkeypatch, cell):
    """One entry of the answer altered by 1% where the port returns it."""
    cfg = harness.resolve(cell, BENCH).config
    app = harness.load_module(harness.find("apps", cfg["app"]))
    if cfg["app"] == "pagerank":
        fn = app.pagerank

        def wrong(*a, **k):
            res = fn(*a, **k)
            s = res.scores.copy()
            s[s.argmax()] *= 1.01
            return dataclasses.replace(res, scores=s)
        monkeypatch.setattr(app, "pagerank", wrong)
    else:
        fn = app.nmf

        def wrong(*a, **k):
            res = fn(*a, **k)
            W = res.W.clone()
            W.view(-1)[W.argmax()] *= 1.01
            return dataclasses.replace(res, W=W)
        monkeypatch.setattr(app, "nmf", wrong)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 1
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    if fault == "altered":
        altered(monkeypatch, cell)
    else:
        {"stale": stale, "half": half}[fault](monkeypatch)
    result = run(cell)
    assert not result["correct"] and result["failed"] == 1
