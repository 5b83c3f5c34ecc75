"""On the card: each cell's whole run at a small size reads correct, and
with its kernel steps left stale reads incorrect.  Skips without a card
(decided in the fixture, never at import)."""
import pytest
import torch

from gb_cells import ALL as BENCH, CELLS
from graphbench import harness
import repro_torch.kernels.ops as ops

SHRINK = {"graph": {"scale": 14}, "store": {"T": 4096, "C": 512,
                                           "chunk_batch": 32}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, card, monkeypatch):
    c = harness.resolve(cell, BENCH)
    result, _ = harness.run_cell(c, 21, 0, True, card, start=0.0,
                                 shrink=SHRINK)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    monkeypatch.setattr(ops, "spmm_tiles_acc", lambda *a, **k: a[6])
    monkeypatch.setattr(ops, "spmm_tiles", lambda meta, r, cl, v, x, *, T,
                        n_tile_rows, variant="gather": torch.zeros(
                            (n_tile_rows * T, x.shape[1]), dtype=x.dtype,
                            device=x.device))
    result, _ = harness.run_cell(c, 21, 0, False, card, start=0.0,
                                 shrink=SHRINK)
    assert not result["correct"]
