"""The port's dry run on 256 placeholder ranks for the ssm family,
reduced as in ``test_torch_dryrun.py`` (the checks are its own)."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dryrun import check_family, run_families  # noqa: E402

FAMILIES = {"ssm": "mamba2-130m"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return run_families(FAMILIES, tmp_path_factory.mktemp("dryrun"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_kind_counts_ok(records, family):
    check_family(records, family, FAMILIES[family])
