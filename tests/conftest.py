import numpy as np
import pytest

from repro.sparse.generate import rmat


@pytest.fixture(scope="session")
def small_graph():
    """~4k vertices, ~28k edges power-law R-MAT graph."""
    return rmat(12, 8, seed=1)


@pytest.fixture(scope="session")
def small_valued(small_graph):
    rng = np.random.default_rng(7)
    return small_graph.with_values(
        rng.standard_normal(small_graph.nnz).astype(np.float32))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason where none "
        "is present")
