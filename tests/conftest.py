"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 real device;
multi-device behavior is tested via subprocesses (see test_distributed.py)
and the production meshes only via launch/dryrun.py."""
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_graph(n, avg_deg, seed=0):
    from repro.core.csr import from_edges

    r = np.random.default_rng(seed)
    m = n * avg_deg // 2
    e = r.integers(0, n, size=(m, 2))
    return from_edges(e, n, undirected=True)


def powerlaw_graph(n, avg_deg, seed=0):
    from repro.graphs.datasets import powerlaw_graph as plg

    return plg(n, avg_deg, seed=seed)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the hand-written kernels of repro_torch); "
        "decided inside the test, which skips when there is none",
    )
