"""The plain reference against a brute-force count, and the frozen generators
pinned by checksums of their edges (not by the program's generators)."""
import hashlib

import numpy as np
import pytest
import torch

from gpubench.reference.generators import (kron_edges, raw_edges, relabel,
                                           urand_edges)
from gpubench.reference.triangles import (lcc_float64, lcc_lower_precision,
                                          triangles_per_vertex)


def brute_force(edges, n):
    a = np.zeros((n, n), np.int64)
    for u, v in edges:
        if u != v:
            a[u, v] = a[v, u] = 1
    return np.diag(a @ a @ a) // 2, a.sum(1)


def _graphs():
    rng = np.random.default_rng(0)
    yield "random", rng.integers(0, 60, size=(400, 2)), 60
    yield "dense", rng.integers(0, 24, size=(600, 2)), 24
    yield "rmat", kron_edges(7, 8, 0.57, 0.19, 0.19, seed=3), 128
    yield "star", np.array([[0, i] for i in range(1, 30)] + [[1, 2], [2, 1],
                                                              [3, 3]]), 32
    yield "empty", np.zeros((0, 2), np.int64), 5


@pytest.mark.parametrize("name,edges,n", list(_graphs()),
                         ids=[g[0] for g in _graphs()])
@pytest.mark.parametrize("block", [1, 7, 1 << 25])
def test_reference_matches_brute_force(name, edges, n, block):
    t, deg = triangles_per_vertex(edges, n, block=block)
    want_t, want_deg = brute_force(edges, n)
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    lcc = lcc_float64(t, deg).numpy()
    d = want_deg.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.where(d > 1, 2.0 * want_t / (d * (d - 1)), 0.0)
    np.testing.assert_allclose(lcc, want, rtol=1e-15, atol=0)


def test_lower_precision_control_departs():
    e = kron_edges(9, 16, 0.57, 0.19, 0.19, seed=1)
    t, deg = triangles_per_vertex(e, 512)
    exact, low = lcc_float64(t, deg), lcc_lower_precision(t, deg)
    rel = ((exact - low).abs() / exact.clamp(min=1e-12)).max().item()
    assert 1e-4 < rel < 3e-2


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("make,digest", [
    (lambda: kron_edges(10, 16, 0.57, 0.19, 0.19, 1), "176ef834686b4a88"),
    (lambda: urand_edges(10, 16, 1), "5eda5ff23e3df7fb"),
    (lambda: relabel(kron_edges(10, 16, 0.57, 0.19, 0.19, 1), 1024, 1, 7, 8),
     "7c83025ac9dd7d16"),
], ids=["kron", "urand", "relabel"])
def test_generators_frozen(make, digest):
    e = make()
    assert e.dtype == np.int64 and e.shape == (16 << 10, 2)
    assert _digest(e) == digest


def test_kron_quadrant_shares():
    # one level: the four quadrants in the shares a, b, c, d
    e = kron_edges(1, 1 << 16, 0.57, 0.19, 0.19, seed=2)
    share = np.bincount(e[:, 0] * 2 + e[:, 1], minlength=4) / e.shape[0]
    np.testing.assert_allclose(share, [0.57, 0.19, 0.19, 0.05], atol=0.005)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11, -3])
def test_seed_deals_blocks_keeps_graph(seed):
    cfg = {"generator": "kron", "scale": 9, "edge_factor": 16, "a": 0.57,
           "b": 0.19, "c": 0.19, "assumed": {"graph_seed": 4, "ranks": 8}}
    e = raw_edges(cfg, seed)
    base = raw_edges(cfg, 1)
    assert e.shape == base.shape and e.min() >= 0 and e.max() < 512
    # the same graph under other labels: the same degrees and triangles
    t, deg = triangles_per_vertex(e, 512)
    t0, deg0 = triangles_per_vertex(base, 512)
    assert sorted(deg.tolist()) == sorted(deg0.tolist())
    assert sorted(t.tolist()) == sorted(t0.tolist())
    # blocks move whole: a label's offset inside its block is kept
    np.testing.assert_array_equal(e % 64, base % 64)
    assert np.array_equal(raw_edges(cfg, seed), e)


def test_reference_runs_on_torch_tensors():
    e = torch.as_tensor(kron_edges(6, 8, 0.57, 0.19, 0.19, seed=9))
    t, _ = triangles_per_vertex(e, 64)
    assert t.dtype == torch.int64 and int(t.sum()) % 3 == 0
