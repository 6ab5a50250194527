"""Public API for triangle counting and LCC (the paper's contribution).

Single entry points used by examples/benchmarks/launchers:

- ``lcc_single(csr)``            exact single-node reference
- ``lcc_distributed(csr, p)``    epoch engine, p logical ranks on one device
- ``triangle_count(csr)``        global triangle count
- ``lcc_simulated(csr, p, ...)`` host trace sim with CLaMPI caches (stats)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .csr import CSRGraph, from_edges, random_relabel, remove_low_degree
from .rma import simulate_rma_lcc
from .triangles import lcc_scores, triangles_per_vertex

__all__ = [
    "prepare_graph",
    "lcc_single",
    "lcc_distributed",
    "triangle_count",
    "lcc_simulated",
]


def prepare_graph(
    edges: np.ndarray,
    n: int,
    *,
    undirected: bool = True,
    relabel_seed: Optional[int] = None,
    drop_low_degree: bool = True,
):
    """Paper §II-B preprocessing: simple graph, degree<2 removal, optional
    random relabeling (for degree-ordered inputs)."""
    csr = from_edges(edges, n, undirected=undirected)
    keep = np.arange(csr.n, dtype=np.int64)
    if drop_low_degree:
        csr, keep = remove_low_degree(csr)
    if relabel_seed is not None:
        csr = random_relabel(csr, relabel_seed)
    return csr, keep


def lcc_single(csr: CSRGraph) -> np.ndarray:
    return lcc_scores(csr)


def triangle_count(csr: CSRGraph) -> int:
    t = triangles_per_vertex(csr)
    return int(t.sum()) // 3


def lcc_distributed(csr: CSRGraph, p: int, **kw):
    from .async_engine import run_distributed_lcc

    return run_distributed_lcc(csr, p, **kw)


def lcc_simulated(csr: CSRGraph, p: int, **kw):
    return simulate_rma_lcc(csr, p, **kw)
