"""Graph dataset stand-ins (paper §IV-A, Table II).

The SNAP/KONECT files are not part of the repository, so those graphs are
represented by *synthetic generators with matching shape statistics*: a power-law
(Barabási–Albert-style preferential attachment) generator for the social
graphs and the R-MAT generator for the synthetic rows of Table II. Each
entry records the real graph's (|V|, |E|) so benchmarks can report the
scale they stand in for.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.csr import CSRGraph, from_edges

__all__ = ["GraphSpec", "GRAPHS", "powerlaw_graph", "uniform_graph", "get"]


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    n: int
    m: int
    directed: bool
    kind: str  # 'powerlaw' | 'uniform' | 'rmat'
    scale_stand_in: int  # scale for generators when materialized


# Real-graph rows of Table II (sizes recorded; materialized via stand-ins).
GRAPHS = {
    "orkut": GraphSpec("SNAP-Orkut", 3_000_000, 117_200_000, False, "powerlaw", 17),
    "livejournal": GraphSpec("SNAP-LiveJournal", 4_000_000, 34_700_000, False, "powerlaw", 17),
    "livejournal1": GraphSpec("SNAP-LiveJournal1", 4_800_000, 69_000_000, True, "powerlaw", 17),
    "skitter": GraphSpec("SNAP-Skitter", 1_700_000, 11_100_000, False, "powerlaw", 16),
    "uk-2005": GraphSpec("uk-2005", 39_500_000, 936_400_000, True, "powerlaw", 18),
    "wiki-en": GraphSpec("wiki-en", 13_600_000, 437_200_000, True, "powerlaw", 18),
    "facebook_circles": GraphSpec("ego-Facebook", 4_039, 88_234, False, "powerlaw", 12),
}


def powerlaw_graph(n: int, avg_deg: int, *, seed: int = 0) -> CSRGraph:
    """Preferential-attachment-flavored power-law graph (vectorized).

    Repeated-degree sampling: draw edge endpoints with probability
    proportional to a Zipf-ish weight, giving a heavy-tailed degree
    distribution comparable to the SNAP social graphs.
    """
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    # Zipf weights over a random permutation so hubs are spread across the
    # id range (the paper random-relabels degree-ordered inputs; we bake
    # the equivalent in).
    w = 1.0 / np.arange(1, n + 1) ** 0.75
    w /= w.sum()
    perm = rng.permutation(n)
    src = perm[rng.choice(n, size=m, p=w)]
    dst = perm[rng.choice(n, size=m, p=w)]
    return from_edges(np.stack([src, dst], 1), n, undirected=True)


def uniform_graph(n: int, avg_deg: int, *, seed: int = 0) -> CSRGraph:
    """Uniform (Erdős–Rényi-style) graph — the flat-degree control of Fig. 4."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    e = rng.integers(0, n, size=(m, 2))
    return from_edges(e, n, undirected=True)


def get(name: str, *, max_n: int = 1 << 14, seed: int = 0) -> CSRGraph:
    """Materialize a (scaled-down) stand-in for a named Table II graph."""
    spec = GRAPHS[name]
    n = min(spec.n, max_n)
    avg = max(2, min(spec.m // max(spec.n, 1) * 2, 64))
    if spec.kind == "uniform":
        return uniform_graph(n, avg, seed=seed)
    return powerlaw_graph(n, avg, seed=seed)
