"""R-MAT synthetic graph generator (paper §IV-A).

Parameters follow the paper: ``a=0.57, b=c=0.19, d=0.05``; a graph with
scale ``x`` and edge factor ``y`` has ``2**x`` vertices and ``2**(x+y)``
edges (the paper writes 2^x * y; Graph500 convention is EF*2^x edges —
we follow #edges = EF * 2**scale, matching Table II's S21/EF16 => 33.6M).

The update-stream generators of the reference (``rmat_stream``,
``rmat_adversarial_stream``) emit ``streaming.updates.EdgeBatch`` objects
and arrive with the streaming subsystem.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rmat_edges", "rmat_graph"]

A, B, C, D = 0.57, 0.19, 0.19, 0.05


def rmat_edges(
    scale: int,
    edge_factor: int,
    *,
    seed: int = 0,
    a: float = A,
    b: float = B,
    c: float = C,
) -> np.ndarray:
    """Vectorized R-MAT: one quadrant draw per (edge, level)."""
    n_edges = edge_factor << scale
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    ab = a + b
    d_ = 1.0 - a - b - c
    for _ in range(scale):
        u = rng.random(n_edges)
        v = rng.random(n_edges)
        # factorized quadrant draw: src bit first (top half has mass a+b),
        # then dst bit conditioned on the half:
        #   top    (src_bit=0): P(dst_bit=1) = b / (a + b)
        #   bottom (src_bit=1): P(dst_bit=1) = d / (c + d)
        src_bit = u >= ab
        p_right = np.where(src_bit, d_ / (c + d_), b / ab)
        dst_bit = v < p_right
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return np.stack([src, dst], axis=1)


def rmat_graph(scale: int, edge_factor: int, *, seed: int = 0, undirected=True):
    """Edges -> simple CSR graph (self-loops/multi-edges removed)."""
    from ..core.csr import from_edges

    e = rmat_edges(scale, edge_factor, seed=seed)
    return from_edges(e, 1 << scale, undirected=undirected)
