"""Edge-centric triangle counting and LCC (paper §II-C, §II-D, Alg. 3).

Single-node reference implementations:

- ``triangles_per_vertex`` (numpy, exact, any intersection method): the
  oracle that all distributed/device paths are validated against.
- ``lcc_scores``: paper Eq. (2) (undirected).
- ``triangles_padded_torch``: the vectorized single-device torch path over
  padded rows — the building block the distributed engines reuse.

Semantics: with full (both-direction) adjacency, define
``S(i) = sum_{j in adj(i)} |adj(i) ∩ adj(j)|``. Every edge (j,k) between
two neighbors of i is seen twice in S(i), so the number of edges among
neighbors (== #triangles through i) is ``T(i) = S(i)/2`` and global
``#triangles = sum_i T(i) / 3``. The paper's upper-triangle offset trick
(count only k > j) is exposed via ``upper_only`` for the TC-only path.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .csr import CSRGraph
from .intersect import (
    count_bsearch_np,
    hybrid_scalar,
    count_bsearch_torch,
    count_pairwise_torch,
)

__all__ = [
    "triangles_per_vertex",
    "global_triangle_count",
    "lcc_scores",
    "triangles_padded_torch",
    "lcc_from_counts_torch",
]


def triangles_per_vertex(
    csr: CSRGraph,
    method: Callable[[np.ndarray, np.ndarray], int] = count_bsearch_np,
    *,
    upper_only: bool = False,
) -> np.ndarray:
    """T(i) per vertex (undirected, both directions stored).

    ``upper_only`` counts each triangle once per *edge* (k > j offset, paper
    §II-C) — used by the TC benchmark; LCC needs the full per-vertex count.
    """
    t = np.zeros(csr.n, np.int64)
    for i in range(csr.n):
        row_i = csr.row(i)
        s = 0
        for j in row_i:
            row_j = csr.row(int(j))
            if upper_only:
                row_j = row_j[np.searchsorted(row_j, j + 1) :]
            s += method(row_i, row_j)
        t[i] = s
    if not upper_only:
        assert np.all(t % 2 == 0)
        t //= 2
    return t


def global_triangle_count(csr: CSRGraph) -> int:
    t = triangles_per_vertex(csr)
    total = int(t.sum())
    assert total % 3 == 0
    return total // 3


def lcc_scores(csr: CSRGraph, t: np.ndarray | None = None) -> np.ndarray:
    """Paper Eq. (2): C(i) = 2*T(i) / (deg(i) * (deg(i) - 1))."""
    if t is None:
        t = triangles_per_vertex(csr)
    deg = csr.degrees.astype(np.float64)
    denom = deg * (deg - 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = 2.0 * t / denom
    return np.where(denom > 0, c, 0.0)


# --------------------------------------------------------------------------
# torch padded single-device path.
# --------------------------------------------------------------------------
def triangles_padded_torch(
    rows: torch.Tensor,  # [n, W] sorted padded rows, sentinel = n
    degrees: torch.Tensor,  # [n] int32
    sentinel: int,
    *,
    method: str = "bsearch",
) -> torch.Tensor:
    """Per-vertex T(i) from padded rows (single device, fits memory).

    For each vertex i and neighbor slot s: j = rows[i, s]; gather row_j and
    count |row_i ∩ row_j|. Padding slots gather row of the sentinel vertex —
    a zero-degree phantom row of sentinels — and contribute 0.
    """
    n, w = rows.shape
    # phantom row for the sentinel id so gathers are in-bounds
    rows_ext = torch.cat(
        [rows, torch.full((1, w), sentinel, dtype=rows.dtype,
                          device=rows.device)], dim=0
    )
    nbr_rows = rows_ext[rows.long()]  # [n, W, W] — rows of each neighbor
    rows_b = rows[:, None, :].expand(n, w, w)
    if method == "bsearch":
        flat_a = rows_b.reshape(n * w, w)
        flat_b = nbr_rows.reshape(n * w, w)
        cnt = count_bsearch_torch(flat_a, flat_b, sentinel).reshape(n, w)
    elif method == "pairwise":
        cnt = count_pairwise_torch(rows_b, nbr_rows, sentinel)
    else:
        raise ValueError(method)
    valid = rows < sentinel
    s = torch.where(valid, cnt, 0).sum(dim=1)
    return (s // 2).to(torch.int32)


def lcc_from_counts_torch(
    t: torch.Tensor, degrees: torch.Tensor
) -> torch.Tensor:
    """Eq. (2) in float32, as the epoch engine computes it."""
    deg = degrees.to(torch.float32)
    denom = deg * (deg - 1.0)
    return torch.where(denom > 0, 2.0 * t.to(torch.float32) / denom, 0.0)
