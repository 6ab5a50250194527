"""CSR graph representation (paper §II-B).

The paper stores each process's partition as two arrays, ``offsets`` and
``adjacencies`` (Fig. 2). We keep the same two-array format host-side
(numpy, exact) and provide padded device layouts for the torch engines.

Conventions
-----------
- vertices are ``int32`` ids in ``[0, n)``; the sentinel id ``n`` pads rows
  (it sorts *after* every real id, so padded rows stay sorted).
- adjacency rows are sorted ascending, deduplicated, loop-free.
- undirected graphs store both directions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CSRGraph",
    "from_edges",
    "remove_low_degree",
    "random_relabel",
    "to_padded_rows",
    "rows_to_bitmap_words",
]


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR graph. ``offsets`` has length ``n + 1``."""

    offsets: np.ndarray  # int64 [n+1]
    adjacencies: np.ndarray  # int32 [m]
    n: int

    @property
    def m(self) -> int:
        return int(self.adjacencies.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    @property
    def max_degree(self) -> int:
        d = self.degrees
        return int(d.max()) if d.size else 0

    @classmethod
    def from_reference(cls, obj) -> "CSRGraph":
        """Copy any object that carries ``offsets``, ``adjacencies`` and
        ``n`` (duck-typed — e.g. the reference package's ``CSRGraph``)."""
        return cls(
            offsets=np.array(obj.offsets, np.int64),
            adjacencies=np.array(obj.adjacencies, np.int32),
            n=int(obj.n),
        )

    def row(self, v: int) -> np.ndarray:
        return self.adjacencies[self.offsets[v] : self.offsets[v + 1]]

    def csr_nbytes(self) -> int:
        """Size of the CSR representation (paper Table II reports this)."""
        return self.offsets.nbytes + self.adjacencies.nbytes

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) arrays, one entry per stored (directed) edge."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        return src, self.adjacencies.astype(np.int32)


def from_edges(
    edges: np.ndarray, n: int, *, undirected: bool = True
) -> CSRGraph:
    """Build a CSR graph from an ``[E, 2]`` edge array.

    Self-loops are dropped and multi-edges deduplicated (paper §II-A
    considers simple graphs). For ``undirected`` both directions are stored.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    mask = edges[:, 0] != edges[:, 1]
    edges = edges[mask]
    if undirected and edges.size:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    if edges.size:
        # dedup via linearized key
        key = edges[:, 0] * n + edges[:, 1]
        key = np.unique(key)
        src = (key // n).astype(np.int64)
        dst = (key % n).astype(np.int32)
    else:
        src = np.zeros((0,), np.int64)
        dst = np.zeros((0,), np.int32)
    counts = np.bincount(src, minlength=n).astype(np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    # unique(key) is sorted, so rows come out sorted ascending.
    return CSRGraph(offsets=offsets, adjacencies=dst, n=n)


def remove_low_degree(csr: CSRGraph) -> Tuple[CSRGraph, np.ndarray]:
    """Drop vertices with degree < 2 (paper §II-B: they close no triangle).

    Single pass, as in the paper (not an iterative 2-core). Returns the
    filtered graph and ``keep_ids`` mapping new ids -> old ids.
    """
    deg = csr.degrees
    keep = np.flatnonzero(deg >= 2)
    if keep.size == csr.n:
        return csr, np.arange(csr.n, dtype=np.int64)
    old_to_new = np.full(csr.n + 1, -1, np.int64)
    old_to_new[keep] = np.arange(keep.size)
    rows = []
    for v in keep:
        r = old_to_new[csr.row(v)]
        rows.append(r[r >= 0])
    counts = np.array([r.size for r in rows], np.int64)
    offsets = np.zeros(keep.size + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    adj = (
        np.concatenate(rows).astype(np.int32)
        if rows
        else np.zeros((0,), np.int32)
    )
    out = CSRGraph(offsets=offsets, adjacencies=adj, n=int(keep.size))
    return out, keep.astype(np.int64)


def random_relabel(csr: CSRGraph, seed: int = 0) -> CSRGraph:
    """Random permutation of vertex ids (paper §II-B: avoids assigning all
    high-degree vertices of a degree-ordered input to one process)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(csr.n).astype(np.int64)  # old -> new
    inv = np.empty_like(perm)
    inv[perm] = np.arange(csr.n)
    counts = csr.degrees[inv]
    offsets = np.zeros(csr.n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    adj = np.empty(csr.m, np.int32)
    for new_v in range(csr.n):
        old_v = inv[new_v]
        r = perm[csr.row(old_v)]
        r.sort()
        adj[offsets[new_v] : offsets[new_v + 1]] = r
    return CSRGraph(offsets=offsets, adjacencies=adj, n=csr.n)


def to_padded_rows(
    csr: CSRGraph,
    width: Optional[int] = None,
    *,
    sentinel: Optional[int] = None,
    vertices: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Padded ``[n, width]`` row matrix, rows sorted, padded with sentinel.

    The sentinel defaults to ``n`` so padded rows remain sorted and
    searchsorted/membership tests never match padding.
    """
    width = int(width if width is not None else max(csr.max_degree, 1))
    sent = int(csr.n if sentinel is None else sentinel)
    vs = (
        np.arange(csr.n, dtype=np.int64)
        if vertices is None
        else np.asarray(vertices, np.int64)
    )
    out = np.full((vs.size, width), sent, np.int32)
    for i, v in enumerate(vs):
        r = csr.row(int(v))[:width]
        out[i, : r.size] = r
    return out


def rows_to_bitmap_words(
    rows: np.ndarray, n_bits: int, *, lo: int = 0
) -> np.ndarray:
    """Pack padded sorted rows into uint32 bitmap words over [lo, lo+n_bits).

    Elements outside the range (including sentinel padding) are dropped.
    Returns ``[rows.shape[0], ceil(n_bits/32)]`` uint32.
    """
    rows = np.asarray(rows)
    e, _ = rows.shape
    n_words = (n_bits + 31) // 32
    out = np.zeros((e, n_words), np.uint32)
    rel = rows.astype(np.int64) - lo
    valid = (rel >= 0) & (rel < n_bits)
    ei, si = np.nonzero(valid)
    bit = rel[ei, si]
    np.bitwise_or.at(out, (ei, bit // 32), (np.uint32(1) << (bit % 32).astype(np.uint32)))
    return out
