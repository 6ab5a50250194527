"""Vertex partitioning: the ownership contract every consumer shares.

Two partition families live here, both exposing the SAME contract (see
docs/partitioning.md for the canonical statement):

- ``owner(v)`` — vectorized owner rank per vertex id;
- ``lo(k)`` / ``hi(k)`` — rank ``k`` owns exactly the contiguous block
  ``[lo(k), hi(k))``; blocks tile ``[0, n)`` in rank order with no gaps
  (``hi(k) == lo(k + 1)``), so ``owner(v) == k  iff  lo(k) <= v < hi(k)``;
- ``sizes()`` — per-rank block sizes, ``sizes()[k] == hi(k) - lo(k)``;
- ``block`` — an upper bound on every rank's block size (consumers size
  dense per-rank buffers with it);
- ``route(v)`` — the rank that should *execute* work keyed by ``v``
  (query routing, worklist sharding by initiator). For ``Partition1D``
  this is always ``owner(v)``; a ``HubPartition`` spreads hub-keyed
  work round-robin so a hot hub does not pin one rank.

``Partition1D`` is the paper's §III-A scheme: ``V_k = { v_i : i in
((k-1)n/p, k*n/p] }`` — contiguous equal-size blocks, generalized to
``p`` not dividing ``n`` with ceil-sized blocks so the owner function
stays a closed form (needed device-side).

``HubPartition`` breaks the 1D scaling wall on scale-free graphs
(ROADMAP item 2) with the two remedies the related work names
(Sanders & Uhl, arXiv 2302.11443; Tom & Karypis, arXiv 1907.09575):

1. **balance-aware cuts** — block boundaries come from degree-weighted
   prefix sums instead of equal vertex counts, so per-rank *work*
   (edges, not vertices) balances;
2. **hub splitting** — rows with degree >= ``threshold`` are additionally
   sharded into ``p`` per-rank *fragments*: fragment ``k`` of a sorted
   row of degree ``d`` is the contiguous slice
   ``row[d*k//p : d*(k+1)//p]``. Fragments are disjoint and concatenate
   in rank order back to the original sorted row, so any intersection
   against a fragmented row reduces deterministically over fragment
   counts: ``|A ∩ B| = sum_k |A ∩ frag_k(B)|`` (integer, order-free).
   Remote readers gather a hub row as ``p - 1`` remote fragments plus
   their own local fragment instead of one whole-row get from a single
   owner — the serve load of a hot hub spreads evenly over all ranks.

Ownership stays contiguous either way, so ``local_block`` slicing, the
static schedule's ``[lo, hi)`` worklists, and the device tier's
per-rank exclusion ranges work unchanged on both families.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .csr import CSRGraph

__all__ = [
    "Partition1D",
    "HubPartition",
    "partition_1d",
    "partition_hub",
    "default_hub_threshold",
    "balanced_cuts",
    "local_block",
]


@dataclasses.dataclass
class Partition1D:
    """Contiguous ceil-sized blocks (paper §III-A).

    Contract invariants (shared with ``HubPartition``):
    ``owner(v) == k  iff  lo(k) <= v < hi(k)``; blocks tile ``[0, n)``
    in rank order; ``sizes()[k] == hi(k) - lo(k) <= block``.
    """

    n: int
    p: int

    @property
    def block(self) -> int:
        """Upper bound on any rank's block size (here: the exact size of
        every non-trailing block)."""
        return -(-self.n // self.p)  # ceil

    def owner(self, v):
        """Owner process of vertex v (vectorized)."""
        return np.minimum(
            np.asarray(v, np.int64) // self.block, self.p - 1
        ).astype(np.int32)

    def route(self, v) -> int:
        """Executing rank for work keyed by ``v`` — for 1D always the
        owner (scalar)."""
        return int(self.owner(int(v)))

    def lo(self, k: int) -> int:
        return min(k * self.block, self.n)

    def hi(self, k: int) -> int:
        return min((k + 1) * self.block, self.n)

    def sizes(self) -> np.ndarray:
        return np.array(
            [self.hi(k) - self.lo(k) for k in range(self.p)], np.int64
        )

    @property
    def has_hubs(self) -> bool:
        return False


def partition_1d(n: int, p: int) -> Partition1D:
    return Partition1D(n=n, p=p)


def default_hub_threshold(degrees: np.ndarray) -> int:
    """Degree above which a row counts as a hub: 4x the mean degree
    (at least 2). On flat-degree graphs nothing crosses it and the
    partition degenerates to balance-aware 1D; on scale-free graphs it
    captures the heavy tail that dominates serve traffic."""
    degrees = np.asarray(degrees)
    if degrees.size == 0:
        return 2
    return max(2, int(np.ceil(4.0 * float(degrees.mean()))))


def balanced_cuts(
    weights: np.ndarray, p: int
) -> np.ndarray:
    """Contiguous cut points ``[p + 1]`` splitting ``weights`` into p
    blocks of near-equal weight sum (``cuts[0] == 0``,
    ``cuts[p] == len(weights)``, non-decreasing). Deterministic:
    boundary k lands at the first prefix position reaching
    ``k/p`` of the total weight."""
    w = np.asarray(weights, np.float64)
    n = w.size
    prefix = np.concatenate([[0.0], np.cumsum(w)])
    total = prefix[-1]
    if n == 0 or total <= 0:
        # degenerate: equal vertex counts (matches 1D for empty graphs)
        return np.minimum(
            np.arange(p + 1, dtype=np.int64) * (-(-n // max(p, 1))), n
        )
    targets = np.arange(1, p, dtype=np.float64) * (total / p)
    interior = np.searchsorted(prefix, targets, side="left")
    cuts = np.concatenate([[0], interior, [n]]).astype(np.int64)
    return np.maximum.accumulate(np.clip(cuts, 0, n))


@dataclasses.dataclass
class HubPartition:
    """Balance-aware contiguous ownership + degree-threshold hub
    splitting. Satisfies the same ``owner()/lo()/hi()/sizes()/block``
    contract as ``Partition1D`` (see the module docstring), with two
    additions:

    - ``hubs`` (sorted ids, degree >= ``threshold`` at build time) are
      transport-fragmented: every rank serves fragment
      ``row[d*k//p : d*(k+1)//p]`` of each hub row, so a remote hub
      read gathers fragments from all ranks instead of hammering the
      single owner (``fragment`` / ``fragment_sizes`` define the split;
      the reduction over fragment counts is a plain integer sum);
    - ``route(v)`` spreads hub-keyed work round-robin by hub position,
      so hot queries stop pinning the hub's home rank.

    ``cuts`` is mutable *in place* on purpose: the online migration path
    (``core.repartition``) moves boundaries while every consumer keeps
    holding this same object — ``owner()`` answers change atomically for
    all of them.
    """

    n: int
    p: int
    cuts: np.ndarray  # [p + 1] int64, cuts[0] == 0, cuts[p] == n
    hubs: np.ndarray  # sorted int64 hub vertex ids
    threshold: int

    def __post_init__(self):
        self.cuts = np.asarray(self.cuts, np.int64)
        self.hubs = np.asarray(self.hubs, np.int64)
        assert self.cuts.shape == (self.p + 1,), self.cuts.shape
        assert self.cuts[0] == 0 and self.cuts[-1] == self.n
        assert bool(np.all(np.diff(self.cuts) >= 0)), "cuts must ascend"

    @property
    def block(self) -> int:
        """Upper bound on any rank's block size (the largest block)."""
        return int(np.max(np.diff(self.cuts), initial=0))

    def owner(self, v):
        """Owner process of vertex v (vectorized): the rank whose
        ``[lo, hi)`` block contains it."""
        idx = np.searchsorted(self.cuts, np.asarray(v, np.int64),
                              side="right") - 1
        return np.clip(idx, 0, self.p - 1).astype(np.int32)

    def lo(self, k: int) -> int:
        return int(self.cuts[k])

    def hi(self, k: int) -> int:
        return int(self.cuts[k + 1])

    def sizes(self) -> np.ndarray:
        return np.diff(self.cuts).astype(np.int64)

    # ---------------- hub splitting ----------------
    @property
    def has_hubs(self) -> bool:
        return self.hubs.size > 0

    def is_hub(self, v) -> np.ndarray:
        """Vectorized membership in the hub set."""
        v = np.asarray(v, np.int64)
        if self.hubs.size == 0:
            return np.zeros(v.shape, bool)
        idx = np.minimum(
            np.searchsorted(self.hubs, v), self.hubs.size - 1
        )
        return self.hubs[idx] == v

    def route(self, v) -> int:
        """Executing rank for work keyed by ``v`` (scalar): hubs spread
        round-robin by hub position, everything else runs at its
        owner. Routing never changes answers — any rank can read any
        row through the transport — only where the read-side load
        lands."""
        v = int(v)
        i = int(np.searchsorted(self.hubs, v))
        if i < self.hubs.size and int(self.hubs[i]) == v:
            return i % self.p
        return int(self.owner(v))

    def fragment_bounds(self, d: int, k: int) -> Tuple[int, int]:
        """Slice bounds of rank ``k``'s fragment of a row of degree
        ``d``: ``[d*k//p, d*(k+1)//p)``. Fragments are disjoint,
        contiguous, and concatenate in rank order to the full row."""
        return d * k // self.p, d * (k + 1) // self.p

    def fragment(self, row: np.ndarray, k: int) -> np.ndarray:
        a, b = self.fragment_bounds(int(row.size), k)
        return row[a:b]

    def fragment_sizes(self, d: int) -> np.ndarray:
        """Per-rank fragment sizes for a row of degree ``d`` (sums to
        ``d``; the deterministic split both the transport model and the
        SPMD collective charge from)."""
        edges = (int(d) * np.arange(self.p + 1, dtype=np.int64)) // self.p
        return np.diff(edges)

    def refresh_hubs(
        self, degrees: np.ndarray, *, threshold: Optional[int] = None
    ) -> int:
        """Recompute the hub set (and, with ``threshold=None``, the
        threshold itself) against a drifted degree sequence; returns the
        new hub count. Batch-boundary only, like ``cuts`` mutation — but
        always *safe*: hub membership only changes when the row's degree
        changed, and every row mutation already invalidates cached
        copies on both tiers, while fragments of an unchanged row are
        byte-identical under the same ``p``."""
        degrees = np.asarray(degrees, np.int64)
        assert degrees.size == self.n, (degrees.size, self.n)
        if threshold is None:
            threshold = default_hub_threshold(degrees)
        self.threshold = int(threshold)
        self.hubs = np.flatnonzero(
            degrees >= self.threshold
        ).astype(np.int64)
        return int(self.hubs.size)


def partition_hub(
    degrees: np.ndarray,
    p: int,
    *,
    threshold: Optional[int] = None,
) -> HubPartition:
    """Build a hub-aware partition from the current degree sequence.

    Cut boundaries balance the degree-*weighted* prefix (weight
    ``1 + min(deg, threshold)``): a hub's serve cost above the threshold
    is spread over all ranks by fragmentation, so only the clipped part
    loads its home rank — charging the full degree would starve hub-
    heavy ranks of vertices for no balance gain."""
    degrees = np.asarray(degrees, np.int64)
    n = int(degrees.size)
    p = int(p)
    if threshold is None:
        threshold = default_hub_threshold(degrees)
    threshold = int(threshold)
    hubs = np.flatnonzero(degrees >= threshold).astype(np.int64)
    weights = 1 + np.minimum(degrees, threshold)
    cuts = balanced_cuts(weights, p)
    return HubPartition(
        n=n, p=p, cuts=cuts, hubs=hubs, threshold=threshold
    )


@dataclasses.dataclass
class LocalBlock:
    """Process-local CSR slab: rows [lo, hi) of the global CSR.

    ``offsets`` is re-based to 0; adjacency ids stay GLOBAL (remote reads
    need global ids — paper Fig. 2 stores global ids too).
    """

    rank: int
    lo: int
    hi: int
    offsets: np.ndarray  # [hi-lo+1] int64, local base
    adjacencies: np.ndarray  # int32 global ids

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    def row(self, v_global: int) -> np.ndarray:
        v = v_global - self.lo
        return self.adjacencies[self.offsets[v] : self.offsets[v + 1]]

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)


def local_block(csr: CSRGraph, part, rank: int) -> LocalBlock:
    """Slice rank ``rank``'s owned block out of the global CSR — works
    for any partition honoring the contiguous ``lo/hi`` contract."""
    lo, hi = part.lo(rank), part.hi(rank)
    a, b = csr.offsets[lo], csr.offsets[hi]
    return LocalBlock(
        rank=rank,
        lo=lo,
        hi=hi,
        offsets=(csr.offsets[lo : hi + 1] - a).astype(np.int64),
        adjacencies=csr.adjacencies[a:b].copy(),
    )


def all_blocks(csr: CSRGraph, p: int) -> List[LocalBlock]:
    part = partition_1d(csr.n, p)
    return [local_block(csr, part, k) for k in range(p)]
