"""DynamicCSR: a CSR graph plus delta buffers, with periodic compaction.

The static pipeline's ``CSRGraph`` is immutable (two packed arrays). A
live graph absorbs updates far faster than it can afford full rebuilds,
so ``DynamicCSR`` keeps

- ``base``     — the last compacted ``CSRGraph`` (sorted rows), and
- ``_added``   — per-vertex sorted arrays of neighbors inserted since,
- ``_removed`` — per-vertex sorted arrays of base neighbors deleted since.

``row(v)`` merges the three on demand (sorted, deduplicated — the same
invariants every intersection kernel relies on). ``compact()`` folds the
deltas back into a fresh ``CSRGraph``; ``maybe_compact()`` triggers when
the delta exceeds a configurable fraction of the base edges, which keeps
merged-row reads amortized O(deg).

Mutations and membership queries are grouped by endpoint vertex: a batch
touching a row pays one sorted merge (or one vectorized binary search)
for that row, not one ``np.insert``/probe per edge — the batch cost is
O(sum of touched-row degrees), independent of how the batch's edges are
ordered.

Invariants (matching ``core/csr.py``):
- vertices are ids in ``[0, n)``; rows sorted ascending, deduplicated,
  loop-free; both directions stored for undirected edges.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from ..core.csr import CSRGraph, from_edges

__all__ = ["DynamicCSR"]


def _in_sorted(sorted_arr: Optional[np.ndarray], values: np.ndarray) -> np.ndarray:
    """Membership mask of ``values`` in the sorted array (vectorized)."""
    values = np.asarray(values)
    if sorted_arr is None or sorted_arr.size == 0:
        return np.zeros(values.shape, bool)
    idx = np.searchsorted(sorted_arr, values)
    idx = np.minimum(idx, sorted_arr.size - 1)
    return sorted_arr[idx] == values


def _ragged_membership(
    flat: np.ndarray, lo: np.ndarray, hi: np.ndarray, vals: np.ndarray
) -> np.ndarray:
    """Membership of ``vals[i]`` in the sorted slice ``flat[lo[i]:hi[i]]``.

    One lock-step vectorized binary search over all queries at once
    (O(Q log max_row) numpy steps, no Python loop per row) — the ragged
    row boundaries ride along as per-query [lo, hi) windows."""
    if flat.size == 0:
        return np.zeros(vals.shape, bool)
    lo = np.asarray(lo, np.int64).copy()
    hi0 = np.asarray(hi, np.int64)
    hi = hi0.copy()
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) >> 1
        fv = flat[np.where(active, mid, 0)]
        go_right = active & (fv < vals)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    found = lo < hi0  # insertion point inside the window
    return found & (flat[np.where(found, lo, 0)] == vals)


def _group_by_vertex(
    a: np.ndarray, b: np.ndarray
) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yield ``(u, vs, positions)`` per distinct endpoint ``u`` of the
    directed pairs ``(a[i], b[i])`` — one group per touched row."""
    order = np.argsort(a, kind="stable")
    a_s, b_s = a[order], b[order]
    starts = np.flatnonzero(np.r_[True, a_s[1:] != a_s[:-1]])
    ends = np.r_[starts[1:], a_s.size]
    for s, e in zip(starts, ends):
        yield int(a_s[s]), b_s[s:e], order[s:e]


class DynamicCSR:
    def __init__(self, base: CSRGraph, *, compact_threshold: float = 0.25):
        self.base = base
        self.n = base.n
        self.compact_threshold = float(compact_threshold)
        self._added: Dict[int, np.ndarray] = {}
        self._removed: Dict[int, np.ndarray] = {}  # sorted int64 per vertex
        self._degree = base.degrees.copy()
        self._delta_edges = 0  # directed insert+delete entries outstanding
        self.n_compactions = 0
        self.n_mutations = 0  # monotone: bumps on every effective batch

    # ---------------- constructors ----------------
    @staticmethod
    def from_csr(csr: CSRGraph, *, compact_threshold: float = 0.25) -> "DynamicCSR":
        return DynamicCSR(csr, compact_threshold=compact_threshold)

    @staticmethod
    def empty(n: int, *, compact_threshold: float = 0.25) -> "DynamicCSR":
        base = CSRGraph(
            offsets=np.zeros(n + 1, np.int64),
            adjacencies=np.zeros((0,), np.int32),
            n=n,
        )
        return DynamicCSR(base, compact_threshold=compact_threshold)

    @classmethod
    def from_reference(cls, store) -> "DynamicCSR":
        """Copy any store that carries the reference's attributes (the
        base CSR, the per-vertex ``_added``/``_removed`` delta tables,
        degrees and counters) — duck-typed, so two engines can start
        from the same mid-stream state."""
        out = cls(
            CSRGraph.from_reference(store.base),
            compact_threshold=float(store.compact_threshold),
        )
        out._added = {
            int(v): np.array(a, np.int64) for v, a in store._added.items()
        }
        out._removed = {
            int(v): np.array(a, np.int64) for v, a in store._removed.items()
        }
        out._degree = np.array(store._degree, copy=True)
        out._delta_edges = int(store._delta_edges)
        out.n_compactions = int(store.n_compactions)
        out.n_mutations = int(store.n_mutations)
        return out

    # ---------------- queries ----------------
    @property
    def m(self) -> int:
        """Number of stored (directed) edges."""
        return int(self._degree.sum())

    @property
    def degrees(self) -> np.ndarray:
        return self._degree

    def degree(self, v: int) -> int:
        return int(self._degree[v])

    @property
    def max_degree(self) -> int:
        return int(self._degree.max()) if self.n else 0

    @property
    def delta_edges(self) -> int:
        return self._delta_edges

    def row(self, v: int) -> np.ndarray:
        """Merged sorted adjacency row of ``v`` (int32)."""
        r = self.base.row(v)
        rem = self._removed.get(v)
        if rem is not None and rem.size:
            r = r[~_in_sorted(rem, r)]
        add = self._added.get(v)
        if add is not None and add.size:
            r = np.sort(np.concatenate([r.astype(np.int64), add])).astype(
                np.int32
            )
        return r

    def has_edge(self, u: int, v: int) -> bool:
        return bool(self.has_edges(np.array([u]), np.array([v]))[0])

    def has_edges(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized membership: is (u[i], v[i]) currently an edge?

        Fully vectorized — one lock-step binary search over the base CSR
        (per-query [offset, offset+deg) windows) plus one over the
        concatenated delta buffers of the touched rows; the only Python
        iteration left is a dict lookup per distinct touched vertex."""
        u = np.asarray(u, np.int64).ravel()
        v = np.asarray(v, np.int64).ravel()
        if u.size == 0:
            return np.zeros(u.shape, bool)
        base = self.base
        in_base = _ragged_membership(
            base.adjacencies, base.offsets[u], base.offsets[u + 1], v
        )
        if not self._added and not self._removed:
            return in_base
        uu, inv = np.unique(u, return_inverse=True)
        in_add = self._delta_membership(self._added, uu, inv, v)
        in_rem = self._delta_membership(self._removed, uu, inv, v)
        return in_add | (in_base & ~in_rem)

    def _delta_membership(
        self, table: Dict[int, np.ndarray], uu, inv, v
    ) -> np.ndarray:
        """Membership of ``v[i]`` in ``table[u[i]]`` (u factored as
        ``uu[inv]``): concatenate the touched rows' delta arrays once,
        then one ragged binary search over all queries."""
        arrs = [table.get(int(x)) for x in uu]
        sizes = np.array(
            [0 if a is None else a.size for a in arrs], np.int64
        )
        if not sizes.any():
            return np.zeros(v.shape, bool)
        offs = np.zeros(uu.size + 1, np.int64)
        np.cumsum(sizes, out=offs[1:])
        flat = np.concatenate(
            [a for a in arrs if a is not None and a.size]
        )
        return _ragged_membership(flat, offs[:-1][inv], offs[1:][inv], v)

    # ---------------- mutation ----------------
    def insert_edges(self, pairs: np.ndarray) -> None:
        """Insert canonical (u < v) edges known to be absent (both dirs)."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        if pairs.shape[0] == 0:
            return
        self.n_mutations += 1
        a = np.concatenate([pairs[:, 0], pairs[:, 1]])
        b = np.concatenate([pairs[:, 1], pairs[:, 0]])
        for u, vs, _ in _group_by_vertex(a, b):
            self._insert_row(u, np.sort(vs))
            self._degree[u] += vs.size

    def delete_edges(self, pairs: np.ndarray) -> None:
        """Delete canonical (u < v) edges known to be present (both dirs)."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        if pairs.shape[0] == 0:
            return
        self.n_mutations += 1
        a = np.concatenate([pairs[:, 0], pairs[:, 1]])
        b = np.concatenate([pairs[:, 1], pairs[:, 0]])
        for u, vs, _ in _group_by_vertex(a, b):
            self._delete_row(u, np.sort(vs))
            self._degree[u] -= vs.size

    def _insert_row(self, u: int, vs: np.ndarray) -> None:
        """Insert the sorted distinct neighbors ``vs`` into row ``u``."""
        rem = self._removed.get(u)
        if rem is not None and rem.size:
            # re-inserts of base edges deleted earlier cancel the removal
            cancel = _in_sorted(rem, vs)
            n_cancel = int(cancel.sum())
            if n_cancel:
                rem = rem[~_in_sorted(vs[cancel], rem)]
                if rem.size:
                    self._removed[u] = rem
                else:
                    del self._removed[u]
                self._delta_edges -= n_cancel
                vs = vs[~cancel]
        if vs.size:
            add = self._added.get(u)
            if add is not None and add.size:
                vs = np.sort(np.concatenate([add, vs]))
            self._added[u] = vs
            self._delta_edges += int(vs.size - (0 if add is None else add.size))

    def _delete_row(self, u: int, vs: np.ndarray) -> None:
        """Delete the sorted distinct neighbors ``vs`` from row ``u``."""
        add = self._added.get(u)
        in_add = _in_sorted(add, vs)
        n_in_add = int(in_add.sum())
        if n_in_add:
            add = add[~_in_sorted(vs[in_add], add)]
            if add.size:
                self._added[u] = add
            else:
                del self._added[u]
            self._delta_edges -= n_in_add  # cancels outstanding inserts
        vs = vs[~in_add]
        if vs.size:
            rem = self._removed.get(u)
            if rem is not None and rem.size:
                vs = np.sort(np.concatenate([rem, vs]))
            self._removed[u] = vs
            self._delta_edges += int(
                vs.size - (0 if rem is None else rem.size)
            )

    # ---------------- compaction ----------------
    def to_csr(self) -> CSRGraph:
        """Compacted snapshot (does not mutate the store)."""
        if not self._added and not self._removed:
            return self.base
        rows = [self.row(v) for v in range(self.n)]
        counts = np.array([r.size for r in rows], np.int64)
        offsets = np.zeros(self.n + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        adj = (
            np.concatenate(rows).astype(np.int32)
            if counts.sum()
            else np.zeros((0,), np.int32)
        )
        return CSRGraph(offsets=offsets, adjacencies=adj, n=self.n)

    def compact(self) -> CSRGraph:
        """Fold deltas into a fresh base CSR; returns the new base."""
        self.base = self.to_csr()
        self._added.clear()
        self._removed.clear()
        self._delta_edges = 0
        self.n_compactions += 1
        assert np.array_equal(self.base.degrees, self._degree)
        return self.base

    def maybe_compact(self) -> bool:
        """Compact when the outstanding delta exceeds the threshold
        fraction of the base edge count."""
        base_m = max(self.base.m, 1)
        if self._delta_edges > self.compact_threshold * base_m:
            self.compact()
            return True
        return False

    # ---------------- device layout ----------------
    def padded_rows(
        self,
        vertices: Iterable[int],
        width: Optional[int] = None,
        *,
        sentinel: Optional[int] = None,
    ) -> np.ndarray:
        """Padded ``[len(vertices), width]`` sorted row matrix (cf.
        ``core.csr.to_padded_rows``), built from the merged rows."""
        vs = np.asarray(list(vertices), np.int64)
        w = int(width if width is not None else max(self.max_degree, 1))
        sent = int(self.n if sentinel is None else sentinel)
        out = np.full((vs.size, w), sent, np.int32)
        for i, v in enumerate(vs):
            r = self.row(int(v))[:w]
            out[i, : r.size] = r
        return out
