"""Edge-update batches for the streaming subsystem.

An ``EdgeBatch`` is an ordered sequence of (u, v, op) tuples. Semantics:
ops apply in order, but triangle counts are only observed at batch
boundaries, so only the *net* effect of the batch matters. Normalization
canonicalizes endpoints (u < v, self-loops dropped), keeps the last op per
edge, and splits the result against the current store state into

- effective inserts: net-INSERT edges not currently in the graph,
- effective deletes: net-DELETE edges currently in the graph,
- no-ops: duplicate inserts, deletes of absent edges, self-loops, and
  insert+delete pairs that cancel within the batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["INSERT", "DELETE", "EdgeBatch", "normalize_batch"]

INSERT = 1
DELETE = -1


@dataclasses.dataclass
class EdgeBatch:
    """One update batch: parallel arrays of endpoints and ops (+1/-1)."""

    u: np.ndarray  # [B] int64
    v: np.ndarray  # [B] int64
    op: np.ndarray  # [B] int8, INSERT or DELETE

    def __post_init__(self):
        self.u = np.asarray(self.u, np.int64).ravel()
        self.v = np.asarray(self.v, np.int64).ravel()
        self.op = np.asarray(self.op, np.int8).ravel()
        assert self.u.shape == self.v.shape == self.op.shape

    @property
    def size(self) -> int:
        return int(self.u.shape[0])

    @staticmethod
    def inserts(edges: np.ndarray) -> "EdgeBatch":
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        return EdgeBatch(
            u=edges[:, 0],
            v=edges[:, 1],
            op=np.full(edges.shape[0], INSERT, np.int8),
        )

    @staticmethod
    def deletes(edges: np.ndarray) -> "EdgeBatch":
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        return EdgeBatch(
            u=edges[:, 0],
            v=edges[:, 1],
            op=np.full(edges.shape[0], DELETE, np.int8),
        )


def normalize_batch(batch: EdgeBatch, store) -> tuple[np.ndarray, np.ndarray, int]:
    """Net effect of ``batch`` against ``store`` (a ``DynamicCSR``).

    Returns ``(ins, del, n_noop)`` where ``ins``/``del`` are ``[K, 2]``
    int64 canonical (u < v) edge arrays, disjoint, with every insert
    currently absent from the store and every delete currently present.
    """
    u, v, op = batch.u, batch.v, batch.op
    keep = u != v  # self-loops never change triangle counts
    u, v, op = u[keep], v[keep], op[keep]
    n_noop = int(batch.size - u.size)
    if u.size == 0:
        z = np.zeros((0, 2), np.int64)
        return z, z, n_noop
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    key = lo * np.int64(store.n) + hi
    # last op per edge wins: stable unique on reversed order
    _, first_rev = np.unique(key[::-1], return_index=True)
    last = key.size - 1 - first_rev
    n_noop += int(key.size - last.size)
    lo, hi, op = lo[last], hi[last], op[last]
    present = store.has_edges(lo, hi)
    ins_mask = (op == INSERT) & ~present
    del_mask = (op == DELETE) & present
    n_noop += int(lo.size - ins_mask.sum() - del_mask.sum())
    ins = np.stack([lo[ins_mask], hi[ins_mask]], axis=1)
    dele = np.stack([lo[del_mask], hi[del_mask]], axis=1)
    return ins, dele, n_noop
