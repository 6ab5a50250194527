"""R-MAT synthetic graph generator (paper §IV-A).

Parameters follow the paper: ``a=0.57, b=c=0.19, d=0.05``; a graph with
scale ``x`` and edge factor ``y`` has ``2**x`` vertices and ``2**(x+y)``
edges (the paper writes 2^x * y; Graph500 convention is EF*2^x edges —
we follow #edges = EF * 2**scale, matching Table II's S21/EF16 => 33.6M).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "rmat_edges",
    "rmat_graph",
    "rmat_stream",
    "rmat_adversarial_stream",
]

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


def rmat_stream(
    scale: int,
    edge_factor: int,
    *,
    batch_size: int,
    delete_frac: float = 0.0,
    seed: int = 0,
    shuffle: bool = True,
):
    """Yield ``EdgeBatch`` update batches replaying an R-MAT edge stream.

    The full R-MAT edge list (raw — duplicates and self-loops included, as
    a real ingest stream would carry them) arrives as insertions in
    ``batch_size``-op batches; with ``delete_frac > 0`` each batch also
    deletes that fraction of ops sampled from edges inserted by *earlier*
    batches (LiveJournal-style churn). Ops within a batch are shuffled so
    normalization sees interleaved inserts/deletes.
    """
    from ..streaming.updates import DELETE, INSERT, EdgeBatch

    edges = rmat_edges(scale, edge_factor, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if shuffle:
        rng.shuffle(edges, axis=0)
    inserted: list = []  # canonical tuples from prior batches
    pos = 0
    while pos < edges.shape[0]:
        ins = edges[pos : pos + batch_size]
        pos += ins.shape[0]
        n_del = int(delete_frac * ins.shape[0])
        if n_del and inserted:
            pick = rng.integers(0, len(inserted), size=min(n_del, len(inserted)))
            dels = np.array([inserted[i] for i in pick], np.int64)
        else:
            dels = np.zeros((0, 2), np.int64)
        u = np.concatenate([ins[:, 0], dels[:, 0]])
        v = np.concatenate([ins[:, 1], dels[:, 1]])
        op = np.concatenate(
            [
                np.full(ins.shape[0], INSERT, np.int8),
                np.full(dels.shape[0], DELETE, np.int8),
            ]
        )
        if shuffle:
            perm = rng.permutation(u.size)
            u, v, op = u[perm], v[perm], op[perm]
        mask = ins[:, 0] != ins[:, 1]
        lo = np.minimum(ins[mask, 0], ins[mask, 1])
        hi = np.maximum(ins[mask, 0], ins[mask, 1])
        inserted.extend(zip(lo.tolist(), hi.tolist()))
        yield EdgeBatch(u=u, v=v, op=op)


def rmat_adversarial_stream(
    scale: int,
    edge_factor: int,
    *,
    batch_size: int,
    delete_frac: float = 0.25,
    hub_frac: float = 0.01,
    seed: int = 0,
):
    """Hub-targeted churn: the adversarial case for degree-scored caches.

    Inserts replay the R-MAT stream like ``rmat_stream``, but every
    delete targets an edge incident to a *current hub* — one of the top
    ``hub_frac`` fraction of vertices by (tracked) degree. Power-law
    hubs are exactly the vertices the degree-scored caches pin and the
    static residency set is built from, so hub-incident deletes maximize
    (a) stale resident rows and (b) top-C membership drift — the rebuild
    policy of ``refresh_static_degree_cache`` under its worst-case
    stream. R-MAT also keeps re-inserting edges at the same hubs, so the
    degree ranking keeps churning in both directions.
    """
    from ..streaming.updates import DELETE, INSERT, EdgeBatch

    n = 1 << scale
    edges = rmat_edges(scale, edge_factor, seed=seed)
    rng = np.random.default_rng(seed + 1)
    rng.shuffle(edges, axis=0)
    deg = np.zeros(n, np.int64)  # tracked over our own insert/delete ops
    # present edges: growable [M] key array + alive mask (rows are never
    # removed, only flagged; compacted when mostly dead) + a key set for
    # O(1) membership — candidate selection stays vectorized numpy.
    pres_keys = np.zeros(0, np.int64)
    alive = np.zeros(0, bool)
    present_set: set = set()
    n_hubs = max(1, int(hub_frac * n))
    pos = 0
    while pos < edges.shape[0]:
        ins = edges[pos : pos + batch_size]
        pos += ins.shape[0]
        mask = ins[:, 0] != ins[:, 1]
        ins_keys = (
            np.minimum(ins[mask, 0], ins[mask, 1]) * n
            + np.maximum(ins[mask, 0], ins[mask, 1])
        )
        n_del = int(delete_frac * ins.shape[0])
        dels = np.zeros((0, 2), np.int64)
        if n_del and alive.any():
            hubs = np.argpartition(deg, -n_hubs)[-n_hubs:]
            hub_mask = np.isin(pres_keys // n, hubs) | np.isin(
                pres_keys % n, hubs
            )
            # exclude edges this batch's slice re-inserts: a delete and
            # an insert of the same edge in one shuffled batch resolves
            # last-op-wins downstream, which would desync the tracker
            cand = np.flatnonzero(
                alive & hub_mask & ~np.isin(pres_keys, ins_keys)
            )
            if cand.size:
                pick = rng.choice(
                    cand, size=min(n_del, cand.size), replace=False
                )
                alive[pick] = False
                keys = pres_keys[pick]
                dels = np.stack([keys // n, keys % n], axis=1)
                present_set.difference_update(keys.tolist())
                np.add.at(deg, dels.ravel(), -1)
        fresh = np.array(
            sorted({int(k) for k in ins_keys.tolist()} - present_set),
            np.int64,
        )
        if fresh.size:
            present_set.update(fresh.tolist())
            pres_keys = np.concatenate([pres_keys, fresh])
            alive = np.concatenate([alive, np.ones(fresh.size, bool)])
            np.add.at(deg, np.concatenate([fresh // n, fresh % n]), 1)
        if alive.size > 64 and np.count_nonzero(alive) < alive.size // 2:
            pres_keys, alive = pres_keys[alive], alive[alive]
        u = np.concatenate([ins[:, 0], dels[:, 0]])
        v = np.concatenate([ins[:, 1], dels[:, 1]])
        op = np.concatenate(
            [
                np.full(ins.shape[0], INSERT, np.int8),
                np.full(dels.shape[0], DELETE, np.int8),
            ]
        )
        perm = rng.permutation(u.size)
        yield EdgeBatch(u=u[perm], v=v[perm], op=op[perm])
