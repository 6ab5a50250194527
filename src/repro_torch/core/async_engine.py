"""Asynchronous distributed LCC engine (paper Alg. 3 + §III-A) on one device.

The p ranks of the 1D partition are logical: every per-rank array carries
the rank as its leading dimension ``[p, ...]`` on one torch device, and all
ranks advance through a round together in one batch: the round's
``p * e_chunk`` edge slots are flattened across ranks and walked in slabs
of at most ``_PAIR_SLAB_BYTES`` per gathered operand (``rows * W * 4``
bytes), so a small problem takes one gather, one count launch and one
accumulate per round for every rank, and a wide one a few, with the
temporaries bounded. The fetch buffer is ``p * p * S_max * W * 4`` bytes;
``n_rounds`` is the schedule knob that shrinks it. Per
round one all-to-all ships exactly the adjacency rows the static pull
schedule (``rma.build_sharded_problem``) resolved as remote+uncached; with
every rank on one device it is the block transpose
``got[dst, src] = to_send[src, dst]``. Round ``r+1``'s fetch is started
before round ``r``'s intersection — the paper's double buffering, kept here
as program order on one stream (the landing copy of round ``r`` comes
first, so only one in-flight fetch buffer is alive at a time).

Compute per edge: gather row_u (local) and row_v (local | cache | fetch
buffer — one combined gather), count |row_u ∩ row_v| with the regime-split
intersection, and accumulate into S(u) with an int32 ``index_add_``
(integer adds are exact in any order). LCC follows Eq. (2) in float32.

The combined row buffer is allocated once per epoch and its fetch region is
overwritten in place every round.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ops import intersect_count
from .intersect import count_bsearch_torch, regime_rule
from .rma import DeviceLCCProblem, ShardedLCCProblem

__all__ = ["lcc_pipelined", "run_distributed_lcc"]

METHODS = ("bsearch", "pairwise", "hybrid")

# most bytes one gathered operand (rows_a or rows_b) of a slab may take
_PAIR_SLAB_BYTES = 2 << 30


def _epoch(prob: DeviceLCCProblem, method: str):
    """One epoch over all rounds; returns device tensors (t, lcc)."""
    p, n_loc, n_rounds, s_max = prob.p, prob.n_loc, prob.n_rounds, prob.s_max
    sentinel = prob.sentinel
    e_chunk = prob.e_max // n_rounds
    rows_ext = prob.rows_ext  # [p, n_loc+1, W]
    dev = rows_ext.device
    w = rows_ext.shape[-1]
    c = prob.cache_rows.shape[0]
    rows_flat = rows_ext.reshape(p * (n_loc + 1), w)
    # first flat row of each rank: turns a rank-local row index into an
    # index of the flattened [p * rows, W] buffers (int64 for index_select)
    rank_base = torch.arange(p, device=dev, dtype=torch.int64)[:, None]
    local_base = rank_base * (n_loc + 1)

    def fetch(r: int) -> torch.Tensor:
        # rows each rank serves in round r -> one a2a -> rows it needs
        idx = prob.serve_idx[:, r].reshape(p, p * s_max) + local_base
        to_send = rows_flat.index_select(0, idx.reshape(-1))
        to_send = to_send.view(p, p, s_max, w)  # [src, dst, S_max, W]
        return to_send.transpose(0, 1)  # got[dst, src] = to_send[src, dst]

    def count(rows_a, rows_b, deg_a):
        if method == "bsearch":
            return count_bsearch_torch(rows_a, rows_b, sentinel)
        if method == "pairwise":
            return intersect_count(rows_a, rows_b, sentinel=sentinel)
        # hybrid: regime select per edge (Eq. 3 analogue)
        deg_b = (rows_b < sentinel).sum(-1, dtype=torch.int32)
        use_pw = regime_rule(deg_a, deg_b, rows_b.shape[-1])
        return torch.where(
            use_pw,
            intersect_count(rows_a, rows_b, sentinel=sentinel),
            count_bsearch_torch(rows_a, rows_b, sentinel),
        )

    deg_ext = torch.cat(
        [prob.degrees, prob.degrees.new_zeros((p, 1))], dim=1
    ).reshape(-1)

    # combined row-index space per rank: [local+phantom | cache | fetched]
    n_comb = n_loc + 1 + c + p * s_max
    combined = torch.empty((p, n_comb, w), dtype=rows_ext.dtype, device=dev)
    combined[:, : n_loc + 1] = rows_ext
    combined[:, n_loc + 1 : n_loc + 1 + c] = prob.cache_rows
    fetch_region = combined[:, n_loc + 1 + c :].view(p, p, s_max, w)
    combined_flat = combined.view(p * n_comb, w)
    comb_base = rank_base * n_comb

    acc = torch.zeros(p * (n_loc + 1), dtype=torch.int32, device=dev)
    slab = max(1, _PAIR_SLAB_BYTES // (4 * w))
    fetched_cur = fetch(0)
    for r in range(n_rounds):
        # land this round's rows, then — double buffering — start the next
        # round's fetch before this round's compute, so the exchange
        # precedes the intersection work.
        fetch_region.copy_(fetched_cur)
        fetched_cur = fetch(min(r + 1, n_rounds - 1))
        sl = slice(r * e_chunk, (r + 1) * e_chunk)
        eu = (prob.edge_u[:, sl] + local_base).reshape(-1)
        evc = (prob.edge_vc[:, sl] + comb_base).reshape(-1)
        msk = prob.edge_mask[:, sl].reshape(-1)
        for lo in range(0, eu.numel(), slab):
            eu_s = eu[lo : lo + slab]
            rows_a = rows_flat.index_select(0, eu_s)
            rows_b = combined_flat.index_select(0, evc[lo : lo + slab])
            cnt = count(rows_a, rows_b, deg_ext[eu_s])
            acc.index_add_(
                0, eu_s, torch.where(msk[lo : lo + slab], cnt, 0)
            )

    s = acc.view(p, n_loc + 1)[:, :n_loc]
    t = s // 2  # undirected: each neighbor-edge seen twice in S(i)
    deg = prob.degrees.to(torch.float32)
    denom = deg * (deg - 1.0)
    lcc = torch.where(denom > 0, 2.0 * t.to(torch.float32) / denom, 0.0)
    return t, lcc


def lcc_pipelined(
    prob: Union[ShardedLCCProblem, DeviceLCCProblem],
    device="cuda",
    *,
    method: str = "bsearch",
):
    """Run the engine; returns (t_per_vertex [p, n_loc] int32, lcc [p, n_loc]
    float32) as numpy. ``prob`` is the host problem (copied to ``device``
    first) or its ``to_device`` view, which must already lie on ``device``.
    """
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    dev = resolve_device(device)
    if isinstance(prob, ShardedLCCProblem):
        prob = prob.to_device(dev)
    elif prob.device.type != dev.type or (
        dev.index is not None and prob.device.index != dev.index
    ):
        raise ValueError(
            f"problem lies on {prob.device}, engine asked for {dev}"
        )
    t, lcc = _epoch(prob, method)
    return t.cpu().numpy(), lcc.cpu().numpy()


def run_distributed_lcc(
    csr,
    p: int,
    *,
    n_rounds: int = 4,
    cache_rows: int = 0,
    method: str = "bsearch",
    device="cuda",
):
    """End-to-end: partition + schedule + engine -> (t, lcc) global."""
    from .cache import build_static_degree_cache
    from .partition import partition_1d
    from .rma import build_sharded_problem

    dev = resolve_device(device)  # before the host schedule build
    cache = (
        build_static_degree_cache(csr.degrees, cache_rows)
        if cache_rows > 0
        else None
    )
    prob = build_sharded_problem(csr, p, n_rounds=n_rounds, cache=cache)
    t, lcc = lcc_pipelined(prob, dev, method=method)
    # unstack device-padded rows back to global vertex order
    t_g = np.zeros(csr.n, np.int64)
    lcc_g = np.zeros(csr.n, np.float64)
    part = partition_1d(csr.n, p)
    for k in range(p):
        lo, hi = part.lo(k), part.hi(k)
        t_g[lo:hi] = t[k, : hi - lo]
        lcc_g[lo:hi] = lcc[k, : hi - lo]
    return t_g, lcc_g
