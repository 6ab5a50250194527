"""Asynchronous distributed LCC engine (paper Alg. 3 + §III-A) on one device.

The p ranks of the 1D partition are logical: every per-rank array carries
the rank as its leading dimension ``[p, ...]`` on one torch device, and all
ranks advance through a round together. Per round one all-to-all ships
exactly the adjacency rows the static pull schedule
(``rma.build_sharded_problem``) resolved as remote+uncached; with every rank
on one device it is the block transpose ``got[dst, src] = to_send[src,
dst]``.

``_epoch_acc`` (the engine; ``kernels/epoch_count.py``) moves no padded row:

- per epoch, ``epoch_index`` makes the valid length of every pulled row and
  its offset in a packed landing buffer (one gather of the degrees through
  ``serve_idx`` and one ``cumsum``), and the valid length of every cache row;
- per round, ``epoch_land`` copies the valid prefix of each real pulled row
  into the landing buffer (the exchange: exactly the ids an RMA get moves),
  and ``epoch_count`` counts every edge slot of the round by index — u's row
  from the problem's ragged row store, v's from the store, the cache rows or
  the landing by its combined index, each with its valid length — and adds
  the count into S(u) with an int32 atomic add (integer adds are exact in
  any order).

Two landing buffers alternate: round ``r+1``'s landing is enqueued before
round ``r``'s count, the paper's double buffering kept as program order on
one stream. On a card both are hand-written CUDA kernels and nothing in the
rounds loop waits for the device; the first sync is the final ``.cpu()``. On
the CPU the same rounds run through the kernels' plain versions.

Each phase of an epoch is a span of ``obs.trace`` (``lcc.epoch`` over the
call; inside it ``lcc.index``, one ``lcc.round`` a round, ``lcc.scores`` and
``lcc.to_host``): no-ops unless a tracer is installed or ``torch.profiler``
records, where they name the host's phase beside the device's work.

``_epoch_plain_acc`` (``plain=True``) is the padded route the engine is held
against, for small problems: the store padded to W (``rows_ext``, built on
demand), and per round the fetched rows copied, at full width W, into a
combined ``[local | cache | fetched]`` buffer, and the round's edge slots
are walked in slabs of at most ``_PAIR_SLAB_BYTES`` per gathered operand
(``rows * W * 4`` bytes), each slab gathered whole, counted by
``count_bsearch_torch`` / ``count_pairwise_torch`` and accumulated by
``index_add_``. LCC follows Eq. (2) in float32 on both routes.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import epoch_count as ec
from ..obs import trace as obs_trace
from .intersect import count_bsearch_torch, count_pairwise_torch, regime_rule
from .rma import ID_BYTES, DeviceLCCProblem, ShardedLCCProblem

__all__ = ["lcc_pipelined", "run_distributed_lcc"]

METHODS = ("bsearch", "pairwise", "hybrid")

# most bytes one gathered operand (rows_a or rows_b) of a slab may take on
# the plain route
_PAIR_SLAB_BYTES = 2 << 30


def _epoch_acc(prob: DeviceLCCProblem, method: str) -> torch.Tensor:
    """One epoch over all rounds by index; returns S, int32 ``[p * (n_loc +
    1)]`` (the phantom row of each rank stays 0)."""
    dev = prob.device
    with obs_trace.span("lcc.index"):
        index = ec.epoch_index(prob)
        acc = torch.zeros(prob.p * (prob.n_loc + 1), dtype=torch.int32,
                          device=dev)
        landing = [torch.empty(max(1, prob.land_ids), dtype=torch.int32,
                               device=dev) for _ in range(2)]
        ec.epoch_land(prob, index, 0, landing[0])
    for r in range(prob.n_rounds):
        with obs_trace.span("lcc.round", r=r):
            # double buffering: land the next round before this round's
            # count
            if r + 1 < prob.n_rounds:
                ec.epoch_land(prob, index, r + 1, landing[(r + 1) % 2])
            ec.epoch_count(prob, index, r, landing[r % 2], acc,
                           method=method)
    return acc


def _epoch_plain_acc(prob: DeviceLCCProblem, method: str) -> torch.Tensor:
    """The padded route: whole rows gathered, counted in plain torch."""
    p, n_loc, n_rounds, s_max = prob.p, prob.n_loc, prob.n_rounds, prob.s_max
    sentinel = prob.sentinel
    e_chunk = prob.e_max // n_rounds
    rows_ext = prob.rows_ext  # [p, n_loc+1, W], padded from the store
    dev = rows_ext.device
    w = prob.width
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
            return count_pairwise_torch(rows_a, rows_b, sentinel)
        # hybrid: regime select per edge (Eq. 3 analogue)
        deg_b = (rows_b < sentinel).sum(-1, dtype=torch.int32)
        use_pw = regime_rule(deg_a, deg_b, rows_b.shape[-1])
        return torch.where(
            use_pw,
            count_pairwise_torch(rows_a, rows_b, sentinel),
            count_bsearch_torch(rows_a, rows_b, sentinel),
        )

    with obs_trace.span("lcc.index"):
        deg_ext = torch.cat(
            [prob.degrees, prob.degrees.new_zeros((p, 1))], dim=1
        ).reshape(-1)

        # combined row-index space per rank: [local+phantom | cache |
        # fetched]
        n_comb = n_loc + 1 + c + p * s_max
        combined = torch.empty((p, n_comb, w), dtype=rows_ext.dtype,
                               device=dev)
        combined[:, : n_loc + 1] = rows_ext
        combined[:, n_loc + 1 : n_loc + 1 + c] = prob.cache_rows
        fetch_region = combined[:, n_loc + 1 + c :].view(p, p, s_max, w)
        combined_flat = combined.view(p * n_comb, w)
        comb_base = rank_base * n_comb

        acc = torch.zeros(p * (n_loc + 1), dtype=torch.int32, device=dev)
        slab = max(1, _PAIR_SLAB_BYTES // (4 * w))
        fetched_cur = fetch(0)
    for r in range(n_rounds):
        with obs_trace.span("lcc.round", r=r):
            # land this round's rows, then start the next round's fetch
            # before this round's compute (one in-flight fetch buffer at a
            # time)
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
    return acc


def _scores(prob: DeviceLCCProblem, acc: torch.Tensor):
    """(t, lcc) device tensors from S."""
    s = acc.view(prob.p, prob.n_loc + 1)[:, : prob.n_loc]
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
    plain: bool = False,
):
    """Run the engine; returns (t_per_vertex [p, n_loc] int32, lcc [p, n_loc]
    float32) as numpy. ``prob`` is the host problem (copied to ``device``
    first) or its ``to_device`` view, which must already lie on ``device``.
    ``plain=True`` runs the padded plain route instead (any device).

    With a tracer installed, the ``lcc.epoch`` span carries the epoch's
    shape, the device bytes of its rows (``row_store_bytes``), on the
    kernels' route the shares of its slots counted by bitmap
    (``bitmap_slot_share``) and as heavy pairs (``heavy_slot_share``) and,
    on a CUDA device, ``device_ms``: the device time from the epoch's first
    enqueued work to its last, by two CUDA events.
    """
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    traced = obs_trace.get_tracer() is not None
    with obs_trace.span("lcc.epoch") as epoch:
        dev = resolve_device(device)
        if isinstance(prob, ShardedLCCProblem):
            prob = prob.to_device(dev)
        elif prob.device.type != dev.type or (
            dev.index is not None and prob.device.index != dev.index
        ):
            raise ValueError(
                f"problem lies on {prob.device}, engine asked for {dev}"
            )
        start = None
        if traced:
            epoch.set(rounds=prob.n_rounds, method=method,
                      route="plain" if plain else "kernels",
                      landed_ids=prob.landed_ids,
                      landed_bytes=ID_BYTES * prob.landed_ids,
                      row_store_bytes=prob.row_store_bytes())
            if not plain:
                epoch.set(bitmap_slot_share=ec.bitmap_slot_share(prob),
                          heavy_slot_share=ec.heavy_slot_share(prob))
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record(stream)
        acc = (_epoch_plain_acc if plain else _epoch_acc)(prob, method)
        with obs_trace.span("lcc.scores"):
            t, lcc = _scores(prob, acc)
        with obs_trace.span("lcc.to_host"):
            out = t.cpu().numpy(), lcc.cpu().numpy()
        if start is not None:
            end.record(stream)
            end.synchronize()
            epoch.set(device_ms=start.elapsed_time(end))
    return out


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
