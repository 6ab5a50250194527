"""TriC-style synchronous baseline (paper §IV-B, Ghosh & Halappanavar 2020).

TriC counts triangles per vertex with a blocking query/response pattern:
every process sends edge queries to owners via **blocking all-to-all**,
waits (global synchronization), receives responses, repeats. The paper
attributes TriC's limited scaling to exactly this synchronization and to
its buffer blow-up on scale-free graphs (hence "TriC Buffered" with capped
16 MiB buffers).

Two artifacts here:

- ``tric_lcc_torch``: a BSP engine — the SAME work as the async
  engine but with a single monolithic (non-pipelined, non-cached,
  non-deduplicated) exchange phase followed by the compute phase, i.e. a
  hard barrier between all communication and all computation. This is the
  apples-to-apples baseline for wall-time comparisons on real devices.
- ``simulate_tric``: host-level cost model with per-superstep barriers
  (makespan = sum over supersteps of the max per-device time) and
  per-query (non-deduplicated) message volume — used in the Fig. 9/10
  benchmark where the paper reports up to 100x advantage for the
  asynchronous RMA version on scale-free graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .cache import NetworkModel
from .csr import CSRGraph
from .partition import partition_1d
from .rma import ShardedLCCProblem, _edge_worklist, build_sharded_problem

__all__ = ["tric_problem", "tric_lcc_torch", "simulate_tric", "TriCStats"]


def tric_problem(csr: CSRGraph, p: int, **kw) -> ShardedLCCProblem:
    """The TriC-like schedule: one round (bulk exchange), no cache, no dedup."""
    return build_sharded_problem(
        csr, p, n_rounds=1, cache=None, dedup_rounds=False, **kw
    )


def tric_lcc_torch(
    csr: CSRGraph, p: int, device="cuda", method: str = "bsearch"
):
    """BSP baseline: monolithic fetch, barrier, compute."""
    from .async_engine import lcc_pipelined

    prob = tric_problem(csr, p)
    return lcc_pipelined(prob, device, method=method)


@dataclasses.dataclass
class TriCStats:
    makespan: float
    comm_time: np.ndarray  # [p]
    sync_time: float
    queries: np.ndarray  # [p]
    buffer_bytes: np.ndarray  # [p] peak response-buffer demand


def simulate_tric(
    csr: CSRGraph,
    p: int,
    *,
    network: Optional[NetworkModel] = None,
    supersteps: int = 8,
    buffer_cap_bytes: int = 16 << 20,
) -> TriCStats:
    """Superstep cost model of TriC's query/response all-to-all.

    Every remote edge sends a query (id, 8 B) and receives the adjacency
    list response; volume is NOT deduplicated (TriC re-requests per edge).
    Each superstep ends in a barrier: its cost is the max across devices.
    Buffered variant: when a device's response volume exceeds the 16 MiB
    cap, extra rounds are added (the protocol change the paper describes).
    """
    net = network or NetworkModel()
    part = partition_1d(csr.n, p)
    deg = csr.degrees
    per_dev_time = np.zeros((p, supersteps), np.float64)
    queries = np.zeros(p, np.int64)
    bufpeak = np.zeros(p, np.int64)
    for k in range(p):
        u_l, v_g = _edge_worklist(csr, part, k)
        owners = part.owner(v_g)
        remote = v_g[owners != k]
        queries[k] = remote.size
        sizes = deg[remote] * 4 + 8
        bufpeak[k] = int(sizes.sum())
        # split the query stream across supersteps (TriC phases by vertex
        # ranges); each chunk: a2a of queries + responses, then barrier.
        chunks = np.array_split(sizes, supersteps)
        for s, ch in enumerate(chunks):
            vol = float(ch.sum())
            n_msgs = max(len(ch), 1)
            # buffered variant: extra rounds if volume exceeds the cap
            extra = int(vol // buffer_cap_bytes)
            per_dev_time[k, s] = (
                net.alpha * (1 + extra) + vol * net.beta + n_msgs * net.alpha * 0.01
            )
    # barrier per superstep: everyone waits for the slowest device
    step_cost = per_dev_time.max(axis=0)
    makespan = float(step_cost.sum())
    sync = float(makespan - per_dev_time.sum(axis=1).mean())
    return TriCStats(
        makespan=makespan,
        comm_time=per_dev_time.sum(axis=1),
        sync_time=max(sync, 0.0),
        queries=queries,
        buffer_bytes=bufpeak,
    )
