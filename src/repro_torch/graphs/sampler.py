"""Neighbor sampler for sampled GNN training (minibatch_lg shape), the
counterpart of ``repro.graphs.sampler``: host numpy, the reference's code
with its imports on the port's ``core/csr.py``, so a seeded sampler draws
the same blocks in both packages.

GraphSAGE-style fanout sampling (fanout (15, 10) for the assigned shape):
for a seed batch of nodes, sample up to ``fanout[0]`` neighbors per seed,
then ``fanout[1]`` per frontier node, producing a fixed-shape (padded)
block: seeds, per-hop edge lists (src, dst) and the unique node set with
an index mapping — every array padded to a fixed shape, as in the
reference, whose compiled step needs it.

This is a *real* sampler: it operates on a
host CSR with reservoir-free uniform sampling via ``np.random.Generator``
and returns numpy arrays for the device step.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from ..core.csr import CSRGraph

__all__ = ["SampledBlock", "NeighborSampler"]


@dataclasses.dataclass
class SampledBlock:
    """Fixed-shape sampled subgraph for one minibatch.

    nodes:      [n_max] global ids (padded with -1)
    n_nodes:    scalar, number of valid nodes
    edge_src:   [e_max] local indices into ``nodes`` (padded with n_max-1)
    edge_dst:   [e_max] local indices (message direction src -> dst)
    edge_mask:  [e_max] bool
    seeds_local:[batch] local indices of the seed nodes (output rows)
    """

    nodes: np.ndarray
    n_nodes: int
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    seeds_local: np.ndarray


class NeighborSampler:
    def __init__(
        self,
        csr: CSRGraph,
        fanout: Sequence[int] = (15, 10),
        *,
        seed: int = 0,
    ):
        self.csr = csr
        self.fanout = tuple(fanout)
        self.rng = np.random.default_rng(seed)

    def max_sizes(self, batch: int) -> Tuple[int, int]:
        """Static (n_max, e_max) bounds for a given seed-batch size."""
        n_max = batch
        e_max = 0
        frontier = batch
        for f in self.fanout:
            e_max += frontier * f
            frontier *= f
            n_max += frontier
        return n_max, e_max

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        batch = seeds.shape[0]
        n_max, e_max = self.max_sizes(batch)
        nodes = list(seeds.astype(np.int64))
        index = {int(v): i for i, v in enumerate(nodes)}
        srcs: list[int] = []
        dsts: list[int] = []
        frontier = list(seeds.astype(np.int64))
        for f in self.fanout:
            nxt: list[int] = []
            for v in frontier:
                row = self.csr.row(int(v))
                if row.size == 0:
                    continue
                take = row if row.size <= f else self.rng.choice(
                    row, size=f, replace=False
                )
                for u in take:
                    u = int(u)
                    if u not in index:
                        index[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    # message u -> v
                    srcs.append(index[u])
                    dsts.append(index[int(v)])
            frontier = nxt
        n_nodes = len(nodes)
        nodes_arr = np.full(n_max, -1, np.int64)
        nodes_arr[:n_nodes] = nodes
        e = len(srcs)
        edge_src = np.full(e_max, n_max - 1, np.int32)
        edge_dst = np.full(e_max, n_max - 1, np.int32)
        mask = np.zeros(e_max, bool)
        edge_src[:e] = srcs
        edge_dst[:e] = dsts
        mask[:e] = True
        seeds_local = np.arange(batch, dtype=np.int32)
        return SampledBlock(
            nodes=nodes_arr,
            n_nodes=n_nodes,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_mask=mask,
            seeds_local=seeds_local,
        )
