"""Hub-replication gather, the counterpart of
``repro.distributed.hub_gather``: the paper's degree-score cache applied
beyond LCC — to GNN feature reads and recsys hot-row lookups.

Idea (paper §III-B, Observations 3.1/3.2): access frequency of a row is
power-law in its degree/popularity, so keeping the top-C hottest rows in a
replicated hub table serves the bulk of the reads; the remaining cold rows
go through the ordinary gather. The split is *static* (degree/popularity is
known offline): two plain gathers and a select, no data-dependent shapes.

``split_hot_cold`` is the host-side planner (numpy, the reference's code);
``hub_gather`` the device op, stock torch indexing (a gather, no kernel of
the reference). On one card the reference's cross-shard traffic does not
exist, so the split changes where a row is read from, never the result.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["HotColdPlan", "split_hot_cold", "hub_gather"]


class HotColdPlan(NamedTuple):
    hot_ids: np.ndarray  # [C] sorted global ids of the hub table
    # per-index remap (precomputed on host for a static id stream):
    is_hot: np.ndarray  # [N_idx] bool
    hot_pos: np.ndarray  # [N_idx] slot into the hot table (junk if cold)


def split_hot_cold(ids: np.ndarray, scores: np.ndarray, capacity: int) -> HotColdPlan:
    """Pick the top-``capacity`` rows by score (degree / popularity) and
    classify a static id stream against them."""
    n_rows = scores.shape[0]
    c = min(capacity, n_rows)
    hot = np.sort(np.argpartition(scores, n_rows - c)[n_rows - c:]) if c > 0 \
        else np.zeros((0,), np.int64)
    pos = np.searchsorted(hot, ids)
    pos = np.minimum(pos, max(c - 1, 0))
    hit = hot[pos] == ids if hot.size else np.zeros(ids.shape, bool)
    return HotColdPlan(hot_ids=hot.astype(np.int64),
                       is_hot=hit,
                       hot_pos=pos.astype(np.int32))


def hub_gather(
    table: torch.Tensor,      # [N, D]
    hot_table: torch.Tensor,  # [C, D]
    ids: torch.Tensor,        # [K] row ids
    is_hot: torch.Tensor,     # [K] bool (the static plan, on the device)
    hot_pos: torch.Tensor,    # [K] int32
) -> torch.Tensor:
    """rows[i] = hot_table[hot_pos[i]] if is_hot[i] else table[ids[i]].

    The cold gather is pointed at row 0 for hot ids, as in the reference.
    """
    cold_ids = torch.where(is_hot, 0, ids)
    cold = table[cold_ids.long()]
    hot = hot_table[hot_pos.long()]
    return torch.where(is_hot[:, None], hot, cold)
