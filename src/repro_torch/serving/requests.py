"""Query/result types for the online graph query service.

A ``Query`` is a point or batch request against the live graph:

- ``lcc(v)``                — local clustering coefficient of one vertex
- ``triangles(v)``          — triangle count through one vertex
- ``common_neighbors(u,v)`` — |adj(u) ∩ adj(v)| plus the neighbor ids
- ``top_k_lcc(k)``          — the k vertices with the highest LCC

Point queries are answered from adjacency rows fetched through the row
provider (and are therefore bit-exact against a from-scratch recount of
the provider's view of the graph); ``top_k_lcc`` reads the exact
per-vertex LCC array the streaming engine maintains incrementally.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

__all__ = ["QueryKind", "Query", "QueryResult"]


class QueryKind(enum.IntEnum):
    LCC = 0
    TRIANGLES = 1
    COMMON_NEIGHBORS = 2
    TOP_K_LCC = 3


@dataclasses.dataclass(frozen=True)
class Query:
    kind: QueryKind
    u: int = -1
    v: int = -1
    k: int = 0
    # multi-tenant serving: admission (token buckets) and cache-share
    # accounting key on this tag; "" = untagged (single-tenant path,
    # never rate-limited). Tag with dataclasses.replace or
    # traffic.assign_tenants.
    tenant: str = ""

    @staticmethod
    def lcc(v: int) -> "Query":
        return Query(QueryKind.LCC, u=int(v))

    @staticmethod
    def triangles(v: int) -> "Query":
        return Query(QueryKind.TRIANGLES, u=int(v))

    @staticmethod
    def common_neighbors(u: int, v: int) -> "Query":
        return Query(QueryKind.COMMON_NEIGHBORS, u=int(u), v=int(v))

    @staticmethod
    def top_k_lcc(k: int) -> "Query":
        return Query(QueryKind.TOP_K_LCC, k=int(k))


@dataclasses.dataclass
class QueryResult:
    """Answer + serving metadata for one query.

    value: LCC (float), triangle count (int), or common-neighbor count.
    ids/values: for ``common_neighbors`` the shared neighbor ids; for
        ``top_k_lcc`` the top-k vertex ids and their LCC scores.
    latency_s: submit-to-completion time, filled by the scheduler.
    """

    query: Query
    value: float
    ids: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None
    latency_s: float = 0.0
