"""Closed-loop workload generators for the query service.

*Closed-loop* means the next request waits for the previous response:
these generators produce query batches the driver feeds through
``MicrobatchScheduler.run`` back-to-back, so measured latency is pure
service time — there is no arrival process and therefore no queueing
delay. To measure latency **under offered load** (arrivals that do not
wait for completions), pair the same query lists with
``repro_torch.traffic``'s open-loop arrival processes and
``traffic.run_open_loop`` — for a fixed query multiset both paths
produce bit-identical answers, they differ only in *when* requests
enter the scheduler.

Three vertex-sampling regimes:

- ``uniform``  — every vertex equally likely (the paper's uniform
  control graphs: flat degree distribution ⇒ little reuse ⇒ caching
  must not help much, cf. Fig. 4),
- ``zipf``     — P(v) ∝ (deg(v)+1)^exponent, the hub-skewed regime a
  social-network point-query front end actually sees (Obs. 3.1/3.2:
  degree predicts reuse — the cache's best case),

and a read-write mix that interleaves query groups with edge-update
batches, driving the freshness/coherence path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..streaming.updates import DELETE, INSERT, EdgeBatch
from .requests import Query, QueryKind

__all__ = [
    "sample_vertices",
    "make_queries",
    "ReadWriteEvent",
    "read_write_stream",
]

# default query mix: (lcc, triangles, common_neighbors, top_k_lcc)
DEFAULT_MIX = (0.45, 0.3, 0.2, 0.05)


def sample_vertices(
    degrees: np.ndarray,
    size: int,
    rng: np.random.Generator,
    *,
    kind: str = "zipf",
    exponent: float = 1.0,
) -> np.ndarray:
    """Sample query target vertices (uniform or degree/hub-skewed)."""
    n = degrees.shape[0]
    if kind == "uniform":
        return rng.integers(0, n, size=size)
    if kind == "zipf":
        w = (degrees.astype(np.float64) + 1.0) ** exponent
        return rng.choice(n, size=size, p=w / w.sum())
    raise ValueError(f"unknown workload kind: {kind}")


def make_queries(
    degrees: np.ndarray,
    n_queries: int,
    *,
    kind: str = "zipf",
    mix: Sequence[float] = DEFAULT_MIX,
    top_k: int = 8,
    exponent: float = 1.0,
    seed: int = 0,
) -> List[Query]:
    """Deterministic query workload over the current degree distribution."""
    rng = np.random.default_rng(seed)
    mix = np.asarray(mix, np.float64)
    kinds = rng.choice(4, size=n_queries, p=mix / mix.sum())
    vs = sample_vertices(
        degrees, 2 * n_queries, rng, kind=kind, exponent=exponent
    )
    out: List[Query] = []
    for i, kq in enumerate(kinds):
        u, v = int(vs[2 * i]), int(vs[2 * i + 1])
        if kq == QueryKind.LCC:
            out.append(Query.lcc(u))
        elif kq == QueryKind.TRIANGLES:
            out.append(Query.triangles(u))
        elif kq == QueryKind.COMMON_NEIGHBORS:
            out.append(Query.common_neighbors(u, v if v != u else (u + 1) % degrees.shape[0]))
        else:
            out.append(Query.top_k_lcc(top_k))
    return out


@dataclasses.dataclass
class ReadWriteEvent:
    """One step of a read-write mixed stream: exactly one of the two."""

    queries: Optional[List[Query]] = None
    update: Optional[EdgeBatch] = None

    @property
    def is_update(self) -> bool:
        return self.update is not None


def read_write_stream(
    degrees_fn,
    n: int,
    n_events: int,
    *,
    write_frac: float = 0.2,
    queries_per_event: int = 32,
    updates_per_event: int = 64,
    delete_frac: float = 0.3,
    kind: str = "zipf",
    seed: int = 0,
) -> Iterator[ReadWriteEvent]:
    """Closed-loop read-write mix. ``degrees_fn()`` returns the *current*
    degree array so query skew tracks the live graph as writes land."""
    rng = np.random.default_rng(seed)
    for i in range(n_events):
        if rng.random() < write_frac:
            e = rng.integers(0, n, size=(updates_per_event, 2))
            op = np.where(
                rng.random(updates_per_event) < delete_frac, DELETE, INSERT
            ).astype(np.int8)
            yield ReadWriteEvent(update=EdgeBatch(u=e[:, 0], v=e[:, 1], op=op))
        else:
            yield ReadWriteEvent(
                queries=make_queries(
                    degrees_fn(),
                    queries_per_event,
                    kind=kind,
                    seed=seed + 1000 + i,
                )
            )
