"""Row providers: how the query engine reads adjacency rows.

A provider is a *view* of the shared ``ShardedRuntime`` pinned to one
rank: the runtime owns the 1D partition, the per-rank degree-scored
``ClampiCache`` instances (carrying real row payloads), the
``NetworkModel``, and the coherence fanout; the provider only says
*which rank is reading*. This is what removed the old rank-0-only
assumption — cross-rank serving instantiates p providers over one
runtime, and each query executes at its owner rank.

- ``DirectRowProvider`` — view of an uncached runtime: every non-local
  read pays the full modeled remote get; rows always come from the
  authoritative store (always fresh).
- ``CacheBackedRowProvider`` — view of a cached runtime. A cache hit
  returns the payload captured at fetch time, NOT the authoritative
  store row, so coherence is a correctness property: if the graph
  mutates and nobody calls ``notify_batch``, hits serve stale rows and
  query answers diverge from a recount. ``StreamingCacheCoherence``
  (or ``ProviderCoherenceHook``) delivers exactly that notification
  after every applied update batch, and the runtime fans it out only to
  the ranks that cached the touched rows — ``audit_freshness`` verifies
  the resulting staleness bound of zero applied-but-unobserved batches.

Point-query workloads are degree-skewed (a hub appears in the neighbor
lists of many queried vertices), which is the paper's Observation 3.1
reuse argument in its strongest form — the reason the cached runtime
exists.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..core.cache import NetworkModel
from ..core.runtime import FetchEvent, ProviderStats, ShardedRuntime

__all__ = [
    "ProviderStats",
    "RuntimeRowProvider",
    "DirectRowProvider",
    "CacheBackedRowProvider",
    "ProviderCoherenceHook",
]


class RuntimeRowProvider:
    """One rank's read path over a shared ``ShardedRuntime``."""

    def __init__(self, runtime: ShardedRuntime, rank: int = 0):
        self.runtime = runtime
        self.rank = int(rank)

    # ---------------- runtime views ----------------
    @property
    def store(self):
        return self.runtime.store

    @property
    def part(self):
        return self.runtime.part

    @property
    def net(self) -> NetworkModel:
        return self.runtime.net

    @property
    def cache(self):
        """This rank's ClampiCache (None on an uncached runtime)."""
        return (
            self.runtime.caches[self.rank]
            if self.runtime.caches is not None
            else None
        )

    @property
    def stats(self) -> ProviderStats:
        return self.runtime.stats[self.rank]

    @property
    def residency(self):
        """The device-resident hot-row tier serving THIS rank's reads
        (None when the tier is off; the rank's own hot set under
        ``device_scope="per_rank"``) — the engine routes resident-vertex
        pairs through the ``resident_intersect`` kernel against it."""
        return self.runtime.device_for(self.rank)

    # ---------------- reads ----------------
    def fetch_rows(
        self,
        vertices: Sequence[int],
        record: Optional[List[FetchEvent]] = None,
        tenants: Optional[Dict[int, str]] = None,
    ) -> Dict[int, np.ndarray]:
        """Sorted adjacency row per distinct vertex (callers dedup).
        ``record`` collects per-vertex ``FetchEvent`` resolutions for
        the SPMD executor's placement plan; ``tenants`` maps vertex ->
        tenant tag for per-tenant accounting + quota-aware caching."""
        return self.runtime.fetch_rows(self.rank, vertices, record=record,
                                       tenants=tenants)

    # ---------------- coherence ----------------
    def notify_batch(self, changed_ids: Iterable[int]) -> None:
        """Fan one applied update batch out through the runtime (only
        ranks that cached the touched rows are told)."""
        self.runtime.invalidate(changed_ids)

    def audit_freshness(self) -> tuple:
        """(cached_entries, stale_entries) for THIS rank's view."""
        return self.runtime.audit_rank(self.rank)


class DirectRowProvider(RuntimeRowProvider):
    """Uncached baseline: a rank view over an uncached runtime."""

    def __init__(
        self,
        store=None,
        *,
        p: int = 1,
        rank: int = 0,
        network: Optional[NetworkModel] = None,
        runtime: Optional[ShardedRuntime] = None,
    ):
        if runtime is None:
            runtime = ShardedRuntime(store, p, network=network, uncached=True)
        super().__init__(runtime, rank)


class CacheBackedRowProvider(RuntimeRowProvider):
    """Rank view over a cached runtime (degree-scored ClampiCache in
    front of the owner's rows, with real payloads — see the module
    docstring for the coherence contract)."""

    def __init__(
        self,
        store=None,
        *,
        p: int = 4,
        rank: int = 0,
        capacity_bytes: int = 1 << 20,
        table_slots: Optional[int] = None,
        network: Optional[NetworkModel] = None,
        use_degree_score: bool = True,
        runtime: Optional[ShardedRuntime] = None,
    ):
        if runtime is None:
            runtime = ShardedRuntime(
                store,
                p,
                cache_bytes=capacity_bytes,
                table_slots=table_slots,
                network=network,
                use_degree_score=use_degree_score,
            )
        super().__init__(runtime, rank)


class ProviderCoherenceHook:
    """Minimal streaming-engine coherence hook (same ``on_batch``
    signature as ``StreamingCacheCoherence``) that only forwards
    mutations to registered listeners (runtimes or providers) — for
    services that want freshness without the CLaMPI delta-replay
    simulation."""

    def __init__(self, *listeners):
        self.providers = list(listeners)

    def attach_provider(self, listener) -> None:
        self.providers.append(listener)

    def on_batch(self, ins: np.ndarray, dele: np.ndarray, store) -> None:
        pairs = np.concatenate([ins, dele], axis=0)
        if pairs.shape[0] == 0:
            return
        changed = np.unique(pairs.ravel())
        for p in self.providers:
            p.notify_batch(changed)
