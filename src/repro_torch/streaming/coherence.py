"""Cache coherence for the streaming setting.

The static pipeline's cache science (paper §II-F, §III-B) assumes a
read-only graph: rows are fetched once and never change. Streaming breaks
that — every applied edge mutates two adjacency rows — so this module
extends both cache layers with coherence, running over the shared
``ShardedRuntime`` (which owns the 1D partition and the p per-rank
``ClampiCache`` instances — this layer constructs neither):

1. Per-rank ClampiCache replay: each batch's delta row-pair reads are
   replayed through the runtime's caches exactly like the static access
   stream (owner(u) pulls row v through *its own rank's* cache), but
   stale entries — cached rows of vertices whose adjacency just
   changed — are *invalidated* first, fanned out by the runtime only to
   the ranks that actually hold them, so hit/miss/eviction/invalidation
   statistics stay meaningful.
2. ``StaticDegreeCache`` rescoring: degree drift moves vertices in and
   out of the top-C residency set; ``refresh_static_degree_cache``
   invalidates stale resident rows and rebuilds the set when drift
   crosses a threshold.

The incremental engine reads from the authoritative ``DynamicCSR``; this
layer models what a distributed deployment (1D partition, remote pulls)
would pay, reporting per-stream hit rate and modeled communication time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.cache import (
    NetworkModel,
    StaticDegreeCache,
    build_static_degree_cache,
    refresh_static_degree_cache,
)
from ..core.runtime import ShardedRuntime
from ..obs import trace as obs_trace

__all__ = ["CoherenceReport", "StreamingCacheCoherence"]

ID_BYTES = 4


@dataclasses.dataclass
class CoherenceReport:
    """Cumulative statistics over the replayed delta access stream."""

    local_reads: int = 0
    static_hits: int = 0
    clampi_hits: int = 0
    clampi_misses: int = 0
    invalidations: int = 0  # ClampiCache entries dropped as stale
    static_stale_rows: int = 0  # resident rows refreshed in place
    static_evictions: int = 0  # residents dropped by rescoring
    static_rebuilds: int = 0
    comm_time: float = 0.0  # modeled, misses + refreshes

    @property
    def remote_reads(self) -> int:
        return self.static_hits + self.clampi_hits + self.clampi_misses

    @property
    def hit_rate(self) -> float:
        """Fraction of remote row reads served by either cache layer."""
        r = self.remote_reads
        return (self.static_hits + self.clampi_hits) / r if r else 0.0


class _RuntimeCacheView:
    """Aggregated statistics view over the runtime's p caches (the
    drop-in replacement for the old single shared simulator)."""

    def __init__(self, runtime: ShardedRuntime):
        self._runtime = runtime

    @property
    def stats(self):
        return self._runtime.merged_cache_stats()


class StreamingCacheCoherence:
    """Replays each batch's delta access stream through both cache layers.

    The runtime's p ranks give the 1D-partition notion of *remote*: the
    owner of u processes edge (u, v) and pulls row v through its own
    rank's cache iff owner(v) differs and v is not static-cache resident.
    """

    def __init__(
        self,
        n: int,
        degrees: np.ndarray,
        *,
        p: int = 4,
        cache_rows: int = 256,
        clampi_bytes: int = 1 << 20,
        table_slots: Optional[int] = None,
        rebuild_fraction: float = 0.05,
        network: Optional[NetworkModel] = None,
        runtime: Optional[ShardedRuntime] = None,
        partition=None,
        device="cuda",
    ):
        """``device`` is handed to the runtime this layer builds when none
        is given: where its device-resident tier will live, once enabled."""
        if runtime is None:
            runtime = ShardedRuntime(
                n=n,
                p=p,
                cache_bytes=clampi_bytes,
                table_slots=table_slots,
                network=network,
                partition=partition,
                device=device,
            )
        assert runtime.caches is not None, (
            "coherence replay needs a cached runtime"
        )
        self.runtime = runtime
        self.part = runtime.part
        self.p = runtime.p
        self.net = runtime.net
        self.rebuild_fraction = rebuild_fraction
        self.static: StaticDegreeCache = build_static_degree_cache(
            np.asarray(degrees), cache_rows
        )
        self.cache_rows = cache_rows
        self.clampi = _RuntimeCacheView(runtime)
        self.report = CoherenceReport()
        self.providers: list = []  # serving listeners to notify

    def attach_provider(self, provider) -> None:
        """Register a serving listener (a provider or a whole runtime)
        whose cached payloads must be invalidated on every applied
        batch — the freshness contract of the query service."""
        self.providers.append(provider)

    def on_batch(
        self, ins: np.ndarray, dele: np.ndarray, store
    ) -> CoherenceReport:
        """Called by the engine after applying a batch (``ins``/``dele``
        are the effective ``[K, 2]`` edge arrays; ``store`` holds the
        post-batch graph). Returns the cumulative report."""
        pairs = np.concatenate([ins, dele], axis=0)
        if pairs.shape[0] == 0:
            return self.report
        with obs_trace.span("delta_replay", cat="coherence",
                            n=pairs.shape[0]):
            return self._on_batch_impl(pairs, store)

    def _on_batch_impl(self, pairs: np.ndarray, store) -> CoherenceReport:
        rep = self.report
        changed = np.unique(pairs.ravel())

        # 1. coherence: cached copies of mutated rows are stale — the
        #    runtime fans the drop out only to the ranks that hold each
        #    row, both for the replay caches and any attached listener.
        self.runtime.invalidate(changed)
        for provider in self.providers:
            provider.notify_batch(changed)

        # 2. replay the delta access stream (both directions of each
        #    edge: owner(u) pulls row v through rank owner(u)'s cache).
        deg = store.degrees
        a = np.concatenate([pairs[:, 0], pairs[:, 1]])
        b = np.concatenate([pairs[:, 1], pairs[:, 0]])
        owners_a = self.part.owner(a)
        owners_b = self.part.owner(b)
        remote = owners_a != owners_b
        rep.local_reads += int(np.count_nonzero(~remote))
        b_rem = b[remote]
        k_rem = owners_a[remote]
        in_static = self.static.slot_of(b_rem) >= 0
        rep.static_hits += int(np.count_nonzero(in_static))
        caches = self.runtime.caches
        for v, k in zip(b_rem[~in_static], k_rem[~in_static]):
            size = int(deg[int(v)]) * ID_BYTES
            caches[int(k)].get(int(v), size, score=float(deg[int(v)]))

        # 3. rescore static residency against the drifted degrees.
        refresh = refresh_static_degree_cache(
            self.static,
            deg,
            changed,
            rebuild_fraction=self.rebuild_fraction,
        )
        rep.static_stale_rows += refresh.stale_rows
        # refreshing a stale resident row = one remote read of fresh data
        rep.comm_time += float(
            sum(self.net.remote(int(deg[int(v)]) * ID_BYTES)
                for v in refresh.stale_ids)
        )
        if refresh.rebuilt:
            self.static = refresh.cache
            rep.static_evictions += refresh.evicted
            rep.static_rebuilds += 1

        st = self.clampi.stats
        rep.clampi_hits = st.hits
        rep.clampi_misses = st.misses
        rep.invalidations = st.invalidations
        return rep

    @property
    def total_comm_time(self) -> float:
        return self.report.comm_time + self.clampi.stats.comm_time
