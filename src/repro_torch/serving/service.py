"""LiveQueryService: queries and streaming updates over one shared graph.

Wires the pieces together so freshness is a property, not a hope:

- one ``DynamicCSR`` store, owned by a ``StreamingLCCEngine`` that keeps
  exact per-vertex triangle counts + LCC under update batches;
- one ``ShardedRuntime`` that owns the 1D partition, the per-rank
  degree-scored caches, and the row transport;
- either a single rank's view of that runtime (the classic single-rank
  service) or — with ``cross_rank=True`` — p ``QueryEngine``/provider
  instances routing every query to its owner rank
  (``ShardedQueryEngine``);
- a coherence hook on the streaming engine that, after every applied
  batch, fans invalidations out through the runtime to exactly the
  ranks that cached the mutated rows — so queries observe the live
  graph with a staleness bound of zero applied-but-unobserved batches
  (``verify()`` checks it across all ranks).

``apply_updates`` and ``flush`` must not interleave (single-writer
semantics — the scheduler drains fully between update batches), which is
exactly the batch-boundary observability the streaming layer defines.

Everything runs on ``device`` (default ``"cuda"``, resolved by
``resolve_device``: raises when missing): the stream engine's counts, the
device tier and the query engines' counts. ``use_kernel=None`` keys the
route of all three on that device (the kernels on CUDA, the plain host
route on the CPU). The reference keeps its stream on the host whenever
``use_kernel`` is left at None; the integers are the same either way.
``execution="spmd"`` (with ``pipeline``) runs the cross-rank views as one
SPMD execution unit per microbatch on the same device
(``distributed/spmd_runtime.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..core.csr import CSRGraph
from ..core.runtime import ShardedRuntime
from ..device import resolve_device
from ..obs import trace as obs_trace
from ..streaming.coherence import StreamingCacheCoherence
from ..streaming.incremental import BatchResult, StreamingLCCEngine
from ..streaming.updates import EdgeBatch
from .engine import QueryEngine, ShardedQueryEngine
from .provider import (
    CacheBackedRowProvider,
    DirectRowProvider,
    ProviderCoherenceHook,
)
from .requests import Query, QueryResult
from .scheduler import MicrobatchScheduler

__all__ = ["LiveQueryService"]


class LiveQueryService:
    def __init__(
        self,
        csr: CSRGraph,
        *,
        p: int = 4,
        rank: int = 0,
        cross_rank: bool = False,
        cache_bytes: int = 1 << 20,
        max_batch: int = 64,
        max_wait: Optional[float] = None,
        max_queue: Optional[int] = None,
        shed_wait: Optional[float] = None,
        device_slots: int = 0,
        device_width: Optional[int] = None,
        use_kernel: Optional[bool] = None,
        coherence: Optional[StreamingCacheCoherence] = None,
        provider=None,
        uncached: bool = False,
        execution: str = "loop",
        pipeline: bool = False,
        device_scope: str = "replicated",
        stream_kw: Optional[dict] = None,
        slo=None,  # Optional[traffic.SLOPolicy]
        quotas=None,  # Optional[traffic.TenantQuotas]
        scorer=None,  # Optional[traffic.WorkloadScorer]
        clock=None,  # injectable time source (traffic clocks)
        partition=None,  # custom vertex partition (e.g. partition_hub)
        device="cuda",
    ):
        assert execution == "loop" or cross_rank, (
            "SPMD execution runs the p cross-rank views on devices — "
            "pass cross_rank=True"
        )
        assert not pipeline or execution == "spmd", (
            "pipeline double-buffers SPMD microbatches — pass "
            "execution='spmd'"
        )
        self.device = resolve_device(device)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        hook = coherence or ProviderCoherenceHook()
        self.stream = StreamingLCCEngine(
            csr,
            coherence=hook,
            use_kernel=bool(use_kernel),
            device=self.device,
            **(stream_kw or {}),
        )
        self.store = self.stream.store
        if provider is not None:
            # caller-supplied rank view: adopt its runtime
            self.runtime = provider.runtime
            self.runtime.bind_store(self.store)
        elif coherence is not None:
            # ONE runtime for all consumers: the coherence layer's
            # partition/caches also carry the serving reads (its p wins
            # over ours), so replay warmth, hit/miss stats, and the
            # invalidation-fanout ledger are shared, not split.
            self.runtime = coherence.runtime
            self.runtime.bind_store(self.store)
        else:
            self.runtime = ShardedRuntime(
                self.store, p, cache_bytes=cache_bytes, uncached=uncached,
                partition=partition, device=self.device,
            )
        if device_slots:
            # the device-resident hot-row tier below the host caches:
            # fetch_rows consults it first, the engines route resident
            # pairs through the resident_intersect gather, and the
            # coherence fanout below keeps it fresh per update batch.
            # scope="per_rank" gives each rank its own hot set of the
            # remote-heavy rows IT reads (own-block rows are excluded).
            self.runtime.enable_device_tier(
                device_slots, device_width, scope=device_scope
            )
        lcc_source = lambda: self.stream.lcc  # noqa: E731
        if cross_rank:
            assert provider is None, "cross_rank builds its own rank views"
            self.engine = ShardedQueryEngine(
                self.store,
                self.runtime,
                use_kernel=use_kernel,
                lcc_source=lcc_source,
                execution=execution,
                pipeline=pipeline,
                device=self.device,
            )
            self.providers = [e.provider for e in self.engine.engines]
            self.provider = self.providers[rank]
        else:
            if provider is None:
                provider = (
                    DirectRowProvider(runtime=self.runtime, rank=rank)
                    if uncached
                    else CacheBackedRowProvider(
                        runtime=self.runtime, rank=rank
                    )
                )
            self.provider = provider
            self.providers = [provider]
            self.engine = QueryEngine(
                self.store,
                self.provider,
                use_kernel=use_kernel,
                lcc_source=lcc_source,
                device=self.device,
            )
        self.cross_rank = cross_rank
        # one coherence registration for the whole runtime: the fanout
        # targets exactly the ranks holding each touched row. (When the
        # hook IS a StreamingCacheCoherence over this same runtime it
        # already invalidates it on every batch — don't register twice.)
        if getattr(hook, "runtime", None) is not self.runtime:
            hook.attach_provider(self.runtime)
        self.coherence = coherence
        # ---------------- traffic plane ----------------
        # live workload scoring: admissions through every rank cache use
        # the EWMA×degree blend, and the device tier re-ranks from the
        # same scorer on refresh_scores().
        self.scorer = scorer
        if scorer is not None:
            self.runtime.attach_scorer(scorer)
        # tenant cache shares: hard byte caps inside each rank's cache.
        # NOTE: shares steer eviction with state the access trace does
        # not record, so don't combine with --cache-trace replay gates.
        self.quotas = quotas
        if quotas is not None and self.runtime.caches is not None:
            shares = quotas.cache_shares()
            if shares:
                for c in self.runtime.caches:
                    c.set_tenant_shares(shares)
        self.scheduler = MicrobatchScheduler(
            self.engine,
            max_batch=max_batch,
            max_wait=max_wait,
            max_queue=max_queue,
            shed_wait=shed_wait,
            clock=clock,
            slo=slo,
            quotas=quotas,
        )

    # ---------------- write path ----------------
    def apply_updates(self, batch: EdgeBatch) -> BatchResult:
        assert self.scheduler.pending == 0, (
            "drain queries before applying updates (single-writer)"
        )
        with obs_trace.span("apply_updates", cat="write",
                            n=batch.u.size):
            return self.stream.apply_batch(batch)

    def refresh_scores(self) -> int:
        """Re-rank the device-resident tier under the live workload
        scores (between windows — rebuilds bump slot epochs). No-op
        without a scorer/tier; returns rebuilds performed."""
        assert self.scheduler.pending == 0, (
            "drain queries before re-ranking residency (epoch bumps "
            "would fault in-flight handles)"
        )
        return self.runtime.refresh_device_scores()

    # ---------------- read path ----------------
    def submit(self, query: Query, *, urgent: bool = False,
               at: Optional[float] = None) -> bool:
        """False when admission control shed the query (tenant quota or
        queue depth). ``at`` stamps the arrival time (open-loop)."""
        return self.scheduler.submit(query, urgent=urgent, at=at)

    def submit_many(self, queries: Sequence[Query]) -> int:
        """Number of queries admitted (the rest were shed)."""
        return self.scheduler.submit_many(queries)

    def flush(self) -> List[QueryResult]:
        return self.scheduler.flush()

    def query(self, query: Query) -> QueryResult:
        """Synchronous single query (no microbatching)."""
        return self.engine.execute_batch([query])[0]

    # ---------------- observability ----------------
    def metrics_registry(self, *, tracer=None):
        """One queryable snapshot of every ledger this service owns:
        per-rank provider/cache stats, device tier, serve matrix +
        placement gauges, serving latency (overall and per SLO class),
        and — under SPMD execution — the measured ``CollectiveLedger``
        with the measured-vs-modeled RMA reconciliation. Pass the
        active ``Tracer`` to fold per-phase wall time in too."""
        from ..obs.metrics import (
            MetricRegistry,
            fold_trace,
            record_collective_ledger,
            record_coherence_report,
            record_latency,
            record_reconciliation,
            record_runtime,
            record_tenancy,
        )

        reg = MetricRegistry()
        record_runtime(reg, self.runtime)
        record_latency(reg, self.scheduler.recorder)
        if self.quotas is not None:
            record_tenancy(reg, self.quotas, self.runtime)
        spmd = getattr(self.engine, "spmd", None)
        if spmd is not None:
            record_collective_ledger(reg, spmd.ledger)
            record_reconciliation(reg, self.runtime, spmd.ledger)
        if self.coherence is not None:
            record_coherence_report(reg, self.coherence.report)
        if tracer is not None:
            fold_trace(reg, tracer)
        return reg

    # ---------------- invariants ----------------
    @property
    def triangle_count(self) -> int:
        return self.stream.triangle_count

    def verify(self) -> None:
        """Streaming state bit-exact vs recount AND zero stale cached
        rows on every runtime rank — the service-level freshness
        contract."""
        self.stream.verify()
        cached, stale = self.runtime.audit_freshness()
        if stale:
            raise AssertionError(
                f"provider staleness bound violated: {stale}/{cached} "
                "cached rows diverge from the store"
            )
