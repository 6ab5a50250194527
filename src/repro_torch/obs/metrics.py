"""One labeled metric registry over the stack's scattered ledgers.

The repo accumulated five ad-hoc accounting dataclasses — per-rank
``ProviderStats`` (host transport), ``CacheStats`` (CLaMPI layer),
``ResidencyStats`` (device tier), ``CollectiveLedger`` (measured SPMD
wire traffic), and the serving ``LatencyRecorder`` — each with its own
report printer and none queryable together. This module gives them a
single address space: every number becomes a counter, gauge, or
histogram keyed by ``(name, rank, tier, phase)``:

- ``rank``  — which of the p ranks (-1 = global / cross-rank)
- ``tier``  — where the number lives: ``host`` (provider transport),
  ``host_cache`` (CLaMPI), ``device`` (resident tier), ``wire``
  (modeled or measured communication), ``serving`` (latency/shed)
- ``phase`` — the span-taxonomy phase it attributes to (see
  ``trace.PHASES``), empty when not phase-specific

Adapters (``record_*``) translate the existing dataclasses verbatim —
they never mutate the sources, so calling them twice on fresh
registries is idempotent per snapshot. ``fold_trace`` adds the time
dimension (per-phase wall seconds/calls/bytes from a ``Tracer``), and
``record_reconciliation`` promotes the measured-vs-modeled RMA byte
comparison (``CollectiveLedger`` vs. the runtime's serve matrix) to
first-class counters plus an agreement gauge — the invariant CI
validates on every smoke.

Derived placement gauges shipped here because ROADMAP items 1/2 need
them measurable: ``load_imbalance`` (max/mean of per-rank row reads)
and ``serve_matrix_skew`` (max/mean of per-owner rows served).

``MetricRegistry.to_dict()``/``save()`` give the serializable snapshot
the launchers write for ``--metrics``; ``repro.obs.validate`` checks the
cross-ledger invariants on that snapshot.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "MetricKey",
    "MetricRegistry",
    "record_provider_stats",
    "record_cache_stats",
    "record_residency_stats",
    "record_collective_ledger",
    "record_latency",
    "record_tenancy",
    "record_coherence_report",
    "record_runtime",
    "record_reconciliation",
    "record_cachescope",
    "fold_trace",
    "imbalance",
    "load_snapshot",
]

# (name, rank, tier, phase)
MetricKey = Tuple[str, int, str, str]


def _key(name: str, rank: int, tier: str, phase: str) -> MetricKey:
    return (str(name), int(rank), str(tier), str(phase))


class MetricRegistry:
    """Counters / gauges / histograms keyed by ``(name, rank, tier,
    phase)``. Counters add, gauges overwrite, histograms accumulate raw
    observations (summarized at serialization time)."""

    def __init__(self):
        self._counters: Dict[MetricKey, float] = {}
        self._gauges: Dict[MetricKey, float] = {}
        self._hists: Dict[MetricKey, List[float]] = {}

    # ---------------- writes ----------------
    def counter(self, name: str, value: float = 1.0, *, rank: int = -1,
                tier: str = "", phase: str = "") -> None:
        k = _key(name, rank, tier, phase)
        self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge(self, name: str, value: float, *, rank: int = -1,
              tier: str = "", phase: str = "") -> None:
        self._gauges[_key(name, rank, tier, phase)] = float(value)

    def observe(self, name: str, values, *, rank: int = -1,
                tier: str = "", phase: str = "") -> None:
        k = _key(name, rank, tier, phase)
        bucket = self._hists.setdefault(k, [])
        if np.isscalar(values):
            bucket.append(float(values))
        else:
            bucket.extend(float(v) for v in np.asarray(values).ravel())

    # ---------------- queries ----------------
    def _match(self, store: Dict[MetricKey, object], name: Optional[str],
               rank: Optional[int], tier: Optional[str],
               phase: Optional[str]) -> Iterator[Tuple[MetricKey, object]]:
        for k, v in store.items():
            if name is not None and k[0] != name:
                continue
            if rank is not None and k[1] != rank:
                continue
            if tier is not None and k[2] != tier:
                continue
            if phase is not None and k[3] != phase:
                continue
            yield k, v

    def get_counter(self, name: str, *, rank: int = -1, tier: str = "",
                    phase: str = "") -> float:
        return self._counters.get(_key(name, rank, tier, phase), 0.0)

    def get_gauge(self, name: str, *, rank: int = -1, tier: str = "",
                  phase: str = "") -> Optional[float]:
        return self._gauges.get(_key(name, rank, tier, phase))

    def total(self, name: str, *, rank: Optional[int] = None,
              tier: Optional[str] = None,
              phase: Optional[str] = None) -> float:
        """Sum of all counters matching the (partial) label filter."""
        return sum(
            v for _, v in self._match(self._counters, name, rank, tier, phase)
        )

    def counters(self, *, name: Optional[str] = None,
                 rank: Optional[int] = None, tier: Optional[str] = None,
                 phase: Optional[str] = None) -> Dict[MetricKey, float]:
        return dict(self._match(self._counters, name, rank, tier, phase))

    def gauges(self, *, name: Optional[str] = None,
               rank: Optional[int] = None, tier: Optional[str] = None,
               phase: Optional[str] = None) -> Dict[MetricKey, float]:
        return dict(self._match(self._gauges, name, rank, tier, phase))

    def ranks(self) -> List[int]:
        rs = {k[1] for k in self._counters} | {k[1] for k in self._gauges}
        return sorted(r for r in rs if r >= 0)

    # ---------------- serialization ----------------
    @staticmethod
    def _row(k: MetricKey, value) -> dict:
        return {"name": k[0], "rank": k[1], "tier": k[2], "phase": k[3],
                "value": value}

    def to_dict(self) -> dict:
        hists = []
        for k, obs in sorted(self._hists.items()):
            a = np.asarray(obs, np.float64)
            p50, p90, p99 = (
                np.percentile(a, [50, 90, 99], method="lower")
                if a.size else (0.0, 0.0, 0.0)
            )
            hists.append({
                "name": k[0], "rank": k[1], "tier": k[2], "phase": k[3],
                "count": int(a.size),
                "sum": float(a.sum()),
                "min": float(a.min()) if a.size else 0.0,
                "max": float(a.max()) if a.size else 0.0,
                "p50": float(p50), "p90": float(p90), "p99": float(p99),
            })
        return {
            "schema": "repro.obs.metrics/v1",
            "counters": [self._row(k, v)
                         for k, v in sorted(self._counters.items())],
            "gauges": [self._row(k, v)
                       for k, v in sorted(self._gauges.items())],
            "histograms": hists,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        snap = json.load(f)
    if snap.get("schema") != "repro.obs.metrics/v1":
        raise ValueError(f"{path}: not a repro.obs metrics snapshot")
    return snap


# --------------------------------------------------------------------------
# Adapters over the existing ledgers. All duck-typed on attribute names so
# repro_torch.obs stays import-clean of the rest of the package (no cycles).
# --------------------------------------------------------------------------

def _record_dataclass_counters(reg: MetricRegistry, stats, *, rank: int,
                               tier: str, phase: str = "") -> None:
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, (int, float, np.integer, np.floating)):
            reg.counter(f.name, float(v), rank=rank, tier=tier, phase=phase)


def record_provider_stats(reg: MetricRegistry, stats, *,
                          rank: int = -1) -> None:
    """One rank's ``ProviderStats`` → ``host``-tier counters (transport:
    local/remote reads, host-cache hits/misses, device-tier hits,
    modeled comm seconds)."""
    _record_dataclass_counters(reg, stats, rank=rank, tier="host")
    # row_requests is the invariant anchor: every row the rank asked for,
    # however it was resolved (locally, device tier, host cache, or wire).
    reg.counter("row_requests", stats.local_reads + stats.remote_reads,
                rank=rank, tier="host", phase="fetch_rows")
    # per-tenant transport attribution (dict fields are skipped by the
    # generic dataclass walk above, so flatten them here).
    for t, n in getattr(stats, "tenant_requests", {}).items():
        reg.counter(f"tenant_requests:{t}", n, rank=rank, tier="host")
    for t, b in getattr(stats, "tenant_bytes_fetched", {}).items():
        reg.counter(f"tenant_bytes_fetched:{t}", b, rank=rank, tier="host")


def record_cache_stats(reg: MetricRegistry, stats, *, rank: int = -1,
                       tier: str = "host_cache") -> None:
    """``CacheStats`` (CLaMPI layer) → ``host_cache``-tier counters."""
    _record_dataclass_counters(reg, stats, rank=rank, tier=tier)


def record_residency_stats(reg: MetricRegistry, stats, *,
                           rank: int = -1) -> None:
    """``ResidencyStats`` (device-resident hot-row tier) → ``device``."""
    _record_dataclass_counters(reg, stats, rank=rank, tier="device")


def record_collective_ledger(reg: MetricRegistry, ledger) -> None:
    """``CollectiveLedger`` → ``wire``-tier *measured* counters, keyed to
    the ``all_to_all`` phase, plus per-owner served-row counters."""
    reg.counter("rma_rows_measured", float(ledger.rows_shipped.sum()),
                tier="wire", phase="all_to_all")
    reg.counter("rma_bytes_measured", float(ledger.bytes_payload),
                tier="wire", phase="all_to_all")
    reg.counter("bytes_on_wire", float(ledger.bytes_on_wire),
                tier="wire", phase="all_to_all")
    reg.counter("n_collectives", float(ledger.n_collectives),
                tier="wire", phase="all_to_all")
    reg.counter("n_pairs", float(ledger.n_pairs),
                tier="wire", phase="all_to_all")
    reg.counter("device_wall_s", float(ledger.device_wall_s),
                tier="wire", phase="all_to_all")
    # The async data plane's savings ledgers: what the width-bucketed
    # collectives stopped padding onto the wire, and what the resident
    # device buffer stopped re-uploading (getattr: tolerate pre-async
    # ledger shims in tests).
    reg.counter("bytes_on_wire_single",
                float(getattr(ledger, "bytes_on_wire_single", 0)),
                tier="wire", phase="all_to_all")
    reg.counter("wire_padding_saved",
                float(getattr(ledger, "wire_padding_saved", 0)),
                tier="wire", phase="all_to_all")
    reg.counter("bytes_uploaded",
                float(getattr(ledger, "bytes_uploaded", 0)),
                tier="wire", phase="spmd_patch")
    reg.counter("upload_bytes_saved",
                float(getattr(ledger, "upload_bytes_saved", 0)),
                tier="wire", phase="spmd_patch")
    reg.counter("spmd_patches", float(getattr(ledger, "n_patches", 0)),
                tier="wire", phase="spmd_patch")
    reg.counter("overlap_wait_s",
                float(getattr(ledger, "overlap_wait_s", 0.0)),
                tier="wire", phase="spmd_overlap_wait")
    served = np.asarray(ledger.rows_shipped).sum(axis=1)
    for k in range(served.size):
        reg.counter("rows_served_measured", float(served[k]), rank=k,
                    tier="wire", phase="all_to_all")


def record_latency(reg: MetricRegistry, recorder, *, rank: int = -1) -> None:
    """``LatencyRecorder`` → ``serving``-tier histograms (overall and
    per SLO class) + shed counters by reason."""
    reg.observe("latency_s", recorder._lat, rank=rank, tier="serving")
    reg.counter("wall_s", recorder.wall_s, rank=rank, tier="serving",
                phase="scheduler_flush")
    for reason, n in recorder.sheds.items():
        reg.counter(f"shed_{reason}", n, rank=rank, tier="serving")
    for cls, lats in getattr(recorder, "by_class", lambda: {})().items():
        reg.observe(f"latency_s:{cls}", lats, rank=rank, tier="serving")
    # SLO attainment (only recorders that saw deadline-stamped queries
    # carry violations; pre-SLO recorders default to zero).
    reg.counter("slo_violations", getattr(recorder, "slo_violations", 0),
                rank=rank, tier="serving")
    summ = recorder.summary()
    reg.gauge("slo_hit_rate", summ.slo_hit_rate, rank=rank, tier="serving")


def record_tenancy(reg: MetricRegistry, quotas, runtime=None, *,
                   rank: int = -1) -> None:
    """``TenantQuotas`` (+ optionally the runtime's per-rank caches) →
    ``serving``/``host_cache`` tenancy counters and gauges: global
    admission outcomes, per-tenant token-bucket levels, and — when a
    cached runtime is passed — per-tenant resident cache bytes, whose
    sum equals each cache's ``used_bytes`` (the accounting invariant
    the traffic bench asserts)."""
    for outcome, per_tenant in quotas.counters().items():
        reg.counter(f"quota_{outcome}", sum(per_tenant.values()),
                    rank=rank, tier="serving")
        for t, n in per_tenant.items():
            reg.counter(f"quota_{outcome}:{t}", n, rank=rank,
                        tier="serving")
    for t, lvl in quotas.bucket_levels().items():
        reg.gauge(f"quota_tokens:{t}", lvl, rank=rank, tier="serving")
    for t, share in quotas.cache_shares().items():
        reg.gauge(f"cache_share:{t}", share, rank=rank, tier="host_cache")
    caches = getattr(runtime, "caches", None) if runtime is not None else None
    if caches is not None:
        for r, c in enumerate(caches):
            for t, b in sorted(c.tenant_bytes().items()):
                reg.counter(f"tenant_cache_bytes:{t or '_untagged'}", b,
                            rank=r, tier="host_cache")


def record_coherence_report(reg: MetricRegistry, report) -> None:
    """Streaming ``CoherenceReport`` → ``host_cache`` counters under the
    ``delta_replay`` phase."""
    _record_dataclass_counters(reg, report, rank=-1, tier="host_cache",
                               phase="delta_replay")


def record_runtime(reg: MetricRegistry, runtime) -> None:
    """The whole ``ShardedRuntime``: per-rank provider + cache stats,
    device-tier stats, the modeled serve matrix, and the derived
    placement gauges (``load_imbalance``, ``serve_matrix_skew``)."""
    for rank, st in enumerate(runtime.stats):
        record_provider_stats(reg, st, rank=rank)
    if runtime.caches is not None:
        for rank, c in enumerate(runtime.caches):
            record_cache_stats(reg, c.stats, rank=rank)
    for dev in getattr(runtime, "device_views", lambda: [])():
        # replicated: one view at rank -1; per_rank: one per rank
        record_residency_stats(reg, dev.stats,
                               rank=getattr(dev, "rank", -1))

    serve = np.asarray(runtime.serve_rows, np.float64)
    reg.counter("rma_rows_modeled", float(serve.sum()),
                tier="wire", phase="fetch_rows")
    reg.counter("rma_bytes_modeled",
                float(sum(s.bytes_fetched for s in runtime.stats)),
                tier="wire", phase="fetch_rows")
    for k in range(serve.shape[0]):
        reg.counter("rows_served_modeled", float(serve[k].sum()), rank=k,
                    tier="wire", phase="fetch_rows")

    # Placement gauges (ROADMAP items 1/2): how evenly reads land on
    # ranks, and how evenly owners shoulder the serving load.
    loads = np.asarray(
        [s.local_reads + s.remote_reads for s in runtime.stats], np.float64
    )
    reg.gauge("load_imbalance", imbalance(loads), tier="host")
    for rank in range(loads.size):
        reg.gauge("row_reads", loads[rank], rank=rank, tier="host")
    reg.gauge("serve_matrix_skew", imbalance(serve.sum(axis=1)),
              tier="wire")

    # Online repartitioning (core.repartition): how often ownership
    # moved and how many rows changed hands — zero on static runs.
    reg.counter("partition_migrations",
                int(getattr(runtime, "migrations", 0)),
                tier="host", phase="migrate")
    reg.counter("rows_migrated",
                int(getattr(runtime, "rows_migrated", 0)),
                tier="host", phase="migrate")


def imbalance(per_rank) -> float:
    """max/mean over a per-rank load vector — 1.0 is perfectly balanced;
    0.0 when there is no load at all (so a populated gauge always means
    "measured")."""
    per_rank = np.asarray(per_rank, np.float64)
    m = float(per_rank.mean()) if per_rank.size else 0.0
    return float(per_rank.max()) / m if m > 0 else 0.0


def record_reconciliation(reg: MetricRegistry, runtime,
                          ledger=None) -> None:
    """Measured-vs-modeled RMA reconciliation as a first-class metric.

    The modeled side is the runtime's serve matrix / ``bytes_fetched``
    (what the 1D-partition cost model says must move); the measured side
    is the ``CollectiveLedger`` (what the SPMD all_to_all actually
    shipped, payload-true). ``rma_agreement`` is 1.0 iff both rows and
    bytes agree exactly — the same invariant the SPMD engine asserts per
    microbatch, now exported and CI-validated end to end."""
    modeled_rows = float(np.asarray(runtime.serve_rows).sum())
    modeled_bytes = float(sum(s.bytes_fetched for s in runtime.stats))
    if ledger is None:
        return
    measured_rows = float(ledger.rows_shipped.sum())
    measured_bytes = float(ledger.bytes_payload)
    agree = (measured_rows == modeled_rows
             and measured_bytes == modeled_bytes)
    reg.gauge("rma_agreement", 1.0 if agree else 0.0, tier="wire")
    reg.gauge("rma_bytes_delta", measured_bytes - modeled_bytes,
              tier="wire")
    reg.gauge("rma_rows_delta", measured_rows - modeled_rows, tier="wire")


def record_cachescope(reg: MetricRegistry, report: dict) -> None:
    """A cachescope analysis report (``repro.obs.cachescope/v1``) →
    per-stream gauges and per-policy replay counters. Gauges answer the
    cache-science questions directly from a metrics snapshot: did the
    replay reconcile, how premature are evictions, what would each
    policy have scored on this exact trace, and how far is the deployed
    policy from the clairvoyant bound."""
    for s in report["streams"]:
        tier = s["tier"]
        rank = int(s["rank"])
        reg.gauge("cachescope_reconciled",
                  1.0 if s["reconciled"] else 0.0, rank=rank, tier=tier)
        a = s["analysis"]
        audit = a.get("eviction_audit")
        if audit and audit["n_evictions"]:
            reg.gauge("premature_eviction_frac", audit["reref_frac"],
                      rank=rank, tier=tier)
            reg.counter("bytes_evicted_reref", audit["bytes_evicted_live"],
                        rank=rank, tier=tier)
        for pol, rep in s.get("replay", {}).items():
            if "hit_rate" in rep:
                reg.gauge(f"replay_hit_rate:{pol}", rep["hit_rate"],
                          rank=rank, tier=tier)
    summ = report["summary"]
    reg.gauge("cachescope_reconciled_all",
              1.0 if summ["all_reconciled"] else 0.0, tier="host_cache")
    reg.gauge("cachescope_belady_dominates",
              1.0 if summ["belady_dominates"] else 0.0, tier="host_cache")


def fold_trace(reg: MetricRegistry, tracer) -> None:
    """Fold a ``Tracer``'s per-phase rollup into the registry: wall
    seconds, call counts, and byte-tagged volume per phase name. This is
    the bridge that gives counters the time dimension the experiments
    report tabulates."""
    for name, d in tracer.phase_totals().items():
        reg.counter("phase_time_s", d["total_s"], phase=name)
        reg.counter("phase_calls", d["calls"], phase=name)
        if d["bytes"]:
            reg.counter("phase_bytes", d["bytes"], phase=name)
