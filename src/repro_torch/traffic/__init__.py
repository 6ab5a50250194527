"""Production traffic plane in front of the serving stack.

Four pillars, each deployed through the existing serving layers rather
than beside them:

- ``arrivals``  — open-loop arrival processes (Poisson / diurnal /
  burst / replayable trace files) + the virtual-time clocks
  (``VirtualClock``, ``HybridClock``) injectable into
  ``MicrobatchScheduler``, so p99 measures queueing, not batch compute.
- ``slo``       — per-class deadlines (lcc / triangles /
  common_neighbors / top_k_lcc), EDF window flush, shed-by-class.
- ``tenancy``   — per-tenant token-bucket admission and cache byte
  shares with quota-aware eviction in ``ClampiCache``.
- ``scoring``   — live request-frequency EWMA (cachescope's exact
  replay formula) blended with degree, feeding both ``ClampiCache``
  and ``ResidencyManager`` scores.
- ``loadgen``   — the open-loop runner tying trace + scheduler + clock
  into latency-vs-offered-load reports.

See docs/serving.md for the end-to-end story.
"""
from .arrivals import (
    ArrivalTrace,
    HybridClock,
    VirtualClock,
    burst_arrivals,
    diurnal_arrivals,
    make_arrivals,
    poisson_arrivals,
)
from .loadgen import OpenLoopReport, run_open_loop
from .scoring import WorkloadScorer
from .slo import DEFAULT_DEADLINES_S, SLOPolicy
from .tenancy import TenantQuotas, TenantSpec, TokenBucket, assign_tenants

__all__ = [
    "ArrivalTrace",
    "VirtualClock",
    "HybridClock",
    "poisson_arrivals",
    "diurnal_arrivals",
    "burst_arrivals",
    "make_arrivals",
    "SLOPolicy",
    "DEFAULT_DEADLINES_S",
    "TokenBucket",
    "TenantSpec",
    "TenantQuotas",
    "assign_tenants",
    "WorkloadScorer",
    "OpenLoopReport",
    "run_open_loop",
]
