"""Multi-tenant admission: per-tenant rate limits and cache shares.

A shared serving stack needs isolation in two places:

1. **The front door** — each tenant gets a token bucket
   (``rate_qps`` sustained, ``burst`` depth). A submit that finds the
   tenant's bucket empty is shed with reason ``"quota"`` *before* it
   can occupy queue depth — an aggressive tenant saturates its own
   budget, not the scheduler.
2. **The cache** — each tenant gets a byte share of ``ClampiCache``
   capacity. Entries are tenant-tagged at admission; eviction is
   quota-aware (a tenant over its share evicts its *own* entries first,
   and general victim selection spares tenants strictly under their
   share), so one hot tenant cannot flush another's working set.
   Per-tenant request/byte counters surface in ``ProviderStats``.

The shares are a soft fairness contract, not a hard partition: bytes a
tenant is not using remain available to everyone (work-conserving),
and are reclaimed from over-share tenants on demand.

``TenantQuotas`` is the one object both layers read; construct it with
``TenantQuotas.uniform(n)`` for symmetric tenants or per-tenant
``TenantSpec`` entries for skewed contracts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

__all__ = ["TokenBucket", "TenantSpec", "TenantQuotas", "assign_tenants"]


class TokenBucket:
    """Lazy-refill token bucket: ``rate`` tokens/s up to ``burst``.

    No background thread — tokens owed since the last call are credited
    inside ``try_take``, so the bucket works under any clock (virtual,
    hybrid, wall)."""

    def __init__(self, rate: float, burst: float, *, t0: float = 0.0):
        assert rate > 0.0 and burst >= 1.0
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)  # start full: cold tenants can burst
        self._t = float(t0)

    def _refill(self, now: float) -> None:
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = max(self._t, now)

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def level(self, now: float) -> float:
        self._refill(now)
        return self._tokens


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract: sustained rate, burst depth, cache share
    (fraction of cache capacity; shares are normalized across tenants
    if they sum past 1)."""

    name: str
    rate_qps: float = 100.0
    burst: float = 16.0
    cache_share: float = 0.0  # 0 = no reserved share (best effort)


class TenantQuotas:
    """Admission + accounting for a fixed tenant set."""

    def __init__(self, specs: Sequence[TenantSpec], *, t0: float = 0.0):
        names = [s.name for s in specs]
        assert len(names) == len(set(names)), "duplicate tenant names"
        self.specs: Dict[str, TenantSpec] = {s.name: s for s in specs}
        self._buckets: Dict[str, TokenBucket] = {
            s.name: TokenBucket(s.rate_qps, s.burst, t0=t0) for s in specs
        }
        self.admitted: Dict[str, int] = {s.name: 0 for s in specs}
        self.rejected: Dict[str, int] = {s.name: 0 for s in specs}

    @staticmethod
    def uniform(n: int, *, rate_qps: float = 100.0, burst: float = 16.0,
                cache_share: Optional[float] = None,
                t0: float = 0.0) -> "TenantQuotas":
        """n symmetric tenants ``t0..t{n-1}`` splitting the cache
        evenly (pass ``cache_share=0.0`` for best-effort tenants)."""
        share = (1.0 / n) if cache_share is None else float(cache_share)
        return TenantQuotas(
            [TenantSpec(f"t{i}", rate_qps=rate_qps, burst=burst,
                        cache_share=share) for i in range(n)],
            t0=t0,
        )

    @property
    def tenants(self) -> List[str]:
        return list(self.specs)

    def admit(self, tenant: str, now: float) -> bool:
        """Charge one request against the tenant's bucket. Unknown or
        empty tenant tags are never rate-limited (the untagged path
        must keep working for single-tenant deployments)."""
        bucket = self._buckets.get(tenant)
        if bucket is None:
            return True
        ok = bucket.try_take(now)
        (self.admitted if ok else self.rejected)[tenant] += 1
        return ok

    def cache_shares(self) -> Dict[str, float]:
        """Per-tenant byte-share fractions, normalized to sum ≤ 1."""
        raw = {n: s.cache_share for n, s in self.specs.items()
               if s.cache_share > 0.0}
        total = sum(raw.values())
        if total > 1.0:
            raw = {n: v / total for n, v in raw.items()}
        return raw

    def bucket_levels(self, now: Optional[float] = None) -> Dict[str, float]:
        """Tokens per tenant; ``now=None`` reads as-of each bucket's
        last refill (pure snapshot, no clock needed)."""
        return {n: b.level(b._t if now is None else now)
                for n, b in self._buckets.items()}

    def counters(self) -> Dict[str, Dict[str, int]]:
        return {"admitted": dict(self.admitted),
                "rejected": dict(self.rejected)}


def assign_tenants(queries: Sequence, tenants: Sequence[str], *,
                   rng: Optional[np.random.Generator] = None,
                   weights: Optional[Mapping[str, float]] = None) -> List:
    """Tag each query with a tenant, sampled i.i.d. (optionally
    weighted — skew one tenant hot to exercise isolation). Deterministic
    under the caller's rng; returns new frozen Query instances."""
    rng = rng or np.random.default_rng(0)
    names = list(tenants)
    if weights is not None:
        w = np.asarray([weights.get(n, 0.0) for n in names], np.float64)
        assert w.sum() > 0.0
        p = w / w.sum()
    else:
        p = None
    idx = rng.choice(len(names), size=len(queries), p=p)
    return [dataclasses.replace(q, tenant=names[i])
            for q, i in zip(queries, idx)]
