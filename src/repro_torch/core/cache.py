"""CLaMPI-style RMA cache (paper §II-F) + application-defined scores (§III-B2).

Two components:

1. ``ClampiCache`` — a faithful host-side simulator of the CLaMPI caching
   layer: hash-table-indexed variable-size entries in a bounded memory
   buffer with a free-list (the AVL tree of the real system is modeled as a
   sorted interval list — same first-fit semantics), external-fragmentation-
   aware victim selection (LRU weighted by a positional score), optional
   application-defined scores (the paper's extension: degree centrality),
   always-cache/transparent/user modes, and the adaptive table-resize
   heuristic (which flushes on resize, as in the paper). It reports the
   hit/miss/compulsory/eviction statistics and the modeled communication
   time ``t(s) = alpha + s * beta`` (§IV-D1) that the Fig. 7/8 benchmarks
   plot.

2. ``StaticDegreeCache`` — the device-side realization: because degree is
   known before the epoch and the paper's own Observations 3.1/3.2 say
   degree predicts reuse, the optimal degree-scored working set can be
   *precomputed*: the top-C highest-in-degree non-local vertices are made
   cache-resident per device before the compute loop. This is what the
   epoch engine consumes (static shapes — no data-dependent
   eviction inside the device program). The dynamic simulator above is used
   offline to pick C and to reproduce the paper's cache science.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import cachescope as obs_cachescope
from ..obs import trace as obs_trace

__all__ = [
    "NetworkModel",
    "CacheStats",
    "merge_cache_stats",
    "ClampiCache",
    "StaticDegreeCache",
    "build_static_degree_cache",
    "StaticCacheRefresh",
    "refresh_static_degree_cache",
]


@dataclasses.dataclass
class NetworkModel:
    """Remote-read cost model t(s) = alpha + s*beta (paper §IV-D1).

    Defaults approximate a Cray Aries put/get: ~2 us setup, ~10 GB/s/link
    effective per-get streaming; the cache-hit path costs a hash probe.
    """

    alpha: float = 2.0e-6
    beta: float = 1.0e-10
    hit_cost: float = 5.0e-8
    insert_cost: float = 1.0e-7

    def remote(self, size_bytes: float) -> float:
        return self.alpha + size_bytes * self.beta


@dataclasses.dataclass
class CacheStats:
    gets: int = 0
    hits: int = 0
    misses: int = 0
    compulsory_misses: int = 0
    evictions: int = 0
    flushes: int = 0
    invalidations: int = 0  # coherence: entries dropped because stale
    bytes_hit: int = 0
    bytes_missed: int = 0
    # bytes of evicted entries later re-referenced: the live byte-
    # denominated "premature eviction" counter (cachescope audits the
    # access-window version offline)
    bytes_evicted_live: int = 0
    comm_time: float = 0.0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.gets if self.gets else 0.0

    @property
    def miss_rate(self) -> float:
        return 1.0 - self.hit_rate if self.gets else 0.0


def merge_counter_dataclasses(cls, items):
    """Field-wise sum over flat numeric-counter dataclasses (per-rank
    statistics aggregation). Enumerates ``dataclasses.fields`` so a new
    counter can never be silently dropped from an aggregate. Dict-valued
    fields (per-tenant counters) merge key-wise."""
    out = cls()
    for s in items:
        for f in dataclasses.fields(cls):
            cur, add = getattr(out, f.name), getattr(s, f.name)
            if isinstance(cur, dict):
                for k, v in add.items():
                    cur[k] = cur.get(k, 0) + v
            else:
                setattr(out, f.name, cur + add)
    return out


def merge_cache_stats(stats: List["CacheStats"]) -> CacheStats:
    """Aggregated view over per-rank cache statistics."""
    return merge_counter_dataclasses(CacheStats, stats)


@dataclasses.dataclass
class _Entry:
    key: int
    addr: int
    size: int
    last_use: int
    score: Optional[float]  # application-defined; None => LRU+positional
    # multi-tenant serving: who fetched this row first (quota-aware
    # eviction keys on it). Must stay LAST with a default — cachescope's
    # replay preload constructs _Entry positionally without it.
    tenant: str = ""


class ClampiCache:
    """Simulator of the CLaMPI RMA caching layer.

    mode: 'always' (read-only data, never flushed between epochs — the
    paper's configuration for LCC), 'transparent' (flush at epoch close),
    'user' (explicit ``flush()``).
    """

    # offline-replay caches set this True on the instance so an active
    # cachescope recorder never re-records a replay of its own trace
    _scope_exempt = False

    def __init__(
        self,
        capacity_bytes: int,
        table_slots: int,
        *,
        mode: str = "always",
        positional_weight: float = 0.5,
        adaptive: bool = False,
        network: Optional[NetworkModel] = None,
    ):
        assert mode in ("always", "transparent", "user")
        self.capacity = int(capacity_bytes)
        self.table_slots = int(table_slots)
        self.mode = mode
        self.positional_weight = positional_weight
        self.adaptive = adaptive
        self.net = network or NetworkModel()
        self.entries: Dict[int, _Entry] = {}
        self.free: List[Tuple[int, int]] = [(0, self.capacity)]  # (addr, size)
        self.clock = 0
        self.stats = CacheStats()
        self._seen: set[int] = set()
        self._conflicts = 0
        self._evicted_sizes: Dict[int, int] = {}  # victim key -> size
        # multi-tenant byte reservations: tenant -> fraction of capacity.
        # Empty (default) = tenancy off, every path bit-identical to the
        # single-tenant cache. NOTE: tenant-share eviction consults state
        # a recorded access trace does not carry, so runs with shares
        # active must not assert cachescope's deployed-replay invariant
        # (see docs/serving.md).
        self.tenant_shares: Dict[str, float] = {}

    # ---------------- multi-tenant accounting ----------------
    def set_tenant_shares(self, shares: Dict[str, float]) -> None:
        """Install per-tenant byte-share fractions (hard caps for tagged
        tenants; untagged traffic is best-effort in the remainder)."""
        assert all(0.0 < v <= 1.0 for v in shares.values())
        assert sum(shares.values()) <= 1.0 + 1e-9, "shares oversubscribed"
        self.tenant_shares = dict(shares)

    def tenant_bytes(self) -> Dict[str, int]:
        """Resident bytes per tenant ("" = untagged). Computed from the
        entry table so it can never drift from ``used_bytes``: the two
        sum identically by construction."""
        out: Dict[str, int] = {}
        for e in self.entries.values():
            out[e.tenant] = out.get(e.tenant, 0) + e.size
        return out

    def _share_cap(self, tenant: str) -> Optional[float]:
        if not tenant or not self.tenant_shares:
            return None
        share = self.tenant_shares.get(tenant)
        return None if share is None else share * self.capacity

    # ---------------- memory buffer management ----------------
    def _alloc(self, size: int) -> Optional[int]:
        """First-fit allocation from the free interval list."""
        for i, (addr, sz) in enumerate(self.free):
            if sz >= size:
                if sz == size:
                    self.free.pop(i)
                else:
                    self.free[i] = (addr + size, sz - size)
                return addr
        return None

    def _dealloc(self, addr: int, size: int) -> None:
        """Insert + coalesce (what the AVL free tree does in CLaMPI)."""
        self.free.append((addr, size))
        self.free.sort()
        merged: List[Tuple[int, int]] = []
        for a, s in self.free:
            if merged and merged[-1][0] + merged[-1][1] == a:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((a, s))
        self.free = merged

    def _positional_bonus(self, e: _Entry) -> float:
        """How much contiguous free space removing ``e`` would create,
        normalized by entry size — CLaMPI's anti-fragmentation score."""
        gain = e.size
        for a, s in self.free:
            if a + s == e.addr or e.addr + e.size == a:
                gain += s
        return gain / max(e.size, 1)

    # ---------------- victim selection ----------------
    def _select_victim(self, entries: Optional[List[_Entry]] = None) -> _Entry:
        if entries is None:
            entries = list(self.entries.values())
        has_user = any(e.score is not None for e in entries)
        if has_user:
            # paper §III-B2: application score dominates; positional/spatial
            # effect intentionally lost. Tie-break by LRU.
            return min(
                entries,
                key=lambda e: (
                    e.score if e.score is not None else float("inf"),
                    e.last_use,
                ),
            )
        # default: LRU weighted by positional (fragmentation) bonus
        return max(
            entries,
            key=lambda e: (self.clock - e.last_use)
            * (1.0 + self.positional_weight * self._positional_bonus(e)),
        )

    # ---------------- public API ----------------
    def get(self, key: int, size: int, *, score: Optional[float] = None,
            tenant: str = "") -> bool:
        """One RMA get of ``size`` bytes for entry ``key``.

        Returns True on hit. On miss, models the remote read and tries to
        cache the entry (CLaMPI caches a missing entry only if resources
        allow after eviction attempts). ``tenant`` tags the entry for
        quota-aware eviction; a hit keeps the original owner tag
        (first-fetcher semantics — shared rows stay charged to whoever
        brought them in).
        """
        rec = obs_cachescope._recorder  # one load + None check when off
        if rec is not None:
            # register the stream BEFORE any stat/clock mutation so the
            # baseline snapshot excludes this very access
            rec.touch(self)
        self.clock += 1
        st = self.stats
        st.gets += 1
        e = self.entries.get(key)
        if e is not None:
            e.last_use = self.clock
            if score is not None:
                e.score = score
            st.hits += 1
            st.bytes_hit += size
            st.comm_time += self.net.hit_cost
            if rec is not None:
                rec.on_get(self, key, size, score, True)
            return True
        st.misses += 1
        if key not in self._seen:
            st.compulsory_misses += 1
            self._seen.add(key)
        prev = self._evicted_sizes.pop(key, None)
        if prev is not None:
            st.bytes_evicted_live += prev
        st.bytes_missed += size
        st.comm_time += self.net.remote(size)
        if rec is not None:
            rec.on_get(self, key, size, score, False)
        self._insert(key, size, score, tenant)
        if self.adaptive:
            self._maybe_resize()
        return False

    def _insert(self, key: int, size: int, score: Optional[float],
                tenant: str = "") -> None:
        if size > self.capacity:
            return
        cap = self._share_cap(tenant)
        if cap is not None:
            if size > cap:
                return  # one entry larger than the tenant's whole share
            # evict-own-first: a tenant over its reservation reclaims
            # from itself before touching shared space — the isolation
            # contract. Refusal (own victims all score higher) means the
            # incoming entry loses to the tenant's own working set.
            while self.tenant_bytes().get(tenant, 0) + size > cap:
                own = [e for e in self.entries.values()
                       if e.tenant == tenant]
                if not own or not self._evict_one(
                    need_better_than=score, candidates=own
                ):
                    return
        # victim loop: evict while out of table slots or buffer space
        while True:
            if len(self.entries) >= self.table_slots:
                self._evict_one(need_better_than=score, requester=tenant)
                if len(self.entries) >= self.table_slots:
                    return  # refused (new entry scored lower than victims)
                continue
            addr = self._alloc(size)
            if addr is not None:
                self.entries[key] = _Entry(key, addr, size, self.clock,
                                           score, tenant)
                self.stats.comm_time += self.net.insert_cost
                if obs_trace.fine_enabled():  # per-entry; fine mode only
                    obs_trace.instant("cache_admit", cat="cache",
                                      key=key, bytes=size)
                return
            if not self.entries:
                return
            if not self._evict_one(need_better_than=score, requester=tenant):
                return

    def _quota_candidates(self, requester: str) -> List[_Entry]:
        """Victim pool under tenancy: the requester's own entries,
        untagged entries, and tenants at-or-over their reserved share.
        Tenants strictly *under* their share are spared — that working
        set is exactly what the reservation protects. Falls back to
        everything when the protected set is the whole cache."""
        if not self.tenant_shares:
            return list(self.entries.values())
        tb = self.tenant_bytes()
        under = {
            t for t, share in self.tenant_shares.items()
            if tb.get(t, 0) < share * self.capacity
        }
        pool = [e for e in self.entries.values()
                if e.tenant == requester or e.tenant not in under]
        return pool if pool else list(self.entries.values())

    def _evict_one(self, need_better_than: Optional[float] = None,
                   requester: str = "",
                   candidates: Optional[List[_Entry]] = None) -> bool:
        if not self.entries:
            return False
        if candidates is None:
            candidates = self._quota_candidates(requester)
        if not candidates:
            return False
        v = self._select_victim(candidates)
        if (
            need_better_than is not None
            and v.score is not None
            and v.score >= need_better_than
        ):
            return False  # incoming entry is less valuable than every victim
        del self.entries[v.key]
        self._dealloc(v.addr, v.size)
        self.stats.evictions += 1
        self._evicted_sizes[v.key] = v.size
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_evict(self, v.key, v.size, v.score)
        if obs_trace.fine_enabled():  # per-entry; fine mode only
            obs_trace.instant("cache_evict", cat="cache",
                              key=v.key, bytes=v.size)
        return True

    def _maybe_resize(self) -> None:
        """Adaptive heuristic (§II-F): grow the table when slot conflicts
        dominate; flushes the cache — so good initial values matter
        (§III-B1), which the Fig. 7 benchmark demonstrates."""
        st = self.stats
        if (
            len(self.entries) >= self.table_slots
            and st.evictions > 4 * self.table_slots
        ):
            self.table_slots *= 2
            self._flush_internal()

    def invalidate(self, key: int) -> bool:
        """Coherence hook: drop ``key`` because its backing data changed
        (streaming updates mutate adjacency rows in place). Unlike an
        eviction this is a *correctness* removal — the next get is a miss
        that refetches fresh data. Returns True if an entry was dropped."""
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_invalidate(self, key)
        e = self.entries.pop(key, None)
        if e is None:
            # data changed for an already-evicted key: its next miss is
            # a correctness refetch, not a premature-eviction signal
            self._evicted_sizes.pop(key, None)
            return False
        self._dealloc(e.addr, e.size)
        self.stats.invalidations += 1
        return True

    def invalidate_many(self, keys) -> int:
        """Batch coherence hook (one streaming update batch mutates many
        rows). Returns the number of entries dropped."""
        return sum(self.invalidate(int(k)) for k in keys)

    def contains(self, key: int) -> bool:
        """Residency probe without touching LRU/statistics — lets a
        payload-carrying layer (serving row provider) mirror this cache's
        admission/eviction decisions."""
        return key in self.entries

    def _flush_internal(self) -> None:
        """Flush without recording a trace event — used by paths the
        cache triggers itself (adaptive resize, transparent epoch close),
        which an offline replay regenerates deterministically."""
        self.entries.clear()
        self.free = [(0, self.capacity)]
        self.stats.flushes += 1
        self._evicted_sizes.clear()

    def flush(self) -> None:
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_flush(self)
        self._flush_internal()

    def close_epoch(self) -> None:
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_close_epoch(self)
        if self.mode == "transparent":
            self._flush_internal()

    @property
    def used_bytes(self) -> int:
        return sum(e.size for e in self.entries.values())


# --------------------------------------------------------------------------
# Static degree-scored cache (device-side realization).
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StaticDegreeCache:
    """Precomputed cache residency: the top-C in-degree non-local vertices.

    vertex_ids:  [C] global ids resident in every device's cache (sorted)
    capacity_rows: C
    The engine stores the corresponding padded rows replicated per device;
    lookup is a host-side precomputation (each edge's remote endpoint maps
    to a cache slot or -1), so the compiled program does plain gathers.
    """

    vertex_ids: np.ndarray

    @property
    def capacity_rows(self) -> int:
        return int(self.vertex_ids.shape[0])

    def slot_of(self, v: np.ndarray) -> np.ndarray:
        """Cache slot per vertex id (-1 if not resident). Vectorized."""
        v = np.asarray(v, np.int64)
        if self.capacity_rows == 0:
            return np.full(v.shape, -1, np.int32)
        idx = np.searchsorted(self.vertex_ids, v)
        idx = np.minimum(idx, self.capacity_rows - 1)
        ok = self.vertex_ids[idx] == v
        return np.where(ok, idx, -1).astype(np.int32)


def build_static_degree_cache(
    degrees: np.ndarray,
    capacity_rows: int,
    *,
    score_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> StaticDegreeCache:
    """Pick cache residents by score (default: degree centrality, §III-B2)."""
    n = degrees.shape[0]
    c = min(capacity_rows, n)
    score = degrees if score_fn is None else score_fn(degrees)
    if c <= 0:
        return StaticDegreeCache(vertex_ids=np.zeros((0,), np.int64))
    # stable tie-break by vertex id: equal-score residency must not
    # reshuffle between calls, or streaming rescores would count tie
    # noise as drift (power-law graphs have large tie classes).
    order = np.lexsort((np.arange(n), score))
    top = order[n - c :]
    return StaticDegreeCache(vertex_ids=np.sort(top.astype(np.int64)))


# --------------------------------------------------------------------------
# Streaming coherence for the static cache.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StaticCacheRefresh:
    """Outcome of rescoring a ``StaticDegreeCache`` after updates.

    stale_ids:   resident vertices whose adjacency changed — their cached
                 rows must be refetched regardless of ranking (correctness).
    evicted:     residents that fell out of the top-C by degree score.
    admitted:    vertices newly promoted into the top-C.
    rebuilt:     whether a new resident set was installed.
    """

    cache: StaticDegreeCache
    stale_ids: np.ndarray
    evicted: int
    admitted: int
    rebuilt: bool

    @property
    def stale_rows(self) -> int:
        return int(self.stale_ids.shape[0])


def refresh_static_degree_cache(
    cache: StaticDegreeCache,
    degrees: np.ndarray,
    changed_ids: np.ndarray,
    *,
    rebuild_fraction: float = 0.0,
    score_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> StaticCacheRefresh:
    """Rescore/invalidate cache residency after degrees changed.

    The paper's Observations 3.1/3.2 motivate degree as the residency
    score; once edges stream in, the score *drifts*. Residents whose
    adjacency changed are stale (rows must be refreshed in place); when
    the drift in the top-C membership exceeds ``rebuild_fraction`` of
    capacity, the resident set itself is rebuilt from current degrees.

    The full O(n log n) rescoring pass is skipped when no membership
    change is possible: no resident changed and every changed outsider
    still scores below the weakest resident — the common case for small
    batches, keeping per-batch cost proportional to the delta.
    """
    changed = np.asarray(changed_ids, np.int64)
    resident_mask = cache.slot_of(changed) >= 0
    stale_ids = changed[resident_mask]
    c = cache.capacity_rows
    if c == 0 or changed.size == 0:
        return StaticCacheRefresh(cache, stale_ids, 0, 0, False)
    score = np.asarray(degrees) if score_fn is None else score_fn(degrees)
    if stale_ids.size == 0:
        outsiders = changed[~resident_mask]
        if score[outsiders].max() < score[cache.vertex_ids].min():
            return StaticCacheRefresh(cache, stale_ids, 0, 0, False)
    fresh = build_static_degree_cache(degrees, c, score_fn=score_fn)
    drift = np.setdiff1d(cache.vertex_ids, fresh.vertex_ids, assume_unique=True)
    if drift.size and drift.size >= rebuild_fraction * c:
        admitted = np.setdiff1d(
            fresh.vertex_ids, cache.vertex_ids, assume_unique=True
        )
        return StaticCacheRefresh(
            fresh, stale_ids, int(drift.size), int(admitted.size), True
        )
    return StaticCacheRefresh(cache, stale_ids, 0, 0, False)
