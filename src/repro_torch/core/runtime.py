"""Sharded RMA runtime: the shared partition/cache/transport substrate.

The paper's central claim is that ONE asynchronous RMA+caching layer
(1D partition, CLaMPI-style caches, degree-scored victim selection)
serves every consumer — the epoch sweep, streaming maintenance, and
point-query serving. This module is that layer, extracted so the three
consumers stop re-implementing single-rank views of it:

- **Ownership** — a partition (``Partition1D`` or ``HubPartition``)
  answers ``owner(v)`` for every consumer; rank ``k`` owns the
  contiguous block ``[lo(k), hi(k))``. The contract (owner/lo/hi/sizes
  /block/route — see ``core.partition`` and docs/partitioning.md) is
  all the runtime assumes, so swapping partition families never
  touches a consumer. With a hub-aware partition, remote misses of
  split hub rows charge one *fragment* serve per holding rank instead
  of one whole-row serve from the owner, and ``migrate(new_cuts)``
  moves ownership boundaries live (cache-invalidation fanout +
  device-residency handoff + schedule rebuild).
- **Transport** — ``fetch_rows(rank, vertices)`` is the rank-indexed
  remote-read path: rows owned by ``rank`` are free, remote rows pay the
  modeled ``NetworkModel`` get and pass through rank ``rank``'s
  ``ClampiCache`` (degree-scored admission, real payloads). The
  ``serve_rows`` matrix accumulates the all-to-all serve lists (rows
  shipped owner -> requester) the static engine compiles ahead of time.
- **Coherence** — ``invalidate(changed_ids)`` fans each mutated row out
  ONLY to the ranks whose cache holds it (``contains`` probe, no stats
  perturbation) instead of broadcasting to all p ranks; the fanout
  ledger records the saving. This is the correctness contract every
  payload-carrying cache relies on: a hit returns the payload captured
  at fetch time, so a mutated row must be dropped everywhere it is
  resident before the next read.
- **Schedule** — the runtime can carry the epoch engine's static pull
  schedule (``ShardedLCCProblem``) and keep it fresh under streaming
  deltas via ``maintain_schedule`` (incremental ``apply_delta`` with a
  width-overflow rebuild fallback).

Consumers hold *views*: a serving row provider is (runtime, rank); a
sharded query engine is p such views; the streaming engine shards its
delta worklists by ``runtime.part.owner``. None of them construct
partitions or caches themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as obs_trace
from .cache import (
    CacheStats,
    ClampiCache,
    NetworkModel,
    StaticDegreeCache,
    build_static_degree_cache,
    merge_cache_stats,
    merge_counter_dataclasses,
)
from .partition import Partition1D, partition_1d

__all__ = ["FetchEvent", "ProviderStats", "ShardedRuntime"]

ID_BYTES = 4


@dataclasses.dataclass(frozen=True)
class FetchEvent:
    """One vertex's resolution inside ``fetch_rows`` — the control-plane
    record the SPMD executor turns into a data-plane placement.

    ``kind`` is how the read was served:

    - ``"local"``  — owned by the reading rank (free; row lives in the
      rank's own shard),
    - ``"device"`` — served by the device-resident tier (no host cache
      probe, no modeled bytes; content = the resident mirror row),
    - ``"hit"``    — host-cache hit (content = the captured payload),
    - ``"miss"``   — remote miss: the row was shipped owner -> reader
      and accounted in the ``serve_rows`` matrix. In SPMD execution this
      is exactly the set of rows that must travel through the
      ``all_to_all`` collective; everything else stays rank-resident.
    """

    v: int
    kind: str  # "local" | "device" | "hit" | "miss"
    owner: int


@dataclasses.dataclass
class ProviderStats:
    """Per-rank read-path accounting (one instance per runtime rank)."""

    local_reads: int = 0
    remote_reads: int = 0  # reads of non-local rows (pre-cache)
    cache_hits: int = 0
    cache_misses: int = 0
    device_hits: int = 0  # served by the device-resident tier (pre-host)
    device_bytes_saved: int = 0  # host materialization/upload avoided
    invalidations: int = 0
    stale_payloads_dropped: int = 0
    bytes_fetched: int = 0  # remote bytes actually moved (post-cache)
    modeled_comm_s: float = 0.0
    # multi-tenant accounting (empty until tenant-tagged fetches occur;
    # merge_counter_dataclasses sums dict fields key-wise)
    tenant_requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    tenant_bytes_fetched: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def hit_rate(self) -> float:
        """Host-cache hit rate over host-cache *probes*. Device-tier
        hits resolve above the host cache and never probe it, so they
        belong in neither numerator nor denominator (using raw
        ``remote_reads`` would deflate the rate whenever the device
        tier is on)."""
        probes = self.cache_hits + self.cache_misses
        return self.cache_hits / probes if probes else 0.0

    @property
    def remote_hit_rate(self) -> float:
        """Fraction of remote reads served without moving bytes, by
        either tier (device-resident or host-cache hit)."""
        r = self.remote_reads
        return (self.cache_hits + self.device_hits) / r if r else 0.0


class ShardedRuntime:
    """Owns the vertex partition, p per-rank caches, the network model,
    the rank-indexed row transport, and (optionally) the static pull
    schedule. See the module docstring for the contracts.

    ``device`` is where the device-resident hot-row tier keeps its rows
    (default ``"cuda"``). Everything else here is host-only, so it is
    resolved — and raises when missing — only when a tier is built.

    ``partition`` (optional) installs any object honoring the
    owner/lo/hi/sizes/block contract — ``partition_1d(n, p)`` by
    default, ``partition_hub(degrees, p)`` for hub-aware serving. Every
    consumer reads ownership through ``self.part``, so the choice is
    made exactly once, here."""

    def __init__(
        self,
        store=None,
        p: int = 4,
        *,
        n: Optional[int] = None,
        cache_bytes: int = 1 << 20,
        table_slots: Optional[int] = None,
        network: Optional[NetworkModel] = None,
        use_degree_score: bool = True,
        uncached: bool = False,
        device_slots: int = 0,
        device_width: Optional[int] = None,
        partition=None,
        device="cuda",
    ):
        if store is not None:
            n = int(store.n)
        assert n is not None, "need a store or an explicit vertex count n"
        self.store = store
        self.n = int(n)
        self.p = int(p)
        self.tier_device = device
        if partition is not None:
            assert partition.n == self.n and partition.p == self.p, (
                "partition shape mismatch",
                (partition.n, partition.p),
                (self.n, self.p),
            )
        self.part: Partition1D = (
            partition if partition is not None
            else partition_1d(self.n, self.p)
        )
        self.net = network or NetworkModel()
        self.use_degree_score = use_degree_score
        self.caches: Optional[List[ClampiCache]] = (
            None
            if uncached
            else [
                ClampiCache(
                    cache_bytes,
                    table_slots or max(1, self.n // 4),
                    mode="always",
                    network=self.net,
                )
                for _ in range(self.p)
            ]
        )
        if self.caches is not None:
            for k, c in enumerate(self.caches):
                c.rank = k  # cachescope stream labeling
                c.scope_label = "runtime"
        # payloads mirror each rank's cache residency: row copy at fetch
        self._payloads: List[Dict[int, np.ndarray]] = [
            {} for _ in range(self.p)
        ]
        self.stats: List[ProviderStats] = [
            ProviderStats() for _ in range(self.p)
        ]
        # all-to-all serve accounting: serve_rows[owner, requester] = rows
        # actually shipped (post-cache misses), the dynamic analogue of
        # the static engine's per-round serve lists.
        self.serve_rows = np.zeros((self.p, self.p), np.int64)
        # targeted-coherence ledger: fanout messages actually sent vs the
        # p * |changed| a broadcast scheme would pay.
        self.invalidations_sent = 0
        self.invalidations_broadcast_equiv = 0
        # optional shared static degree cache (epoch/coherence consumers)
        self.static_cache: Optional[StaticDegreeCache] = None
        # optional static pull schedule kept fresh under deltas
        self.problem = None
        self.schedule_rebuilds = 0
        self.schedule_deltas = 0
        self.schedule_residency_refreshes = 0
        # online repartitioning ledger (migrate())
        self.migrations = 0
        self.rows_migrated = 0
        # optional device-resident hot-row tier, below the host caches.
        # scope="replicated": one manager models the per-device
        # replicated buffer (content identical across ranks by
        # construction; per-rank hit counts live in ProviderStats).
        # scope="per_rank": p managers, each holding its OWN rank's
        # remote-heavy rows (a rank's owned range is excluded — those
        # reads are local and never touch the tier).
        self.device = None
        self._devices: Optional[list] = None
        self.device_scope = "replicated"
        self._device_slots = int(device_slots)
        self._device_width = device_width
        # one-shot set of ids whose device rows a producer has already
        # patched this batch (consumed by the next invalidate)
        self._device_fresh_once = None
        # coherence listeners beyond the built-in tiers (e.g. the SPMD
        # executor's resident shard buffer): called with the changed-id
        # list on every invalidate, and with None on a store swap.
        self._invalidation_listeners: list = []
        # optional live workload scorer (traffic.WorkloadScorer): when
        # attached, cache admission scores come from its EWMA×degree
        # blend instead of the static degree prior, and device-tier
        # selection reads the same scorer via score_fn.
        self.scorer = None
        if self._device_slots and self.store is not None:
            self.enable_device_tier(self._device_slots, self._device_width)

    # ---------------- wiring ----------------
    def bind_store(self, store) -> None:
        """Attach (or swap) the authoritative row store. Consumers that
        create their own store (e.g. the streaming engine) bind it here
        so every rank's transport reads the same live graph. Swapping an
        already-bound store flushes every rank's cache: payloads captured
        from the old store would otherwise be served as hits against the
        new one."""
        assert int(store.n) == self.n, "store/partition size mismatch"
        if store is self.store:
            return
        swapped = self.store is not None
        self.store = store
        if swapped and self.caches is not None:
            for k, cache in enumerate(self.caches):
                if cache.entries:
                    cache.flush()
                self._payloads[k].clear()
        if swapped:
            for fn in self._invalidation_listeners:
                fn(None)  # everything captured from the old store is dead
        if self._device_slots and (swapped or not self.has_device_tier):
            self.enable_device_tier(
                self._device_slots, self._device_width,
                scope=self.device_scope,
            )

    def enable_device_tier(
        self,
        slots: int,
        max_width: Optional[int] = None,
        *,
        scope: str = "replicated",
    ):
        """Build (or rebuild, against the current store) the device-
        resident hot-row tier: ``slots`` degree-scored rows padded to
        ``max_width``, consulted by ``fetch_rows`` before the host cache
        and kept coherent by ``invalidate``.

        ``scope="replicated"`` models one buffer identical on every
        device. ``scope="per_rank"`` gives each
        rank a *distinct* hot set that excludes the rank's own owned
        range — local reads never touch the tier, so replicating an
        owner's rows on its own device wastes slots; each rank instead
        holds its hottest remote rows."""
        from ..device import ResidencyManager

        assert self.store is not None, "bind a store first"
        assert scope in ("replicated", "per_rank"), scope
        self.device_scope = scope
        if scope == "replicated":
            self.device = ResidencyManager(
                self.store, slots=slots, max_width=max_width,
                device=self.tier_device,
            )
            self.device.scope_label = "runtime"
            self.device.rank = -1
            self._devices = None
        else:
            self.device = None
            self._devices = []
            for k in range(self.p):
                mgr = ResidencyManager(
                    self.store,
                    slots=slots,
                    max_width=max_width,
                    exclude_range=(int(self.part.lo(k)),
                                   int(self.part.hi(k))),
                    device=self.tier_device,
                )
                mgr.scope_label = "runtime"
                mgr.rank = k
                self._devices.append(mgr)
        self._device_slots = int(slots)
        self._device_width = max_width
        return self.device if self.device is not None else self._devices

    @property
    def has_device_tier(self) -> bool:
        return self.device is not None or self._devices is not None

    def device_for(self, rank: int):
        """The device-tier manager serving ``rank``'s reads (None when
        the tier is off): the shared replicated manager, or rank's own
        hot set under ``scope="per_rank"``."""
        if self._devices is not None:
            return self._devices[int(rank)]
        return self.device

    def device_views(self) -> list:
        """All distinct device-tier managers (0 or 1 when replicated,
        p when per-rank) — for coherence fanout, audits, and metrics."""
        if self._devices is not None:
            return list(self._devices)
        return [self.device] if self.device is not None else []

    def merged_device_stats(self):
        """Summed ResidencyStats across the tier's views (None when the
        tier is off)."""
        views = self.device_views()
        if not views:
            return None
        return merge_counter_dataclasses(
            type(views[0].stats), [v.stats for v in views]
        )

    def add_invalidation_listener(self, fn) -> None:
        """Register a coherence listener: ``fn(changed_ids)`` on every
        invalidate, ``fn(None)`` (= drop everything) on a store swap."""
        if fn not in self._invalidation_listeners:
            self._invalidation_listeners.append(fn)

    def attach_scorer(self, scorer) -> None:
        """Install a live workload scorer (``traffic.WorkloadScorer``):
        every remote read through the host cache observes the vertex and
        scores admission by the EWMA×degree blend; the device tier's
        selection reads the same scorer (applied on its next rebuild —
        call ``refresh_device_scores()`` to force one)."""
        self.scorer = scorer
        if scorer is not None and self.store is not None:
            scorer.set_degree_scale(float(np.max(self.store.degrees,
                                                 initial=1)))
        for dev in self.device_views():
            dev.score_fn = (None if scorer is None
                            else scorer.score_array)

    def refresh_device_scores(self) -> int:
        """Re-rank the device tier under the current workload scores
        (no-op without a scorer or tier). Returns rebuilds performed.
        Called between serving windows, never inside one — rebuilds bump
        slot epochs, which would fault in-flight residency handles."""
        views = self.device_views()
        if self.scorer is None or not views:
            return 0
        for dev in views:
            dev.score_fn = self.scorer.score_array
            dev.rebuild()
        return len(views)

    def build_static_cache(self, capacity_rows: int) -> StaticDegreeCache:
        """Install a shared top-C degree-scored resident set."""
        deg = np.asarray(self.store.degrees)
        self.static_cache = build_static_degree_cache(deg, capacity_rows)
        return self.static_cache

    # ---------------- ownership ----------------
    def owner(self, v):
        """Owner rank per vertex id (vectorized), delegated to the
        installed partition. The contract (docs/partitioning.md):
        ``owner(v) == k  iff  part.lo(k) <= v < part.hi(k)`` — blocks
        are contiguous and tile ``[0, n)``, for both partition
        families, and stay true across ``migrate()`` (in-place cut
        moves)."""
        return self.part.owner(v)

    def shard_of(self, vertices: np.ndarray) -> np.ndarray:
        """Owner rank per vertex — the worklist-sharding helper."""
        return self.part.owner(np.asarray(vertices, np.int64))

    # ---------------- transport ----------------
    def _charge_remote_miss(
        self, st: ProviderStats, rank: int, owner: int, v: int,
        d: int, tenant: str,
    ) -> int:
        """Account one remote miss in the serve matrix + byte ledger.

        Non-hub row: one whole-row ship owner -> rank (``d`` ids).
        Split hub row: one *fragment* ship from every rank holding a
        nonempty fragment except the reader — the reader's own fragment
        is rank-resident and free, so the bytes moved are
        ``d - |own fragment|`` ids spread across up to p-1 servers.
        This is exactly what the SPMD executor ships (fragment keys over
        the all_to_all), so measured traffic reconciles row-for-row and
        byte-for-byte against this model. Returns bytes charged."""
        part = self.part
        if getattr(part, "has_hubs", False) and bool(part.is_hub(v)):
            sizes = part.fragment_sizes(d)
            bytes_moved = 0
            for q in range(self.p):
                if q == rank or sizes[q] == 0:
                    continue
                self.serve_rows[q, rank] += 1
                bytes_moved += int(sizes[q]) * ID_BYTES
        else:
            self.serve_rows[owner, rank] += 1
            bytes_moved = d * ID_BYTES
        st.bytes_fetched += bytes_moved
        if tenant:
            st.tenant_bytes_fetched[tenant] = (
                st.tenant_bytes_fetched.get(tenant, 0) + bytes_moved
            )
        return bytes_moved

    def fetch_rows(
        self,
        rank: int,
        vertices: Sequence[int],
        record: Optional[List[FetchEvent]] = None,
        tenants: Optional[Dict[int, str]] = None,
    ) -> Dict[int, np.ndarray]:
        """Sorted adjacency row per distinct vertex, as read by ``rank``.

        Rows owned by ``rank`` bypass the cache (free); remote rows go
        through rank ``rank``'s ClampiCache admission — a hit returns the
        payload captured at fetch time, a miss pays the modeled remote
        get and ships the row from its owner (serve matrix). Under a
        hub-aware partition a missed *hub* row ships as per-rank
        fragments instead (``_charge_remote_miss``): every holding rank
        serves one fragment, the reader's own fragment is free — the
        returned row is still the full sorted row either way.

        ``record`` (optional) collects one ``FetchEvent`` per vertex in
        resolution order: the SPMD executor replays it to decide which
        rows stay rank-resident on device and which must arrive through
        the all_to_all collective — by construction the recorded
        ``"miss"`` events are exactly the reads this same call charged to
        ``serve_rows``, so the measured collective traffic reconciles
        against the model without a second bookkeeping path.

        ``tenants`` (optional) maps vertex -> tenant tag: tagged reads
        are charged to the tenant in ``ProviderStats`` and tag the
        cache entry they admit (quota-aware eviction)."""
        rank = int(rank)
        with obs_trace.span("fetch_rows", rank=rank, cat="runtime",
                            n=len(vertices)):
            return self._fetch_rows_impl(rank, vertices, record, tenants)

    def _fetch_rows_impl(
        self,
        rank: int,
        vertices: Sequence[int],
        record: Optional[List[FetchEvent]],
        tenants: Optional[Dict[int, str]] = None,
    ) -> Dict[int, np.ndarray]:
        st = self.stats[rank]
        if tenants:
            for v in vertices:
                t = tenants.get(int(v), "")
                if t:
                    st.tenant_requests[t] = st.tenant_requests.get(t, 0) + 1
        out: Dict[int, np.ndarray] = {}
        store = self.store
        dev = self.device_for(rank)
        if self.caches is None:
            for v in vertices:
                v = int(v)
                owner = int(self.part.owner(v))
                if owner == rank:
                    st.local_reads += 1
                    out[v] = store.row(v)
                    if record is not None:
                        record.append(FetchEvent(v, "local", owner))
                    continue
                st.remote_reads += 1
                if dev is not None:
                    row = dev.serve(v)
                    if row is not None:
                        st.device_hits += 1
                        st.device_bytes_saved += row.size * ID_BYTES
                        out[v] = row
                        if record is not None:
                            record.append(FetchEvent(v, "device", owner))
                        continue
                row = store.row(v)
                st.cache_misses += 1
                tenant = tenants.get(v, "") if tenants else ""
                moved = self._charge_remote_miss(
                    st, rank, owner, v, int(row.size), tenant
                )
                st.modeled_comm_s += self.net.remote(moved)
                out[v] = row
                if record is not None:
                    record.append(FetchEvent(v, "miss", owner))
            return out
        cache = self.caches[rank]
        payloads = self._payloads[rank]
        deg = store.degrees
        scorer = self.scorer
        for v in vertices:
            v = int(v)
            owner = int(self.part.owner(v))
            if owner == rank:
                st.local_reads += 1
                out[v] = store.row(v)
                if record is not None:
                    record.append(FetchEvent(v, "local", owner))
                continue
            st.remote_reads += 1
            # the device tier sits below the host cache (closer to the
            # compute): a resident row is already on device, so the read
            # neither probes the host cache nor moves modeled bytes.
            if dev is not None:
                row = dev.serve(v)
                if row is not None:
                    st.device_hits += 1
                    st.device_bytes_saved += row.size * ID_BYTES
                    out[v] = row
                    if record is not None:
                        record.append(FetchEvent(v, "device", owner))
                    continue
            d = int(deg[v])
            size = d * ID_BYTES
            tenant = tenants.get(v, "") if tenants else ""
            if scorer is not None:
                # tick the EWMA at the cache-probe point — the same
                # place cachescope's trace ticks its access counter, so
                # the live frequency matches the offline replay's
                scorer.observe(v)
                score = scorer.cache_score(v, d)
            else:
                score = float(d) if self.use_degree_score else None
            if cache.get(v, size, score=score, tenant=tenant):
                st.cache_hits += 1
                row = payloads.get(v)
                if row is None:
                    # entry admitted without a payload (the coherence
                    # replay drives the same caches via get() directly);
                    # nothing invalidation-worthy happened since, so the
                    # store row IS the row at admission time — capture it
                    # and restore the payloads-mirror invariant.
                    row = store.row(v).copy()
                    payloads[v] = row
                out[v] = row
                if record is not None:
                    record.append(FetchEvent(v, "hit", owner))
                continue
            st.cache_misses += 1
            # the cache probe above still keys/charges the FULL row
            # (capacity + admission semantics are per-row); the serve
            # matrix and byte ledger charge what actually moves.
            self._charge_remote_miss(st, rank, owner, v, d, tenant)
            row = store.row(v).copy()
            if cache.contains(v):  # admitted after the miss
                payloads[v] = row
            else:
                payloads.pop(v, None)
            out[v] = row
            if record is not None:
                record.append(FetchEvent(v, "miss", owner))
        # single comm ledger: the cache already charges remote reads on
        # miss plus hit/insert probe costs (paper §IV-D1) — mirror it.
        st.modeled_comm_s = cache.stats.comm_time
        return out

    # ---------------- coherence ----------------
    def invalidate(self, changed_ids: Iterable[int]) -> int:
        """One applied update batch mutated ``changed_ids``' rows: drop
        their cached payloads on exactly the ranks that hold them.
        Returns the number of host-cache entries dropped."""
        changed = [int(v) for v in changed_ids]
        with obs_trace.span("cache_invalidate", cat="coherence",
                            n=len(changed)):
            return self._invalidate_impl(changed)

    def _invalidate_impl(self, changed: List[int]) -> int:
        # both tiers observe every mutation: the device tier patches the
        # touched resident rows in place (or evicts on width overflow)
        # and re-scores admission, so a later resident hit is fresh.
        # Rows a producer already synced mid-batch (mark_device_fresh)
        # are skipped once — they were patched against the same final
        # state, so a second merge+upload would only burn time and
        # double-count the patch/upload ledger.
        fresh = self._device_fresh_once or ()
        dev_ids = [v for v in changed if v not in fresh]
        if dev_ids:
            for dev in self.device_views():
                dev.notify_batch(dev_ids)
        self._device_fresh_once = None
        # external coherence listeners (e.g. the SPMD resident buffer)
        # observe every mutation, including producer-fresh ids: they key
        # content by id, not by the device tier's patch schedule.
        for fn in self._invalidation_listeners:
            fn(changed)
        if self.caches is None:
            return 0
        dropped = 0
        self.invalidations_broadcast_equiv += self.p * len(changed)
        for k, cache in enumerate(self.caches):
            st = self.stats[k]
            payloads = self._payloads[k]
            for v in changed:
                if not cache.contains(v):
                    continue  # targeted fanout: rank k never sees v
                self.invalidations_sent += 1
                if cache.invalidate(v):
                    st.invalidations += 1
                    dropped += 1
                if payloads.pop(v, None) is not None:
                    st.stale_payloads_dropped += 1
            self._prune_evicted(k)
        return dropped

    # hook-compatible alias: coherence layers call ``notify_batch`` on
    # every registered listener; the runtime is such a listener.
    def notify_batch(self, changed_ids: Iterable[int]) -> None:
        self.invalidate(changed_ids)

    def mark_device_fresh(self, ids: Iterable[int]) -> None:
        """Declare that the device rows of ``ids`` already reflect the
        batch's final state (a producer patched them mid-batch); the
        NEXT ``invalidate`` skips them on the device tier only — host
        payload caches are always invalidated."""
        self._device_fresh_once = {int(v) for v in ids}

    # ---------------- online repartitioning ----------------
    def migrate(self, new_cuts) -> int:
        """Move the ownership boundaries to ``new_cuts`` live, with the
        full handoff protocol (docs/partitioning.md):

        1. the partition's ``cuts`` mutate IN PLACE, so every consumer
           holding ``runtime.part`` (SPMD executor, coherence layer, row
           providers) sees the new ownership atomically;
        2. rows whose owner changed get the invalidation fanout — host
           payload caches drop them and coherence listeners observe
           them, so no rank serves a row it believes it still owns from
           a stale tier placement;
        3. per-rank device hot sets are rebuilt against the new
           exclusion ranges (a rank's newly-owned rows leave its remote
           hot set; newly-remote rows become eligible) — the
           device-residency handoff;
        4. an attached static pull schedule is recompiled against the
           new cuts (ownership is baked into its worklists).

        Call between batches only (single-writer; mid-batch migration
        would tear the measured-vs-modeled reconciliation). Returns the
        number of rows whose owner changed. Bit-exactness: ownership
        placement never affects answers, only where reads are served
        from — the tests pin this at p ∈ {1, 4, 8}."""
        part = self.part
        assert hasattr(part, "cuts"), (
            "migrate() needs a cut-based partition (HubPartition)"
        )
        new = np.asarray(new_cuts, np.int64)
        assert new.shape == part.cuts.shape, (new.shape, part.cuts.shape)
        assert new[0] == 0 and new[-1] == self.n
        assert bool(np.all(np.diff(new) >= 0)), "cuts must ascend"
        ids = np.arange(self.n, dtype=np.int64)
        before = part.owner(ids)
        part.cuts[:] = new
        after = part.owner(ids)
        moved = ids[before != after]
        if moved.size:
            self.invalidate(moved.tolist())
        if self._devices is not None:
            self.enable_device_tier(
                self._device_slots, self._device_width, scope="per_rank"
            )
        if self.problem is not None:
            from .rma import build_sharded_problem

            prob = self.problem
            csr = (
                self.store.to_csr()
                if hasattr(self.store, "to_csr")
                else self.store
            )
            cache = (
                StaticDegreeCache(vertex_ids=prob.cache_ids)
                if prob.cache_ids.size
                else None
            )
            self.problem = build_sharded_problem(
                csr,
                self.p,
                n_rounds=prob.n_rounds_requested,
                cache=cache,
                width=prob.width,
                dedup_rounds=prob.dedup_rounds,
                part=part,
            )
            self.schedule_rebuilds += 1
        self.migrations += 1
        self.rows_migrated += int(moved.size)
        return int(moved.size)

    def _prune_evicted(self, rank: int) -> None:
        """Payloads of entries the cache evicted on its own are dead
        weight (never returned — a future get misses); drop them."""
        if self.caches is None:
            return
        cache = self.caches[rank]
        payloads = self._payloads[rank]
        dead = [k for k in payloads if not cache.contains(k)]
        for k in dead:
            del payloads[k]

    def audit_rank(self, rank: int) -> Tuple[int, int]:
        """(cached_entries, stale_entries) for one rank: every resident
        payload compared against the authoritative store row."""
        if self.caches is None:
            return 0, 0
        self._prune_evicted(rank)
        payloads = self._payloads[rank]
        stale = 0
        for v, row in payloads.items():
            if not np.array_equal(row, self.store.row(v)):
                stale += 1
        return len(payloads), stale

    def audit_freshness(self) -> Tuple[int, int]:
        """(cached, stale) summed over every rank and the device tier —
        the freshness bound holds iff stale == 0 everywhere."""
        cached = stale = 0
        for k in range(self.p):
            c, s = self.audit_rank(k)
            cached += c
            stale += s
        for dev in self.device_views():
            c, s = dev.audit()
            cached += c
            stale += s
        return cached, stale

    # ---------------- aggregated metrics ----------------
    def aggregate_stats(self) -> ProviderStats:
        return merge_counter_dataclasses(ProviderStats, self.stats)

    def merged_cache_stats(self) -> CacheStats:
        if self.caches is None:
            return CacheStats()
        return merge_cache_stats([c.stats for c in self.caches])

    @property
    def invalidation_fanout_saved(self) -> int:
        """Messages a broadcast invalidation scheme would have sent that
        the targeted fanout did not."""
        return self.invalidations_broadcast_equiv - self.invalidations_sent

    def cross_rank_rows_served(self) -> int:
        return int(self.serve_rows.sum())

    # ---------------- static pull schedule ----------------
    def attach_problem(self, problem) -> None:
        """Carry the epoch engine's compiled pull schedule so streaming
        deltas can keep it fresh (``maintain_schedule``)."""
        self.problem = problem

    def maintain_schedule(
        self,
        ins: np.ndarray,
        dele: np.ndarray,
        *,
        rebuild_width: Optional[int] = None,
        new_cache_ids: Optional[np.ndarray] = None,
    ) -> bool:
        """Patch the attached schedule for one applied update batch.

        Uses ``ShardedLCCProblem.apply_delta`` (O(delta) row/worklist
        patching + vectorized schedule recompile); on width overflow —
        a touched vertex outgrew the padded row width — falls back to a
        from-scratch ``build_sharded_problem`` against the bound store,
        keeping the problem's build parameters (requested rounds, cache
        residency, dedup) and doubling the width for headroom unless
        ``rebuild_width`` overrides it. Returns True if the incremental
        path succeeded, False if the fallback rebuild ran.

        ``new_cache_ids`` is the drifted static residency set (e.g. the
        coherence layer's rescored top-C): ``apply_delta`` refreshes
        ``cache_ids``/``cache_rows`` in place and recompiles, so
        residency drift alone never forces a from-scratch rebuild —
        only width overflow does."""
        from .rma import ScheduleWidthOverflow, build_sharded_problem

        if self.problem is None:
            return True
        had_ids = self.problem.cache_ids.copy()
        try:
            self.problem.apply_delta(ins, dele, new_cache_ids=new_cache_ids)
            self.schedule_deltas += 1
            if new_cache_ids is not None and not np.array_equal(
                had_ids, self.problem.cache_ids
            ):
                self.schedule_residency_refreshes += 1
            return True
        except ScheduleWidthOverflow:
            prob = self.problem
            csr = (
                self.store.to_csr()
                if hasattr(self.store, "to_csr")
                else self.store
            )
            if rebuild_width is None:
                rebuild_width = max(2 * int(csr.max_degree), 2 * prob.width, 1)
            ids = (
                np.sort(np.unique(np.asarray(new_cache_ids, np.int64)))
                if new_cache_ids is not None
                else prob.cache_ids
            )
            cache = (
                StaticDegreeCache(vertex_ids=ids) if ids.size else None
            )
            self.problem = build_sharded_problem(
                csr,
                self.p,
                n_rounds=prob.n_rounds_requested,
                cache=cache,
                width=rebuild_width,
                dedup_rounds=prob.dedup_rounds,
            )
            self.schedule_rebuilds += 1
            return False
