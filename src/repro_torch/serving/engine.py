"""Query engine: answers point/batch graph queries without a full epoch.

Execution of one microbatch (the scheduler's unit of work):

1. **Endpoint fetch** — the distinct endpoints of all queries in the
   batch are fetched through the row provider once (order of first use,
   the same within-round dedup ``rma.build_sharded_problem`` applies).
2. **Neighbor fetch** — triangle/LCC queries need the rows of every
   neighbor of the target; the union over the batch is deduplicated
   against the endpoint set and fetched in one provider call. On a
   hub-skewed workload most of these rows repeat across queries — the
   reuse the degree-scored cache converts into hits.
3. **Pair intersection** — every (target, neighbor) and (u, v) pair is
   canonicalized (min, max) and deduplicated across the whole batch,
   then counted in one width-bucketed ``batched_pair_counts`` call
   (the CUDA ``intersect_count`` kernel, B1, on the engine's device; the
   vectorized host binary search on the plain route). Pairs with one
   side resident in the device tier go through ``resident_intersect``
   (B3), which reads that side from the tier's tensor on the card.
4. **Scatter** — per-vertex sums give ``T(v) = S(v)/2`` and
   ``LCC(v) = 2 T(v) / (deg (deg-1))`` with arithmetic identical to
   ``core.triangles`` (bit-exact against the batch oracle, using the
   *provider's* row widths as degrees so answers are consistent with the
   rows actually read).

``top_k_lcc`` reads the exact LCC array from ``lcc_source`` (the
streaming engine's incrementally-maintained scores); ties break by
vertex id, matching the reference ordering ``sort by (-lcc, id)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.runtime import FetchEvent, ShardedRuntime
from ..core.triangles import lcc_scores, triangles_per_vertex
from ..device import resolve_device
from ..obs import trace as obs_trace
from ..kernels.bucketing import pack_rows, width_classes
from ..kernels.delta_intersect import delta_intersect_masks
from ..kernels.point_query import batched_pair_counts
from ..kernels.resident_intersect import resident_intersect_counts
from .provider import DirectRowProvider, RuntimeRowProvider
from .requests import Query, QueryKind, QueryResult

__all__ = [
    "InflightBatch",
    "PreparedBatch",
    "QueryEngine",
    "ShardedQueryEngine",
]


@dataclasses.dataclass
class PreparedBatch:
    """Host-side half of one microbatch: rows fetched (control plane
    complete — cache stats and the serve matrix are already charged),
    pair worklist deduplicated. What remains is counting the unique
    pairs — in loop mode immediately on this engine (``_pair_counts``), in
    SPMD mode as one execution unit across all engines."""

    queries: Sequence[Query]
    tri: List[Query]
    cn: List[Query]
    rows: Dict[int, np.ndarray]
    u_lo: np.ndarray  # unique canonical pairs, low id
    u_hi: np.ndarray
    inv: np.ndarray  # raw pair -> unique pair scatter
    qid: Optional[np.ndarray]  # tri-query index per raw tri pair
    n_tri_pairs: int  # raw tri pairs (rest of `inv` are cn pairs)
    record: Optional[List[FetchEvent]] = None


class QueryEngine:
    """Batched point queries over one provider (one rank's view).

    ``device`` (default ``"cuda"``, resolved by ``resolve_device``: raises
    when missing) is where the kernels run. ``use_kernel=None`` means
    "the device is CUDA": the kernel route (B1, B3) there, the plain
    route (host binary search, B4's masks against the tier's host mirror)
    on the CPU. ``use_kernel=True`` on the CPU runs the kernels' plain
    torch versions. Every route gives the same integers."""

    def __init__(
        self,
        store,
        provider=None,
        *,
        use_kernel: Optional[bool] = None,
        lcc_source: Optional[Callable[[], np.ndarray]] = None,
        device="cuda",
    ):
        self.store = store  # DynamicCSR or CSRGraph (row/degrees/n)
        self.provider = provider or DirectRowProvider(store)
        self.device = resolve_device(device)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        self.use_kernel = bool(use_kernel)
        self.lcc_source = lcc_source
        self._static_lcc: Optional[np.ndarray] = None  # lazy, static graphs
        self._static_lcc_token = None  # store state the cached array is for
        self.n_queries = 0
        self.n_pairs_total = 0  # row pairs after batch-wide dedup
        self.n_pairs_raw = 0  # row pairs before dedup
        self.n_pairs_resident = 0  # pairs served via the device tier
        self.host_pack_bytes = 0  # row bytes packed host-side per call

    # ---------------- point/batch execution ----------------
    def execute_batch(self, queries: Sequence[Query]) -> List[QueryResult]:
        prep = self.prepare_batch(queries)
        rank = int(getattr(self.provider, "rank", -1))
        with obs_trace.span("intersect_kernel", rank=rank, cat="serving",
                            pairs=prep.u_lo.size):
            counts = self._pair_counts(prep.u_lo, prep.u_hi, prep.rows)
        return self.finalize_batch(prep, counts)

    def prepare_batch(
        self,
        queries: Sequence[Query],
        record: Optional[List[FetchEvent]] = None,
    ) -> PreparedBatch:
        """Fetch rows + build the deduplicated pair worklist (all the
        control-plane work of a microbatch; see ``PreparedBatch``)."""
        tri = [q for q in queries
               if q.kind in (QueryKind.LCC, QueryKind.TRIANGLES)]
        cn = [q for q in queries if q.kind == QueryKind.COMMON_NEIGHBORS]
        rows = self._fetch_rows_for(tri, cn, record=record)

        # pair worklist: (target, neighbor) per tri/lcc query + (u, v) per
        # common-neighbors query, all as flat arrays
        a_parts: List[np.ndarray] = []
        b_parts: List[np.ndarray] = []
        qid_parts: List[np.ndarray] = []  # tri-query index per pair
        for i, q in enumerate(tri):
            r = rows[q.u]
            if r.size:
                a_parts.append(np.full(r.size, q.u, np.int64))
                b_parts.append(r.astype(np.int64))
                qid_parts.append(np.full(r.size, i, np.int64))
        if cn:
            a_parts.append(np.array([q.u for q in cn], np.int64))
            b_parts.append(np.array([q.v for q in cn], np.int64))
        a = np.concatenate(a_parts) if a_parts else np.zeros(0, np.int64)
        b = np.concatenate(b_parts) if b_parts else np.zeros(0, np.int64)

        # batch-wide canonical dedup: each distinct unordered pair is
        # intersected exactly once, results scattered back via inverse
        key = np.minimum(a, b) * np.int64(self.store.n) + np.maximum(a, b)
        uniq, inv = np.unique(key, return_inverse=True)
        u_lo = uniq // self.store.n
        u_hi = uniq % self.store.n
        self.n_pairs_total += int(uniq.size)
        self.n_pairs_raw += int(key.size)
        qid = np.concatenate(qid_parts) if qid_parts else None
        return PreparedBatch(
            queries=queries,
            tri=tri,
            cn=cn,
            rows=rows,
            u_lo=u_lo,
            u_hi=u_hi,
            inv=inv,
            qid=qid,
            n_tri_pairs=int(key.size - len(cn)),
            record=record,
        )

    def finalize_batch(
        self, prep: PreparedBatch, uniq_counts: np.ndarray
    ) -> List[QueryResult]:
        """Scatter unique-pair counts back into query results (the
        execution-mode-independent half: loop and SPMD counts are the
        same integers, so results are bit-identical)."""
        queries, tri, cn, rows = prep.queries, prep.tri, prep.cn, prep.rows
        counts = np.asarray(uniq_counts, np.int64)[prep.inv]

        # scatter: S(v) = sum_j |N(v) ∩ N(j)| per tri query, T = S/2.
        # S is even whenever the row views are mutually consistent; a
        # stale provider (no coherence hook) can make membership
        # asymmetric and S odd — serve floor(S/2) rather than killing
        # the whole microbatch (staleness is the documented divergence
        # mode, and audit_freshness/verify expose it).
        n_tri_pairs = prep.n_tri_pairs
        s = np.zeros(len(tri), np.int64)
        if n_tri_pairs:
            np.add.at(s, prep.qid, counts[:n_tri_pairs])
        t_of = s // 2
        cn_counts = counts[n_tri_pairs:]

        out: List[QueryResult] = []
        i_tri = 0
        i_cn = 0
        for q in queries:
            if q.kind == QueryKind.TOP_K_LCC:
                out.append(self._top_k(q))
            elif q.kind == QueryKind.COMMON_NEIGHBORS:
                c = int(cn_counts[i_cn])
                i_cn += 1
                ids = np.intersect1d(rows[q.u], rows[q.v])
                assert ids.size == c, "kernel count disagrees with ids"
                out.append(QueryResult(q, value=c, ids=ids))
            else:
                t = int(t_of[i_tri])
                d = float(rows[q.u].size)
                i_tri += 1
                if q.kind == QueryKind.TRIANGLES:
                    out.append(QueryResult(q, value=t))
                else:
                    denom = d * (d - 1.0)
                    lcc = 2.0 * t / denom if denom > 0 else 0.0
                    out.append(QueryResult(q, value=lcc))
        self.n_queries += len(queries)
        return out

    # ---------------- internals ----------------
    @property
    def residency(self):
        """Device-resident tier behind this engine's provider (or None)."""
        return getattr(self.provider, "residency", None)

    def _fetch_rows_for(
        self,
        tri: Sequence[Query],
        cn: Sequence[Query],
        record: Optional[List[FetchEvent]] = None,
    ) -> Dict[int, np.ndarray]:
        """Two-phase dedup'd row fetch: endpoints, then their neighbors.

        Neighbors resident in the device tier are NOT fetched: their
        rows stay on device and the pair intersection gathers them from
        the residency buffer — the host-row-materialization saving the
        tier exists for. (Endpoints are always fetched: the engine
        needs their rows to enumerate pairs and for degrees/ids.)

        Tenant-tagged queries build a vertex -> tenant map with
        first-requester semantics (a row two tenants' queries share is
        charged to whichever query claims it first, matching the
        cache's first-fetcher entry tag); neighbor fetches inherit the
        tenant of the query whose row surfaced them."""
        endpoints = [q.u for q in tri]
        for q in cn:
            endpoints.extend((q.u, q.v))
        tenants: Optional[Dict[int, str]] = None
        if any(q.tenant for q in tri) or any(q.tenant for q in cn):
            tenants = {}
            for q in tri:
                tenants.setdefault(int(q.u), q.tenant)
            for q in cn:
                tenants.setdefault(int(q.u), q.tenant)
                tenants.setdefault(int(q.v), q.tenant)
        ep = np.array(endpoints, np.int64)
        # dedup preserving order of first use (what the cache replay sees)
        _, first = np.unique(ep, return_index=True)
        need = ep[np.sort(first)]
        rows = self.provider.fetch_rows(need, record=record,
                                        tenants=tenants)
        if tri:
            cat = np.concatenate(
                [rows[q.u] for q in tri]
            ).astype(np.int64)
            nbrs, first_nbr = np.unique(cat, return_index=True)
            if tenants is not None and cat.size:
                qidx = np.concatenate(
                    [np.full(rows[q.u].size, i, np.int64)
                     for i, q in enumerate(tri)]
                )
                owner_q = qidx[first_nbr]
                for v, qi in zip(nbrs.tolist(), owner_q.tolist()):
                    tenants.setdefault(int(v), tri[qi].tenant)
            need2 = nbrs[~np.isin(nbrs, need, assume_unique=False)]
            dev = self.residency
            if dev is not None and need2.size:
                need2 = need2[dev.slot_of(need2) < 0]
            if need2.size:
                rows.update(self.provider.fetch_rows(need2, record=record,
                                                     tenants=tenants))
        return rows

    def _pair_counts(
        self, u_lo: np.ndarray, u_hi: np.ndarray, rows: Dict[int, np.ndarray]
    ) -> np.ndarray:
        """Counts per unique pair, routed by residency: a pair whose
        row was left on device (not in ``rows``) goes through the
        ``resident_intersect`` gather; fully-materialized pairs take
        the classic width-bucketed host path."""
        sent = self.store.n
        dev = self.residency
        if dev is None:
            out = batched_pair_counts(
                [rows[int(x)] for x in u_lo],
                [rows[int(x)] for x in u_hi],
                sentinel=sent,
                use_kernel=self.use_kernel,
                device=self.device,
            )
            self.host_pack_bytes += 4 * int(
                sum(rows[int(x)].size for x in u_lo)
                + sum(rows[int(x)].size for x in u_hi)
            )
            return out
        lo_in, hi_in, groups = self._residency_groups(u_lo, u_hi, rows)
        out = np.zeros(u_lo.size, np.int64)
        host = lo_in & hi_in
        if host.any():
            idx = np.flatnonzero(host)
            ra = [rows[int(u_lo[i])] for i in idx]
            rb = [rows[int(u_hi[i])] for i in idx]
            out[idx] = batched_pair_counts(
                ra, rb, sentinel=sent, use_kernel=self.use_kernel,
                device=self.device,
            )
            self.host_pack_bytes += 4 * int(
                sum(r.size for r in ra) + sum(r.size for r in rb)
            )
        for res_idx, res_v, mat_v in groups:
            if res_idx.size == 0:
                continue
            out[res_idx] = self._resident_counts(
                dev,
                res_v[res_idx],
                [rows[int(x)] for x in mat_v[res_idx]],
                sentinel=sent,
            )
            self.n_pairs_resident += int(res_idx.size)
        return out

    @staticmethod
    def _residency_groups(
        u_lo: np.ndarray, u_hi: np.ndarray, rows: Dict[int, np.ndarray]
    ):
        """Residency routing shared by loop mode (``_pair_counts``) and
        SPMD mode (``ShardedQueryEngine._shard_work``): which side of
        each unique pair was materialized, plus the routed groups in the
        canonical order (resident-hi first, then resident-lo). ~hi_in
        and ~lo_in are disjoint (asserted): exactly one side of a
        routed pair stayed on device."""
        n_pairs = u_lo.size
        lo_in = np.fromiter((int(x) in rows for x in u_lo), bool, n_pairs)
        hi_in = np.fromiter((int(x) in rows for x in u_hi), bool, n_pairs)
        assert bool(np.all(lo_in | hi_in)), (
            "every pair has at least one fetched endpoint"
        )
        groups = (
            (np.flatnonzero(~hi_in), u_hi, u_lo),
            (np.flatnonzero(~lo_in), u_lo, u_hi),
        )
        return lo_in, hi_in, groups

    @staticmethod
    def _claim_resident(dev, vs: np.ndarray) -> np.ndarray:
        """Claim + epoch-check one routed group's resident side (the
        ledger update both execution modes must perform identically);
        returns the slots."""
        slots, epochs = dev.claim(vs)
        assert bool(np.all(slots >= 0)), "routing bug: non-resident pair"
        dev.check(slots, epochs)  # stale handles are impossible by design
        return slots

    def _resident_counts(
        self,
        dev,
        resident_v: np.ndarray,
        rows_other: List[np.ndarray],
        *,
        sentinel: int,
    ) -> np.ndarray:
        """|row(resident_v[i]) ∩ rows_other[i]| with the resident side
        gathered from the device buffer (kernel path: ``dev.rows`` with
        each slot's valid length ``dev.lens``, both left on the device;
        one upload of the packed other side per width class) or its host
        mirror (host path) — never re-materialized from the store."""
        slots = self._claim_resident(dev, resident_v)
        out = np.zeros(len(rows_other), np.int64)
        self.host_pack_bytes += 4 * int(sum(r.size for r in rows_other))
        widths = width_classes([r.size for r in rows_other])
        for w in np.unique(widths):
            idx = np.flatnonzero(widths == w)
            packed = pack_rows([rows_other[i] for i in idx], int(w), sentinel)
            if self.use_kernel:
                out[idx] = resident_intersect_counts(
                    dev.rows, slots[idx], packed, lengths=dev.lens,
                    sentinel=sentinel, device=self.device,
                )
            else:
                out[idx] = delta_intersect_masks(
                    packed, dev.host_rows(slots[idx]), sentinel=sentinel
                ).sum(1)
        return out

    def _top_k(self, q: Query) -> QueryResult:
        lcc = self._current_lcc()
        k = min(q.k, lcc.shape[0])
        # reference ordering: sort by (-lcc, vertex id), take first k
        order = np.lexsort((np.arange(lcc.shape[0]), -lcc))[:k]
        return QueryResult(
            q,
            value=float(lcc[order[0]]) if k else 0.0,
            ids=order.astype(np.int64),
            values=lcc[order],
        )

    def _current_lcc(self) -> np.ndarray:
        if self.lcc_source is not None:
            return self.lcc_source()
        # no incremental source: recount lazily, caching per store state —
        # a mutated DynamicCSR must not serve a pre-mutation ranking
        token = getattr(self.store, "n_mutations", None)
        if self._static_lcc is None or token != self._static_lcc_token:
            csr = (
                self.store.to_csr()
                if hasattr(self.store, "to_csr")
                else self.store
            )
            self._static_lcc = lcc_scores(csr, triangles_per_vertex(csr))
            self._static_lcc_token = token
        return self._static_lcc


@dataclasses.dataclass
class InflightBatch:
    """One dispatched-but-unfinalized SPMD microbatch. The control
    plane (cache admission, stats, serve matrix, the measured-vs-
    modeled reconciliation) completed at ``begin_batch``; only the
    device counts are outstanding — ``end_batch`` waits and scatters
    them into results."""

    queries: Sequence[Query]
    by_rank: Dict[int, List[int]]
    preps: List[Optional[PreparedBatch]]
    pending: object  # distributed.spmd_runtime.PendingUnit


class ShardedQueryEngine:
    """p per-rank ``QueryEngine`` instances over one shared runtime.

    Each microbatch is split by *owner rank* — ``lcc(v)``/``triangles(v)``
    execute where ``v`` lives, ``common_neighbors(u, v)`` where ``u``
    lives, ``top_k_lcc`` at rank 0 (it reads the replicated incremental
    LCC array) — and each rank's sub-batch runs through that rank's
    engine and provider view, so remote rows pass through that rank's
    cache exactly as the static engine's all-to-all serve lists would
    ship them. Results reassemble in submission order, so answers are
    independent of the routing (the scheduler and callers can't tell p=1
    from p=8 apart from the metrics).

    ``execution`` picks how the p rank views run their intersect work, on
    ``device``:

    - ``"loop"`` — sequential Python loop over the p in-process engines
      (the modeled runtime);
    - ``"spmd"`` — one execution unit per microbatch
      (``SpmdIntersectExecutor``): every rank's held rows are resident in
      the unit's ``[p, H, W]`` buffer, remote misses arrive through the
      serve block (B5) whose measured traffic is asserted equal to the
      ``serve_rows`` delta the control plane modeled, and pair counts run
      in the pair-count program (B6). Answers, per-rank cache stats, and
      the serve matrix are bit-identical between the two modes (only the
      host-packing ledgers differ — SPMD does not pack rows per pair).

    ``pipeline`` (SPMD only) exposes the double-buffered shape: a
    microbatch splits into ``begin_batch`` (prepare + dispatch, no device
    sync) and ``end_batch`` (wait + finalize), so a caller — the
    ``MicrobatchScheduler``'s ``flush`` — can overlap the pack + launch of
    window k+1 with the in-flight counts of window k. Pipelined and
    unpipelined execution are bit-identical: the control plane is
    sequential host-side either way."""

    def __init__(
        self,
        store,
        runtime: ShardedRuntime,
        *,
        use_kernel: Optional[bool] = None,
        lcc_source: Optional[Callable[[], np.ndarray]] = None,
        execution: str = "loop",
        pipeline: bool = False,
        device="cuda",
    ):
        assert execution in ("loop", "spmd"), execution
        assert not (pipeline and execution != "spmd"), (
            "pipeline requires execution='spmd'"
        )
        self.runtime = runtime
        self.pipeline = bool(pipeline)
        self.engines = [
            QueryEngine(
                store,
                RuntimeRowProvider(runtime, rank),
                use_kernel=use_kernel,
                lcc_source=lcc_source,
                device=device,
            )
            for rank in range(runtime.p)
        ]
        self.store = store
        self.execution = execution
        self.spmd = None
        if execution == "spmd":
            from ..distributed.spmd_runtime import SpmdIntersectExecutor

            self.spmd = SpmdIntersectExecutor(
                runtime.part,
                runtime.n,
                use_kernel=use_kernel,
                device=self.engines[0].device,
                runtime=runtime,
            )

    def route(self, q: Query) -> int:
        """Executing rank for ``q`` — the partition's ``route()``, which
        is the owner except for split hub vertices, whose queries spread
        round-robin across ranks (any rank can read any row through the
        transport, so routing moves load, never answers)."""
        if q.kind == QueryKind.TOP_K_LCC:
            return 0
        return int(self.runtime.part.route(q.u))

    def execute_batch(self, queries: Sequence[Query]) -> List[QueryResult]:
        by_rank: Dict[int, List[int]] = {}
        for i, q in enumerate(queries):
            by_rank.setdefault(self.route(q), []).append(i)
        if self.execution == "spmd":
            return self.end_batch(self.begin_batch(queries, by_rank))
        out: List[Optional[QueryResult]] = [None] * len(queries)
        for rank, idxs in sorted(by_rank.items()):
            results = self.engines[rank].execute_batch(
                [queries[i] for i in idxs]
            )
            for i, r in zip(idxs, results):
                out[i] = r
        return out  # type: ignore[return-value]

    # ---------------- SPMD execution ----------------
    def begin_batch(
        self,
        queries: Sequence[Query],
        by_rank: Optional[Dict[int, List[int]]] = None,
    ) -> InflightBatch:
        """Dispatch one device-parallel microbatch WITHOUT waiting on
        the device: per-rank prepare (control plane: cache admission,
        stats, serve matrix — host-side and identical to loop mode),
        then ONE rank-sharded intersect launch. The measured collective
        rows are asserted equal, owner-for-requester, to the modeled
        ``serve_rows`` delta this same microbatch produced — the full
        ledger exists at dispatch, so reconciliation does not need the
        counts. A pipelined caller may ``begin_batch`` the next
        microbatch before ``end_batch``-ing this one."""
        from ..distributed.spmd_runtime import ShardWork

        if by_rank is None:
            by_rank = {}
            for i, q in enumerate(queries):
                by_rank.setdefault(self.route(q), []).append(i)
        rt = self.runtime
        serve_before = rt.serve_rows.copy()
        empty = np.zeros(0, np.int64)
        preps: List[Optional[PreparedBatch]] = [None] * rt.p
        shards: List[ShardWork] = []
        for rank in range(rt.p):
            idxs = by_rank.get(rank)
            if not idxs:
                shards.append(ShardWork(rank, empty, empty, {}))
                continue
            record: List[FetchEvent] = []
            prep = self.engines[rank].prepare_batch(
                [queries[i] for i in idxs], record=record
            )
            preps[rank] = prep
            shards.append(self._shard_work(rank, prep, record))
        pending = self.spmd.dispatch(shards, rt.store)
        measured = pending.unit.rows_shipped
        modeled = rt.serve_rows - serve_before
        assert np.array_equal(measured, modeled), (
            "SPMD collective traffic diverged from the modeled serve "
            f"matrix:\nmeasured=\n{measured}\nmodeled=\n{modeled}"
        )
        return InflightBatch(queries, by_rank, preps, pending)

    def end_batch(self, inflight: InflightBatch) -> List[QueryResult]:
        """Reconciliation barrier: wait for the in-flight microbatch's
        device counts, then per-rank finalize and reassemble results in
        submission order."""
        counts, _unit = inflight.pending.wait()
        out: List[Optional[QueryResult]] = [None] * len(inflight.queries)
        for rank, idxs in sorted(inflight.by_rank.items()):
            results = self.engines[rank].finalize_batch(
                inflight.preps[rank], counts[rank]
            )
            for i, r in zip(idxs, results):
                out[i] = r
        return out  # type: ignore[return-value]

    def _shard_work(
        self, rank: int, prep: PreparedBatch, record: List[FetchEvent]
    ):
        """Turn one rank's prepared microbatch into its SPMD slice:
        local rows / cache hits / device-mirror rows stay rank-resident,
        misses ship through the collective. Device-tier bookkeeping
        (claim + epoch check per resident pair side) runs exactly as
        loop mode's resident routing would, so the residency ledgers
        stay field-for-field identical."""
        from ..distributed.spmd_runtime import ShardWork

        eng = self.engines[rank]
        rows = prep.rows
        held: Dict[int, np.ndarray] = {}
        fetched: List[int] = []
        for ev in record:
            if ev.kind == "miss":
                fetched.append(ev.v)
            else:
                held[ev.v] = rows[ev.v]
        dev = eng.residency
        u_lo, u_hi = prep.u_lo, prep.u_hi
        if dev is not None and u_lo.size:
            # the same routing (and group order) loop-mode _pair_counts
            # applies, so the residency claim/check ledgers match.
            _, _, groups = QueryEngine._residency_groups(u_lo, u_hi, rows)
            for res_idx, res_v, _mat_v in groups:
                if res_idx.size == 0:
                    continue
                vs = res_v[res_idx]
                slots = QueryEngine._claim_resident(dev, vs)
                mirror = dev.host_rows(slots)
                widths = dev.widths[slots]
                for i, v in enumerate(vs):
                    v = int(v)
                    if v not in held:
                        held[v] = mirror[i, : int(widths[i])].copy()
                eng.n_pairs_resident += int(res_idx.size)
        return ShardWork(
            rank,
            prep.u_lo.astype(np.int64),
            prep.u_hi.astype(np.int64),
            held,
            fetched,
        )

    # ---------------- aggregated accounting ----------------
    @property
    def n_queries(self) -> int:
        return sum(e.n_queries for e in self.engines)

    @property
    def n_pairs_total(self) -> int:
        return sum(e.n_pairs_total for e in self.engines)

    @property
    def n_pairs_raw(self) -> int:
        return sum(e.n_pairs_raw for e in self.engines)

    @property
    def n_pairs_resident(self) -> int:
        return sum(e.n_pairs_resident for e in self.engines)

    @property
    def host_pack_bytes(self) -> int:
        return sum(e.host_pack_bytes for e in self.engines)
