"""Exact incremental triangle counting + LCC under batched edge updates.

Per batch the engine computes the per-vertex triangle delta without
touching unaffected parts of the graph. For an *insertion* set D applied
to graph G (all D edges absent from G), split every endpoint neighborhood
into its old part ``N(x)`` (rows of G) and its new part ``N_D(x)``
(neighbors within the batch). A new triangle {u, v, w} with exactly

- 1 batch edge is discovered once   (w ∈ N(u) ∩ N(v)        for that edge),
- 2 batch edges is discovered twice (once per batch edge, via N ∩ N_D),
- 3 batch edges is discovered 3×    (w ∈ N_D(u) ∩ N_D(v) per edge),

so crediting each discovery to u, v and w with weights 6 / 3 / 2
(old∩old / old∩new / new∩new) gives every new triangle weight exactly 6
at each of its three corners — integer arithmetic, no double counting
(Tangwongsan et al.'s batched wedge-closure corrections in scaled form).
Deletions are the time-reverse: remove the edges from the store, compute
the same insertion delta against the post-delete rows, and subtract.

The old∩old intersections — the hot path, row widths up to the max
degree — run on the engine's ``device``: pairs with a row resident in the
device tier go through the ``resident_intersect`` kernel (B3), which reads
the resident rows from the tier's persistent tensor; the rest through the
``intersect_count`` kernel (B1) via the batched ``delta_intersect_counts``
wrapper. The membership masks that identify the closing vertices w come
from the vectorized binary-search companion ``delta_intersect_masks``
(host numpy) and are cross-checked against the kernel counts on every
batch. LCC is patched in place for exactly the dirty vertices with the
same arithmetic as ``lcc_scores`` (bit-exact vs a recount).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.csr import CSRGraph
from ..core.runtime import ShardedRuntime
from ..core.triangles import lcc_scores, triangles_per_vertex
from ..device import resolve_device
from ..kernels.delta_intersect import (
    delta_intersect_counts,
    delta_intersect_masks,
)
from ..kernels.resident_intersect import resident_intersect_counts
from ..obs import trace as obs_trace
from .store import DynamicCSR
from .updates import EdgeBatch, normalize_batch

__all__ = ["BatchResult", "StreamingLCCEngine"]


@dataclasses.dataclass
class BatchResult:
    """Per-batch accounting returned by ``apply_batch``."""

    n_inserted: int
    n_deleted: int
    n_noop: int
    d_triangles: int  # global triangle-count delta
    n_dirty: int  # vertices whose T or LCC changed
    delta_pairs: int  # row pairs intersected (kernel or host path)
    compacted: bool
    # True/False: the attached pull schedule was patched incrementally /
    # rebuilt on width overflow; None: no schedule attached
    schedule_incremental: Optional[bool] = None


class StreamingLCCEngine:
    """Maintains exact per-vertex triangle counts and LCC for a
    ``DynamicCSR`` under batched insert/delete updates.

    ``t``/``lcc`` always equal ``triangles_per_vertex``/``lcc_scores`` of
    the compacted current graph (the streaming tests assert this after
    arbitrary update sequences).

    With a ``ShardedRuntime`` attached (directly or via the coherence
    layer), each batch's delta worklist is partitioned by the owner rank
    of its first endpoint — the same ownership rule the static engine's
    edge worklists follow — and the batched old∩old intersections run
    through the ``delta_intersect`` path once per shard. The per-vertex
    deltas are integer scatter-adds, so the sharded result is bit-exact
    vs the unsharded one at any p. The runtime also carries the optional
    static pull schedule, kept fresh per batch via ``maintain_schedule``.

    The kernels run on ``device`` (default ``"cuda"``, resolved by
    ``resolve_device``: raises when missing; ``"cpu"`` runs their plain
    torch versions). An attached device tier must live on the same device.

    ``execution="spmd"`` runs the per-rank shards as ONE execution unit per
    batch phase (``SpmdIntersectExecutor``, on the same device): remote rows
    ship owner -> rank through the serve block (B5) and the old∩old counts
    come back from the pair-count program (B6), cross-checked against the
    host membership masks — bit-exact vs ``execution="loop"`` at any p.
    ``pipeline=True`` (SPMD only) dispatches a batch's insert phase before
    its delete phase's counts are waited for.
    """

    def __init__(
        self,
        csr: CSRGraph,
        *,
        use_kernel: bool = True,
        auto_compact: bool = True,
        compact_threshold: float = 0.25,
        coherence=None,
        runtime: Optional[ShardedRuntime] = None,
        execution: str = "loop",
        pipeline: bool = False,
        device="cuda",
    ):
        assert execution in ("loop", "spmd"), execution
        assert not pipeline or execution == "spmd", (
            "pipeline overlaps the two SPMD phase dispatches of a batch "
            "— pass execution='spmd'"
        )
        self.device = resolve_device(device)
        self.store = DynamicCSR.from_csr(
            csr, compact_threshold=compact_threshold
        )
        self.t = triangles_per_vertex(csr).astype(np.int64)
        self.lcc = lcc_scores(csr, self.t)
        self.use_kernel = use_kernel
        self.auto_compact = auto_compact
        self.coherence = coherence
        if runtime is None and coherence is not None:
            runtime = getattr(coherence, "runtime", None)
        self.runtime = runtime
        if runtime is not None:
            runtime.bind_store(self.store)
        assert execution == "loop" or runtime is not None, (
            "SPMD execution shards the worklist by the runtime's owner "
            "partition — attach a ShardedRuntime (or coherence layer)"
        )
        self.execution = execution
        self.pipeline = bool(pipeline)
        self.spmd = None
        if execution == "spmd":
            from ..distributed.spmd_runtime import SpmdIntersectExecutor

            # runtime= registers the executor's resident-buffer
            # invalidation on the runtime's coherence fanout, so
            # end-of-batch invalidates keep the buffer's mirror fresh.
            self.spmd = SpmdIntersectExecutor(
                runtime.part,
                runtime.n,
                use_kernel=use_kernel,
                device=self.device,
                runtime=runtime,
            )
        self.shard_pairs = np.zeros(
            runtime.p if runtime is not None else 1, np.int64
        )  # row pairs processed per owner rank (worklist balance)
        self.n_batches = 0
        self.n_updates = 0  # effective (non-noop) undirected updates
        self.delta_pairs_total = 0
        # host-row-materialization ledger for the oo path: rows/bytes
        # merged+packed from the store per batch (resident rows served
        # from the device tier's persistent mirror are NOT counted here
        # — their savings accrue in runtime.device.stats.bytes_saved).
        self.oo_host_rows = 0
        self.oo_host_bytes = 0
        self.oo_resident_pairs = 0  # oo pairs counted on-device

    # ---------------- public API ----------------
    @staticmethod
    def empty(n: int, **kw) -> "StreamingLCCEngine":
        base = CSRGraph(
            offsets=np.zeros(n + 1, np.int64),
            adjacencies=np.zeros((0,), np.int32),
            n=n,
        )
        return StreamingLCCEngine(base, **kw)

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def triangle_count(self) -> int:
        total = int(self.t.sum())
        assert total % 3 == 0
        return total // 3

    def apply_batch(self, batch: EdgeBatch) -> BatchResult:
        with obs_trace.span("stream_batch", cat="streaming",
                            n=batch.u.size):
            return self._apply_batch_impl(batch)

    def _apply_batch_impl(self, batch: EdgeBatch) -> BatchResult:
        ins, dele, n_noop = normalize_batch(batch, self.store)
        delta6 = np.zeros(self.n, np.int64)
        delta_pairs = 0
        pipelined = (
            self.pipeline and ins.shape[0] > 0 and dele.shape[0] > 0
        )
        if dele.shape[0]:
            # time-reverse: destroyed triangles == triangles an insertion
            # of ``dele`` into the post-delete graph would create.
            self.store.delete_edges(dele)
            self._sync_device_after_delete(dele)
        if pipelined:
            # double-buffered batch: both phases read the same store
            # state (post-delete, pre-insert), so the insert phase's
            # host pack + launch overlaps the delete phase's in-flight
            # device counts. The host-side scatter math of each phase
            # runs at its finish — integer scatter-adds, so the result
            # is bit-exact vs the sequential path.
            fin_del = self._delta6_begin(dele, sign=-1)
            fin_ins = self._delta6_begin(ins, sign=+1)
            self.store.insert_edges(ins)
            delta_pairs += fin_del(delta6)
            delta_pairs += fin_ins(delta6)
        else:
            if dele.shape[0]:
                delta_pairs += self._accumulate_insertion_delta6(
                    dele, delta6, sign=-1
                )
            if ins.shape[0]:
                delta_pairs += self._accumulate_insertion_delta6(
                    ins, delta6, sign=+1
                )
                self.store.insert_edges(ins)

        assert (delta6 % 6 == 0).all(), "triangle weights must close to 6"
        dt = delta6 // 6
        self.t += dt
        endpoints = np.concatenate([ins.ravel(), dele.ravel()]).astype(
            np.int64
        )
        dirty = np.unique(np.concatenate([endpoints, np.flatnonzero(dt)]))
        if dirty.size:
            self._patch_lcc(dirty)

        compacted = self.store.maybe_compact() if self.auto_compact else False
        self.n_batches += 1
        self.n_updates += int(ins.shape[0] + dele.shape[0])
        self.delta_pairs_total += delta_pairs
        if (
            self.runtime is not None
            and self.runtime.has_device_tier
            and dele.shape[0]
        ):
            # delete-only rows were already patched by the mid-batch
            # sync against what is also their final state; tell the
            # coming invalidate fanout not to patch them a second time
            # (ids the insert phase touched again are NOT marked).
            fresh = np.setdiff1d(
                np.unique(dele.ravel()), np.unique(ins.ravel())
            )
            if fresh.size:
                self.runtime.mark_device_fresh(fresh.tolist())
        if self.coherence is not None:
            self.coherence.on_batch(ins, dele, self.store)
        elif self.runtime is not None:
            # no coherence layer to fan the mutations out: the engine
            # itself invalidates through the runtime, so both tiers
            # (host payload caches + device residency) stay fresh — the
            # next batch's oo rows are served from the resident mirror.
            changed = np.unique(
                np.concatenate([ins.ravel(), dele.ravel()])
            ).astype(np.int64)
            if changed.size:
                self.runtime.invalidate(changed.tolist())
        schedule_incremental = None
        if self.runtime is not None and self.runtime.problem is not None:
            # residency drift: hand the coherence layer's rescored
            # static set to the schedule so cache_ids refresh in place
            # (a drifted top-C alone never forces a full rebuild).
            new_ids = None
            static = getattr(self.coherence, "static", None)
            if static is not None and self.runtime.problem.cache_ids.size:
                new_ids = static.vertex_ids
            schedule_incremental = self.runtime.maintain_schedule(
                ins, dele, new_cache_ids=new_ids
            )
        return BatchResult(
            n_inserted=int(ins.shape[0]),
            n_deleted=int(dele.shape[0]),
            n_noop=n_noop,
            d_triangles=int(dt.sum()) // 3,
            n_dirty=int(dirty.size),
            delta_pairs=delta_pairs,
            compacted=compacted,
            schedule_incremental=schedule_incremental,
        )

    def verify(self) -> None:
        """Assert engine state == from-scratch recount (bit-exact)."""
        csr = self.store.to_csr()
        want_t = triangles_per_vertex(csr)
        if not np.array_equal(self.t, want_t):
            bad = np.flatnonzero(self.t != want_t)[:8]
            raise AssertionError(
                f"incremental T diverged at vertices {bad.tolist()}"
            )
        want_lcc = lcc_scores(csr, want_t)
        if not np.array_equal(self.lcc, want_lcc):
            bad = np.flatnonzero(self.lcc != want_lcc)[:8]
            raise AssertionError(
                f"incremental LCC diverged at vertices {bad.tolist()}"
            )

    # ---------------- internals ----------------
    def _sync_device_after_delete(self, dele: np.ndarray) -> None:
        """The delta intersections of this batch read POST-delete rows:
        patch the touched resident rows in every device view now so the
        device tier serves the same state mid-batch (the end-of-batch
        coherence fanout re-syncs after the inserts land), and drop the
        SPMD executor's resident-buffer copies of the same ids — a stale
        buffer row would break the loop-vs-SPMD bit-exactness contract.
        The patch and the kernels that read it run on one stream, so they
        are ordered."""
        changed = np.unique(dele.ravel())
        if self.runtime is not None and self.runtime.has_device_tier:
            ids = changed.tolist()
            for dv in self.runtime.device_views():
                dv.notify_batch(ids)
        if self.spmd is not None:
            self.spmd.invalidate(changed)

    @staticmethod
    def _batch_adjacency(pairs: np.ndarray) -> Dict[int, np.ndarray]:
        """Batch-internal adjacency N_D (sorted per vertex) — built over
        the WHOLE batch: a shard's wedge-closure corrections must see
        batch edges owned by other ranks too."""
        d_adj: Dict[int, np.ndarray] = {}
        for a, b in pairs:
            d_adj.setdefault(int(a), []).append(int(b))
            d_adj.setdefault(int(b), []).append(int(a))
        for x in d_adj:
            d_adj[x] = np.array(sorted(d_adj[x]), np.int64)
        return d_adj

    def _delta6_begin(self, pairs: np.ndarray, *, sign: int):
        """Dispatch one phase's SPMD unit WITHOUT waiting: all host row
        materialization happens here (against the current post-delete /
        pre-insert store), so the returned ``finish(delta6) -> n_pairs``
        closure only waits on the device counts and runs the host scatter
        math."""
        assert self.spmd is not None, "pipelining is SPMD-only"
        d_adj = self._batch_adjacency(pairs)
        owners = self.runtime.part.owner(pairs[:, 0])
        shards = [
            pairs[owners == rank] for rank in range(self.runtime.p)
        ]
        pending, rowdata = self._delta6_spmd_dispatch(shards, d_adj)

        def finish(delta6: np.ndarray) -> int:
            return self._delta6_spmd_finish(
                pending, shards, rowdata, d_adj, delta6, sign=sign
            )

        return finish

    def _accumulate_insertion_delta6(
        self, pairs: np.ndarray, delta6: np.ndarray, *, sign: int
    ) -> int:
        """Add ``sign *`` (scaled-by-6 per-vertex triangle delta of
        inserting ``pairs``) into ``delta6``. Rows of ``self.store`` are
        the *old* neighborhoods (callers guarantee ``pairs`` are absent).
        Returns the number of row pairs sent through delta-intersect."""
        d_adj = self._batch_adjacency(pairs)

        spmd = self.spmd is not None
        if self.runtime is not None and (self.runtime.p > 1 or spmd):
            # shard the delta worklist by owner rank of the first
            # endpoint; per-shard scatter-adds are integer, so the sum
            # over shards is bit-exact vs the single-shard path.
            owners = self.runtime.part.owner(pairs[:, 0])
            shards = [
                pairs[owners == rank] for rank in range(self.runtime.p)
            ]
            if spmd:
                return self._delta6_spmd(shards, d_adj, delta6, sign=sign)
            total = 0
            for rank, shard in enumerate(shards):
                if shard.shape[0] == 0:
                    continue
                total += self._delta6_for_shard(
                    shard, d_adj, delta6, sign=sign, rank=rank
                )
                self.shard_pairs[rank] += shard.shape[0]
            return total
        n = self._delta6_for_shard(pairs, d_adj, delta6, sign=sign)
        self.shard_pairs[0] += n
        return n

    def _delta6_spmd(
        self,
        shards,
        d_adj: Dict[int, np.ndarray],
        delta6: np.ndarray,
        *,
        sign: int,
    ) -> int:
        """SPMD variant of the per-shard loop: every shard's old∩old counts
        run as ONE execution unit — rows owned by the executing rank (or
        resident in the device tier's mirror) stay rank-local, remote rows
        ship owner -> requester through the serve block — then the
        per-shard host math (masks, wedge corrections, scatters) proceeds
        unchanged against those counts. The engine's kernel-vs-mask
        cross-check still runs, so SPMD counts are verified against the
        host membership masks on every batch."""
        pending, rowdata = self._delta6_spmd_dispatch(shards, d_adj)
        return self._delta6_spmd_finish(
            pending, shards, rowdata, d_adj, delta6, sign=sign
        )

    def _delta6_spmd_dispatch(self, shards, d_adj: Dict[int, np.ndarray]):
        """Pack every shard and launch the unit; all store reads happen
        here, so the in-flight unit is immune to later store mutations.
        Returns ``(PendingUnit, rowdata)``."""
        from ..distributed.spmd_runtime import ShardWork

        rt = self.runtime
        store = self.store
        empty = np.zeros(0, np.int64)
        rowdata = [None] * rt.p
        works = []
        for rank, shard in enumerate(shards):
            if shard.shape[0] == 0:
                works.append(ShardWork(rank, empty, empty, {}))
                continue
            rd = self._shard_rows(shard, rank)
            rowdata[rank] = rd
            rows_u, rows_v, res_u, res_v, w_old = rd
            u, v = shard[:, 0], shard[:, 1]
            held: Dict[int, np.ndarray] = {}
            fetched: List[int] = []
            dev = rt.device_for(rank)
            resident = set(u[res_u].tolist()) | set(v[res_v].tolist())
            for x in np.unique(np.concatenate([u, v])):
                x = int(x)
                if x in resident:
                    # content the loop path would read: the device tier's
                    # persistent mirror row, not a store merge
                    slot = int(dev.slot_of(x))
                    w_true = int(dev.widths[slot])
                    held[x] = dev.host_rows(
                        np.array([slot])
                    )[0, :w_true].copy()
                elif int(rt.part.owner(x)) == rank:
                    held[x] = np.asarray(store.row(x))
                else:
                    fetched.append(x)
            works.append(
                ShardWork(
                    rank,
                    u.astype(np.int64),
                    v.astype(np.int64),
                    held,
                    fetched,
                )
            )
        return self.spmd.dispatch(works, store), rowdata

    def _delta6_spmd_finish(
        self,
        pending,
        shards,
        rowdata,
        d_adj: Dict[int, np.ndarray],
        delta6: np.ndarray,
        *,
        sign: int,
    ) -> int:
        """Reconciliation barrier of one dispatched phase: wait for the
        device counts, then per-shard host math (masks, corrections,
        scatters)."""
        counts, _unit = pending.wait()
        total = 0
        for rank, shard in enumerate(shards):
            if shard.shape[0] == 0:
                continue
            total += self._delta6_for_shard(
                shard,
                d_adj,
                delta6,
                sign=sign,
                rank=rank,
                rowdata=rowdata[rank],
                oo_counts=counts[rank],
            )
            self.shard_pairs[rank] += shard.shape[0]
        return total

    def _shard_rows(self, pairs: np.ndarray, rank: int = 0):
        """Materialize one shard's old-neighborhood rows (the executing
        rank's device-tier view for resident endpoints, store merges for
        the rest) with the host-materialization ledger updates. Returns
        ``(rows_u, rows_v, res_u, res_v, w_old)``."""
        store = self.store
        sent = store.n
        k = pairs.shape[0]
        u, v = pairs[:, 0], pairs[:, 1]
        w_old = max(int(store.degrees[np.concatenate([u, v])].max()), 1)
        dev = (
            self.runtime.device_for(rank)
            if self.runtime is not None
            else None
        )
        if dev is not None:
            # resident hub rows come from the tier's persistent mirror
            # (no per-batch DynamicCSR merge); only the rest are
            # materialized from the store.
            rows_u, res_u = dev.padded_rows(u, w_old, sentinel=sent)
            rows_v, res_v = dev.padded_rows(v, w_old, sentinel=sent)
            built = np.concatenate([u[~res_u], v[~res_v]])
            self.oo_host_rows += int(built.size)
            self.oo_host_bytes += int(store.degrees[built].sum()) * 4
        else:
            rows_u = store.padded_rows(u, w_old, sentinel=sent)
            rows_v = store.padded_rows(v, w_old, sentinel=sent)
            res_u = res_v = np.zeros(k, bool)
            both = np.concatenate([u, v])
            self.oo_host_rows += int(both.size)
            self.oo_host_bytes += int(store.degrees[both].sum()) * 4
        return rows_u, rows_v, res_u, res_v, w_old

    def _delta6_for_shard(
        self,
        pairs: np.ndarray,
        d_adj: Dict[int, np.ndarray],
        delta6: np.ndarray,
        *,
        sign: int,
        rank: int = 0,
        rowdata=None,
        oo_counts: Optional[np.ndarray] = None,
    ) -> int:
        """One shard's worth of batched intersections (see caller).
        ``oo_counts`` injects old∩old counts computed elsewhere (the SPMD
        executor) — they are still cross-checked against the host
        membership masks below."""
        with obs_trace.span("intersect_kernel", rank=rank, cat="streaming",
                            pairs=pairs.shape[0]):
            return self._delta6_for_shard_impl(
                pairs, d_adj, delta6, sign=sign, rank=rank,
                rowdata=rowdata, oo_counts=oo_counts,
            )

    def _delta6_for_shard_impl(
        self,
        pairs: np.ndarray,
        d_adj: Dict[int, np.ndarray],
        delta6: np.ndarray,
        *,
        sign: int,
        rank: int = 0,
        rowdata=None,
        oo_counts: Optional[np.ndarray] = None,
    ) -> int:
        store = self.store
        sent = store.n
        k = pairs.shape[0]
        u, v = pairs[:, 0], pairs[:, 1]

        if rowdata is None:
            rowdata = self._shard_rows(pairs, rank)
        rows_u, rows_v, res_u, res_v, w_old = rowdata
        dev = (
            self.runtime.device_for(rank)
            if self.runtime is not None
            else None
        )
        w_new = max(max(len(r) for r in d_adj.values()), 1)
        rows_du = _padded_from_dict(d_adj, u, w_new, sent)
        rows_dv = _padded_from_dict(d_adj, v, w_new, sent)

        # old ∩ old — the wide hot path: kernels for the counts,
        # membership masks for the identities of the closing vertices.
        mask_oo = delta_intersect_masks(rows_u, rows_v, sentinel=sent)
        if oo_counts is not None:
            c_oo = np.asarray(oo_counts, np.int64)
            assert np.array_equal(c_oo, mask_oo.sum(1)), (
                "SPMD counts disagree with membership masks"
            )
            if dev is not None:
                self.oo_resident_pairs += int(
                    np.count_nonzero(res_u | res_v)
                )
        elif self.use_kernel:
            c_oo = self._oo_counts(
                u, v, rows_u, rows_v, res_u, res_v, dev, sent
            )
            assert np.array_equal(c_oo, mask_oo.sum(1)), (
                "kernel counts disagree with membership masks"
            )
        else:
            c_oo = mask_oo.sum(1).astype(np.int64)
        # wedge-closure corrections: old ∩ new (both orientations), new ∩ new
        mask_on = delta_intersect_masks(rows_u, rows_dv, sentinel=sent)
        mask_no = delta_intersect_masks(rows_du, rows_v, sentinel=sent)
        mask_nn = delta_intersect_masks(rows_du, rows_dv, sentinel=sent)
        c_on = mask_on.sum(1).astype(np.int64)
        c_no = mask_no.sum(1).astype(np.int64)
        c_nn = mask_nn.sum(1).astype(np.int64)

        end6 = sign * (6 * c_oo + 3 * (c_on + c_no) + 2 * c_nn)
        np.add.at(delta6, u, end6)
        np.add.at(delta6, v, end6)
        for mask, rows, coef in (
            (mask_oo, rows_u, 6),
            (mask_on, rows_u, 3),
            (mask_no, rows_du, 3),
            (mask_nn, rows_du, 2),
        ):
            w_ids = rows[mask].astype(np.int64)
            if w_ids.size:
                np.add.at(delta6, w_ids, sign * coef)
        return k

    def _oo_counts(
        self,
        u: np.ndarray,
        v: np.ndarray,
        rows_u: np.ndarray,
        rows_v: np.ndarray,
        res_u: np.ndarray,
        res_v: np.ndarray,
        dev,
        sent: int,
    ) -> np.ndarray:
        """Kernel-path old∩old counts, routed per pair: both sides
        resident -> slot-vs-slot gather on device (zero upload); one
        side resident -> gather vs the packed other side; neither ->
        the classic ``delta_intersect`` path (B1). The resident side is
        read from the tier's device tensor ``dev.rows``, with each slot's
        valid length from ``dev.lens``, never from its host mirror, so
        resident rows are not uploaded again."""
        k = u.shape[0]
        if dev is None or not (res_u.any() or res_v.any()):
            return delta_intersect_counts(
                rows_u, rows_v, sentinel=sent, device=self.device,
            )
        c = np.zeros(k, np.int64)
        slots_u = dev.slot_of(u)
        slots_v = dev.slot_of(v)
        both = res_u & res_v
        only_u = res_u & ~both
        only_v = res_v & ~both
        neither = ~(res_u | res_v)
        if both.any():
            c[both] = resident_intersect_counts(
                dev.rows, slots_u[both], slots_b=slots_v[both],
                lengths=dev.lens, sentinel=sent, device=self.device,
            )
            self.oo_resident_pairs += int(np.count_nonzero(both))
        if only_u.any():
            c[only_u] = resident_intersect_counts(
                dev.rows, slots_u[only_u], rows_v[only_u],
                lengths=dev.lens, sentinel=sent, device=self.device,
            )
            self.oo_resident_pairs += int(np.count_nonzero(only_u))
        if only_v.any():
            c[only_v] = resident_intersect_counts(
                dev.rows, slots_v[only_v], rows_u[only_v],
                lengths=dev.lens, sentinel=sent, device=self.device,
            )
            self.oo_resident_pairs += int(np.count_nonzero(only_v))
        if neither.any():
            c[neither] = delta_intersect_counts(
                rows_u[neither], rows_v[neither], sentinel=sent,
                device=self.device,
            )
        return c

    def _patch_lcc(self, vs: np.ndarray) -> None:
        # identical arithmetic to core.triangles.lcc_scores, elementwise,
        # so checkpoints compare bit-exact against a recount.
        deg = self.store.degrees[vs].astype(np.float64)
        denom = deg * (deg - 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            c = 2.0 * self.t[vs] / denom
        self.lcc[vs] = np.where(denom > 0, c, 0.0)


def _padded_from_dict(
    d_adj: Dict[int, np.ndarray], vs: np.ndarray, width: int, sentinel: int
) -> np.ndarray:
    out = np.full((vs.size, width), sentinel, np.int32)
    for i, x in enumerate(vs):
        r = d_adj.get(int(x))
        if r is not None:
            out[i, : r.size] = r
    return out
