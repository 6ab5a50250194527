"""RMA-style remote-read machinery (paper §III-A/B) adapted to a
single-program device engine.

The paper reads remote adjacency lists with MPI one-sided gets over two
windows (``w_offsets`` and ``w_adj``). A device program has no one-sided
get, so the remote-read pattern is compiled into a **static pull
schedule**:

- Host-side preprocessing walks each device's edge worklist, resolves every
  remote endpoint against the static degree cache, dedups within a round
  (the within-epoch reuse CLaMPI also captures), and emits, per round, a
  *serve list*: which of its local rows each device must ship to each peer.
- Device-side, one ``all_to_all`` per round moves exactly those rows; the
  pipelined engine overlaps round ``r``'s intersection with round
  ``r+1``'s fetch (the paper's double buffering, §III-A).

This module builds the schedule + stacked device arrays; the compiled
engine lives in ``async_engine.py``. A host-level trace simulator
(``simulate_rma_lcc``) replays the same access stream through the
``ClampiCache`` simulator to produce the paper's cache/communication
metrics (Figs. 4, 7, 8, 9, 10) without needing p physical devices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cache import CacheStats, ClampiCache, NetworkModel, StaticDegreeCache
from .csr import CSRGraph, to_padded_rows
from .partition import HubPartition, Partition1D, partition_1d

__all__ = [
    "ShardedLCCProblem",
    "DeviceLCCProblem",
    "ScheduleWidthOverflow",
    "build_sharded_problem",
    "assert_problems_equal",
    "RMATraceStats",
    "simulate_rma_lcc",
]

OFFSET_ENTRY_BYTES = 8  # (start, end) pair of int32 — paper §IV-D2
ID_BYTES = 4


class ScheduleWidthOverflow(ValueError):
    """A touched vertex's degree outgrew the problem's padded row width;
    the incremental patch cannot represent its row. Callers rebuild from
    scratch with a larger width (``ShardedRuntime.maintain_schedule``
    does so automatically, doubling the width for headroom)."""


@dataclasses.dataclass
class DeviceLCCProblem:
    """The tensors of one ``ShardedLCCProblem`` on one torch device — what
    the epoch engine runs on. Dtypes are the host problem's: ids and
    indices int32, the edge mask bool."""

    rows_ext: "torch.Tensor"  # [p, n_loc+1, W] int32
    degrees: "torch.Tensor"  # [p, n_loc] int32
    edge_u: "torch.Tensor"  # [p, E_max] int32
    edge_vc: "torch.Tensor"  # [p, E_max] int32
    edge_mask: "torch.Tensor"  # [p, E_max] bool
    serve_idx: "torch.Tensor"  # [p, NR, p, S_max] int32
    cache_rows: "torch.Tensor"  # [C, W] int32
    n: int
    p: int
    n_loc: int
    e_max: int
    n_rounds: int
    s_max: int

    @property
    def sentinel(self) -> int:
        return self.n

    @property
    def device(self):
        return self.rows_ext.device


def _part_from_reference(part):
    """Duck-typed copy of a partition object (1D or hub-aware)."""
    if part is None:
        return None
    if hasattr(part, "cuts"):
        return HubPartition(
            n=int(part.n),
            p=int(part.p),
            cuts=np.array(part.cuts, np.int64),
            hubs=np.array(part.hubs, np.int64),
            threshold=int(part.threshold),
        )
    return Partition1D(n=int(part.n), p=int(part.p))


@dataclasses.dataclass
class ShardedLCCProblem:
    """Stacked per-device arrays (leading axis p) + static metadata.

    Combined row-index space per round (per device):
      [0, n_loc+1)                         local rows (+1 phantom at n_loc)
      [n_loc+1, n_loc+1+C)                 replicated cache rows
      [n_loc+1+C, n_loc+1+C+p*S_max)       this round's fetched rows
    """

    # device data (leading axis p)
    rows_ext: np.ndarray  # [p, n_loc+1, W] int32 global ids, sentinel = n
    degrees: np.ndarray  # [p, n_loc] int32 true degrees
    edge_u: np.ndarray  # [p, E_max] int32 local u index (pad -> n_loc)
    edge_vc: np.ndarray  # [p, E_max] int32 combined row index of v
    edge_mask: np.ndarray  # [p, E_max] bool
    serve_idx: np.ndarray  # [p, NR, p, S_max] int32 local rows to send
    cache_rows: np.ndarray  # [C, W] int32 (replicated)
    # metadata
    n: int
    p: int
    width: int
    n_loc: int
    e_max: int
    n_rounds: int
    s_max: int
    cache_ids: np.ndarray  # [C] global ids
    # host-side schedule-maintenance state (not shipped to devices):
    # the build parameters before clamping, and the per-rank edge
    # worklists (u_local, v_global) the schedule was compiled from.
    n_rounds_requested: int = 4
    dedup_rounds: bool = True
    works: Optional[List[Tuple[np.ndarray, np.ndarray]]] = dataclasses.field(
        default=None, repr=False
    )

    @property
    def sentinel(self) -> int:
        return self.n

    @classmethod
    def from_reference(cls, obj) -> "ShardedLCCProblem":
        """Copy a problem compiled elsewhere: any object that carries this
        class's fields as numpy arrays / ints (duck-typed — e.g. the
        reference package's ``ShardedLCCProblem``). Arrays are copied, so
        later ``apply_delta`` calls never alias the source."""
        works = getattr(obj, "works", None)
        prob = cls(
            rows_ext=np.array(obj.rows_ext, np.int32),
            degrees=np.array(obj.degrees, np.int32),
            edge_u=np.array(obj.edge_u, np.int32),
            edge_vc=np.array(obj.edge_vc, np.int32),
            edge_mask=np.array(obj.edge_mask, bool),
            serve_idx=np.array(obj.serve_idx, np.int32),
            cache_rows=np.array(obj.cache_rows, np.int32),
            n=int(obj.n),
            p=int(obj.p),
            width=int(obj.width),
            n_loc=int(obj.n_loc),
            e_max=int(obj.e_max),
            n_rounds=int(obj.n_rounds),
            s_max=int(obj.s_max),
            cache_ids=np.array(obj.cache_ids, np.int64),
            n_rounds_requested=int(obj.n_rounds_requested),
            dedup_rounds=bool(obj.dedup_rounds),
            works=(
                None
                if works is None
                else [(np.array(u), np.array(v)) for u, v in works]
            ),
        )
        prob.part = _part_from_reference(getattr(obj, "part", None))
        return prob

    def to_device(self, device) -> DeviceLCCProblem:
        """The tensor view the engine runs on, copied to ``device``.
        int32 stays int32 and the mask stays bool; the engine widens an
        index to int64 only where a torch indexing op demands it."""
        import torch

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return DeviceLCCProblem(
            rows_ext=dev(self.rows_ext),
            degrees=dev(self.degrees),
            edge_u=dev(self.edge_u),
            edge_vc=dev(self.edge_vc),
            edge_mask=dev(self.edge_mask),
            serve_idx=dev(self.serve_idx),
            cache_rows=dev(self.cache_rows),
            n=self.n,
            p=self.p,
            n_loc=self.n_loc,
            e_max=self.e_max,
            n_rounds=self.n_rounds,
            s_max=self.s_max,
        )

    def comm_bytes_per_round(self) -> np.ndarray:
        """[p, NR] payload bytes each device *receives* per round."""
        # serve_idx[q, r, k] = rows q sends to k; received-by-k = sum over q
        valid = self.serve_idx < self.n_loc
        per = valid.sum(axis=-1) * self.width * ID_BYTES  # [p(send), NR, p(dst)]
        return per.transpose(2, 1, 0).sum(axis=-1)  # [p(dst), NR]

    # ------------------------------------------------------------------
    # Incremental schedule maintenance.
    # ------------------------------------------------------------------
    def apply_delta(
        self,
        ins: np.ndarray,
        dele: np.ndarray,
        *,
        new_cache_ids: Optional[np.ndarray] = None,
    ) -> "ShardedLCCProblem":
        """Patch the compiled problem for one applied update batch.

        ``ins``/``dele`` are canonical ``[K, 2]`` edge arrays with the
        streaming contract: every insert absent from, and every delete
        present in, the graph the problem currently describes (exactly
        what ``normalize_batch`` emits). The patch

        1. rewrites the padded rows + degrees of the touched vertices
           (and their replicated cache-row copies) — O(delta) rows,
        2. splices the touched edges in/out of each rank's worklist —
           one vectorized merge per rank, and — when ``new_cache_ids``
           carries a drifted static residency set — swaps
           ``cache_ids``/``cache_rows`` in place (the replicated rows
           are gathered from the already-patched ``rows_ext``, so no
           graph pass is needed), then
        3. recompiles the pull schedule (round request lists, serve
           lists, combined indices) from the patched worklists with the
           vectorized compiler — bit-exact vs the per-edge reference in
           ``build_sharded_problem``.

        Residency drift therefore never forces a from-scratch rebuild;
        only a width overflow does. Raises ``ScheduleWidthOverflow``
        (leaving the problem untouched) when a touched vertex outgrows
        the padded width; callers rebuild with a larger width. Mutates
        and returns ``self``.
        """
        ins = np.asarray(ins, np.int64).reshape(-1, 2)
        dele = np.asarray(dele, np.int64).reshape(-1, 2)
        fresh_ids: Optional[np.ndarray] = None
        if new_cache_ids is not None:
            fresh_ids = np.sort(
                np.unique(np.asarray(new_cache_ids, np.int64).ravel())
            )
            if np.array_equal(fresh_ids, self.cache_ids):
                fresh_ids = None
        if ins.shape[0] == 0 and dele.shape[0] == 0 and fresh_ids is None:
            return self
        if self.works is None:
            raise ValueError(
                "problem carries no host worklists; rebuild it with "
                "build_sharded_problem before applying deltas"
            )
        # problems compiled against a custom partition carry it (see
        # build_sharded_problem); older pickles/tests fall back to 1D.
        part = getattr(self, "part", None)
        if part is None:
            part = partition_1d(self.n, self.p)
        sent = self.sentinel
        w = self.width

        # per-vertex delta neighbor lists (both directions of each edge)
        add_of: Dict[int, List[int]] = {}
        del_of: Dict[int, List[int]] = {}
        for a, b in ins:
            add_of.setdefault(int(a), []).append(int(b))
            add_of.setdefault(int(b), []).append(int(a))
        for a, b in dele:
            del_of.setdefault(int(a), []).append(int(b))
            del_of.setdefault(int(b), []).append(int(a))
        touched = sorted(set(add_of) | set(del_of))

        # validate EVERYTHING up front (width fit + splice consistency)
        # so any failure leaves the problem bit-identical — a failed
        # apply_delta must be safely retryable/rebuildable.
        for v in touched:
            k = int(part.owner(v))
            lu = v - part.lo(k)
            d_old = int(self.degrees[k, lu])
            d_new = d_old + len(add_of.get(v, ())) - len(del_of.get(v, ()))
            if d_old > w or d_new > w:
                raise ScheduleWidthOverflow(
                    f"vertex {v}: degree {max(d_old, d_new)} exceeds the "
                    f"padded row width {w}"
                )
        span = np.int64(self.n + 1)
        src_i = np.concatenate([ins[:, 0], ins[:, 1]])
        dst_i = np.concatenate([ins[:, 1], ins[:, 0]])
        src_d = np.concatenate([dele[:, 0], dele[:, 1]])
        dst_d = np.concatenate([dele[:, 1], dele[:, 0]])
        own_i = part.owner(src_i)
        own_d = part.owner(src_d)
        splices = []  # per rank: (del_positions, ins_locals, ins_globals)
        for k in range(self.p):
            u_l, v_g = self.works[k]
            # keys are strictly increasing: u ascending, v ascending
            # within u, (u, v) unique
            key = u_l.astype(np.int64) * span + v_g.astype(np.int64)
            mk = own_d == k
            dpos = np.zeros(0, np.int64)
            if mk.any():
                dkeys = np.sort((src_d[mk] - part.lo(k)) * span + dst_d[mk])
                dpos = np.searchsorted(key, dkeys)
                if dpos.size and (
                    dpos.max() >= key.size
                    or not np.array_equal(key[dpos], dkeys)
                ):
                    raise ValueError(
                        "delete of an edge absent from the schedule"
                    )
            mk = own_i == k
            s_loc = np.zeros(0, np.int64)
            d_glb = np.zeros(0, np.int64)
            if mk.any():
                s_loc = src_i[mk] - part.lo(k)
                d_glb = dst_i[mk]
                order = np.argsort(s_loc * span + d_glb, kind="stable")
                s_loc, d_glb = s_loc[order], d_glb[order]
                ikeys = s_loc * span + d_glb
                # the streaming contract makes ins/dele disjoint, so
                # presence in the PRE-delete keys is a contract breach
                pos = np.searchsorted(key, ikeys)
                probe = (
                    key[np.minimum(pos, max(key.size - 1, 0))]
                    if key.size
                    else ikeys + 1
                )
                if np.any((pos < key.size) & (probe == ikeys)):
                    raise ValueError(
                        "insert of an edge already in the schedule"
                    )
            splices.append((dpos, s_loc, d_glb))

        # 1. patch padded rows, degrees, and replicated cache rows
        for v in touched:
            k = int(part.owner(v))
            lu = v - part.lo(k)
            d_old = int(self.degrees[k, lu])
            row = self.rows_ext[k, lu, :d_old].astype(np.int64)
            dels = np.asarray(del_of.get(v, ()), np.int64)
            adds = np.asarray(add_of.get(v, ()), np.int64)
            if dels.size:
                row = row[~np.isin(row, dels)]
            if adds.size:
                row = np.sort(np.concatenate([row, adds]))
            self.rows_ext[k, lu, :] = sent
            self.rows_ext[k, lu, : row.size] = row.astype(np.int32)
            self.degrees[k, lu] = row.size
            if self.cache_ids.size:
                ci = int(np.searchsorted(self.cache_ids, v))
                if ci < self.cache_ids.size and self.cache_ids[ci] == v:
                    self.cache_rows[ci, :] = sent
                    self.cache_rows[ci, : row.size] = row.astype(np.int32)

        # 2. splice the touched edges in/out of each rank's worklist
        #    (pre-validated above, so this cannot fail midway)
        for k in range(self.p):
            u_l, v_g = self.works[k]
            dpos, s_loc, d_glb = splices[k]
            if dpos.size:
                keep = np.ones(u_l.size, bool)
                keep[dpos] = False
                u_l, v_g = u_l[keep], v_g[keep]
            if s_loc.size:
                key = u_l.astype(np.int64) * span + v_g.astype(np.int64)
                pos = np.searchsorted(key, s_loc * span + d_glb)
                u_l = np.insert(u_l, pos, s_loc.astype(u_l.dtype))
                v_g = np.insert(v_g, pos, d_glb.astype(v_g.dtype))
            self.works[k] = (u_l, v_g)

        # 2b. residency drift: install the rescored static set in place.
        #     Replicated cache rows are gathers of already-patched local
        #     rows (widths fit by construction), so this costs O(C W).
        if fresh_ids is not None:
            if fresh_ids.size:
                owners = part.owner(fresh_ids).astype(np.int64)
                lo_of = np.array(
                    [part.lo(k) for k in range(self.p)], np.int64
                )
                lus = fresh_ids - lo_of[owners]
                self.cache_rows = self.rows_ext[owners, lus].copy()
            else:
                self.cache_rows = np.zeros((0, w), np.int32)
            self.cache_ids = fresh_ids

        # 3. recompile the schedule from the patched worklists
        (
            self.edge_u,
            self.edge_vc,
            self.edge_mask,
            self.serve_idx,
            self.e_max,
            self.n_rounds,
            self.s_max,
        ) = _compile_schedule(
            self.works,
            part,
            n=self.n,
            n_loc=self.n_loc,
            cache_ids=self.cache_ids,
            n_rounds_req=self.n_rounds_requested,
            dedup_rounds=self.dedup_rounds,
        )
        return self


def _edge_worklist(
    csr: CSRGraph, part: Partition1D, rank: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(u_local, v_global) for every edge owned by ``rank``."""
    lo, hi = part.lo(rank), part.hi(rank)
    a, b = csr.offsets[lo], csr.offsets[hi]
    deg = np.diff(csr.offsets[lo : hi + 1])
    u_local = np.repeat(np.arange(hi - lo, dtype=np.int32), deg)
    v_global = csr.adjacencies[a:b].astype(np.int64)
    return u_local, v_global


def build_sharded_problem(
    csr: CSRGraph,
    p: int,
    *,
    n_rounds: int = 4,
    cache: Optional[StaticDegreeCache] = None,
    width: Optional[int] = None,
    dedup_rounds: bool = True,
    part=None,
) -> ShardedLCCProblem:
    """Compile the static pull schedule for a p-way contiguous
    partition — 1D by default; pass ``part`` (any owner/lo/hi/sizes
    contract holder, e.g. ``partition_hub``) to compile against
    variable cuts. Per-device row slabs are sized to the LARGEST block
    so the ``[p, n_loc, ...]`` layout stays rectangular."""
    n_rounds_requested = n_rounds
    if part is None:
        part = partition_1d(csr.n, p)
    n_loc = int(np.max(part.sizes(), initial=0))
    w = int(width if width is not None else max(csr.max_degree, 1))
    sent = csr.n
    cache_ids = (
        cache.vertex_ids if cache is not None else np.zeros((0,), np.int64)
    )
    c = cache_ids.shape[0]

    # local padded rows (+ phantom row) and true degrees, per device
    rows_ext = np.full((p, n_loc + 1, w), sent, np.int32)
    degrees = np.zeros((p, n_loc), np.int32)
    deg_all = csr.degrees
    for k in range(p):
        lo, hi = part.lo(k), part.hi(k)
        if hi > lo:
            vs = np.arange(lo, hi)
            rows_ext[k, : hi - lo] = to_padded_rows(
                csr, w, sentinel=sent, vertices=vs
            )
            degrees[k, : hi - lo] = deg_all[lo:hi]

    cache_rows = (
        to_padded_rows(csr, w, sentinel=sent, vertices=cache_ids)
        if c
        else np.zeros((0, w), np.int32)
    )
    cache_slot_of = (
        cache.slot_of if cache is not None else (lambda v: np.full(len(v), -1, np.int32))
    )

    # per-device worklists + per-round fetch sets
    works = [_edge_worklist(csr, part, k) for k in range(p)]
    e_max = max((u.size for u, _ in works), default=1) or 1
    n_rounds = max(1, min(n_rounds, e_max))
    e_chunk = -(-e_max // n_rounds)
    e_max = e_chunk * n_rounds  # pad to a whole number of equal chunks

    # first pass: compute per (initiator, round, owner) request lists
    # requests[k][r][q] = list of local row indices on q (order of first use)
    requests: List[List[Dict[int, List[int]]]] = [
        [dict() for _ in range(n_rounds)] for _ in range(p)
    ]
    # remember, per edge, how to find its row: (source, index)
    edge_src_kind = [np.zeros(e_max, np.int8) for _ in range(p)]  # 0 loc 1 cache 2 fetch
    edge_src_idx = [np.zeros(e_max, np.int64) for _ in range(p)]
    for k in range(p):
        u_l, v_g = works[k]
        owners = part.owner(v_g)
        slots = cache_slot_of(v_g)
        pos_maps: List[Dict[Tuple[int, int], int]] = [
            dict() for _ in range(n_rounds)
        ]
        for e in range(v_g.size):
            r = e // e_chunk
            v = int(v_g[e])
            if owners[e] == k:
                edge_src_kind[k][e] = 0
                edge_src_idx[k][e] = v - part.lo(k)
            elif slots[e] >= 0:
                edge_src_kind[k][e] = 1
                edge_src_idx[k][e] = slots[e]
            else:
                q = int(owners[e])
                lst = requests[k][r].setdefault(q, [])
                v_local = v - part.lo(q)
                key = (q, v_local)
                pm = pos_maps[r]
                if dedup_rounds and key in pm:
                    pos = pm[key]
                else:
                    pos = len(lst)
                    lst.append(v_local)
                    pm[key] = pos
                edge_src_kind[k][e] = 2
                edge_src_idx[k][e] = q * 10**9 + pos  # resolved after S_max known

    s_max = 1
    for k in range(p):
        for r in range(n_rounds):
            for q, lst in requests[k][r].items():
                s_max = max(s_max, len(lst))

    # serve lists: serve_idx[q, r, k] = rows q sends to k in round r
    serve_idx = np.full((p, n_rounds, p, s_max), n_loc, np.int32)
    for k in range(p):
        for r in range(n_rounds):
            for q, lst in requests[k][r].items():
                serve_idx[q, r, k, : len(lst)] = lst

    # finalize combined indices
    base_cache = n_loc + 1
    base_fetch = n_loc + 1 + c
    edge_u = np.full((p, e_max), n_loc, np.int32)
    edge_vc = np.full((p, e_max), n_loc, np.int32)  # phantom
    edge_mask = np.zeros((p, e_max), bool)
    for k in range(p):
        u_l, v_g = works[k]
        ne = u_l.size
        edge_u[k, :ne] = u_l
        edge_mask[k, :ne] = True
        kind = edge_src_kind[k]
        idx = edge_src_idx[k]
        vc = np.full(e_max, n_loc, np.int64)
        loc = kind == 0
        vc[: ne][loc[:ne]] = idx[:ne][loc[:ne]]
        cch = kind == 1
        vc[: ne][cch[:ne]] = base_cache + idx[:ne][cch[:ne]]
        ftc = kind == 2
        q = idx // 10**9
        pos = idx % 10**9
        vc[: ne][ftc[:ne]] = base_fetch + (q * s_max + pos)[:ne][ftc[:ne]]
        edge_vc[k] = vc.astype(np.int32)

    prob = ShardedLCCProblem(
        rows_ext=rows_ext,
        degrees=degrees,
        edge_u=edge_u,
        edge_vc=edge_vc,
        edge_mask=edge_mask,
        serve_idx=serve_idx,
        cache_rows=cache_rows,
        n=csr.n,
        p=p,
        width=w,
        n_loc=n_loc,
        e_max=e_max,
        n_rounds=n_rounds,
        s_max=s_max,
        cache_ids=cache_ids,
        n_rounds_requested=n_rounds_requested,
        dedup_rounds=dedup_rounds,
        works=works,
    )
    # the partition rides along as a plain attribute (not a dataclass
    # field, so assert_problems_equal keeps comparing arrays only):
    # apply_delta re-derives worklist ownership from it.
    prob.part = part
    return prob


# --------------------------------------------------------------------------
# Vectorized schedule compiler (the apply_delta recompile path).
# --------------------------------------------------------------------------
def _cumcount(groups: np.ndarray) -> np.ndarray:
    """Per-element index among prior occurrences of the same value, in
    the given order (vectorized group cumcount)."""
    if groups.size == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(groups, kind="stable")
    gs = groups[order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    lens = np.diff(np.r_[starts, gs.size])
    out = np.empty(gs.size, np.int64)
    out[order] = np.arange(gs.size) - np.repeat(starts, lens)
    return out


def _compile_schedule(
    works: List[Tuple[np.ndarray, np.ndarray]],
    part: Partition1D,
    *,
    n: int,
    n_loc: int,
    cache_ids: np.ndarray,
    n_rounds_req: int,
    dedup_rounds: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """Vectorized re-derivation of the pull schedule from edge worklists.

    Bit-exact vs the per-edge reference loops in ``build_sharded_problem``
    (the property tests assert every array): same round chunking, same
    order-of-first-use request dedup per (initiator, round), same serve
    lists and combined indices. One pass of numpy group ops per
    (rank, round) instead of one Python iteration per edge — this is
    what makes per-batch schedule maintenance cheap.

    Returns ``(edge_u, edge_vc, edge_mask, serve_idx, e_max, n_rounds,
    s_max)``.
    """
    p = part.p
    c = int(cache_ids.shape[0])
    slot_lookup = StaticDegreeCache(vertex_ids=cache_ids) if c else None
    e_max = max((u.size for u, _ in works), default=1) or 1
    n_rounds = max(1, min(n_rounds_req, e_max))
    e_chunk = -(-e_max // n_rounds)
    e_max = e_chunk * n_rounds
    base_cache = n_loc + 1
    span = np.int64(n_loc + 1)  # q * span + v_local keys are collision-free

    edge_u = np.full((p, e_max), n_loc, np.int32)
    edge_vc64 = np.full((p, e_max), n_loc, np.int64)
    edge_mask = np.zeros((p, e_max), bool)
    fetch_edges = []  # (rank, edge_idx, q, pos) awaiting s_max resolution
    serve_entries = []  # (rank, round, q, pos, v_local)
    s_max = 1
    for k in range(p):
        u_l, v_g = works[k]
        ne = int(v_g.size)
        if ne == 0:
            continue
        edge_u[k, :ne] = u_l
        edge_mask[k, :ne] = True
        v64 = v_g.astype(np.int64)
        owners = part.owner(v64).astype(np.int64)
        loc = owners == k
        slots = (
            slot_lookup.slot_of(v64)
            if slot_lookup is not None
            else np.full(ne, -1, np.int32)
        )
        cch = (~loc) & (slots >= 0)
        ftc = (~loc) & (slots < 0)
        vc = edge_vc64[k]
        idx_all = np.arange(ne)
        vc[idx_all[loc]] = v64[loc] - part.lo(k)
        vc[idx_all[cch]] = base_cache + slots[cch]
        r_of = idx_all // e_chunk
        lo_arr = np.array([part.lo(q) for q in range(p)], np.int64)
        for r in range(n_rounds):
            idx = np.flatnonzero(ftc & (r_of == r))
            if idx.size == 0:
                continue
            q = owners[idx]
            v_local = v64[idx] - lo_arr[q]
            keys = q * span + v_local
            if dedup_rounds:
                uniq, first, inv = np.unique(
                    keys, return_index=True, return_inverse=True
                )
                order = np.argsort(first, kind="stable")  # first-use order
                q_u = uniq[order] // span
                v_u = uniq[order] % span
                pos_u = _cumcount(q_u)  # index within q's request list
                rank_of = np.empty(uniq.size, np.int64)
                rank_of[order] = np.arange(uniq.size)
                pos_e = pos_u[rank_of[inv]]
                serve_entries.append((k, r, q_u, pos_u, v_u))
                counts = np.bincount(q_u, minlength=p)
            else:
                pos_e = _cumcount(q)  # every occurrence appends
                serve_entries.append((k, r, q, pos_e, v_local))
                counts = np.bincount(q, minlength=p)
            s_max = max(s_max, int(counts.max()))
            fetch_edges.append((k, idx, q, pos_e))

    serve_idx = np.full((p, n_rounds, p, s_max), n_loc, np.int32)
    for k, r, q_u, pos_u, v_u in serve_entries:
        serve_idx[q_u, r, k, pos_u] = v_u.astype(np.int32)
    base_fetch = n_loc + 1 + c
    for k, idx, q, pos_e in fetch_edges:
        edge_vc64[k][idx] = base_fetch + q * s_max + pos_e
    return (
        edge_u,
        edge_vc64.astype(np.int32),
        edge_mask,
        serve_idx,
        int(e_max),
        int(n_rounds),
        int(s_max),
    )


def assert_problems_equal(
    got: ShardedLCCProblem, want: ShardedLCCProblem
) -> None:
    """Field-wise bit-exact comparison of two compiled problems (the
    incremental-maintenance acceptance check)."""
    for f in ("n", "p", "width", "n_loc", "e_max", "n_rounds", "s_max"):
        g, w = getattr(got, f), getattr(want, f)
        assert g == w, f"{f}: {g} != {w}"
    for f in (
        "rows_ext",
        "degrees",
        "edge_u",
        "edge_vc",
        "edge_mask",
        "serve_idx",
        "cache_rows",
        "cache_ids",
    ):
        g, w = getattr(got, f), getattr(want, f)
        assert np.array_equal(g, w), f"{f} diverged"


# --------------------------------------------------------------------------
# Host trace simulator: replays the RMA access stream through ClampiCache.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RMATraceStats:
    """Per-device communication statistics for one LCC computation."""

    remote_gets: np.ndarray  # [p] int64 — adjacency gets made (pre-cache)
    remote_reads_unique: np.ndarray  # [p]
    comm_time: np.ndarray  # [p] float — modeled, caches applied
    compute_edges: np.ndarray  # [p]
    remote_bytes: np.ndarray = None  # [p] bytes fetched AFTER caching
    remote_bytes_raw: np.ndarray = None  # [p] bytes demanded (pre-cache)
    post_cache_gets: np.ndarray = None  # [p] gets that miss the caches
    offsets_stats: List[CacheStats] = dataclasses.field(default_factory=list)
    adj_stats: List[CacheStats] = dataclasses.field(default_factory=list)

    @property
    def makespan(self) -> float:
        return float(self.comm_time.max()) if self.comm_time.size else 0.0


def simulate_rma_lcc(
    csr: CSRGraph,
    p: int,
    *,
    offsets_cache_bytes: int = 0,
    adj_cache_bytes: int = 0,
    use_degree_score: bool = False,
    network: Optional[NetworkModel] = None,
    table_slots_offsets: Optional[int] = None,
    table_slots_adj: Optional[int] = None,
    positional_weight: float = 0.5,
    part=None,
) -> RMATraceStats:
    """Replay the per-device remote-access stream of Algorithm 3.

    Each remote adjacency read = one get on w_offsets (8 B) + one get on
    w_adj (deg * 4 B), both cached when cache bytes > 0 (always-cache
    mode). ``use_degree_score`` switches the adjacency cache's victim
    selection to the paper's application-defined degree score.
    """
    net = network or NetworkModel()
    if part is None:
        part = partition_1d(csr.n, p)
    deg = csr.degrees
    remote_gets = np.zeros(p, np.int64)
    uniq = np.zeros(p, np.int64)
    comm = np.zeros(p, np.float64)
    edges = np.zeros(p, np.int64)
    bytes_after = np.zeros(p, np.int64)
    bytes_raw = np.zeros(p, np.int64)
    gets_after = np.zeros(p, np.int64)
    o_stats: List[CacheStats] = []
    a_stats: List[CacheStats] = []
    for k in range(p):
        u_l, v_g = _edge_worklist(csr, part, k)
        owners = part.owner(v_g)
        remote = v_g[owners != k]
        remote_gets[k] = remote.size
        uniq[k] = np.unique(remote).size
        edges[k] = v_g.size
        c_off = (
            ClampiCache(
                offsets_cache_bytes,
                table_slots_offsets
                or max(1, offsets_cache_bytes // OFFSET_ENTRY_BYTES),
                network=net,
                positional_weight=positional_weight,
            )
            if offsets_cache_bytes > 0
            else None
        )
        if c_off is not None:
            c_off.rank = k  # cachescope stream labeling
            c_off.scope_label = "offsets"
        # hash-table sizing heuristic of §III-B1: n * 0.5**alpha with alpha=2
        default_adj_slots = max(1, int(csr.n * 0.25))
        c_adj = (
            ClampiCache(
                adj_cache_bytes,
                table_slots_adj or default_adj_slots,
                network=net,
                positional_weight=positional_weight,
            )
            if adj_cache_bytes > 0
            else None
        )
        if c_adj is not None:
            c_adj.rank = k
            c_adj.scope_label = "adj"
        t = 0.0
        for v in remote:
            v = int(v)
            size_adj = int(deg[v]) * ID_BYTES
            score = float(deg[v]) if use_degree_score else None
            bytes_raw[k] += OFFSET_ENTRY_BYTES + size_adj
            if c_off is not None:
                if not c_off.get(v, OFFSET_ENTRY_BYTES):
                    bytes_after[k] += OFFSET_ENTRY_BYTES
                    gets_after[k] += 1
            else:
                t += net.remote(OFFSET_ENTRY_BYTES)
                bytes_after[k] += OFFSET_ENTRY_BYTES
                gets_after[k] += 1
            if c_adj is not None:
                if not c_adj.get(v, size_adj, score=score):
                    bytes_after[k] += size_adj
                    gets_after[k] += 1
            else:
                t += net.remote(size_adj)
                bytes_after[k] += size_adj
                gets_after[k] += 1
        if c_off is not None:
            t += c_off.stats.comm_time
            o_stats.append(c_off.stats)
        if c_adj is not None:
            t += c_adj.stats.comm_time
            a_stats.append(c_adj.stats)
        comm[k] = t
    return RMATraceStats(
        remote_gets=remote_gets,
        remote_reads_unique=uniq,
        comm_time=comm,
        compute_edges=edges,
        remote_bytes=bytes_after,
        remote_bytes_raw=bytes_raw,
        post_cache_gets=gets_after,
        offsets_stats=o_stats,
        adj_stats=a_stats,
    )
