"""Rank-sharded SPMD execution of the sharded runtime's rank views, on one
device.

The ``ShardedRuntime`` models p ranks — per-rank caches, a rank-indexed
``fetch_rows`` transport, an all-to-all ``serve_rows`` matrix. In loop mode
the rank views run one after another; this module runs one *execution unit*
of all p rank views as two device programs on the executor's ``device``, the
rank axis the leading dimension of every tensor (the reference runs the same
unit as two ``shard_map`` programs over a p-device JAX mesh):

- **Resident rank-sharded state** — the padded row buffer ``[p, H, W]``
  persists on the device across execution units. Each unit only *patches*
  the rows that are new or drifted (one ``index_copy_`` staged through a
  pinned host buffer): reused rows cost zero H2D traffic and are reported
  as ``upload_bytes_saved``. Freshness is an invalidation contract — the
  runtime's coherence fanout (and the streaming engine's mid-batch delete
  notification) drop mutated ids from the buffer, so a mapped id always
  matches ``store.row(v)`` at pack time.
- **Width-bucketed transport** — the control plane (``fetch_rows`` cache
  admission, stats, the modeled ``serve_rows`` matrix) stays host-side and
  untouched; its recorded ``"miss"`` events become serve lists, bucketed
  onto a fixed geometric ladder of pow-2 width rungs
  (``_PAIR_WIDTH_LADDER``) with windowed high-water capacities. The serve
  program (B5, ``kernels/spmd_plane.py::serve_landing``) moves exactly
  those rows owner -> requester, the all_to_all as the block transpose
  ``got[dst, src] = to_send[src, dst]``: each row's valid prefix, packed
  into one landing at offsets the host computes from the lengths it holds
  (the plain route builds the reference's ``[p, f_pad, W]`` block
  instead, ``serve_block_ref``). The measured ``CollectiveLedger``
  reconciles *by construction* against the modeled matrix; ``bytes_on_wire``
  is charged from the rung shapes, ``bytes_on_wire_single`` from what one
  single-width collective would have moved — the same capacities, layout
  and byte counts as the reference's, so both packages' ledgers are equal
  field for field.
- **Hub-fragment fan-out** — under a hub-aware partition
  (``core.partition.HubPartition``) a fetched split-hub row does not ship
  whole from its owner: every rank serves its *fragment* (slot keyed
  ``n + 1 + v`` so fragment and full-row residency never collide), the
  requester's own fragment stays local, and each pair touching the row
  expands into sub-pairs whose counts are summed by an additive integer
  scatter (``np.add.at`` on int64) — the deterministic fragment reduction.
- **Double-buffered units** — ``dispatch()`` packs, patches and launches a
  unit without synchronising: every upload is a ``non_blocking`` copy from
  pinned memory, the counts come back by one ``non_blocking`` copy into
  pinned memory, and a CUDA event marks the unit's end. ``PendingUnit.wait()``
  is the only synchronisation. Every patch, grow and kernel of the buffer
  runs on the current stream, so unit k's reads come before unit k+1's
  in-place patch (the reference gets the same from functional ``.at[].set``
  patches); the ``PendingUnit`` holds the tensors its unit reads (the
  pre-grow buffer included) and its pinned staging buffers until ``wait()``.
  ``run()`` is dispatch + wait.
- **On-device intersect** — every rank's pair worklist is counted by the
  pair-count program (B6, ``kernels/spmd_plane.py::pair_counts_landed``),
  each side read by index where it lies (resident buffer or landing) over
  its valid length, over the real sub-pairs only (their flat positions are
  staged with the worklist). ``use_kernel=None`` keys the route on the
  device: the CUDA
  kernels there, their plain torch versions on the CPU; ``use_kernel=False``
  takes the plain versions on any device. Counts are exact integers either
  way, so SPMD execution — pipelined or not — is bit-exact against the
  loop-mode engines.

Consumers: ``serving.engine.ShardedQueryEngine(execution="spmd")`` and
``streaming.incremental.StreamingLCCEngine(execution="spmd")``; launchers
``launch/query_serve.py --spmd [--pipeline]`` and
``launch/stream_run.py --spmd [--pipeline]``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import spmd_plane
from ..kernels.bucketing import pow2_ceil
from ..obs import trace as obs_trace

__all__ = [
    "CollectiveLedger",
    "PendingUnit",
    "ShardWork",
    "SpmdIntersectExecutor",
]

ID_BYTES = 4
# bounded bucket counts on a fixed geometric ladder of pow-2 widths
# (clipped to the buffer width), for the serve rungs and the pair buckets
# alike, so the capacities — and with them the fetched block's layout and
# every byte the ledger charges — stay canonical across units.
_PAIR_WIDTH_LADDER = (16, 64, 256, 1 << 30)
# Windowed high-water capacities: per-rung counts follow the max need
# over the last _CAP_WINDOW units, so capacities stay put through per-unit
# jitter, grow immediately on demand, and decay once a peak ages out.
_CAP_WINDOW = 16
# staged arrays start at multiples of this many bytes (int64 views need 8)
_ALIGN = 16


@dataclasses.dataclass
class ShardWork:
    """One rank's slice of an execution unit.

    ``rows_held`` maps vertex id -> sorted 1-D row for every row that is
    rank-resident this unit (local shard rows, cache-hit payloads,
    device-tier mirror rows) — content is whatever the loop-mode engine
    would have read, so staleness semantics carry over unchanged.
    ``fetched_ids`` are the remote misses (in fetch order): their content
    is *not* taken from this rank — it ships from the owner's buffer
    through the serve block. Every id referenced by ``pair_a``/``pair_b``
    must be in exactly one of the two."""

    rank: int
    pair_a: np.ndarray  # int64 [E] vertex ids
    pair_b: np.ndarray  # int64 [E]
    rows_held: Dict[int, np.ndarray]
    fetched_ids: Sequence[int] = ()


@dataclasses.dataclass
class CollectiveLedger:
    """Measured collective + upload traffic of SPMD execution units.

    ``rows_shipped[owner, requester]`` counts rows that travelled through
    the serve block — the measured analogue of the runtime's modeled
    ``serve_rows`` matrix (the serving engine asserts they agree
    delta-for-delta). ``bytes_payload`` is the true row payload moved (sum
    of shipped row widths, the quantity the ``NetworkModel`` charges);
    ``bytes_on_wire`` is what the width-bucketed rungs move between ranks
    (excludes the self-chunk), and ``bytes_on_wire_single`` is what one
    single-max-width collective *would* have moved — their difference is
    the recovered padding. ``bytes_uploaded`` / ``upload_bytes_saved``
    split each unit's working set into rows that had to be H2D-patched into
    the resident buffer vs rows already resident from earlier units (a full
    re-pack would upload the sum of both). Wall-clock fields:
    ``device_wall_s`` is dispatch-to-ready per unit; ``overlap_wait_s`` is
    the part actually spent blocked in ``wait()`` — under pipelining the
    gap between them is work the overlap hid."""

    p: int
    rows_shipped: np.ndarray  # [p, p] int64, owner -> requester
    bytes_payload: int = 0
    bytes_on_wire: int = 0
    bytes_on_wire_single: int = 0
    bytes_uploaded: int = 0
    upload_bytes_saved: int = 0
    n_patches: int = 0
    n_collectives: int = 0
    n_pairs: int = 0
    device_wall_s: float = 0.0
    overlap_wait_s: float = 0.0

    @staticmethod
    def zero(p: int) -> "CollectiveLedger":
        return CollectiveLedger(p=p, rows_shipped=np.zeros((p, p), np.int64))

    def add(self, other: "CollectiveLedger") -> None:
        assert other.p == self.p
        self.rows_shipped += other.rows_shipped
        self.bytes_payload += other.bytes_payload
        self.bytes_on_wire += other.bytes_on_wire
        self.bytes_on_wire_single += other.bytes_on_wire_single
        self.bytes_uploaded += other.bytes_uploaded
        self.upload_bytes_saved += other.upload_bytes_saved
        self.n_patches += other.n_patches
        self.n_collectives += other.n_collectives
        self.n_pairs += other.n_pairs
        self.device_wall_s += other.device_wall_s
        self.overlap_wait_s += other.overlap_wait_s

    @property
    def total_rows(self) -> int:
        return int(self.rows_shipped.sum())

    @property
    def wire_padding_saved(self) -> int:
        """Wire bytes the width-bucketed rungs did NOT move compared to
        the single-max-width baseline."""
        return int(self.bytes_on_wire_single - self.bytes_on_wire)

    def to_dict(self) -> dict:
        return {
            "p": self.p,
            "rows_shipped": int(self.rows_shipped.sum()),
            "bytes_payload": int(self.bytes_payload),
            "bytes_on_wire": int(self.bytes_on_wire),
            "bytes_on_wire_single": int(self.bytes_on_wire_single),
            "wire_padding_saved": self.wire_padding_saved,
            "bytes_uploaded": int(self.bytes_uploaded),
            "upload_bytes_saved": int(self.upload_bytes_saved),
            "n_patches": int(self.n_patches),
            "n_collectives": int(self.n_collectives),
            "n_pairs": int(self.n_pairs),
            "device_wall_s": self.device_wall_s,
            "overlap_wait_s": self.overlap_wait_s,
        }


def _exclusive_rows(lens: np.ndarray) -> np.ndarray:
    """``[p, F + 1]`` int64: row j holds the exclusive cumsum of ``lens``
    flattened in row order at ``[j, :F]`` and row j's end at ``[j, F]``
    (row j + 1's start), so ``[-1, -1]`` is the total."""
    p, f = lens.shape
    flat = np.zeros(p * f + 1, np.int64)
    np.cumsum(lens.reshape(-1), dtype=np.int64, out=flat[1:])
    return flat[np.arange(p)[:, None] * f + np.arange(f + 1)[None, :]]


def _stage(arrays: Sequence[np.ndarray], device: torch.device):
    """Upload ``arrays`` to ``device`` with one copy: laid out in one host
    byte buffer (pinned for CUDA), copied with ``non_blocking=True``, viewed
    back as tensors of their dtypes and shapes. Returns ``(views, host)``;
    the caller keeps ``host`` alive until the copy has completed."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    cuda = device.type == "cuda"
    host = torch.empty(max(total, _ALIGN), dtype=torch.uint8, pin_memory=cuda)
    raw = host.numpy()
    for a, o in zip(arrays, offs):
        raw[o: o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).ravel()
    dev = host.to(device, non_blocking=True) if cuda else host
    views = [
        dev[o: o + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
        for a, o in zip(arrays, offs)
    ]
    return views, host


class _ResidentShardBuffer:
    """The persistent rank-sharded row buffer ``[p, H, W]``.

    Slot ``H-1`` of every rank is a permanent all-sentinel pad row; data
    slots hold one adjacency row each, keyed by vertex id per rank. The
    numpy ``mirror`` is authoritative; ``rows`` is its int32 twin on
    ``device``, patched in place (one ``index_copy_`` a unit, staged through
    a pinned buffer) — the same epoch/patch idiom as the device tier's
    ``ResidencyManager``, minus the scoring (admission here is "whatever
    this unit needs", eviction is LRU among slots the current unit does not
    reference). A grow allocates a new tensor; the old one stays alive in
    the ``PendingUnit`` that still reads it.

    Freshness contract: a mapped id's mirror content equals
    ``store.row(v)`` as of the last unit that wrote it. Callers MUST route
    every store mutation through ``invalidate`` before the next dispatch
    (the engines register on the runtime's coherence fanout, and the
    streaming engine notifies deletions mid-batch); ``audit`` verifies the
    contract against an authoritative store."""

    def __init__(self, p: int, sentinel: int, device: torch.device):
        self.p = int(p)
        self.sentinel = int(sentinel)
        self.device = device
        self.h = 0  # slots per rank, incl. the trailing pad row
        self.w = 0
        self.mirror: Optional[np.ndarray] = None  # [p, h, w] int32
        self.rows: Optional[torch.Tensor] = None  # [p, h, w] int32 twin
        self.slot_of: List[Dict[int, int]] = [dict() for _ in range(p)]
        self.slot_ids: Optional[np.ndarray] = None  # [p, h] int64, -1 free
        self.widths: Optional[np.ndarray] = None  # [p, h] int32
        self.last_used: Optional[np.ndarray] = None  # [p, h] int64
        self.tick = 0

    @property
    def pad_slot(self) -> int:
        return self.h - 1

    # ---------------- capacity ----------------
    def _grow(self, h_new: int, w_new: int, unit: "CollectiveLedger") -> None:
        """Reallocate to (h_new, w_new), keeping mapped rows (slot indices
        are preserved — only the pad slot moves). A grow is a full
        re-upload in the reference, charged to ``bytes_uploaded`` at true
        payload widths, and the ledger charges it so here too; on one card
        the new tensor is filled with the sentinel and the kept slots are
        copied into it on the device, in stream order after the units that
        still read the old one."""
        p = self.p
        rows = torch.full((p, h_new, w_new), self.sentinel, dtype=torch.int32,
                          device=self.device)
        mirror = np.full((p, h_new, w_new), self.sentinel, np.int32)
        slot_ids = np.full((p, h_new), -1, np.int64)
        widths = np.zeros((p, h_new), np.int32)
        last_used = np.zeros((p, h_new), np.int64)
        if self.mirror is not None:
            keep_slots = self.h - 1  # old data slots (old pad row is empty)
            rows[:, :keep_slots, : self.w] = self.rows[:, :keep_slots]
            mirror[:, :keep_slots, : self.w] = self.mirror[:, :keep_slots, :]
            slot_ids[:, :keep_slots] = self.slot_ids[:, :keep_slots]
            widths[:, :keep_slots] = self.widths[:, :keep_slots]
            last_used[:, :keep_slots] = self.last_used[:, :keep_slots]
            unit.bytes_uploaded += (
                int(self.widths[:, :keep_slots].sum()) * ID_BYTES
            )
        self.rows, self.mirror, self.slot_ids = rows, mirror, slot_ids
        self.widths, self.last_used = widths, last_used
        self.h, self.w = h_new, w_new

    def _alloc(self, k: int, protected: set) -> int:
        """A data slot for rank k: first free slot, else LRU-evict a slot
        the current unit does not reference. Capacity is grown ahead of
        assignment, so an evictable slot always exists."""
        ids = self.slot_ids[k, : self.h - 1]
        free = np.flatnonzero(ids < 0)
        if free.size:
            return int(free[0])
        lu = self.last_used[k, : self.h - 1].astype(np.int64, copy=True)
        if protected:
            lu[list(protected)] = np.iinfo(np.int64).max
        s = int(np.argmin(lu))
        assert s not in protected, "no evictable resident slot"
        old = int(self.slot_ids[k, s])
        del self.slot_of[k][old]
        return s

    # ---------------- per-unit patching ----------------
    def ensure(
        self,
        needed: List[Dict[int, np.ndarray]],
        unit: "CollectiveLedger",
        keep: list,
    ) -> None:
        """Make every (rank, id) in ``needed`` resident: reuse mapped rows
        (``upload_bytes_saved``), patch the rest in one device scatter
        (``bytes_uploaded`` / ``n_patches``, span ``spmd_patch``). Host
        buffers the uploads read go to ``keep``."""
        self.tick += 1
        p = self.p
        w_need = max((r.size for d in needed for r in d.values()), default=1)
        h_need = max((len(d) for d in needed), default=0) + 1
        grew = False
        if w_need > self.w or h_need > self.h:
            grew = True
            self._grow(
                max(self.h, pow2_ceil(h_need, 8)),
                max(self.w, pow2_ceil(w_need, 8)),
                unit,
            )
        patches: List[Tuple[int, int, np.ndarray]] = []
        for k in range(p):
            # reused slots are protected from this unit's evictions
            protected = {
                s
                for v, row in needed[k].items()
                if (s := self.slot_of[k].get(v)) is not None
                and self.widths[k, s] == row.size
            }
            for v, row in needed[k].items():
                s = self.slot_of[k].get(v)
                if s is not None and self.widths[k, s] == row.size:
                    # fresh by the invalidation contract — zero H2D.
                    # (a grow already charged this row to the full
                    # re-upload, so it is not "saved" this unit)
                    if not grew:
                        unit.upload_bytes_saved += row.size * ID_BYTES
                    self.last_used[k, s] = self.tick
                    continue
                if s is None:
                    s = self._alloc(k, protected)
                    self.slot_of[k][v] = s
                    self.slot_ids[k, s] = v
                protected.add(s)
                self.widths[k, s] = row.size
                self.last_used[k, s] = self.tick
                self.mirror[k, s, :] = self.sentinel
                self.mirror[k, s, : row.size] = row
                patches.append((k, s, row))
                unit.bytes_uploaded += row.size * ID_BYTES
                unit.n_patches += 1
        self._patch_device(patches, grew, keep)

    def _patch_device(self, patches, grew: bool, keep: list) -> None:
        if not patches:
            return
        with obs_trace.span(
            "spmd_patch", cat="spmd", n_patches=len(patches),
            patch_bytes=sum(r.size for _, _, r in patches) * ID_BYTES,
            rebuild=grew,
        ):
            # pad the scatter to a pow-2 row count, as the reference does;
            # filler rows rewrite the permanent pad slot with the sentinel
            # it already holds
            m = pow2_ceil(len(patches))
            flat = np.full(m, self.pad_slot, np.int64)
            vals = np.full((m, self.w), self.sentinel, np.int32)
            for i, (k, s, row) in enumerate(patches):
                flat[i] = k * self.h + s
                vals[i, : row.size] = row
            (idx, rows), host = _stage([flat, vals], self.device)
            keep.append(host)
            # in place, on the stream every unit's kernels run on: a unit
            # dispatched earlier has read its rows before this patch lands
            self.rows.view(self.p * self.h, self.w).index_copy_(0, idx, rows)

    # ---------------- coherence ----------------
    def invalidate(self, changed_ids=None) -> None:
        """Drop mutated ids from every rank's map (``None`` = drop
        everything, e.g. on a store swap). Slot contents become
        unreferenced garbage; no device traffic."""
        if self.mirror is None:
            return
        if changed_ids is None:
            for k in range(self.p):
                self.slot_of[k].clear()
            self.slot_ids[:, :] = -1
            self.widths[:, :] = 0
            return
        for v in np.unique(np.asarray(changed_ids, np.int64).ravel()):
            v = int(v)
            for k in range(self.p):
                s = self.slot_of[k].pop(v, None)
                if s is not None:
                    self.slot_ids[k, s] = -1
                    self.widths[k, s] = 0

    def audit(self, store, expect=None) -> int:
        """Number of mapped rows whose mirror content differs from the
        authoritative store — 0 under the invalidation contract.
        ``expect(k, key)`` (optional) maps a buffer key to its expected
        content; the default is ``store.row(key)`` (the executor passes a
        resolver that understands hub-fragment keys)."""
        bad = 0
        for k in range(self.p):
            for v, s in self.slot_of[k].items():
                row = (
                    expect(k, v)
                    if expect is not None
                    else np.asarray(store.row(v))
                )
                ok = self.widths[k, s] == row.size and np.array_equal(
                    self.mirror[k, s, : row.size], row
                )
                bad += 0 if ok else 1
        return bad


@dataclasses.dataclass
class PendingUnit:
    """An in-flight execution unit: the host-side ledger is final at
    dispatch (pack, patch, and ship accounting are synchronous), the device
    counts are not. ``wait()`` is the reconciliation barrier — the only
    synchronisation of the SPMD path (the unit's CUDA event) — and returns
    ``(counts, unit)`` exactly like the blocking ``run()``: per-rank int64
    counts in worklist order. ``keep`` holds what the unit's device work
    reads (the buffer it captured, the landing or the fetched block, the
    index tensors)
    and its pinned staging buffers until then."""

    executor: "SpmdIntersectExecutor"
    out: Optional[torch.Tensor]  # host [p, E_tot] int32, or None (empty)
    scatter: Optional[List[List[Tuple[np.ndarray, int]]]]
    pair_sizes: List[int]
    unit: CollectiveLedger
    t_dispatch: float
    event: Optional[object] = None  # torch.cuda.Event after the D2H copy
    keep: Optional[list] = None
    _done: Optional[tuple] = None

    def wait(self):
        if self._done is not None:
            return self._done
        if self.out is None:  # empty unit — nothing was dispatched
            counts = [np.zeros(sz, np.int64) for sz in self.pair_sizes]
            self._done = (counts, self.unit)
            return self._done
        with obs_trace.span(
            "spmd_overlap_wait", cat="spmd", pairs=int(self.unit.n_pairs)
        ):
            t0 = time.perf_counter()
            if self.event is not None:
                self.event.synchronize()
            arr = self.out.numpy().astype(np.int64)
            t1 = time.perf_counter()
        self.keep = None  # the device work has completed
        waited = t1 - t0
        wall = t1 - self.t_dispatch
        self.unit.overlap_wait_s += waited
        self.unit.device_wall_s += wall
        led = self.executor.ledger
        led.overlap_wait_s += waited
        led.device_wall_s += wall
        counts = [np.zeros(sz, np.int64) for sz in self.pair_sizes]
        for j in range(self.executor.p):
            for positions, off in self.scatter[j]:
                # additive scatter on int64: a pair against a split hub row
                # expands into one sub-pair per fragment, all mapped to the
                # same worklist position — fragments partition the row, so
                # summing the sub-counts IS the deterministic fragment
                # reduction (plain assignment when every position is
                # unique, the non-hub case).
                np.add.at(
                    counts[j], positions,
                    arr[j, off: off + positions.size],
                )
        self._done = (counts, self.unit)
        return self._done


class SpmdIntersectExecutor:
    """Runs per-rank pair-intersection worklists as one execution unit of
    p ranks on ``device`` (default ``"cuda"``, resolved by
    ``resolve_device``: raises when missing).

    One ``dispatch()`` call launches one unit: patch the persistent
    resident buffer with this unit's working-set drift, ship the remote
    misses by width rung (B5), and count every pair on its executing rank's
    slice (B6). The returned ``PendingUnit`` carries the complete measured
    ``CollectiveLedger`` immediately; ``wait()`` blocks for the per-rank
    counts. ``run()`` is the unpipelined dispatch+wait convenience.
    ``use_kernel=None`` takes the CUDA kernels on a CUDA device and their
    plain torch versions on the CPU; ``use_kernel=False`` the plain
    versions anywhere."""

    def __init__(
        self,
        part,
        n: int,
        *,
        p: Optional[int] = None,
        device="cuda",
        use_kernel: Optional[bool] = None,
        runtime=None,
    ):
        self.part = part
        self.n = int(n)
        self.p = int(p if p is not None else part.p)
        self.device = resolve_device(device)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        self.use_kernel = bool(use_kernel)
        self.ledger = CollectiveLedger.zero(self.p)
        self._buf = _ResidentShardBuffer(self.p, self.n, self.device)
        self._empty_blocks: Dict[Tuple[int, int], torch.Tensor] = {}
        # windowed high-water capacities (keyed by rung width) that keep
        # the block layout and the ledger's charges canonical across
        # units — see _CAP_WINDOW
        self._f_hw = 1  # fetched-block capacity, pow-2, grow-only
        self._serve_s_seen: Dict[int, object] = {}  # rung w -> need deque
        self._pair_e_seen: Dict[int, object] = {}  # rung w -> need deque
        if runtime is not None:
            runtime.add_invalidation_listener(self.invalidate)

    # ---------------- coherence ----------------
    def invalidate(self, changed_ids=None) -> None:
        """Drop mutated ids from the resident buffer (``None`` = all).
        Wired to the runtime's coherence fanout by the engines; the
        streaming engine additionally notifies deletions mid-batch. Hub
        fragments live under synthetic keys ``n + 1 + v`` (see
        ``dispatch``), so a mutated row drops both its full-row and its
        fragment residency."""
        self._buf.invalidate(changed_ids)
        if changed_ids is not None:
            arr = np.unique(np.asarray(changed_ids, np.int64).ravel())
            if arr.size:
                self._buf.invalidate(arr + self.n + 1)

    def audit_resident(self, store) -> int:
        """Stale resident rows vs the authoritative store (0 expected).
        Fragment keys audit against the fragment of the current store row
        they are defined to mirror."""
        frag_base = self.n + 1
        part = self.part

        def expect(k: int, key: int) -> np.ndarray:
            if key >= frag_base:
                return part.fragment(
                    np.asarray(store.row(key - frag_base)), k
                )
            return np.asarray(store.row(key))

        return self._buf.audit(store, expect=expect)

    def _empty_fetched(self, f_pad: int, w: int) -> torch.Tensor:
        """Cached all-sentinel fetch block for units with no serve traffic
        on the plain route: the reference's pair program still takes its
        ``[p, f_pad, w]`` fetch input, but nothing moves (the kernel route
        takes an empty landing)."""
        blk = self._empty_blocks.get((f_pad, w))
        if blk is None:
            blk = torch.full((self.p, f_pad, w), self.n, dtype=torch.int32,
                             device=self.device)
            self._empty_blocks[(f_pad, w)] = blk
        return blk

    def _pair_widths(self, w: int) -> List[int]:
        """Fixed geometric pow-2 pair-bucket widths for buffer width ``w``
        (the ladder clipped to ``w``, so at most ``len(_PAIR_WIDTH_LADDER)``
        buckets, last always ``w``)."""
        return sorted({min(w, c) for c in _PAIR_WIDTH_LADDER})

    def _cap(self, seen: Dict[int, object], rung_w: int, need: int,
             lo: int) -> int:
        """Windowed pow-2 capacity for one rung: the pow-2 ceiling of the
        max need over the last ``_CAP_WINDOW`` units. Stable under per-unit
        jitter, grows immediately when a unit needs more, and decays once
        an old peak leaves the window."""
        dq = seen.get(rung_w)
        if dq is None:
            dq = seen[rung_w] = collections.deque(maxlen=_CAP_WINDOW)
        dq.append(int(need))
        return pow2_ceil(max(dq), lo)

    # ---------------- one execution unit ----------------
    def dispatch(self, shards: List[ShardWork], store) -> PendingUnit:
        """Pack, patch, and launch one unit without synchronising.
        ``store`` provides ``row(v)`` for the rows each owner serves (its
        authoritative shard content). The returned ``PendingUnit``'s ledger
        is complete immediately (and already folded into the cumulative
        ``self.ledger``, wall-clock fields excepted) — the measured-vs-
        modeled reconciliation can run before ``wait()``."""
        p = self.p
        assert len(shards) == p and all(
            s.rank == k for k, s in enumerate(shards)
        ), "need one ShardWork per rank, in rank order"
        unit = CollectiveLedger.zero(p)
        pair_sizes = [s.pair_a.size for s in shards]
        n_pairs = sum(pair_sizes)
        n_fetched = sum(len(s.fetched_ids) for s in shards)
        if n_pairs == 0 and n_fetched == 0:
            return PendingUnit(self, None, None, pair_sizes, unit, 0.0)

        # spans: host-side packing vs. the device programs, as two sibling
        # phases (manual open/close keeps the hot path unindented)
        _pack = obs_trace.span("spmd_pack", cat="spmd", n_pairs=n_pairs,
                               n_fetched=n_fetched)
        _pack.__enter__()
        keep: list = [self._buf.rows]  # what this unit's device work reads

        # serve lists: ship[k][j] = buffer keys rank k sends requester j,
        # in requester fetch order (mirrors serve_rows accounting). Keys
        # are vertex ids for whole rows; a *split hub* row ships as
        # per-rank fragments under synthetic keys ``frag_base + v``
        # (frag_base = n + 1, so full-row and fragment residency never
        # collide): every rank with a nonempty fragment serves it, the
        # requester's own fragment stays rank-resident and free — exactly
        # the charges ``ShardedRuntime._charge_remote_miss`` models, so the
        # reconciliation stays row-for-row.
        part = self.part
        hub_split = bool(getattr(part, "has_hubs", False))
        frag_base = self.n + 1
        ship: List[List[List[int]]] = [
            [[] for _ in range(p)] for _ in range(p)
        ]
        requested: List[set] = [set() for _ in range(p)]
        # full content of every fetched hub row (fragments slice it)
        hub_full: Dict[int, np.ndarray] = {}
        # requester -> fetched hub ids (their own-fragment residency)
        hub_fetched: List[List[int]] = [[] for _ in range(p)]
        for j, sh in enumerate(shards):
            for v in sh.fetched_ids:
                v = int(v)
                assert v not in sh.rows_held, (
                    f"id {v} both held and fetched at rank {j}"
                )
                k = int(part.owner(v))
                assert k != j, f"rank {j} fetching its own row {v}"
                if v in requested[j]:
                    continue  # one shipment per (owner, requester, id)
                requested[j].add(v)
                if hub_split and bool(part.is_hub(v)):
                    row = hub_full.get(v)
                    if row is None:
                        held = shards[k].rows_held.get(v)
                        row = np.asarray(
                            held if held is not None else store.row(v)
                        )
                        hub_full[v] = row
                    hub_fetched[j].append(v)
                    for q in range(p):
                        if q == j:
                            continue
                        if part.fragment(row, q).size == 0:
                            continue
                        ship[q][j].append(frag_base + v)
                else:
                    ship[k][j].append(v)

        # serve content: whole rows come from the serving rank's held copy
        # (else the authoritative store); fragment keys slice the full hub
        # row — every rank can serve its fragment because the fragment IS
        # rank q's share of the split row.
        serve_rows_content: List[Dict[int, np.ndarray]] = [
            {} for _ in range(p)
        ]
        for k in range(p):
            for j in range(p):
                for key in ship[k][j]:
                    if key not in serve_rows_content[k]:
                        if key >= frag_base:
                            row = part.fragment(
                                hub_full[key - frag_base], k
                            )
                        else:
                            held = shards[k].rows_held.get(key)
                            row = held if held is not None else np.asarray(
                                store.row(key)
                            )
                        serve_rows_content[k][key] = row
                    unit.rows_shipped[k, j] += 1
                    unit.bytes_payload += (
                        serve_rows_content[k][key].size * ID_BYTES
                    )

        # resident working set: held rows, the rows/fragments served from
        # this rank's buffer, and each requester's own fragment of every
        # hub row it fetched (local, never on the wire) — already-resident
        # entries cost zero H2D.
        needed: List[Dict[int, np.ndarray]] = []
        for k, sh in enumerate(shards):
            d = {int(v): np.asarray(row) for v, row in sh.rows_held.items()}
            for key, row in serve_rows_content[k].items():
                d.setdefault(key, row)
            for v in hub_fetched[k]:
                own = part.fragment(hub_full[v], k)
                if own.size:
                    d.setdefault(frag_base + v, own)
            needed.append(d)
        self._buf.ensure(needed, unit, keep)
        h, w = self._buf.h, self._buf.w
        pad_slot = self._buf.pad_slot

        # per-unit max width (held + served), for the single-width wire
        # baseline the non-bucketed collective would have paid
        w_unit = max((r.size for d in needed for r in d.values()), default=1)

        # ---- serve rungs: one ladder width class each ----
        # Canonical shapes: the fixed geometric width ladder (the same as
        # the pair buckets) and windowed per-rung count capacities.
        # ``bytes_on_wire`` reports the shipped rung shapes, so the padding
        # accounting stays honest; the windowed decay keeps the capacities
        # tracking the workload instead of its historical peak.
        widths = self._pair_widths(w)
        serve_lists: List[Dict[Tuple[int, int], List[int]]] = [
            {} for _ in widths
        ]
        widths_arr = np.asarray(widths, np.int64)
        has_serve = False
        for k in range(p):
            for j in range(p):
                for key in ship[k][j]:
                    has_serve = True
                    rung = int(np.searchsorted(
                        widths_arr, max(serve_rows_content[k][key].size, 1),
                        side="left",
                    ))
                    serve_lists[rung].setdefault((k, j), []).append(key)
        serve_cfg: List[Tuple[int, int]] = []
        serve_segs: List[np.ndarray] = []
        len_segs: List[np.ndarray] = []  # valid length a serve position
        # fetch_refs[j][key] -> every (combined-buffer index, width) that
        # arrived for ``key`` at requester j. Whole rows have one ref; a
        # split hub row has one ref per serving rank (its fragments), all
        # under the same ``frag_base + v`` key.
        fetch_refs: List[Dict[int, List[Tuple[int, int]]]] = [
            {} for _ in range(p)
        ]
        fetch_base = h
        wire_bytes = 0
        for rung, w_b in enumerate(widths):
            lists = serve_lists[rung]
            need = max((len(vs) for vs in lists.values()), default=0)
            s_b = self._cap(self._serve_s_seen, w_b, need, 1)
            # a unit with no serve traffic at all skips the serve program
            # (wire bytes 0, cached sentinel fetch block below)
            if not has_serve:
                continue
            seg = np.full((p, p, s_b), pad_slot, np.int32)
            len_seg = np.zeros((p, p, s_b), np.int32)
            for (k, j), keys in lists.items():
                for pos, key in enumerate(keys):
                    size = serve_rows_content[k][key].size
                    seg[k, j, pos] = self._buf.slot_of[k][key]
                    len_seg[k, j, pos] = size
                    fetch_refs[j].setdefault(key, []).append((
                        fetch_base + k * s_b + pos, size,
                    ))
            serve_cfg.append((s_b, w_b))
            serve_segs.append(seg)
            len_segs.append(len_seg)
            fetch_base += p * s_b
            wire_bytes += p * (p - 1) * s_b * w_b * ID_BYTES
        # single-width baseline: one collective padded to the max ship
        # count and the unit's max row width (the pre-bucketing scheme)
        s_single = pow2_ceil(
            max((len(ship[k][j]) for k in range(p) for j in range(p)),
                default=0),
            4,
        )
        # the baseline skips empty units too — it gets the same no-traffic
        # shortcut, so the comparison is padding-vs-padding
        single_bytes = (
            p * (p - 1) * s_single * pow2_ceil(w_unit, 1) * ID_BYTES
            if has_serve
            else 0
        )

        # ---- pair worklists, bucketed by pow-2 pair width ----
        # A pair references each side through its *refs*: the combined-
        # buffer indices (with true widths) covering that row as read by
        # rank j. Whole rows — held, served-from-own-buffer, or fetched —
        # have exactly one ref; a fetched split-hub row has one ref per
        # nonempty fragment (own fragment resident, the rest in the fetch
        # block). The pair expands into the cross product of its sides'
        # refs; fragments partition the row, so the sub-counts sum to the
        # whole-row intersection (the additive scatter in
        # ``PendingUnit.wait`` performs that reduction). Everything reduces
        # to one sub-pair per pair when no hub is split.
        def refs(j: int, v: int) -> List[Tuple[int, int]]:
            row = needed[j].get(v)
            if row is not None:
                return [(self._buf.slot_of[j][v], row.size)]
            out: List[Tuple[int, int]] = []
            own = needed[j].get(frag_base + v)
            if own is not None:
                out.append((self._buf.slot_of[j][frag_base + v],
                            own.size))
            out.extend(fetch_refs[j].get(frag_base + v, ()))
            out.extend(fetch_refs[j].get(v, ()))
            return out

        sub_rank: List[int] = []
        sub_pos: List[int] = []
        sub_a: List[int] = []
        sub_b: List[int] = []
        sub_wa: List[int] = []
        sub_wb: List[int] = []
        for j, sh in enumerate(shards):
            for i in range(sh.pair_a.size):
                for ia, wa in refs(j, int(sh.pair_a[i])):
                    for ib, wb in refs(j, int(sh.pair_b[i])):
                        sub_rank.append(j)
                        sub_pos.append(i)
                        sub_a.append(ia)
                        sub_b.append(ib)
                        sub_wa.append(wa)
                        sub_wb.append(wb)
        sub_rank = np.asarray(sub_rank, np.int64)
        sub_pos = np.asarray(sub_pos, np.int64)
        sub_a_arr = np.asarray(sub_a, np.int64)
        sub_b_arr = np.asarray(sub_b, np.int64)
        sub_wa_arr = np.asarray(sub_wa, np.int64)
        sub_wb_arr = np.asarray(sub_wb, np.int64)

        # the fetched block is padded to a grow-only pow-2 capacity, as
        # the reference's is (its layout is the ledger's and the tests')
        f_exact = fetch_base - h
        self._f_hw = max(self._f_hw, pow2_ceil(max(f_exact, 1)))
        f_pad = self._f_hw

        sub_w_arr = np.maximum(np.maximum(sub_wa_arr, sub_wb_arr), 1)
        pair_slot = np.searchsorted(
            np.asarray(widths, np.int64), sub_w_arr, side="left"
        )
        pair_cfg: List[Tuple[int, int]] = []
        segs: List[List[np.ndarray]] = [[], [], [], [], []]
        scatter: List[List[Tuple[np.ndarray, int]]] = [[] for _ in range(p)]
        real_runs: List[Tuple[int, int, int]] = []  # (rank, start, count)
        seg_off = 0
        for slot, w_p in enumerate(widths):
            indices = np.flatnonzero(pair_slot == slot)
            e_max = (
                int(np.max(np.bincount(sub_rank[indices], minlength=p)))
                if indices.size
                else 0
            )
            # windowed per-rung capacity: the bucket re-shapes only when
            # its windowed high-water mark moves
            e_pad = self._cap(self._pair_e_seen, w_p, e_max, 8)
            a_seg = np.full((p, e_pad), pad_slot, np.int32)
            b_seg = np.full((p, e_pad), pad_slot, np.int32)
            la_seg = np.zeros((p, e_pad), np.int32)
            lb_seg = np.zeros((p, e_pad), np.int32)
            m_seg = np.zeros((p, e_pad), bool)
            if indices.size:
                with obs_trace.span(
                    "intersect_kernel", cat="spmd", bucket_w=w_p,
                    pairs=int(indices.size),
                ):
                    for j in range(p):
                        sel = indices[sub_rank[indices] == j]
                        if not sel.size:
                            continue
                        a_seg[j, : sel.size] = sub_a_arr[sel]
                        b_seg[j, : sel.size] = sub_b_arr[sel]
                        la_seg[j, : sel.size] = sub_wa_arr[sel]
                        lb_seg[j, : sel.size] = sub_wb_arr[sel]
                        m_seg[j, : sel.size] = True
                        scatter[j].append((sub_pos[sel], seg_off))
                        real_runs.append((j, seg_off, sel.size))
            pair_cfg.append((e_pad, w_p))
            for lst, seg in zip(segs, (a_seg, b_seg, la_seg, lb_seg, m_seg)):
                lst.append(seg)
            seg_off += e_pad
        a_idx, b_idx, a_len, b_len, mask = (
            np.concatenate(lst, axis=1) for lst in segs
        )
        staged = [a_idx, b_idx, a_len, b_len, mask]
        # the landing: every shipped row's valid prefix, packed in (j, f)
        # order (f = fetched row); f_exact = fetch_base - h rows a rank
        flen = (np.concatenate([x.transpose(1, 0, 2).reshape(p, -1)
                                for x in len_segs], axis=1)
                if has_serve else np.zeros((p, 0), np.int32))
        land_off = _exclusive_rows(flen)
        n_landed = int(land_off[-1, -1])
        if self.use_kernel:
            # the real sub-pairs' flat positions, ascending: B6's grid
            e_tot = a_idx.shape[1]
            real = np.sort(np.concatenate(
                [j * e_tot + off + np.arange(n, dtype=np.int64)
                 for j, off, n in real_runs] or [np.zeros(0, np.int64)]
            )).astype(np.int32)
            staged += [real, land_off]
        if has_serve:
            staged.append(np.concatenate(serve_segs, axis=2))
            if self.use_kernel:
                staged += [np.concatenate(len_segs, axis=2),
                           spmd_plane.landing_items(flen)]
        views, host = _stage(staged, self.device)
        keep.append(host)
        _pack.__exit__(None, None, None)

        unit.n_collectives += 1 if has_serve else 0
        unit.n_pairs += n_pairs
        unit.bytes_on_wire += wire_bytes
        unit.bytes_on_wire_single += single_bytes
        t0 = time.perf_counter()
        # asynchronous launch — the span covers dispatch only; the device
        # time surfaces in spmd_overlap_wait at the reconciliation barrier
        with obs_trace.span(
            "all_to_all", cat="spmd", pairs=n_pairs,
            payload_bytes=int(unit.bytes_payload), wire_bytes=wire_bytes,
            buckets=len(serve_cfg), landed_bytes=n_landed * ID_BYTES,
        ):
            rows = self._buf.rows
            if self.use_kernel:
                # B5 lands the valid prefixes packed; B6 reads them there
                real_v, land_off_v = views[5], views[6]
                if has_serve:
                    fetched = spmd_plane.serve_landing(
                        rows, views[7], views[8], land_off_v, serve_cfg,
                        n_landed, items=views[9])
                else:
                    fetched = rows.new_empty(0)  # the empty landing
                out = spmd_plane.pair_counts_landed(
                    rows, fetched, land_off_v, *views[:5], pair_cfg=pair_cfg,
                    sentinel=self.n, real=real_v)
            else:
                # the reference's layout: the [p, f_pad, W] block
                if has_serve:
                    fetched = spmd_plane.serve_block_ref(
                        rows, views[5], serve_cfg, f_pad, sentinel=self.n)
                else:
                    fetched = self._empty_fetched(f_pad, w)
                out = spmd_plane.pair_counts_ref(
                    rows, fetched, *views[:5], pair_cfg=pair_cfg,
                    sentinel=self.n)
            event = None
            if out.device.type == "cuda":
                host_out = torch.empty(out.shape, dtype=out.dtype,
                                       pin_memory=True)
                host_out.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host_out = out
            keep.extend([rows, fetched, out, views])
        self.ledger.add(unit)  # wall-clock fields accrue at wait()
        return PendingUnit(self, host_out, scatter, pair_sizes, unit, t0,
                           event, keep)

    def run(self, shards: List[ShardWork], store):
        """Execute one unit synchronously (dispatch + wait). Returns
        ``(counts, ledger)``: per-rank int64 count arrays in worklist order
        and this unit's measured collective ledger (also folded into the
        cumulative ``self.ledger``)."""
        return self.dispatch(shards, store).wait()
