"""ResidencyManager: the device-resident hot-row cache tier.

One fixed-capacity padded buffer ``rows [slots, max_width]`` lives on
device; each slot holds the sorted adjacency row of one hot vertex,
sentinel-padded. Selection uses the same CLaMPI-style application score
as the host tier — degree centrality (paper §III-B2, Observations
3.1/3.2: degree predicts reuse) — restricted to rows that fit the
padded width. A dense vertex→slot table answers residency probes in
O(1) vectorized.

Coherence under streaming deltas (the part the static
``StaticDegreeCache`` cannot do):

- **in-place row patch** — a mutated resident row is re-read from the
  authoritative store and re-uploaded into its slot (one row-granular
  DMA, not a buffer rebuild) as long as it still fits ``max_width``;
- **score-driven evict/admit** — mutated outsiders whose degree now
  strictly exceeds the weakest resident's displace it (strict
  comparison, so score ties never thrash slots); residents that outgrow
  the padded width or drop to degree 0 are evicted;
- **epoch-bumped slots** — every slot carries an epoch that bumps on
  any content change (patch, evict, admit). A consumer that captured
  ``(slot, epoch)`` handles before a batch fails ``check()`` after it,
  so a stale resident hit is impossible by construction; evicted slots
  are additionally overwritten with sentinel rows, which intersect
  nothing.

A host mirror of the buffer backs the non-kernel consumers: serving a
resident row from the mirror skips the per-batch ``DynamicCSR.row``
merge + padding + upload (host-row materialization);
``stats.bytes_saved`` ledgers exactly those bytes.

On the device, ``rows`` is one persistent int32 tensor ``[slots,
max_width]`` on the manager's ``device``, and ``lens`` an int32 tensor
``[slots]`` beside it: the valid length of each slot (its ``widths``
entry; 0 for an empty or evicted slot), which the ``resident_intersect``
kernel (B3) reads instead of searching each row for its padding. A
rebuild uploads both whole, a patch writes only the changed slots of both
with one ``index_copy_`` each. Neither shares memory with the mirror (on
the CPU too), so a missed sync shows up as a mirror/device divergence in
``audit()``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..kernels.bucketing import pow2_ceil
from ..obs import cachescope as obs_cachescope
from ..obs import trace as obs_trace
from .resolve import resolve_device

__all__ = ["ResidencyStats", "ResidencyManager"]

ID_BYTES = 4


@dataclasses.dataclass
class ResidencyStats:
    """Flat counters (aggregable via ``merge_counter_dataclasses``)."""

    lookups: int = 0  # rows asked of the tier (claims + padded fills)
    hits: int = 0  # rows served from the resident buffer
    misses: int = 0
    bytes_saved: int = 0  # host materialization/upload bytes avoided
    admits: int = 0
    evicts: int = 0
    patches: int = 0  # in-place row re-uploads after a mutation
    uploads: int = 0  # rows shipped host -> device (admits + patches)
    upload_bytes: int = 0
    epoch_bumps: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class ResidencyManager:
    def __init__(
        self,
        store,
        *,
        slots: int,
        max_width: Optional[int] = None,
        exclude_range: Optional[Tuple[int, int]] = None,
        device="cuda",
    ):
        """``exclude_range=(lo, hi)`` makes vertices in ``[lo, hi)``
        ineligible — the per-rank hot-set mode: a rank's own owned
        block is served locally and never reads through the tier, so
        its slots should hold remote-heavy rows instead. ``rows`` lives
        on ``device`` (resolved by ``resolve_device``: raises when it is
        missing)."""
        assert slots >= 1
        self.device = resolve_device(device)
        self.store = store
        self.n = int(store.n)
        self.sentinel = self.n
        self.slots = int(slots)
        self.exclude_range = (
            (int(exclude_range[0]), int(exclude_range[1]))
            if exclude_range is not None
            else None
        )
        if max_width is None:
            max_width = pow2_ceil(max(int(store.max_degree), 1))
        self.max_width = int(max_width)
        self.slot_ids = np.full(self.slots, -1, np.int64)  # -1: empty
        self.slot_epochs = np.zeros(self.slots, np.int64)
        self.widths = np.zeros(self.slots, np.int32)  # true degree per slot
        self._slot_table = np.full(self.n, -1, np.int32)
        self._host = np.full(
            (self.slots, self.max_width), self.sentinel, np.int32
        )
        self.rows: Optional[torch.Tensor] = None  # set by _sync_device
        self.lens: Optional[torch.Tensor] = None  # [slots] int32, with rows
        self.stats = ResidencyStats()
        self.rebuilds = 0
        # optional workload-driven selection score: callable
        # degrees -> per-vertex score array (e.g. the traffic plane's
        # EWMA×degree blend). None = the paper's pure-degree prior,
        # bit-identical to the pre-hook behavior. Takes effect on the
        # next rebuild()/notify_batch().
        self.score_fn = None
        self.rebuild()

    # ---------------- selection ----------------
    def _selection_scores(self, deg: np.ndarray) -> Optional[np.ndarray]:
        """Workload scores (float) when a score_fn is attached, else
        None (degree prior)."""
        if self.score_fn is None:
            return None
        return np.asarray(self.score_fn(deg), np.float64)

    def _eligible_scores(self) -> np.ndarray:
        deg = np.asarray(self.store.degrees, np.int64)
        sc = self._selection_scores(deg)
        base = deg if sc is None else sc
        # eligibility stays structural (nonzero degree, fits the padded
        # width) regardless of what scores the ranking: a workload score
        # cannot admit a row the buffer cannot hold. NOTE rebuild keeps
        # only score > 0 — with a pure-frequency score (blend=1.0) a
        # never-accessed row scores 0 and is excluded; keep blend < 1 so
        # the degree term breaks ties among cold rows (docs/serving.md).
        score = np.where((deg > 0) & (deg <= self.max_width), base, -1)
        if self.exclude_range is not None:
            lo, hi = self.exclude_range
            score[lo:hi] = -1  # owned rows are local reads — never cached
        return score

    def rebuild(self) -> None:
        """Select the hot set from scratch: top-``slots`` eligible
        vertices by degree score (stable tie-break by vertex id, same
        rule as ``build_static_degree_cache``) and upload their rows."""
        with obs_trace.span("residency_rebuild", cat="device",
                            slots=self.slots):
            self._rebuild_impl()

    def _rebuild_impl(self) -> None:
        score = self._eligible_scores()
        order = np.lexsort((np.arange(self.n), score))
        order = order[score[order] > 0]
        chosen = np.sort(order[max(0, order.size - self.slots):])
        rec = obs_cachescope._recorder
        if rec is not None:
            # before any mutation: a stream registered here snapshots the
            # PRE-rebuild membership, then the "r" event installs `chosen`
            rec.on_dev_reset(self, chosen)
        self._slot_table[:] = -1
        self.slot_ids[:] = -1
        self.widths[:] = 0
        self._host[:] = self.sentinel
        for s, v in enumerate(chosen.tolist()):
            row = self.store.row(int(v))
            self.slot_ids[s] = v
            self.widths[s] = row.size
            self._host[s, : row.size] = row
            self._slot_table[v] = s
            self.stats.uploads += 1
            self.stats.upload_bytes += row.size * ID_BYTES
        self.slot_epochs += 1
        self.stats.epoch_bumps += self.slots
        self.rebuilds += 1
        self._sync_device()

    def _sync_device(self, changed_slots: Optional[np.ndarray] = None) -> None:
        """Full upload of ``rows`` and ``lens`` on rebuild, else one
        ``index_copy_`` of the changed slots into each. All copy:
        ``torch.tensor`` copies the mirror, and the fancy-indexed
        ``_host[changed_slots]`` / ``widths[changed_slots]`` are fresh
        arrays that the next batch does not mutate, so no later
        ``_write``/``_evict`` can reach the device without passing through
        here."""
        if self.rows is None or changed_slots is None:
            self.rows = torch.tensor(self._host, device=self.device)
            self.lens = torch.tensor(self.widths, device=self.device)
        elif changed_slots.size:
            idx = torch.from_numpy(changed_slots.astype(np.int64))
            idx = idx.to(self.device)
            src = torch.from_numpy(self._host[changed_slots])
            self.rows.index_copy_(0, idx, src.to(self.device))
            lens = torch.from_numpy(self.widths[changed_slots])
            self.lens.index_copy_(0, idx, lens.to(self.device))

    # ---------------- probes ----------------
    @property
    def resident_rows(self) -> int:
        return int(np.count_nonzero(self.slot_ids >= 0))

    def slot_of(self, v) -> np.ndarray:
        """Slot per vertex id, -1 if not resident (vectorized, no stats)."""
        return self._slot_table[np.asarray(v, np.int64)]

    def claim(self, vertices) -> Tuple[np.ndarray, np.ndarray]:
        """(slots, epochs) per vertex (-1 / 0 when not resident), with
        the ledger update: every resident row claimed is one host
        fetch+pack+upload avoided this kernel call."""
        vs = np.asarray(vertices, np.int64)
        slots = self._slot_table[vs].copy()
        hit = slots >= 0
        epochs = np.zeros(vs.size, np.int64)
        epochs[hit] = self.slot_epochs[slots[hit]]
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_dev_lookup(self, vs)
        st = self.stats
        st.lookups += int(vs.size)
        st.hits += int(np.count_nonzero(hit))
        st.misses += int(np.count_nonzero(~hit))
        st.bytes_saved += int(self.widths[slots[hit]].sum()) * ID_BYTES
        return slots, epochs

    def check(self, slots: np.ndarray, epochs: np.ndarray) -> None:
        """Fail on any stale ``(slot, epoch)`` handle — the guarantee
        that a resident hit can never observe pre-mutation content."""
        slots = np.asarray(slots, np.int64)
        epochs = np.asarray(epochs, np.int64)
        if slots.size and not np.array_equal(
            self.slot_epochs[slots], epochs
        ):
            bad = np.flatnonzero(self.slot_epochs[slots] != epochs)[:8]
            raise AssertionError(
                f"stale residency handles at slots {slots[bad].tolist()}"
            )

    # ---------------- serving ----------------
    def serve(self, v: int) -> Optional[np.ndarray]:
        """The trimmed resident row of ``v`` (None on miss), from the
        host mirror — the ``fetch_rows`` fast path."""
        s = int(self._slot_table[int(v)])
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_dev_lookup(self, [int(v)])
        st = self.stats
        st.lookups += 1
        if s < 0:
            st.misses += 1
            return None
        st.hits += 1
        w = int(self.widths[s])
        st.bytes_saved += w * ID_BYTES
        return self._host[s, :w].copy()

    def host_rows(self, slots: np.ndarray) -> np.ndarray:
        """Mirror rows for the given slots (host-side count fallback)."""
        return self._host[np.asarray(slots, np.int64)]

    def padded_rows(
        self, vertices, width: int, *, sentinel: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Padded ``[len(vertices), width]`` row matrix where resident
        rows come from the mirror (no per-row merge) and the rest from
        the store. Returns ``(rows, resident_mask)``.

        Requires ``width`` >= every resident row's true width among
        ``vertices`` (callers size by max touched degree, which bounds
        resident widths)."""
        vs = np.asarray(vertices, np.int64)
        sent = int(self.sentinel if sentinel is None else sentinel)
        # resident tails copied from the mirror carry the manager's own
        # sentinel; a different caller sentinel would mix padding values
        # and let paddings match each other downstream
        assert sent == self.sentinel, "sentinel must equal store.n"
        out = np.full((vs.size, width), sent, np.int32)
        slots = self._slot_table[vs]
        resident = slots >= 0
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_dev_lookup(self, vs)
        st = self.stats
        st.lookups += int(vs.size)
        st.hits += int(np.count_nonzero(resident))
        st.misses += int(np.count_nonzero(~resident))
        res_idx = np.flatnonzero(resident)
        if res_idx.size:
            s = slots[res_idx]
            assert int(self.widths[s].max()) <= width, (
                "resident row wider than the target layout"
            )
            # one vectorized gather: the mirror is sentinel-padded past
            # each row's true width, so copying a rectangle is exact
            w_copy = min(width, self.max_width)
            out[res_idx, :w_copy] = self._host[s, :w_copy]
            st.bytes_saved += int(self.widths[s].sum()) * ID_BYTES
        for i in np.flatnonzero(~resident):
            r = self.store.row(int(vs[i]))[:width]
            out[i, : r.size] = r
        return out, resident

    # ---------------- coherence ----------------
    def _evict(self, s: int) -> None:
        v = int(self.slot_ids[s])
        rec = obs_cachescope._recorder
        if rec is not None:
            rec.on_dev_evict(self, v)
        self._slot_table[v] = -1
        self.slot_ids[s] = -1
        self.widths[s] = 0
        self._host[s, :] = self.sentinel  # stale content can match nothing
        self.slot_epochs[s] += 1
        self.stats.evicts += 1
        self.stats.epoch_bumps += 1

    def _write(self, s: int, v: int, row: np.ndarray) -> None:
        self._host[s, :] = self.sentinel
        self._host[s, : row.size] = row
        self.slot_ids[s] = v
        self.widths[s] = row.size
        self._slot_table[v] = s
        self.slot_epochs[s] += 1
        st = self.stats
        st.epoch_bumps += 1
        st.uploads += 1
        st.upload_bytes += row.size * ID_BYTES

    def notify_batch(self, changed_ids: Iterable[int]) -> int:
        """Bring the tier up to date after one applied update batch
        mutated ``changed_ids``' rows. Returns slots touched."""
        changed = np.unique(np.asarray(list(changed_ids), np.int64))
        if changed.size == 0:
            return 0
        with obs_trace.span("residency_patch", cat="device",
                            n=changed.size):
            return self._notify_batch_impl(changed)

    def _notify_batch_impl(self, changed: np.ndarray) -> int:
        deg = np.asarray(self.store.degrees, np.int64)
        touched: list[int] = []
        # 1. resident mutations: patch in place or evict on overflow
        slots = self._slot_table[changed]
        for i in np.flatnonzero(slots >= 0):
            v = int(changed[i])
            s = int(slots[i])
            d = int(deg[v])
            if d == 0 or d > self.max_width:
                self._evict(s)
            else:
                rec = obs_cachescope._recorder
                if rec is not None:
                    rec.on_dev_patch(self, v)
                self._write(s, v, self.store.row(v))
                self.stats.patches += 1
            touched.append(s)
        # 2. score-driven admission: mutated outsiders displace the
        #    weakest resident only on a STRICT score win (no tie churn).
        #    With a workload score_fn attached, "weakest" and the
        #    candidate ranking use the blended score instead of degree.
        cand = changed[slots < 0]
        cand = cand[(deg[cand] > 0) & (deg[cand] <= self.max_width)]
        if self.exclude_range is not None:
            lo, hi = self.exclude_range
            cand = cand[(cand < lo) | (cand >= hi)]
        if cand.size:
            sc = self._selection_scores(deg)
            key = deg if sc is None else sc
            cand = cand[np.argsort(-key[cand], kind="stable")]
            for v in cand.tolist():
                v = int(v)
                free = np.flatnonzero(self.slot_ids < 0)
                if free.size:
                    s = int(free[0])
                elif sc is None:
                    s = int(np.argmin(self.widths))
                    if int(deg[v]) <= int(self.widths[s]):
                        break  # weakest resident >= best candidate left
                    self._evict(s)
                    touched.append(s)
                else:
                    res_sc = sc[self.slot_ids]  # no free slot: all occupied
                    s = int(np.argmin(res_sc))
                    if float(sc[v]) <= float(res_sc[s]):
                        break  # weakest resident >= best candidate left
                    self._evict(s)
                    touched.append(s)
                rec = obs_cachescope._recorder
                if rec is not None:
                    rec.on_dev_admit(self, v)
                self._write(s, v, self.store.row(v))
                self.stats.admits += 1
                touched.append(s)
        if touched:
            self._sync_device(np.unique(np.asarray(touched, np.int64)))
        return len(set(touched))

    # ---------------- audit ----------------
    def audit(self) -> Tuple[int, int]:
        """(resident_rows, stale_rows): every resident slot compared
        bit-exactly against the authoritative store row, and the device
        buffer and its lengths against the host mirror."""
        occupied = np.flatnonzero(self.slot_ids >= 0)
        stale = 0
        dev = self.rows.cpu().numpy()
        dev_lens = self.lens.cpu().numpy()
        for s in occupied.tolist():
            v = int(self.slot_ids[s])
            w = int(self.widths[s])
            want = self.store.row(v)
            got = self._host[s, :w]
            if want.size != w or not np.array_equal(got, want):
                stale += 1
            elif not np.array_equal(dev[s], self._host[s]):
                stale += 1  # mirror/device divergence is also staleness
            elif dev_lens[s] != w:
                stale += 1  # so is a device length that is not the row's
        return int(occupied.size), stale
