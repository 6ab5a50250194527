"""Online repartitioning: bounded ownership migration under drift.

The streaming engines mutate the degree sequence (hub churn under
``rmat_adversarial_stream`` is the adversarial case), so the cuts a
``HubPartition`` was built with slowly stop balancing. This module
plans *bounded* boundary moves back toward the degree-weighted balance
point and lets ``ShardedRuntime.migrate`` apply them live:

- ``plan_repartition`` compares the current cuts against freshly
  balanced cuts for the live degree sequence and shifts each boundary
  at most ``max_moves`` rows toward its target (monotonicity is
  enforced, so blocks never invert);
- ``Rebalancer`` watches the runtime's per-rank read counters (the
  same data the ``load_imbalance`` gauge summarizes) and triggers a
  plan only when imbalance crosses ``trigger``, with hysteresis and a
  cooldown so a single hot batch cannot thrash ownership back and
  forth.

Migration itself (cache invalidation fanout, device-residency handoff,
schedule rebuild) lives in ``ShardedRuntime.migrate``; the planner is
pure and side-effect free so tests can exercise it in isolation. See
docs/partitioning.md for the full protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .partition import HubPartition, balanced_cuts

__all__ = ["MigrationPlan", "plan_repartition", "Rebalancer"]


@dataclasses.dataclass
class MigrationPlan:
    """A bounded cut move: apply with ``runtime.migrate(plan.new_cuts)``."""

    old_cuts: np.ndarray
    new_cuts: np.ndarray
    moved: np.ndarray  # vertex ids whose owner changes

    @property
    def n_moved(self) -> int:
        return int(self.moved.size)


def _moved_ids(old_cuts: np.ndarray, new_cuts: np.ndarray) -> np.ndarray:
    """Vertex ids whose owner differs between two cut vectors — the
    union of the half-open ranges each boundary swept over."""
    ids = []
    for k in range(1, len(old_cuts) - 1):
        a, b = int(old_cuts[k]), int(new_cuts[k])
        if a != b:
            ids.append(np.arange(min(a, b), max(a, b), dtype=np.int64))
    if not ids:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(ids))


def plan_repartition(
    part: HubPartition,
    degrees: np.ndarray,
    *,
    max_moves: int = 4096,
) -> Optional[MigrationPlan]:
    """Plan a bounded step from ``part.cuts`` toward the balanced cuts
    for the *current* degree sequence. Returns None when already at the
    target. Each interior boundary moves at most ``max_moves`` rows;
    repeated calls converge to the full rebalance."""
    degrees = np.asarray(degrees, np.int64)
    assert degrees.size == part.n, (degrees.size, part.n)
    weights = 1 + np.minimum(degrees, part.threshold)
    target = balanced_cuts(weights, part.p)
    old = part.cuts.astype(np.int64).copy()
    shift = np.clip(target - old, -int(max_moves), int(max_moves))
    new = old + shift
    new[0], new[-1] = 0, part.n
    new = np.maximum.accumulate(np.clip(new, 0, part.n))
    moved = _moved_ids(old, new)
    if moved.size == 0:
        return None
    return MigrationPlan(old_cuts=old, new_cuts=new, moved=moved)


class Rebalancer:
    """Gauge-driven migration trigger with hysteresis.

    Reads the runtime's per-rank ``local_reads + remote_reads`` deltas
    since the last check (the instantaneous form of the
    ``load_imbalance`` gauge), and fires ``plan_repartition`` +
    ``runtime.migrate`` only when the windowed imbalance exceeds
    ``trigger``. After a migration the trigger arms again only once
    ``cooldown`` checks have passed — ownership moves are bounded AND
    rate-limited. Call ``maybe_rebalance`` between batches only: the
    runtime is single-writer and migration mid-batch would tear the
    measured-vs-modeled reconciliation.
    """

    def __init__(
        self,
        runtime,
        *,
        trigger: float = 1.25,
        max_moves: int = 4096,
        cooldown: int = 2,
        hub_threshold: Optional[int] = None,
        refresh: bool = True,
        reads=None,
    ):
        self.runtime = runtime
        self.trigger = float(trigger)
        self.max_moves = int(max_moves)
        self.cooldown = int(cooldown)
        # reads: optional zero-arg callable returning the per-rank
        # cumulative load counters to window over. Default is the
        # runtime's provider read stats (the serving load gauge); the
        # streaming launcher passes the sharded-worklist pair counts
        # instead, since its delta replay does not flow through
        # fetch_rows.
        self._reads_fn = reads
        # refresh=True re-derives the hub set from the live degrees
        # before each planned migration (hub_threshold=None recomputes
        # the default threshold too) — required when the partition was
        # built against an empty store (stream_run) and the heavy tail
        # only emerges as the stream applies.
        self.hub_threshold = hub_threshold
        self.refresh = bool(refresh)
        self._cool = 0
        self._last_reads = self._reads()
        self.migrations = 0
        self.rows_moved = 0

    def _reads(self) -> np.ndarray:
        if self._reads_fn is not None:
            return np.asarray(self._reads_fn(), np.float64).copy()
        return np.array(
            [st.local_reads + st.remote_reads for st in self.runtime.stats],
            np.float64,
        )

    def window_imbalance(self) -> float:
        """max/mean of per-rank reads since the previous check (1.0 is
        perfectly balanced; ranks with no reads contribute 0)."""
        now = self._reads()
        delta = now - self._last_reads
        self._last_reads = now
        mean = float(delta.mean())
        if mean <= 0:
            return 1.0
        return float(delta.max()) / mean

    def maybe_rebalance(self, degrees: np.ndarray) -> Optional[MigrationPlan]:
        """Check the gauge; migrate if it crossed the trigger. Returns
        the applied plan (or None). Safe to call every batch."""
        imb = self.window_imbalance()
        if self._cool > 0:
            self._cool -= 1
            return None
        part = self.runtime.part
        if not isinstance(part, HubPartition):
            return None
        if imb <= self.trigger:
            return None
        if self.refresh:
            part.refresh_hubs(degrees, threshold=self.hub_threshold)
        plan = plan_repartition(part, degrees, max_moves=self.max_moves)
        if plan is None:
            return None
        self.runtime.migrate(plan.new_cuts)
        self.migrations += 1
        self.rows_moved += plan.n_moved
        self._cool = self.cooldown
        return plan
