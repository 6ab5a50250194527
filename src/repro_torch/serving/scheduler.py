"""Microbatching scheduler: coalesce concurrent queries into one batch.

Point queries arrive one at a time but are cheapest answered together:
a batch shares row fetches (the provider is called once per distinct
vertex per batch), shares pair intersections (canonical dedup across
queries), and amortizes kernel/vectorization overhead over the whole
padded batch. The scheduler

- queues submitted queries with their arrival timestamp,
- drains them in windows of at most ``max_batch`` through
  ``QueryEngine.execute_batch``, and
- stamps each result with its submit-to-completion latency, feeding the
  p50/p99 ``LatencyRecorder``.

Two drain policies coexist:

- ``flush()`` — the closed-loop drain: empty the whole queue now
  (callers that own the loop, e.g. the launchers and benchmarks).
- ``poll()`` — deadline-aware batching for open-loop serving: a window
  dispatches when it is *full* (``max_batch``), when the **oldest
  pending query has waited ``max_wait`` seconds** (the latency deadline
  — without it a trickle of requests would wait forever for a full
  window), when an **SLO deadline is imminent** (an ``SLOPolicy``
  stamps each query ``t_submit + budget(class)``; the window goes out
  ``headroom_s`` before the most urgent one), or when an **urgent**
  query is pending (priority flush: ``submit(q, urgent=True)``).
  Otherwise ``poll`` returns nothing and requests keep coalescing.

**EDF window selection** — with an SLO policy attached, each window
takes the ``max_batch`` pending queries with the *earliest deadlines*
(stable on submit time), not the oldest submissions: a late-arriving
tight-deadline query jumps a queue of loose-deadline ones. Without a
policy, FIFO order is unchanged.

**Admission control / load shedding** — an overloaded open-loop service
must reject work it cannot serve in time, or every queued query's
latency collapses together:

- ``quotas`` (a ``TenantQuotas``) rate-limits per tenant at submit:
  an empty token bucket sheds with reason ``"quota"`` before the query
  can occupy queue depth;
- ``max_queue`` bounds the pending depth: a submit past it is rejected
  immediately (``submit`` returns False, reason ``"depth"``);
- ``shed_wait`` bounds staleness at dispatch: ``poll()`` drops pending
  queries that have already waited past it (reason ``"deadline"``);
- with an SLO policy, a query whose *class* deadline has strictly
  passed is shed with reason ``"slo"`` — under overload, tight-budget
  classes shed first, which is the policy expressing itself.

All four feed the ``shed``/``shed_rate`` counters (and per-class
``shed_by_class``) in the latency summary.

``max_batch=1`` degenerates to one-query-at-a-time serving — the
baseline the serving benchmark compares against. The clock is
injectable so deadline behavior is testable without sleeping, and
``submit(q, at=...)`` lets an open-loop generator stamp the query with
its schedule arrival time even when the submit call itself runs late
(backlogged server) — that difference IS the queueing delay.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

from ..obs import trace as obs_trace
from .engine import QueryEngine
from .metrics import LatencyRecorder, LatencySummary
from .requests import Query, QueryResult

__all__ = ["MicrobatchScheduler"]


def _slo_class(q: Query) -> str:
    """Latency class label for per-SLO breakdowns (the query kind)."""
    return q.kind.name.lower()


@dataclasses.dataclass
class _Pending:
    """One queued query with its admission-time metadata."""

    query: Query
    t_submit: float
    urgent: bool = False
    deadline: Optional[float] = None  # absolute SLO deadline (None: no SLO)


class MicrobatchScheduler:
    def __init__(
        self,
        engine: QueryEngine,
        *,
        max_batch: int = 64,
        max_wait: Optional[float] = None,
        max_queue: Optional[int] = None,
        shed_wait: Optional[float] = None,
        clock: Optional[Callable[[], float]] = None,
        slo=None,  # Optional[traffic.SLOPolicy]
        quotas=None,  # Optional[traffic.TenantQuotas]
    ):
        assert max_batch >= 1
        assert max_wait is None or max_wait >= 0.0
        assert max_queue is None or max_queue >= 1
        assert shed_wait is None or shed_wait >= 0.0
        if shed_wait is not None and max_wait is not None:
            # strict: _shed_stale runs before the due check with >=
            # comparisons, so equality would shed exactly the queries
            # the deadline flush exists to serve
            assert shed_wait > max_wait, (
                "shed_wait must exceed max_wait, or queries the "
                "deadline drain promises to serve get shed instead"
            )
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait = max_wait
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_wait = shed_wait
        self.slo = slo
        self.quotas = quotas
        self._clock = clock or time.perf_counter
        self._pending: List[_Pending] = []
        self._n_urgent = 0
        self.recorder = LatencyRecorder()
        self.n_batches = 0
        self.n_deadline_flushes = 0
        self.n_priority_flushes = 0
        self.n_slo_flushes = 0
        self.n_shed_depth = 0
        self.n_shed_deadline = 0
        self.n_shed_slo = 0
        self.n_shed_quota = 0

    # ---------------- request path ----------------
    def _admit(self, query: Query, t: float, urgent: bool) -> bool:
        """Shared admission path: quota, then depth, then enqueue."""
        cls = _slo_class(query)
        if self.quotas is not None and query.tenant:
            if not self.quotas.admit(query.tenant, t):
                self.n_shed_quota += 1
                self.recorder.record_shed("quota", cls=cls)
                return False
        if self.max_queue is not None and len(self._pending) >= self.max_queue:
            self.n_shed_depth += 1
            self.recorder.record_shed("depth", cls=cls)
            return False
        deadline = self.slo.deadline(cls, t) if self.slo is not None else None
        self._pending.append(_Pending(query, t, bool(urgent), deadline))
        if urgent:
            self._n_urgent += 1
        return True

    def submit(self, query: Query, *, urgent: bool = False,
               at: Optional[float] = None) -> bool:
        """Queue one query. Returns False (and records a shed with the
        rejecting reason: ``"quota"`` for an exhausted tenant bucket,
        ``"depth"`` for a full queue) when admission fails — the
        caller's signal to back off or retry elsewhere.

        ``at`` stamps the query's *arrival* time (open-loop generators
        replaying a schedule); default is the clock's now.
        """
        t = self._clock() if at is None else float(at)
        return self._admit(query, t, urgent)

    def submit_many(self, queries: Sequence[Query]) -> int:
        """Queue many at one timestamp; returns how many were admitted
        (the rest shed, by reason)."""
        t = self._clock()
        return sum(1 for q in queries if self._admit(q, t, False))

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ---------------- drain policies ----------------
    def _due(self, now: float) -> Optional[str]:
        """Why the front window should dispatch now (None: keep waiting)."""
        if not self._pending:
            return None
        if len(self._pending) >= self.max_batch:
            return "full"
        if self._n_urgent:
            return "urgent"
        if self.slo is not None:
            dmin = min(p.deadline for p in self._pending)
            if now >= dmin - self.slo.headroom_s:
                return "slo"
        if self.max_wait is not None and (
            now - self._pending[0].t_submit >= self.max_wait
        ):
            return "deadline"
        return None

    def next_due_at(self) -> Optional[float]:
        """Earliest future time at which the queue becomes due, or None
        when no time-based trigger exists (queue empty, or neither
        ``max_wait`` nor an SLO policy is set). Open-loop drains advance
        a virtual clock to this point instead of busy-waiting."""
        if not self._pending:
            return None
        if len(self._pending) >= self.max_batch or self._n_urgent:
            return self._clock()
        cands = []
        if self.slo is not None:
            cands.append(min(p.deadline for p in self._pending)
                         - self.slo.headroom_s)
        if self.max_wait is not None:
            cands.append(self._pending[0].t_submit + self.max_wait)
        return min(cands) if cands else None

    def _peek_window(self) -> List[_Pending]:
        """Select (without removing) the next window. FIFO without an
        SLO policy; EDF (earliest absolute deadline, stable on submit
        order) with one — a full queue serves the most urgent work
        first. Selection previews so an engine error leaves the window
        queued (visible, retryable), not silently dropped; ``_remove``
        commits after success."""
        if self.slo is None or len(self._pending) <= 1:
            return self._pending[: self.max_batch]
        order = sorted(range(len(self._pending)),
                       key=lambda i: (self._pending[i].deadline, i))
        return [self._pending[i] for i in sorted(order[: self.max_batch])]

    def _record_results(self, chunk: List[_Pending], results, t0, t1):
        self.recorder.record_wall(t1 - t0)
        self.n_batches += 1
        for p, r in zip(chunk, results):
            r.latency_s = t1 - p.t_submit
            self.recorder.record(
                r.latency_s, cls=_slo_class(p.query),
                deadline_s=(None if p.deadline is None
                            else p.deadline - p.t_submit),
            )
        obs_trace.counter("queue_depth", len(self._pending))

    def _drain_window(self) -> List[QueryResult]:
        chunk = self._peek_window()
        t0 = self._clock()
        with obs_trace.span("scheduler_flush", cat="serving",
                            n=len(chunk)):
            results = self.engine.execute_batch([p.query for p in chunk])
        t1 = self._clock()
        self._remove(chunk)
        self._record_results(chunk, results, t0, t1)
        return results

    def _remove(self, chunk: List[_Pending]) -> None:
        taken = set(map(id, chunk))
        self._pending = [p for p in self._pending if id(p) not in taken]
        self._n_urgent -= sum(1 for p in chunk if p.urgent)

    def flush(self) -> List[QueryResult]:
        """Drain the queue in ``max_batch`` windows; returns all results
        in dispatch order (submission order without an SLO policy, EDF
        order with one). When the engine is a pipelined SPMD engine
        (``engine.pipeline``), the host pack + collective launch of
        window k+1 overlaps window k's in-flight device intersect —
        ``end_batch`` is the only device sync (the trace's
        ``spmd_overlap_wait``). The control plane stays sequential
        host-side, so pipelined and unpipelined drains are bit-exact."""
        if getattr(self.engine, "pipeline", False):
            return self._flush_pipelined()
        out: List[QueryResult] = []
        while self._pending:
            out.extend(self._drain_window())
        return out

    # ---------------- pipelined drain ----------------
    def _begin_window(self) -> tuple:
        """Dispatch the front window without waiting on the device.
        The ``scheduler_flush`` span covers only the host-side begin —
        keeping spans disjoint per lane (the wait is its own span), so
        the exported trace stays well-nested under overlap."""
        chunk = self._peek_window()
        t0 = self._clock()
        with obs_trace.span("scheduler_flush", cat="serving",
                            n=len(chunk), pipelined=True):
            inflight = self.engine.begin_batch([p.query for p in chunk])
        # the control plane (cache admission, serve matrix, the
        # measured-vs-modeled reconciliation) completed inside
        # begin_batch — the chunk is committed; only device counts
        # remain outstanding. A begin error leaves the chunk queued.
        self._remove(chunk)
        return chunk, inflight, t0

    def _finish_window(self, chunk, inflight, t0) -> List[QueryResult]:
        results = self.engine.end_batch(inflight)
        t1 = self._clock()
        self._record_results(chunk, results, t0, t1)
        return results

    def _flush_pipelined(self) -> List[QueryResult]:
        """Double-buffered drain: begin window k+1 before finishing
        window k, so at most one microbatch is in flight on device
        while the next one packs on host."""
        out: List[QueryResult] = []
        prev = None
        while self._pending or prev is not None:
            nxt = self._begin_window() if self._pending else None
            if prev is not None:
                out.extend(self._finish_window(*prev))
            prev = nxt
        return out

    def _shed_stale(self, now: float) -> None:
        """Drop pending queries that can no longer be served usefully:
        past ``shed_wait`` (reason ``"deadline"``) or, with an SLO
        policy, strictly past their class deadline (reason ``"slo"`` —
        strict, so a query AT its deadline still rides the flush that
        the ``"slo"`` due-reason triggers for it)."""
        if (self.shed_wait is None and self.slo is None) or not self._pending:
            return
        keep: List[_Pending] = []
        for p in self._pending:
            if self.shed_wait is not None and now - p.t_submit >= self.shed_wait:
                reason = "deadline"
                self.n_shed_deadline += 1
            elif p.deadline is not None and now > p.deadline:
                reason = "slo"
                self.n_shed_slo += 1
            else:
                keep.append(p)
                continue
            self.recorder.record_shed(reason, cls=_slo_class(p.query))
            if p.urgent:
                self._n_urgent -= 1
        if len(keep) != len(self._pending):
            self._pending = keep

    def poll(self) -> List[QueryResult]:
        """Deadline-aware drain with load shedding: dispatch windows
        only while one is due (full / urgent pending / an SLO deadline
        within headroom / oldest past ``max_wait``); queries already
        stale past ``shed_wait`` or their class deadline are
        rejected-with-reason instead of served; otherwise return
        nothing and let requests keep coalescing."""
        out: List[QueryResult] = []
        while True:
            now = self._clock()
            self._shed_stale(now)
            reason = self._due(now)
            if reason is None:
                return out
            if reason == "deadline":
                self.n_deadline_flushes += 1
            elif reason == "urgent":
                self.n_priority_flushes += 1
            elif reason == "slo":
                self.n_slo_flushes += 1
            out.extend(self._drain_window())

    def run(self, queries: Sequence[Query]) -> List[QueryResult]:
        """Closed-loop convenience: submit all, drain to completion."""
        self.submit_many(queries)
        return self.flush()

    def latency_summary(self) -> LatencySummary:
        return self.recorder.summary()
