"""Open-loop load generator: drive the scheduler from an arrival trace.

The runner walks a fixed ``ArrivalTrace``: for each arrival it lifts
the clock's virtual floor to the arrival time, submits the query
stamped with that arrival (``submit(q, at=t)``), and polls the
scheduler — which dispatches whatever its deadline/SLO policy says is
due. Crucially the schedule never waits for the server: if a batch's
real service time overruns the next arrival, that query is submitted
*late relative to its own arrival stamp*, and the backlog shows up as
queueing delay in the measured latency. That is the open-loop property
the latency-vs-offered-load curve needs — under saturation, p99 grows
with queue depth instead of flattening at batch compute time.

With a ``HybridClock`` the idle gaps between arrivals are free (the
floor jumps) while engine compute advances time at true cost; with a
``VirtualClock`` plus a caller-managed service model the whole run is
deterministic (tests). After the last arrival the runner drains the
queue by advancing time to each next-due deadline — shedding still
applies, so queries that were doomed at drain time are shed, not
quietly served.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .arrivals import ArrivalTrace, HybridClock

__all__ = ["OpenLoopReport", "run_open_loop"]


@dataclasses.dataclass
class OpenLoopReport:
    """One open-loop run: offered vs achieved load + the scheduler's
    latency summary (queueing included)."""

    process: str
    offered_qps: float
    n_arrivals: int
    n_admitted: int
    n_served: int
    duration_s: float
    summary: object  # LatencySummary
    by_class: Dict[str, object]
    results: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def achieved_qps(self) -> float:
        return self.n_served / self.duration_s if self.duration_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "process": self.process,
            "offered_qps": round(self.offered_qps, 3),
            "achieved_qps": round(self.achieved_qps, 3),
            "n_arrivals": self.n_arrivals,
            "n_admitted": self.n_admitted,
            "n_served": self.n_served,
            "duration_s": round(self.duration_s, 4),
            "latency": self.summary.as_dict(),
            "by_class": {c: s.as_dict() for c, s in self.by_class.items()},
        }


def run_open_loop(
    scheduler,
    queries: Sequence,
    arrivals: ArrivalTrace,
    *,
    clock: Optional[object] = None,
    keep_results: bool = True,
) -> OpenLoopReport:
    """Replay ``queries[i]`` at ``arrivals.t[i]`` through ``scheduler``.

    ``clock`` must be the same object the scheduler reads (pass it to
    both); defaults to a fresh ``HybridClock`` ONLY if the scheduler
    was built with one via ``scheduler._clock`` — otherwise arrival
    stamps and the scheduler's notion of now would disagree.
    """
    n = min(len(queries), len(arrivals))
    assert n > 0, "empty run"
    clock = clock if clock is not None else scheduler._clock
    assert clock is scheduler._clock or isinstance(clock, HybridClock), (
        "loadgen and scheduler must share one clock"
    )
    # The trace is relative: shift it forward so the first arrival is
    # never before "now" (a HybridClock has been running through setup;
    # backdating arrivals into that dead time would charge queueing
    # delay nothing ever queued for). Under a fresh VirtualClock the
    # shift is zero and runs stay bit-deterministic.
    shift = max(0.0, float(clock()) - float(arrivals.t[0]))
    results: List = []
    t_start = float(arrivals.t[0]) + shift
    admitted = 0
    def _fire_timers_until(t_next: float) -> None:
        # A real server's flush timer fires between arrivals; polling
        # only at arrival instants would let deadlines expire in the
        # gaps (shed where a dispatch was promised). Advance to each
        # due time that falls before the next arrival and poll there.
        prev_due = -float("inf")
        while scheduler.pending:
            due_at = scheduler.next_due_at()
            if due_at is None or due_at >= t_next:
                return
            if due_at <= prev_due:  # no forward progress: livelock guard
                return
            prev_due = due_at
            clock.advance_to(due_at)
            results.extend(scheduler.poll())

    for i in range(n):
        t_arr = float(arrivals.t[i]) + shift
        _fire_timers_until(t_arr)
        clock.advance_to(t_arr)
        if scheduler.submit(queries[i], at=t_arr):
            admitted += 1
        results.extend(scheduler.poll())

    # Drain: advance time to each next dispatch deadline until the
    # queue empties. Shed policies keep applying — a query that is
    # already past shed_wait at drain time is dropped, as it would be
    # in steady state.
    while scheduler.pending:
        out = scheduler.poll()
        if out:
            results.extend(out)
            continue
        due_at = scheduler.next_due_at()
        if due_at is None or not hasattr(clock, "advance_to"):
            # no deadline machinery to wait for: close out the queue
            results.extend(scheduler.flush())
            break
        clock.advance_to(max(due_at, clock() + 1e-9))

    duration = max(float(clock()) - t_start, 0.0)
    return OpenLoopReport(
        process=arrivals.process,
        offered_qps=arrivals.offered_qps,
        n_arrivals=n,
        n_admitted=admitted,
        n_served=len(results),
        duration_s=duration,
        summary=scheduler.latency_summary(),
        by_class=scheduler.recorder.summary_by_class(),
        results=results if keep_results else [],
    )
