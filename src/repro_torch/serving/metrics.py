"""Latency/throughput/shed accounting for the query service.

Percentiles use the 'lower' interpolation so a reported p99 is an
actually-observed latency, not an average of two observations.

Shed accounting backs the admission-control policy: a bounded queue
rejects work it cannot serve in time instead of letting every queued
query's latency collapse. ``shed_rate`` = shed / (served + shed) — the
fraction of offered load turned away, by reason.

Latencies can carry an optional class label (``cls``, e.g. the query
kind: ``"lcc"``/``"triangles"``/``"common_neighbors"``/``"top_k_lcc"``)
so per-SLO-class breakdowns are possible: ``summary_by_class()``
returns one ``LatencySummary`` per class (wall clock is shared across
classes, so per-class summaries report percentiles and shed counts but
no throughput), and the top-level summary carries ``shed_by_class`` /
``shed_rate_by_class``.

With an SLO policy active, each served latency can carry its class
deadline budget (``deadline_s``): ``slo_violations`` counts queries
served *late* (beyond budget — distinct from shed, which never served),
and ``slo_hit_rate`` = on-time / (served + shed): the fraction of
admitted-or-offered work that met its promise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LatencySummary", "LatencyRecorder"]


@dataclasses.dataclass
class LatencySummary:
    count: int
    wall_s: float
    throughput_qps: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    max_ms: float
    shed: int = 0
    shed_rate: float = 0.0
    shed_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    shed_rate_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    slo_violations: int = 0
    slo_hit_rate: float = 1.0

    def as_dict(self) -> dict:
        out = {}
        for k, v in dataclasses.asdict(self).items():
            if isinstance(v, float):
                out[k] = round(v, 4)
            elif isinstance(v, dict):
                out[k] = {c: (round(x, 4) if isinstance(x, float) else x)
                          for c, x in sorted(v.items())}
            else:
                out[k] = v
        return out


def _summarize(lat: np.ndarray, wall_s: float, shed: int,
               shed_by_class: Optional[Dict[str, int]] = None,
               served_by_class: Optional[Dict[str, int]] = None,
               slo_violations: int = 0) -> LatencySummary:
    served = int(lat.size)
    rate = shed / (served + shed) if (served + shed) else 0.0
    shed_by_class = dict(shed_by_class or {})
    shed_rate_by_class = {}
    for c, n in shed_by_class.items():
        off = n + (served_by_class or {}).get(c, 0)
        shed_rate_by_class[c] = n / off if off else 0.0
    on_time = served - int(slo_violations)
    slo_hit = on_time / (served + shed) if (served + shed) else 1.0
    if served == 0:
        return LatencySummary(
            0, wall_s, 0.0, 0.0, 0.0, 0.0, 0.0, shed, rate,
            shed_by_class, shed_rate_by_class, int(slo_violations), slo_hit,
        )
    p50, p90, p99 = np.percentile(lat, [50, 90, 99], method="lower")
    return LatencySummary(
        count=served,
        wall_s=wall_s,
        # no measured wall => no throughput claim (a tiny guard
        # denominator would report ~1e12 qps instead of "unknown")
        throughput_qps=served / wall_s if wall_s > 0 else 0.0,
        p50_ms=float(p50) * 1e3,
        p90_ms=float(p90) * 1e3,
        p99_ms=float(p99) * 1e3,
        max_ms=float(lat.max()) * 1e3,
        shed=shed,
        shed_rate=rate,
        shed_by_class=shed_by_class,
        shed_rate_by_class=shed_rate_by_class,
        slo_violations=int(slo_violations),
        slo_hit_rate=slo_hit,
    )


class LatencyRecorder:
    def __init__(self):
        self._lat: List[float] = []
        self._cls_lat: Dict[str, List[float]] = {}
        self.wall_s = 0.0
        self.sheds: Dict[str, int] = {}  # reason -> queries rejected
        self._cls_sheds: Dict[str, int] = {}  # class -> queries rejected
        self.slo_violations = 0  # served late (beyond class budget)
        self._cls_violations: Dict[str, int] = {}

    def record(self, latency_s: float, cls: Optional[str] = None,
               deadline_s: Optional[float] = None) -> None:
        """One served latency. ``deadline_s`` is the query's SLO budget
        (submit-relative); a latency beyond it counts as a violation —
        served, but late."""
        self._lat.append(float(latency_s))
        if cls is not None:
            self._cls_lat.setdefault(str(cls), []).append(float(latency_s))
        if deadline_s is not None and latency_s > deadline_s:
            self.slo_violations += 1
            if cls is not None:
                c = str(cls)
                self._cls_violations[c] = self._cls_violations.get(c, 0) + 1

    def record_wall(self, seconds: float) -> None:
        self.wall_s += float(seconds)

    def record_shed(self, reason: str, n: int = 1,
                    cls: Optional[str] = None) -> None:
        self.sheds[reason] = self.sheds.get(reason, 0) + int(n)
        if cls is not None:
            cls = str(cls)
            self._cls_sheds[cls] = self._cls_sheds.get(cls, 0) + int(n)

    @property
    def count(self) -> int:
        return len(self._lat)

    @property
    def n_shed(self) -> int:
        return sum(self.sheds.values())

    def classes(self) -> List[str]:
        return sorted(set(self._cls_lat) | set(self._cls_sheds))

    def by_class(self) -> Dict[str, List[float]]:
        """Raw per-class latency observations (obs adapters read this)."""
        return {c: list(v) for c, v in self._cls_lat.items()}

    def summary(self) -> LatencySummary:
        lat = np.asarray(self._lat, np.float64)
        served_by_class = {c: len(v) for c, v in self._cls_lat.items()}
        return _summarize(lat, self.wall_s, self.n_shed,
                          shed_by_class=self._cls_sheds,
                          served_by_class=served_by_class,
                          slo_violations=self.slo_violations)

    def summary_by_class(self) -> Dict[str, LatencySummary]:
        """One summary per SLO class. wall_s/throughput are 0: the wall
        clock is shared across classes and not attributable to one."""
        return {
            c: _summarize(
                np.asarray(self._cls_lat.get(c, []), np.float64),
                0.0,
                self._cls_sheds.get(c, 0),
                slo_violations=self._cls_violations.get(c, 0),
            )
            for c in self.classes()
        }
