"""Per-class latency SLOs for the query service.

Every query carries an SLO class — its ``QueryKind`` name
(``lcc`` / ``triangles`` / ``common_neighbors`` / ``top_k_lcc``) — and
every class has a deadline: the submit-to-completion budget the service
promises. The scheduler turns the policy into behavior:

- **absolute deadlines** — each admitted query is stamped
  ``deadline = t_submit + budget(class)``;
- **EDF window selection** — when a window dispatches, pending queries
  are taken in earliest-deadline-first order (stable on submit time),
  so a late-arriving tight-deadline query jumps a queue of loose ones;
- **deadline-driven flush** — a window becomes due ``headroom_s``
  before its most urgent deadline, instead of waiting out ``max_wait``;
- **shed-by-class** — a query whose deadline has strictly passed is
  rejected with reason ``"slo"`` (and counted against its class in
  ``LatencySummary.shed_by_class``) rather than served late: under
  overload the classes with tight budgets shed first, which is the
  policy's whole point.

Deadlines compose with, not replace, the scheduler's existing
``max_wait``/``shed_wait`` machinery — those bound *any* query's wait;
the SLO bounds each class's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

__all__ = ["SLOPolicy", "DEFAULT_DEADLINES_S"]

# Per-class submit-to-completion budgets (seconds). Pair lookups
# (common_neighbors) are the interactive tier; single-vertex counts sit
# in the middle; top-k is an analytics scan that tolerates batching.
DEFAULT_DEADLINES_S: Dict[str, float] = {
    "common_neighbors": 0.050,
    "lcc": 0.100,
    "triangles": 0.100,
    "top_k_lcc": 0.500,
}


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Immutable deadline table + dispatch headroom.

    ``headroom_s`` is how far *before* the most urgent pending deadline
    the scheduler starts a window — the dispatch margin covering batch
    service time. 0 means "dispatch exactly at the deadline", which
    only meets the SLO if service were instantaneous; size it to a
    typical window's service time.
    """

    deadline_s: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_DEADLINES_S)
    )
    default_deadline_s: float = 0.250
    headroom_s: float = 0.0

    def __post_init__(self):
        assert self.default_deadline_s > 0.0
        assert self.headroom_s >= 0.0
        assert all(v > 0.0 for v in self.deadline_s.values())

    def budget(self, cls: str) -> float:
        """Latency budget (seconds) for an SLO class."""
        return float(self.deadline_s.get(cls, self.default_deadline_s))

    def deadline(self, cls: str, t_submit: float) -> float:
        """Absolute completion deadline for a query of ``cls``
        submitted at ``t_submit``."""
        return t_submit + self.budget(cls)

    def scaled(self, factor: float) -> "SLOPolicy":
        """Uniformly loosened/tightened copy (benchmark sweeps)."""
        assert factor > 0.0
        return SLOPolicy(
            deadline_s={k: v * factor for k, v in self.deadline_s.items()},
            default_deadline_s=self.default_deadline_s * factor,
            headroom_s=self.headroom_s,
        )
