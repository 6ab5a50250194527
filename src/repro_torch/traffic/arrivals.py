"""Open-loop arrival processes and the virtual-time clocks they drive.

A closed-loop harness (submit, wait, repeat) can never observe
queueing: the next request only exists once the previous one finished,
so reported p99 is batch compute time, not waiting time. An *open-loop*
load generator fixes the arrival schedule in advance — requests arrive
when the process says they arrive, whether or not the server has kept
up — which is the only regime where latency-vs-offered-load curves mean
anything (p99 must rise as offered load approaches capacity).

Four arrival processes, all bit-reproducible under one seed:

- ``poisson``  — homogeneous Poisson: i.i.d. exponential interarrivals
  at ``rate`` qps, the memoryless baseline.
- ``diurnal``  — nonhomogeneous Poisson with a sinusoidal rate
  ``rate(t) = base * (1 + amplitude * sin(2*pi*t / period))``, sampled
  by Lewis-Shedler thinning — the day/night envelope of a user-facing
  service, compressed to a benchmark-sized period.
- ``burst``    — a two-state MMPP (Markov-modulated Poisson process):
  exponential-duration quiet/burst phases at ``rate`` / ``burst_rate``,
  the flash-crowd regime admission control exists for.
- ``trace``    — replayable timestamp files (``save``/``load``), so a
  recorded production schedule — or any synthetic one — can be re-run
  bit-exactly across policy changes.

Two clocks make the schedules testable and measurable:

- ``VirtualClock`` — fully manual time. Injected into
  ``MicrobatchScheduler`` it makes every deadline/shed/EDF policy a
  deterministic function of explicit ``advance`` calls (no sleeping in
  tests, no wall-clock noise).
- ``HybridClock`` — virtual floor + real elapsed time:
  ``now() = offset + perf_counter()``. ``advance_to`` raises the floor
  (an idle server skips ahead to the next arrival for free), while real
  compute between calls advances time at true cost — so open-loop
  latency = queueing (virtual) + service (measured), which is exactly
  the decomposition the offered-load curve plots.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np

__all__ = [
    "VirtualClock",
    "HybridClock",
    "ArrivalTrace",
    "poisson_arrivals",
    "diurnal_arrivals",
    "burst_arrivals",
    "make_arrivals",
]

ARRIVALS_SCHEMA = "repro.traffic.arrivals/v1"  # shared with the reference


class VirtualClock:
    """Deterministic manual clock (callable, seconds). Inject as
    ``MicrobatchScheduler(clock=...)`` so deadline behavior is a pure
    function of ``advance``/``advance_to`` calls."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, "time never runs backwards"
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        """Monotone jump: no-op when ``t`` is in the past."""
        self._t = max(self._t, float(t))
        return self._t


class HybridClock:
    """Virtual floor + real elapsed time.

    ``now()`` advances with the process's real clock (so engine compute
    is charged at true cost), while ``advance_to(t)`` lifts the floor
    without waiting (so the gap until the next scheduled arrival is
    free). The open-loop runner uses this to simulate hours of arrival
    schedule in seconds of wall time without distorting service time.
    """

    def __init__(self, *, start: float = 0.0, time_fn=time.perf_counter):
        self._fn = time_fn
        self._offset = float(start) - self._fn()

    def __call__(self) -> float:
        return self._offset + self._fn()

    def now(self) -> float:
        return self()

    def advance_to(self, t: float) -> float:
        now = self()
        if t > now:
            self._offset += float(t) - now
        return self()


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """One arrival schedule: sorted timestamps (seconds from t=0) plus
    the provenance needed to regenerate or gate on it."""

    t: np.ndarray  # [n] float64, nondecreasing
    process: str
    offered_qps: float  # nominal offered load (n / span for traces)
    seed: Optional[int] = None

    def __post_init__(self):
        t = np.asarray(self.t, np.float64)
        assert t.ndim == 1
        assert t.size == 0 or bool(np.all(np.diff(t) >= 0.0)), (
            "arrival timestamps must be sorted"
        )
        object.__setattr__(self, "t", t)

    def __len__(self) -> int:
        return int(self.t.size)

    @property
    def span_s(self) -> float:
        return float(self.t[-1] - self.t[0]) if self.t.size > 1 else 0.0

    @property
    def measured_qps(self) -> float:
        """Empirical rate over the realized span (vs the nominal)."""
        return (self.t.size - 1) / self.span_s if self.span_s > 0 else 0.0

    # ---------------- replayable trace files ----------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "schema": ARRIVALS_SCHEMA,
                    "process": self.process,
                    "offered_qps": self.offered_qps,
                    "seed": self.seed,
                    "t": self.t.tolist(),
                },
                f,
            )

    @staticmethod
    def load(path: str) -> "ArrivalTrace":
        with open(path) as f:
            obj = json.load(f)
        if obj.get("schema") != ARRIVALS_SCHEMA:
            raise ValueError(f"{path}: not an arrival trace "
                             f"({obj.get('schema')!r})")
        return ArrivalTrace(
            t=np.asarray(obj["t"], np.float64),
            process=str(obj["process"]),
            offered_qps=float(obj["offered_qps"]),
            seed=obj.get("seed"),
        )


def _rng(seed) -> np.random.Generator:
    return seed if isinstance(seed, np.random.Generator) else (
        np.random.default_rng(seed)
    )


def poisson_arrivals(n: int, rate_qps: float, *, seed=0,
                     t0: float = 0.0) -> ArrivalTrace:
    """Homogeneous Poisson: n arrivals at ``rate_qps``."""
    assert rate_qps > 0.0
    rng = _rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=int(n))
    return ArrivalTrace(
        t=t0 + np.cumsum(gaps),
        process="poisson",
        offered_qps=float(rate_qps),
        seed=seed if isinstance(seed, int) else None,
    )


def diurnal_arrivals(
    n: int,
    rate_qps: float,
    *,
    period_s: float = 8.0,
    amplitude: float = 0.8,
    seed=0,
    t0: float = 0.0,
) -> ArrivalTrace:
    """Nonhomogeneous Poisson with a sinusoidal day/night envelope,
    sampled by thinning: candidates at the peak rate, each kept with
    probability ``rate(t) / rate_max``."""
    assert rate_qps > 0.0 and 0.0 <= amplitude < 1.0 and period_s > 0.0
    rng = _rng(seed)
    rate_max = rate_qps * (1.0 + amplitude)
    out = np.empty(int(n), np.float64)
    t = float(t0)
    k = 0
    while k < n:
        t += float(rng.exponential(1.0 / rate_max))
        lam = rate_qps * (
            1.0 + amplitude * np.sin(2.0 * np.pi * t / period_s)
        )
        if rng.random() < lam / rate_max:
            out[k] = t
            k += 1
    return ArrivalTrace(
        t=out,
        process="diurnal",
        offered_qps=float(rate_qps),
        seed=seed if isinstance(seed, int) else None,
    )


def burst_arrivals(
    n: int,
    rate_qps: float,
    *,
    burst_rate_qps: Optional[float] = None,
    mean_quiet_s: float = 2.0,
    mean_burst_s: float = 0.5,
    seed=0,
    t0: float = 0.0,
) -> ArrivalTrace:
    """Two-state MMPP: exponential-duration quiet phases at
    ``rate_qps`` alternating with bursts at ``burst_rate_qps``
    (default 8x) — the flash-crowd arrival shape."""
    assert rate_qps > 0.0
    burst = float(burst_rate_qps if burst_rate_qps is not None
                  else 8.0 * rate_qps)
    rng = _rng(seed)
    out = np.empty(int(n), np.float64)
    t = float(t0)
    k = 0
    bursting = False
    phase_end = t + float(rng.exponential(mean_quiet_s))
    while k < n:
        lam = burst if bursting else rate_qps
        t_next = t + float(rng.exponential(1.0 / lam))
        if t_next >= phase_end:
            # phase flips before the candidate lands: resample from the
            # phase boundary at the new rate (memorylessness makes the
            # restart exact, not an approximation)
            t = phase_end
            bursting = not bursting
            phase_end = t + float(
                rng.exponential(mean_burst_s if bursting else mean_quiet_s)
            )
            continue
        t = t_next
        out[k] = t
        k += 1
    return ArrivalTrace(
        t=out,
        process="burst",
        offered_qps=float(rate_qps),
        seed=seed if isinstance(seed, int) else None,
    )


def make_arrivals(process: str, n: int, rate_qps: float, *, seed=0,
                  **kw) -> ArrivalTrace:
    """Dispatcher: ``poisson`` / ``diurnal`` / ``burst`` / a
    ``trace:<path>`` replay file (rate/seed ignored for traces)."""
    if process.startswith("trace:"):
        return ArrivalTrace.load(process[len("trace:"):])
    fns = {
        "poisson": poisson_arrivals,
        "diurnal": diurnal_arrivals,
        "burst": burst_arrivals,
    }
    if process not in fns:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(want {sorted(fns)} or trace:<path>)")
    return fns[process](n, rate_qps, seed=seed, **kw)
