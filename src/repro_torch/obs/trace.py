"""Near-zero-overhead span tracer with a Chrome-trace-event exporter, and
the one source of the port's ``torch.profiler`` ranges.

The paper's headline numbers are *attribution* claims — caching cuts
total running time by up to 73%, and communication vs. computation
decomposes per rank. Reproducing those breakdowns needs a time
dimension on top of the counter ledgers: which phase (``fetch_rows``,
``all_to_all``, ``lcc.round``, ...) spent the wall clock, on which rank,
inside which enclosing unit of work.

Design constraints, in order:

1. **Disabled is the default and must cost ~nothing.** ``span()`` with
   no tracer installed and no profiler recording is one module-global
   load, a ``None`` check, one read of the profiler's flag and a shared
   no-op context manager — no allocation, no clock read. The serving
   benchmark measures this (< 3% of end-to-end wall is the gate; in
   practice it is orders of magnitude below that).
2. **The profiler sees every span.** While ``torch.profiler`` records,
   ``span()`` also opens a profiler range of the same name, on the
   profiler's clock, with or without an installed ``Tracer``: the device
   trace then shows which phase of the program the host was in during
   each gap of the device. The range is ``_RecordFunctionFast`` (2.2 µs
   a span on an H100 machine's host, torch 2.11), never
   ``record_function`` (13.3 µs there, and 10.2 µs even with the
   profiler off). Both that class and the flag
   (``torch.autograd.profiler._is_profiler_enabled``) are private; if
   either is missing from the installed torch, no range is opened.
3. **Spans are nestable and per-rank.** Rank maps to the Chrome trace
   ``tid``, so Perfetto renders one swim-lane per rank; nesting follows
   ``with`` scoping, which makes the exported span tree well-nested by
   construction (the validator checks it anyway). Profiler ranges nest
   the same way, on the calling thread.
4. **The export is a standard Chrome trace** (``{"traceEvents": [...]}``
   with ``ph: "X"`` complete events, microsecond timestamps of the
   host's ``perf_counter``): open it at https://ui.perfetto.dev or
   ``chrome://tracing`` unmodified.

Taxonomy (the phase names instrumentation uses):

    fetch_rows        rank-indexed row transport (``ShardedRuntime``)
    all_to_all        the SPMD collective + fused on-device intersect
    intersect_kernel  pair-intersection compute (serving, streaming, SPMD)
    cache_admit       ClampiCache admission   (fine mode, instant)
    cache_evict       ClampiCache eviction    (fine mode, instant)
    cache_invalidate  coherence fanout through the runtime
    residency_patch   device-tier patch/evict/admit after a batch
    scheduler_flush   one microbatch drained through the engine
    delta_replay      coherence replay of a delta access stream
    stream_batch      one applied streaming update batch
    spmd_pack         host-side packing of one SPMD execution unit
    spmd_patch        resident-buffer drift patched to device (H2D)
    spmd_overlap_wait the reconciliation barrier of a pipelined unit

The static LCC epoch (``core/async_engine.py::lcc_pipelined``):

    lcc.epoch         one whole call; args ``rounds``, ``method``,
                      ``route``, ``landed_ids``, ``landed_bytes``,
                      ``row_store_bytes``, on the kernels' route
                      ``bitmap_slot_share`` and ``heavy_slot_share`` and,
                      on a CUDA device with a tracer, ``device_ms``
    lcc.index         ``epoch_index``, the accumulators and landing
                      buffers, round 0's landing
    lcc.round         one round's landing and count (arg ``r``)
    lcc.scores        Eq. 2 from the accumulated counts
    lcc.to_host       ``t`` and ``lcc`` copied back to the host

Its set-up, once a graph:

    csr.from_edges    the edge list deduplicated into a CSR graph
    cache.build       the static degree cache's residents chosen
    schedule.build    ``build_sharded_problem``, with the children
    schedule.rows       the ragged store of local rows and the padded cache
                        rows; args ``ids`` (stored) and
                        ``padded_ids_not_allocated``
    schedule.requests   the per-edge pass: local, cached or pulled
    schedule.serve      the serve lists
    schedule.finalize   the combined row indices
    schedule.upload   ``ShardedLCCProblem.to_device``; arg
                      ``row_store_bytes``
    clampi_sim        ``simulate_rma_lcc``: the CLaMPI cache simulation

Fine mode (``enable_tracing(fine=True)``) additionally emits per-entry
``cache_admit``/``cache_evict`` instants from inside the cache — useful
for cache forensics, too hot to leave on for long runs.
"""
from __future__ import annotations

import json
import time
import types
from typing import Any, Dict, List, Optional

try:
    from torch._C._profiler import _RecordFunctionFast
    from torch.autograd import profiler as _profiler

    _profiler._is_profiler_enabled  # the flag read on every span()
except (ImportError, AttributeError):  # a torch without them: no ranges
    _RecordFunctionFast = None
    _profiler = types.SimpleNamespace(_is_profiler_enabled=False)

__all__ = [
    "PHASES",
    "Tracer",
    "enable_tracing",
    "disable_tracing",
    "get_tracer",
    "span",
    "instant",
    "counter",
    "fine_enabled",
]

PHASES = (
    "fetch_rows",
    "all_to_all",
    "intersect_kernel",
    "cache_admit",
    "cache_evict",
    "cache_invalidate",
    "residency_patch",
    "scheduler_flush",
    "delta_replay",
    "stream_batch",
    "spmd_pack",
    "spmd_patch",
    "spmd_overlap_wait",
    "lcc.epoch",
    "lcc.index",
    "lcc.round",
    "lcc.scores",
    "lcc.to_host",
    "csr.from_edges",
    "cache.build",
    "schedule.build",
    "schedule.rows",
    "schedule.requests",
    "schedule.serve",
    "schedule.finalize",
    "schedule.upload",
    "clampi_sim",
)


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        """No-op twin of ``_Span.set`` (late argument attachment)."""


_NULL_SPAN = _NullSpan()


class _ProfilerRange:
    """A profiler range alone: what ``span()`` returns while
    ``torch.profiler`` records and no tracer is installed."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = _RecordFunctionFast(name)

    def __enter__(self) -> "_ProfilerRange":
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        return False

    def set(self, **args) -> None:
        """Arguments go to the tracer's events only."""


class _Span:
    """One live span: records a ``ph: "X"`` complete event on exit."""

    __slots__ = ("_tracer", "name", "rank", "cat", "args", "_t0", "_rf")

    def __init__(self, tracer: "Tracer", name: str, rank: int, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.rank = rank
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        """Attach arguments discovered mid-span (e.g. measured bytes)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __enter__(self) -> "_Span":
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._tracer._complete(self, self._t0, t1)
        return False


class Tracer:
    """Collects trace events in memory; exports Chrome trace JSON.

    ``rank`` maps to ``tid`` (+1, so unranked events get lane 0); the
    single process is ``pid`` 0. Timestamps are microseconds relative
    to tracer creation (``perf_counter`` based, so durations are exact
    even though the origin is arbitrary).
    """

    def __init__(self, *, fine: bool = False):
        self.fine = bool(fine)
        self.events: List[dict] = []
        self._t0 = time.perf_counter()
        self._n_dropped = 0

    # ---------------- recording ----------------
    def _ts(self, t: float) -> float:
        return (t - self._t0) * 1e6  # microseconds, Chrome's unit

    def span(self, name: str, *, rank: int = -1, cat: str = "",
             **args) -> _Span:
        return _Span(self, name, int(rank), cat, args or None)

    def _complete(self, s: _Span, t0: float, t1: float) -> None:
        ev = {
            "name": s.name,
            "ph": "X",
            "ts": self._ts(t0),
            "dur": (t1 - t0) * 1e6,
            "pid": 0,
            "tid": s.rank + 1,
        }
        if s.cat:
            ev["cat"] = s.cat
        if s.args:
            ev["args"] = {k: _jsonable(v) for k, v in s.args.items()}
        self.events.append(ev)

    def instant(self, name: str, *, rank: int = -1, cat: str = "",
                **args) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "ts": self._ts(time.perf_counter()),
            "pid": 0,
            "tid": int(rank) + 1,
            "s": "t",  # thread-scoped instant
        }
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self.events.append(ev)

    def counter(self, name: str, value: float, *, rank: int = -1) -> None:
        self.events.append({
            "name": name,
            "ph": "C",
            "ts": self._ts(time.perf_counter()),
            "pid": 0,
            "tid": int(rank) + 1,
            "args": {name: float(value)},
        })

    # ---------------- aggregation ----------------
    def phase_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-phase rollup over the complete ("X") events:
        ``{name: {"calls", "total_s", "bytes"}}`` — the time dimension
        the metric registry folds in (``metrics.fold_trace``)."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            if ev.get("ph") != "X":
                continue
            d = out.setdefault(
                ev["name"], {"calls": 0.0, "total_s": 0.0, "bytes": 0.0}
            )
            d["calls"] += 1
            d["total_s"] += ev.get("dur", 0.0) * 1e-6
            args = ev.get("args") or {}
            for k, v in args.items():
                if k.endswith("bytes") and isinstance(v, (int, float)):
                    d["bytes"] += v
        return out

    # ---------------- export ----------------
    def to_chrome(self) -> dict:
        """The Chrome trace object (Perfetto/chrome://tracing format)."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "repro"}},
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "global"}},
        ]
        for tid in sorted({ev["tid"] for ev in self.events}):
            if tid > 0:
                meta.append({
                    "name": "thread_name", "ph": "M", "pid": 0,
                    "tid": tid, "args": {"name": f"rank {tid - 1}"},
                })
        return {
            "traceEvents": meta + self.events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs.trace"},
        }

    def export(self, path: str) -> None:
        """Write the trace; open the file at https://ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def __len__(self) -> int:
        return len(self.events)


def _jsonable(v):
    """Span args must survive json.dump: coerce numpy scalars etc."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        return str(v)


# --------------------------------------------------------------------------
# Module-level switchboard: the instrumentation hooks call these. With no
# tracer installed and no profiler recording, span() costs one global load,
# a None check, one read of the profiler's flag and returning the shared
# _NULL_SPAN — the near-zero-overhead contract.
# --------------------------------------------------------------------------
_tracer: Optional[Tracer] = None


def enable_tracing(*, fine: bool = False) -> Tracer:
    """Install (and return) a fresh global tracer."""
    global _tracer
    _tracer = Tracer(fine=fine)
    return _tracer


def disable_tracing() -> Optional[Tracer]:
    """Remove the global tracer; returns it (events intact) if any."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def get_tracer() -> Optional[Tracer]:
    return _tracer


def span(name: str, *, rank: int = -1, cat: str = "", **args):
    """A context manager timing one phase: a tracer's span (and a profiler
    range of the same name while ``torch.profiler`` records), a profiler
    range alone, or the shared no-op."""
    t = _tracer
    if t is None:
        if _profiler._is_profiler_enabled:
            return _ProfilerRange(name)
        return _NULL_SPAN
    return t.span(name, rank=rank, cat=cat, **args)


def instant(name: str, *, rank: int = -1, cat: str = "", **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, rank=rank, cat=cat, **args)


def counter(name: str, value: float, *, rank: int = -1) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value, rank=rank)


def fine_enabled() -> bool:
    """True iff a tracer is installed AND fine-grained (per-cache-entry)
    events were requested — the gate in the cache hot paths."""
    t = _tracer
    return t is not None and t.fine
