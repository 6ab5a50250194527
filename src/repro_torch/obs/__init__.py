"""Unified observability plane: span tracing + labeled metrics.

- ``repro_torch.obs.trace`` — near-zero-overhead nestable span tracer with a
  Chrome-trace (Perfetto-viewable) exporter; no-op when disabled.
- ``repro_torch.obs.metrics`` — one ``(name, rank, tier, phase)``-labeled
  registry with adapters over the existing stat ledgers and a
  serializable snapshot.
- ``repro_torch.obs.validate`` — CLI + library checks for the exported
  artifacts (Chrome-trace schema, span-tree nesting, cross-ledger
  accounting invariants, cachescope replay reconciliation).
- ``repro_torch.obs.cachescope`` — per-rank, per-tier cache access-trace
  recorder + analysis engine (reuse distances, Mattson hit-rate curves,
  eviction audit, offline policy replay with Belady bound).

See docs/observability.md for the taxonomy and usage.
"""
from . import cachescope, trace
from .cachescope import (
    CacheTraceRecorder,
    disable_recording,
    enable_recording,
    get_recorder,
)
from .metrics import MetricRegistry
from .trace import Tracer, disable_tracing, enable_tracing, get_tracer

__all__ = [
    "trace",
    "cachescope",
    "MetricRegistry",
    "Tracer",
    "enable_tracing",
    "disable_tracing",
    "get_tracer",
    "CacheTraceRecorder",
    "enable_recording",
    "disable_recording",
    "get_recorder",
]
