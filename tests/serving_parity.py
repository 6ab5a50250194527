"""Shared helpers of the serving and traffic parity tests: one scenario is
written once against a ``Side`` (one package, one route) and run on the
reference and on the port; ``same`` then compares what each returned.

The reference side takes its host route (``use_kernel=False``, what it
does on the CPU by default). The port runs ``route="plain"``
(``use_kernel=False``) or ``route="kernel"`` (``use_kernel=True`` on the
CPU: the plain torch versions of B1 and B3 behind the kernel route).
"""
import dataclasses
import enum

import numpy as np
import torch

import repro.serving as ref_serving
import repro.streaming as ref_streaming
import repro.traffic as ref_traffic
from repro.core import cache as ref_cache
from repro.core import triangles as ref_triangles
from repro.core.runtime import ShardedRuntime as RefRuntime
from repro.graphs.datasets import powerlaw_graph as ref_powerlaw_graph
from repro.kernels.point_query import (
    batched_pair_counts as ref_batched_pair_counts,
)
from repro_torch import serving, streaming, traffic
from repro_torch.core import cache, triangles
from repro_torch.core.csr import CSRGraph
from repro_torch.core.runtime import ShardedRuntime
from repro_torch.kernels.point_query import batched_pair_counts

ROUTES = ("plain", "kernel")


class Side:
    """One package and route: its modules, a graph converter and the
    keyword arguments every engine, service and pair count takes."""

    def __init__(self, route: str):
        self.route = route
        self.is_ref = route == "ref"
        if self.is_ref:
            self.serving, self.streaming, self.traffic = (
                ref_serving, ref_streaming, ref_traffic)
            self.cache, self.triangles = ref_cache, ref_triangles
            self.Runtime = RefRuntime
            self.batched_pair_counts = ref_batched_pair_counts
            self.kw = {"use_kernel": False}
            self.dev = {}
        else:
            assert route in ROUTES, route
            self.serving, self.streaming, self.traffic = (
                serving, streaming, traffic)
            self.cache, self.triangles = cache, triangles
            self.Runtime = ShardedRuntime
            self.batched_pair_counts = batched_pair_counts
            self.kw = {"use_kernel": route == "kernel", "device": "cpu"}
            self.dev = {"device": "cpu"}

    def graph(self, n, avg_deg, seed):
        g = ref_powerlaw_graph(n, avg_deg, seed=seed)
        return g if self.is_ref else CSRGraph.from_reference(g)

    def coherence(self, csr, **kw):
        return self.streaming.coherence.StreamingCacheCoherence(
            csr.n, csr.degrees, **kw, **self.dev)

    def service(self, csr, **kw):
        return self.serving.LiveQueryService(csr, **kw, **self.kw)

    def engine(self, store, provider=None, **kw):
        return self.serving.QueryEngine(store, provider, **kw, **self.kw)

    def check(self, results, snap):
        """The reference tests' oracle: every answer equals a recount of
        ``snap`` by this side's own ``core.triangles``."""
        S = self.serving
        t_ref = self.triangles.triangles_per_vertex(snap)
        lcc_ref = self.triangles.lcc_scores(snap, t_ref)
        for r in results:
            q = r.query
            if q.kind == S.QueryKind.TRIANGLES:
                assert r.value == t_ref[q.u]
            elif q.kind == S.QueryKind.LCC:
                assert r.value == lcc_ref[q.u]
            elif q.kind == S.QueryKind.COMMON_NEIGHBORS:
                want = np.intersect1d(snap.row(q.u), snap.row(q.v))
                assert r.value == want.size
                assert np.array_equal(r.ids, want)
            else:
                order = np.lexsort((np.arange(snap.n), -lcc_ref))[: q.k]
                assert np.array_equal(r.ids, order)
                assert np.array_equal(r.values, lcc_ref[order])


class TickClock:
    """A clock that moves 1 ms each time it is read: latencies and walls
    become a function of the scheduler's own steps, equal across packages
    whose schedulers take the same steps."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n * 1e-3


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def results_view(results, latency=True):
    """Query results as plain data (queries by their fields)."""
    out = []
    for r in results:
        q = r.query
        d = {"query": (q.kind.name, q.u, q.v, q.k, q.tenant),
             "value": r.value, "ids": r.ids, "values": r.values}
        if latency:
            d["latency_s"] = r.latency_s
        out.append(d)
    return out


def runtime_view(rt):
    """Every ledger of a ``ShardedRuntime`` the serving path moves."""
    out = {
        "stats": list(rt.stats),
        "aggregate": rt.aggregate_stats(),
        "serve_rows": rt.serve_rows,
        "invalidations": (rt.invalidations_sent,
                          rt.invalidations_broadcast_equiv),
        "audit": rt.audit_freshness(),
        "rows_migrated": rt.rows_migrated,
        "device": rt.merged_device_stats(),
    }
    if rt.caches is not None:
        out["cache"] = rt.merged_cache_stats()
        out["tenant_bytes"] = [c.tenant_bytes() for c in rt.caches]
        out["used_bytes"] = [c.used_bytes for c in rt.caches]
    for k, dv in enumerate(rt.device_views()):
        rows = dv.rows
        rows = (rows.cpu().numpy() if isinstance(rows, torch.Tensor)
                else np.asarray(rows))
        out[f"tier{k}"] = (dv.slot_ids, dv.slot_epochs, rows)
    return out


def engine_view(eng):
    return {k: getattr(eng, k) for k in (
        "n_queries", "n_pairs_total", "n_pairs_raw", "n_pairs_resident",
        "host_pack_bytes")}


def service_view(svc, latency=True):
    sch = svc.scheduler
    out = {
        "t": svc.stream.t,
        "lcc": svc.stream.lcc,
        "triangle_count": svc.triangle_count,
        "runtime": runtime_view(svc.runtime),
        "engine": engine_view(svc.engine),
        "scheduler": {k: getattr(sch, k) for k in (
            "n_batches", "n_deadline_flushes", "n_priority_flushes",
            "n_slo_flushes", "n_shed_depth", "n_shed_deadline",
            "n_shed_slo", "n_shed_quota")},
        "sheds": sch.recorder.sheds,
    }
    if latency:
        out["latency"] = sch.latency_summary()
        out["by_class"] = sch.recorder.summary_by_class()
    return out


def same(got, want, path="$"):
    """``got`` (port) equals ``want`` (reference) exactly: arrays by
    dtype, shape and value; dataclasses field by field; numbers by type
    and value; enums by name and value."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert np.array_equal(got, want), path
    elif dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        names = [f.name for f in dataclasses.fields(want)]
        assert names == [f.name for f in dataclasses.fields(got)], path
        for k in names:
            same(getattr(got, k), getattr(want, k), f"{path}.{k}")
    elif isinstance(want, dict):
        assert isinstance(got, dict), (path, type(got))
        assert sorted(map(str, got)) == sorted(map(str, want)), (
            path, sorted(got), sorted(want))
        for k in want:
            same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, enum.Enum):
        assert (got.name, got.value) == (want.name, want.value), path
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert got == want, (path, got, want)
