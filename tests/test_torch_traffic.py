"""The traffic plane: the port's ``traffic`` package (arrivals, clocks, SLO
scheduling, tenancy, live cache scores, the open-loop runner) held
against the reference on the same seeded inputs.

The scenarios of ``tests/test_traffic.py`` run on the reference and on the
port (``serving_parity.Side``); those that drive a query engine run the
port's two routes on the CPU (``plain`` and ``kernel``). Under
``VirtualClock`` everything is compared: answers, latency summaries, shed
counts by reason and class, tenant counters and cache bytes, scorer
arrays and the ``metrics_registry()`` counters. Arrival traces are equal
array for array, and a trace saved by either package loads in the other.
"""
import dataclasses
import functools

import numpy as np
import pytest

from serving_parity import (
    ROUTES,
    Side,
    results_view,
    runtime_view,
    same,
    service_view,
)

MIX = (0.5, 0.3, 0.2, 0.0)


def _engine(s, n=40, seed=21):
    csr = s.graph(n, 4, seed=seed)
    return s.engine(s.streaming.DynamicCSR.from_csr(csr))


def _sched(s, **kw):
    return s.serving.MicrobatchScheduler(_engine(s), **kw)


def _sched_view(sched):
    return {"counters": {k: getattr(sched, k) for k in (
        "pending", "n_batches", "n_priority_flushes", "n_slo_flushes",
        "n_shed_slo", "n_shed_quota", "n_shed_depth", "n_shed_deadline")},
        "sheds": sched.recorder.sheds,
        "latency": sched.latency_summary(),
        "by_class": sched.recorder.summary_by_class()}


# --------------------------------------------------------------------------
# scenarios on a query engine: reference vs both routes of the port
# --------------------------------------------------------------------------
def sc_all_expired_window(s):
    T = s.traffic
    clk = T.VirtualClock()
    sched = _sched(s, max_batch=8, clock=clk, slo=T.SLOPolicy())
    sched.submit(s.serving.Query.lcc(1))
    sched.submit(s.serving.Query.common_neighbors(2, 3))
    clk.advance(5.0)
    assert sched.poll() == []
    assert sched.pending == 0 and sched.n_shed_slo == 2
    summ = sched.latency_summary()
    assert summ.shed_by_class == {"common_neighbors": 1, "lcc": 1}
    assert summ.shed_rate_by_class["lcc"] == 1.0 and summ.slo_hit_rate == 0.0
    return _sched_view(sched)


def sc_query_at_exact_deadline(s):
    T = s.traffic
    clk = T.VirtualClock()
    sched = _sched(s, max_batch=8, clock=clk, slo=T.SLOPolicy())
    sched.submit(s.serving.Query.lcc(1), at=0.0)
    due = sched.next_due_at()
    clk.advance_to(due)
    res = sched.poll()
    assert len(res) == 1 and sched.n_slo_flushes == 1
    assert sched.n_shed_slo == 0
    return {"due": due, "results": results_view(res),
            "sched": _sched_view(sched)}


def sc_mixed_class_urgent_flush(s):
    T, Q = s.traffic, s.serving.Query
    clk = T.VirtualClock()
    sched = _sched(s, max_batch=4, clock=clk, slo=T.SLOPolicy())
    sched.submit(Q.lcc(1))
    sched.submit(Q.lcc(2))
    sched.submit(Q.common_neighbors(3, 4), urgent=True)
    res = sched.poll()
    assert [r.query.u for r in res] == [1, 2, 3]
    assert sched.n_priority_flushes == 1 and sched.pending == 0
    summ = sched.latency_summary()
    assert summ.count == 3 and summ.shed == 0 and summ.slo_hit_rate == 1.0
    return {"results": results_view(res), "sched": _sched_view(sched)}


def sc_edf_jumps_fifo_queue(s):
    T, Q = s.traffic, s.serving.Query
    clk = T.VirtualClock()
    sched = _sched(s, max_batch=2, clock=clk, slo=T.SLOPolicy())
    for v in (1, 2, 3):
        sched.submit(Q.lcc(v), at=0.0)
    sched.submit(Q.common_neighbors(5, 6), at=0.001)
    clk.advance_to(0.051)
    res = sched.poll()
    assert [r.query.u for r in res[:2]] == [1, 5]
    return {"results": results_view(res), "sched": _sched_view(sched)}


def sc_quota_exhausted_tenant(s):
    T, Q = s.traffic, s.serving.Query
    clk = T.VirtualClock()
    quotas = T.TenantQuotas([T.TenantSpec("a", rate_qps=1.0, burst=2.0)])
    sched = _sched(s, max_batch=64, clock=clk, quotas=quotas)
    qa = dataclasses.replace(Q.lcc(1), tenant="a")
    admitted = [sched.submit(qa), sched.submit(qa), sched.submit(qa)]
    assert admitted == [True, True, False]
    assert sched.n_shed_quota == 1 and sched.pending == 2
    admitted.append(sched.submit(Q.lcc(2)))
    clk.advance(1.0)
    admitted.append(sched.submit(qa))
    assert admitted[3:] == [True, True]
    assert quotas.rejected["a"] == 1 and quotas.admitted["a"] == 3
    assert sched.latency_summary().shed_by_class == {"lcc": 1}
    return {"admitted": admitted, "quota": quotas.counters(),
            "levels": quotas.bucket_levels(clk()),
            "sched": _sched_view(sched)}


def sc_slo_violation_counted(s):
    T = s.traffic
    clk = T.VirtualClock()
    sched = _sched(s, max_batch=1, clock=clk, slo=T.SLOPolicy())
    sched.submit(s.serving.Query.lcc(1))
    res = sched.poll()
    assert len(res) == 1
    summ = sched.latency_summary()
    assert summ.slo_violations == 0 and summ.slo_hit_rate == 1.0
    sched.recorder.record(1.0, cls="lcc", deadline_s=0.1)
    assert sched.latency_summary().slo_violations == 1
    return {"results": results_view(res), "sched": _sched_view(sched)}


def sc_next_due_at(s):
    T, Q = s.traffic, s.serving.Query
    clk = T.VirtualClock()
    sched = _sched(s, max_batch=8, clock=clk,
                   slo=T.SLOPolicy(headroom_s=0.01), max_wait=1.0)
    due = [sched.next_due_at()]
    sched.submit(Q.lcc(1), at=0.0)
    due.append(sched.next_due_at())
    sched.submit(Q.common_neighbors(2, 3), at=0.0)
    due.append(sched.next_due_at())
    assert due[0] is None
    assert due[1] == pytest.approx(0.09) and due[2] == pytest.approx(0.04)
    return {"due": due}


def sc_queueing_delay_from_arrival_stamp(s):
    clk = s.traffic.VirtualClock()
    sched = _sched(s, max_batch=1, clock=clk)
    clk.advance(2.0)
    sched.submit(s.serving.Query.lcc(1), at=0.5)
    res = sched.poll()
    assert res[0].latency_s == pytest.approx(1.5)
    return {"results": results_view(res), "sched": _sched_view(sched)}


def _service(s, csr, **kw):
    return s.service(csr, p=4, cache_bytes=1 << 16, max_batch=16, **kw)


def sc_open_loop_vs_closed_loop(s):
    T = s.traffic
    csr = s.graph(60, 4, seed=31)
    qs = s.serving.make_queries(csr.degrees, 50, kind="zipf", mix=MIX,
                                seed=32)
    closed = _service(s, csr, clock=T.VirtualClock()).scheduler.run(qs)
    clk = T.VirtualClock()
    svc = _service(s, csr, clock=clk)
    rep = T.run_open_loop(svc.scheduler, qs,
                          T.poisson_arrivals(len(qs), 100.0, seed=33),
                          clock=clk)
    assert rep.n_served == len(qs)
    want = {(r.query.kind, r.query.u, r.query.v, r.query.k): r.value
            for r in closed}
    for r in rep.results:
        q = r.query
        assert r.value == want[(q.kind, q.u, q.v, q.k)]
    s.check(rep.results, csr)
    return {"closed": results_view(closed), "open": results_view(rep.results),
            "report": dataclasses.replace(rep, results=[]),
            "svc": service_view(svc)}


def sc_open_loop_deterministic_under_virtual_clock(s):
    T = s.traffic
    csr = s.graph(60, 4, seed=34)
    qs = s.serving.make_queries(csr.degrees, 40, kind="zipf", mix=MIX,
                                seed=35)
    arr = T.poisson_arrivals(len(qs), 200.0, seed=36)

    def once():
        clk = T.VirtualClock()
        svc = _service(s, csr, clock=clk, slo=T.SLOPolicy(headroom_s=0.005))
        rep = T.run_open_loop(svc.scheduler, qs, arr, clock=clk)
        return {"results": results_view(rep.results),
                "report": dataclasses.replace(rep, results=[]),
                "svc": service_view(svc)}

    a = once()
    same(once(), a)
    return a


def sc_service_tenants_and_metrics_registry(s):
    T = s.traffic
    csr = s.graph(80, 4, seed=37)
    quotas = T.TenantQuotas.uniform(2, rate_qps=1e6, burst=1e6)
    svc = _service(s, csr, quotas=quotas, clock=T.VirtualClock(),
                   scorer=T.WorkloadScorer(blend=0.5))
    qs = T.assign_tenants(
        s.serving.make_queries(csr.degrees, 60, kind="zipf", mix=MIX,
                               seed=38),
        quotas.tenants, rng=np.random.default_rng(39))
    res = svc.scheduler.run(qs)
    s.check(res, csr)
    for c in svc.runtime.caches:
        assert sum(c.tenant_bytes().values()) == c.used_bytes
    reg = svc.metrics_registry()
    assert reg.total("quota_admitted", tier="serving") == 60
    got = sum(v for (name, _, tier, _), v in reg.counters().items()
              if name.startswith("tenant_cache_bytes:")
              and tier == "host_cache")
    assert got == sum(c.used_bytes for c in svc.runtime.caches)
    assert reg.total("tenant_requests:t0", tier="host") > 0
    return {"results": results_view(res), "svc": service_view(svc),
            "quota": quotas.counters(),
            "counters": reg.counters(), "gauges": reg.to_dict()["gauges"],
            "scores": svc.scorer.score_array(
                svc.store.degrees.astype(np.float64))}


def sc_tier_with_scorer_refresh(s):
    """The device tier re-ranked from live workload scores between
    windows (``refresh_scores``), with tenants and SLO classes."""
    T = s.traffic
    csr = s.graph(96, 6, seed=40)
    quotas = T.TenantQuotas.uniform(3, rate_qps=1e6, burst=1e6)
    clk = T.VirtualClock()
    svc = _service(s, csr, quotas=quotas, clock=clk, device_slots=10,
                   slo=T.SLOPolicy(), scorer=T.WorkloadScorer(blend=0.6))
    rounds = []
    for i in range(3):
        qs = T.assign_tenants(
            s.serving.make_queries(svc.store.degrees, 40, kind="zipf",
                                   seed=41 + i),
            quotas.tenants, rng=np.random.default_rng(44 + i))
        rep = T.run_open_loop(svc.scheduler, qs,
                              T.poisson_arrivals(len(qs), 300.0,
                                                 seed=47 + i), clock=clk)
        s.check(rep.results, csr)
        rounds.append((results_view(rep.results), svc.refresh_scores()))
    assert svc.engine.n_pairs_resident > 0
    return {"rounds": rounds, "svc": service_view(svc),
            "quota": quotas.counters()}


ENGINE_SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
                    if name.startswith("sc_")}


@functools.lru_cache(maxsize=None)
def reference(name):
    return ENGINE_SCENARIOS[name](Side("ref"))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(ENGINE_SCENARIOS))
def test_engine_scenario_matches_reference(name, route):
    same(ENGINE_SCENARIOS[name](Side(route)), reference(name))


# --------------------------------------------------------------------------
# host-only pieces: arrivals, clocks, tenancy, caches, scorer
# --------------------------------------------------------------------------
def pair(fn):
    """``fn(side)`` on the reference and on the port, compared."""
    want = fn(Side("ref"))
    got = fn(Side("plain"))
    same(got, want)
    return got


def test_poisson_arrivals_equal_and_calibrated():
    def run(s):
        T = s.traffic
        a = T.poisson_arrivals(4000, 250.0, seed=3)
        assert np.array_equal(a.t, T.poisson_arrivals(4000, 250.0, seed=3).t)
        assert np.all(np.diff(a.t) >= 0)
        assert a.measured_qps == pytest.approx(250.0, rel=0.1)
        b = T.poisson_arrivals(100, 250.0, seed=4)
        assert b.t[1] != a.t[1]
        return [a, b, a.measured_qps, a.span_s]

    pair(run)


def test_diurnal_and_burst_arrivals_equal():
    def run(s):
        T = s.traffic
        out = []
        for mk in (T.diurnal_arrivals, T.burst_arrivals):
            a = mk(500, 100.0, seed=5)
            assert np.all(np.diff(a.t) >= 0)
            assert np.array_equal(a.t, mk(500, 100.0, seed=5).t)
            out.append(a)
        a = T.burst_arrivals(2000, 100.0, seed=6)
        assert np.percentile(np.diff(a.t), 10) < 0.2 / 100.0
        out.append(a)
        out.append(T.make_arrivals("diurnal", 300, 50.0, seed=7))
        return out

    pair(run)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_arrival_trace_crosses_packages(writer, tmp_path):
    """A trace saved by either package loads in the other, array for
    array, and ``trace:PATH`` replays it verbatim in both."""
    import repro.traffic as ref_traffic
    from repro_torch import traffic

    src = ref_traffic if writer == "ref" else traffic
    a = src.poisson_arrivals(64, 50.0, seed=7)
    path = str(tmp_path / "arr.json")
    a.save(path)
    for mod in (ref_traffic, traffic):
        b = mod.ArrivalTrace.load(path)
        assert np.array_equal(a.t, b.t) and b.t.dtype == np.float64
        assert (b.process, b.offered_qps, b.seed) == (
            a.process, a.offered_qps, a.seed)
        c = mod.make_arrivals(f"trace:{path}", 32, 999.0)
        assert np.array_equal(c.t, a.t)


def test_arrival_trace_rejects_unsorted_and_foreign_files(tmp_path):
    from repro_torch.traffic import ArrivalTrace

    with pytest.raises(AssertionError):
        ArrivalTrace(t=np.asarray([0.2, 0.1]), process="x", offered_qps=1.0)
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "other", "t": []}')
    with pytest.raises(ValueError, match="not an arrival trace"):
        ArrivalTrace.load(str(bad))


def test_virtual_clock_monotone_and_hybrid_floor():
    def run(s):
        T = s.traffic
        c = T.VirtualClock()
        vals = [c.advance(0.5), c.advance_to(0.3), c()]
        with pytest.raises(AssertionError):
            c.advance(-0.1)
        h = T.HybridClock(start=10.0)
        t0 = h()
        assert t0 >= 10.0
        h.advance_to(t0 - 5.0)
        assert h() >= t0
        h.advance_to(t0 + 100.0)
        assert h() >= t0 + 100.0
        return vals

    assert pair(run) == [0.5, 0.5, 0.5]


def test_token_bucket_and_quotas_equal():
    def run(s):
        T = s.traffic
        b = T.TokenBucket(rate=10.0, burst=4.0)
        takes = [b.try_take(0.0) for _ in range(5)] + [b.try_take(0.25)]
        assert takes == [True] * 4 + [False, True]
        levels = [b.level(0.25), b.level(100.0)]
        assert levels[0] == pytest.approx(1.5) and levels[1] == 4.0
        q = T.TenantQuotas.uniform(4)
        assert sorted(q.tenants) == ["t0", "t1", "t2", "t3"]
        over = T.TenantQuotas([T.TenantSpec("a", cache_share=0.8),
                               T.TenantSpec("b", cache_share=0.8)])
        assert sum(over.cache_shares().values()) == pytest.approx(1.0)
        assert q.admit("unknown", 0.0)
        return [takes, levels, q.cache_shares(), over.cache_shares(),
                q.counters(), q.bucket_levels(0.0),
                T.DEFAULT_DEADLINES_S, T.SLOPolicy().scaled(0.5)]

    pair(run)


def test_assign_tenants_equal_and_weighted():
    def run(s):
        T, Q = s.traffic, s.serving.Query
        qs = [Q.lcc(i) for i in range(200)]
        a = T.assign_tenants(qs, ["x", "y"], rng=np.random.default_rng(3))
        w = T.assign_tenants(qs, ["x", "y"], rng=np.random.default_rng(3),
                             weights={"x": 9.0, "y": 1.0})
        assert sum(q.tenant == "x" for q in w) > 150
        return [[q.tenant for q in a], [q.tenant for q in w]]

    pair(run)


def test_cache_tenant_shares_equal():
    def run(s):
        C = s.cache.ClampiCache
        c = C(1000, 64)
        c.set_tenant_shares({"a": 0.5, "b": 0.5})
        for k in range(10):
            c.get(k, 100, score=float(k), tenant="a")
        snap = [c.tenant_bytes(), c.used_bytes]
        assert snap[0].get("a", 0) <= 500
        c.get(100, 100, score=0.5, tenant="b")
        for k in range(10, 20):
            c.get(k, 100, score=float(k), tenant="a")
        assert c.tenant_bytes()["b"] == 100
        assert sum(c.tenant_bytes().values()) == c.used_bytes
        d = C(1000, 64)
        d.set_tenant_shares({"a": 0.5, "b": 0.5})
        d.get(1, 100, score=1.0, tenant="a")
        hit = d.get(1, 100, score=1.0, tenant="b")
        assert d.tenant_bytes() == {"a": 100}
        for shares in ({"a": 0.7, "b": 0.7}, {"a": 0.0}):
            with pytest.raises(AssertionError):
                C(1000, 64).set_tenant_shares(shares)
        return [snap, c.tenant_bytes(), c.used_bytes, c.stats, hit,
                d.tenant_bytes(), d.stats]

    pair(run)


def test_scorer_equal():
    def run(s):
        W = s.traffic.WorkloadScorer
        sc = W(blend=1.0, decay=0.5)
        seen = [sc.observe(7), sc.observe(9), sc.observe(7)]
        assert sc.freq(7) == pytest.approx(1.25)
        assert sc.freq(9) == pytest.approx(0.5) and sc.freq(42) == 0.0
        sb = W(blend=0.7, decay=0.9)
        deg = np.asarray([10.0, 5.0, 0.0])
        sb.set_degree_scale(10.0)
        for _ in range(5):
            sb.observe(1)
        arr = sb.score_array(deg)
        for v in range(3):
            assert arr[v] == pytest.approx(sb.cache_score(v, deg[v]))
        assert sb.cache_score(0, 10.0) > 0.0
        rng = np.random.default_rng(5)
        big = W(blend=0.7, decay=0.98)
        degs = rng.integers(0, 300, 500).astype(np.float64)
        big.set_degree_scale(float(degs.max()))
        for key in rng.zipf(1.3, 2000) % 500:
            big.observe(int(key))
        return [seen, [sc.freq(k) for k in (7, 9, 42)], arr,
                [sb.cache_score(v, deg[v]) for v in range(3)],
                big.score_array(degs)]

    pair(run)
