"""The serving slice: the port's ``serving`` package and
``launch/query_serve.py`` held against the reference on the same seeded
inputs.

Every scenario of ``tests/test_serving.py`` is written once against a
``serving_parity.Side`` and run on the reference (its host route) and on
the port's two routes on the CPU: ``plain`` (``use_kernel=False``) and
``kernel`` (``use_kernel=True``: the plain torch versions of B1 and B3
behind the kernel route). Answers, ids, LCC at the reference's float64,
``ProviderStats``, ``CacheStats``, residency stats and rows, engine and
scheduler counters, and latency summaries (under deterministic clocks)
must be equal, types and dtypes included. Each side also passes the
reference test's own oracle (a recount of the snapshot).
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

from serving_parity import (
    ROUTES,
    FakeClock,
    Side,
    TickClock,
    engine_view,
    results_view,
    runtime_view,
    same,
    service_view,
)


def queries_view(qs):
    return [(q.kind.name, q.u, q.v, q.k, q.tenant) for q in qs]


def _updates(s, rng, n, size, p_delete=0.3):
    e = rng.integers(0, n, size=(size, 2))
    op = np.where(rng.random(size) < p_delete, -1, 1).astype(np.int8)
    return s.streaming.EdgeBatch(u=e[:, 0], v=e[:, 1], op=op)


# --------------------------------------------------------------------------
# scenarios: each returns what the two packages must agree on
# --------------------------------------------------------------------------
def sc_pair_counts(s):
    rng = np.random.default_rng(0)
    sent = 300
    rows = [
        np.unique(rng.integers(0, sent, size=rng.integers(0, w)))
        .astype(np.int32)
        for w in (1, 2, 3, 9, 40, 130, 7, 2, 65, 17)
    ]
    a = [rows[i] for i in rng.integers(0, len(rows), 25)]
    b = [rows[i] for i in rng.integers(0, len(rows), 25)]
    got = s.batched_pair_counts(a, b, sentinel=sent, **s.kw)
    want = np.array([np.intersect1d(x, y).size for x, y in zip(a, b)])
    assert np.array_equal(got, want)
    return {"counts": got}


def sc_pair_counts_empty(s):
    z = [np.zeros(0, np.int32)]
    return {"empty": s.batched_pair_counts([], [], sentinel=8, **s.kw),
            "zero": s.batched_pair_counts(z, z, sentinel=8, **s.kw)}


def _static(s, cached):
    S = s.serving
    csr = s.graph(90, 6, seed=1)
    store = s.streaming.DynamicCSR.from_csr(csr)
    provider = (
        S.CacheBackedRowProvider(store, p=4, capacity_bytes=1 << 16)
        if cached
        else S.DirectRowProvider(store, p=4)
    )
    eng = s.engine(store, provider)
    queries = (
        [S.Query.triangles(v) for v in range(csr.n)]
        + [S.Query.lcc(v) for v in range(csr.n)]
        + [S.Query.common_neighbors(u, v)
           for u, v in [(0, 1), (3, 17), (5, 5)]]
        + [S.Query.top_k_lcc(7)]
    )
    sched = S.MicrobatchScheduler(eng, max_batch=16, clock=TickClock())
    res = sched.run(queries)
    s.check(res, csr)
    if cached:
        assert provider.stats.cache_hits > 0
    return {"results": results_view(res), "engine": engine_view(eng),
            "runtime": runtime_view(provider.runtime),
            "latency": sched.latency_summary()}


def sc_static_direct(s):
    return _static(s, cached=False)


def sc_static_cached(s):
    return _static(s, cached=True)


def sc_engine_triangles(s):
    csr = s.graph(60, 5, seed=2)
    store = s.streaming.DynamicCSR.from_csr(csr)
    eng = s.engine(store)
    res = eng.execute_batch(
        [s.serving.Query.triangles(v) for v in range(0, 60, 3)])
    s.check(res, csr)
    return {"results": results_view(res), "engine": engine_view(eng)}


def sc_microbatch_windows(s):
    S = s.serving
    csr = s.graph(70, 5, seed=3)
    store = s.streaming.DynamicCSR.from_csr(csr)
    qs = S.make_queries(csr.degrees, 80, kind="zipf", seed=4)
    out, answers = {}, []
    for w in (1, 64):
        eng = s.engine(store, S.CacheBackedRowProvider(store, p=4))
        sched = S.MicrobatchScheduler(eng, max_batch=w, clock=TickClock())
        res = sched.run(qs)
        s.check(res, csr)
        assert all(r.latency_s > 0 for r in res)
        out[w] = {"results": results_view(res), "engine": engine_view(eng),
                  "latency": sched.latency_summary()}
        answers.append(results_view(res, latency=False))
    same(answers[0], answers[1])  # the window does not change the answers
    return out


def sc_top_k_after_mutation(s):
    csr = s.graph(40, 4, seed=20)
    store = s.streaming.DynamicCSR.from_csr(csr)
    eng = s.engine(store)
    r0 = eng.execute_batch([s.serving.Query.top_k_lcc(5)])[0]
    s.check([r0], store.to_csr())
    rng = np.random.default_rng(21)
    e = rng.integers(0, csr.n, size=(60, 2))
    e = e[e[:, 0] != e[:, 1]]
    lo, hi = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    fresh = np.stack([lo, hi], 1)[~store.has_edges(lo, hi)]
    key = np.unique(fresh[:, 0] * csr.n + fresh[:, 1])
    store.insert_edges(np.stack([key // csr.n, key % csr.n], 1))
    r1 = eng.execute_batch([s.serving.Query.top_k_lcc(5)])[0]
    s.check([r1], store.to_csr())
    return {"results": results_view([r0, r1])}


def sc_degree_zero_and_one(s):
    store = s.streaming.DynamicCSR.empty(8)
    eng = s.engine(store)
    res = eng.execute_batch([s.serving.Query.lcc(0),
                             s.serving.Query.triangles(1)])
    assert res[0].value == 0.0 and res[1].value == 0
    return {"results": results_view(res)}


def _service_rounds(s, svc, n, seed, rounds, size, n_q, kind, q_seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(rounds):
        svc.apply_updates(_updates(s, rng, n, size))
        res = svc.scheduler.run(s.serving.make_queries(
            svc.store.degrees, n_q, kind=kind, seed=q_seed + i))
        s.check(res, svc.store.to_csr())
        out.append(results_view(res))
    svc.verify()
    return out


def sc_live_service_updates(s):
    csr = s.graph(80, 5, seed=6)
    svc = s.service(csr, p=4, max_batch=32, clock=TickClock())
    rounds = _service_rounds(s, svc, csr.n, 7, 6, 30, 30, "zipf", 10)
    assert svc.provider.stats.invalidations > 0
    return {"rounds": rounds, "svc": service_view(svc)}


def sc_live_service_coherence_sim(s):
    csr = s.graph(64, 4, seed=8)
    coh = s.coherence(csr, p=4, cache_rows=8, clampi_bytes=1 << 12)
    svc = s.service(csr, p=4, coherence=coh, max_batch=16,
                    clock=TickClock())
    rng = np.random.default_rng(9)
    rounds = []
    for i in range(4):
        e = rng.integers(0, csr.n, size=(24, 2))
        svc.apply_updates(s.streaming.EdgeBatch.inserts(e))
        res = svc.scheduler.run(s.serving.make_queries(
            svc.store.degrees, 20, kind="uniform", seed=20 + i))
        s.check(res, svc.store.to_csr())
        rounds.append(results_view(res))
    assert coh.report.remote_reads > 0
    svc.verify()
    return {"rounds": rounds, "svc": service_view(svc),
            "report": coh.report}


def sc_read_write_stream(s):
    csr = s.graph(64, 4, seed=10)
    svc = s.service(csr, p=4, max_batch=32, clock=TickClock())
    events = []
    for ev in s.serving.read_write_stream(
        lambda: svc.store.degrees, csr.n, 20, write_frac=0.4, seed=11
    ):
        if ev.is_update:
            r = svc.apply_updates(ev.update)
            events.append(("u", ev.update.u, ev.update.v, ev.update.op,
                           dataclasses.asdict(r)))
        else:
            events.append(("q", results_view(svc.scheduler.run(ev.queries))))
    res = svc.scheduler.run(s.serving.make_queries(svc.store.degrees, 20,
                                                   seed=12))
    s.check(res, svc.store.to_csr())
    svc.verify()
    return {"events": events, "last": results_view(res),
            "svc": service_view(svc)}


def sc_stale_provider_without_coherence(s):
    csr = s.graph(60, 6, seed=13)
    store = s.streaming.DynamicCSR.from_csr(csr)
    hub = int(np.argmax(csr.degrees))
    p = 4
    provider = s.serving.CacheBackedRowProvider(store, p=p,
                                                capacity_bytes=1 << 20)
    if int(provider.part.owner(hub)) == provider.rank:
        provider.rank = (provider.rank + 1) % p
    eng = s.engine(store, provider)
    Q = s.serving.Query
    before = eng.execute_batch([Q.triangles(hub)])[0].value
    assert provider.cache.contains(hub)
    absent = [v for v in range(csr.n)
              if v != hub and not store.has_edge(hub, v)][:3]
    store.insert_edges(np.array([[min(hub, v), max(hub, v)]
                                 for v in absent]))
    audit_stale = provider.audit_freshness()
    assert audit_stale[1] > 0
    stale_val = eng.execute_batch([Q.triangles(hub)])[0].value
    fresh_t = s.triangles.triangles_per_vertex(store.to_csr())
    changed = np.unique(np.array([[hub, v] for v in absent]).ravel())
    provider.notify_batch(changed)
    assert provider.audit_freshness()[1] == 0
    healed = eng.execute_batch([Q.triangles(hub)])[0].value
    assert healed == fresh_t[hub]
    return {"values": (before, stale_val, healed),
            "audit": (audit_stale, provider.audit_freshness()),
            "runtime": runtime_view(provider.runtime)}


def sc_payloads_survive_unrelated_updates(s):
    csr = s.graph(60, 5, seed=14)
    svc = s.service(csr, p=4, max_batch=16, clock=TickClock())
    hub = int(np.argmax(csr.degrees))
    if int(svc.provider.part.owner(hub)) == svc.provider.rank:
        svc.provider.rank = (svc.provider.rank + 1) % 4
    r = svc.query(s.serving.Query.triangles(hub))
    assert svc.provider.cache.contains(hub)
    others = [v for v in range(csr.n) if v != hub]
    u, v = others[0], others[1]
    svc.apply_updates(s.streaming.EdgeBatch.inserts([[min(u, v),
                                                      max(u, v)]]))
    assert svc.provider.cache.contains(hub)
    svc.verify()
    return {"result": results_view([r]), "svc": service_view(svc)}


def sc_workload_generators(s):
    S = s.serving
    deg = s.graph(200, 6, seed=15).degrees
    zipf = S.sample_vertices(deg, 4000, np.random.default_rng(0),
                             kind="zipf", exponent=1.0)
    uni = S.sample_vertices(deg, 4000, np.random.default_rng(0),
                            kind="uniform")
    assert deg[zipf].mean() > deg[uni].mean() * 1.5
    a = S.make_queries(deg, 50, kind="zipf", seed=3)
    assert a == S.make_queries(deg, 50, kind="zipf", seed=3)
    mix = S.make_queries(deg, 300, kind="zipf", seed=4)
    assert {q.kind.name for q in mix} == {
        "LCC", "TRIANGLES", "COMMON_NEIGHBORS", "TOP_K_LCC"}
    with pytest.raises(ValueError):
        S.sample_vertices(deg, 5, np.random.default_rng(0), kind="nope")
    rw = [queries_view(ev.queries) if ev.queries is not None
          else (ev.update.u, ev.update.v, ev.update.op)
          for ev in S.read_write_stream(lambda: deg, deg.size, 12,
                                        write_frac=0.5, seed=5)]
    return {"zipf": zipf, "uniform": uni, "queries": queries_view(a + mix),
            "read_write": rw}


def sc_cross_rank_updates(s):
    csr = s.graph(96, 5, seed=21)
    svc = s.service(csr, p=4, cross_rank=True, max_batch=16,
                    clock=TickClock())
    assert len(svc.providers) == 4
    rounds = _service_rounds(s, svc, csr.n, 22, 5, 24, 40, "zipf", 30)
    active = [k for k, st in enumerate(svc.runtime.stats)
              if st.local_reads + st.remote_reads > 0]
    assert len(active) >= 2
    assert svc.runtime.cross_rank_rows_served() > 0
    assert svc.runtime.invalidation_fanout_saved > 0
    return {"rounds": rounds, "svc": service_view(svc)}


def sc_cross_rank_routes_to_owner(s):
    S = s.serving
    csr = s.graph(64, 4, seed=23)
    store = s.streaming.DynamicCSR.from_csr(csr)
    rt = s.Runtime(store, p=4)
    eng = S.ShardedQueryEngine(store, rt, **s.kw)
    routes = [eng.route(S.Query.lcc(v)) for v in (0, 17, 40, 63)]
    assert routes == [int(rt.part.owner(v)) for v in (0, 17, 40, 63)]
    assert eng.route(S.Query.top_k_lcc(3)) == 0
    res = eng.execute_batch([S.Query.triangles(v) for v in range(64)])
    s.check(res, csr)
    assert all(st.local_reads > 0 for st in rt.stats)
    return {"routes": routes, "results": results_view(res),
            "engine": engine_view(eng), "runtime": runtime_view(rt)}


def sc_cross_and_single_rank_agree(s):
    csr = s.graph(80, 5, seed=24)
    qs = s.serving.make_queries(csr.degrees, 60, kind="zipf", seed=25)
    out = {}
    for cross in (False, True):
        svc = s.service(csr, p=4, cross_rank=cross, max_batch=16,
                        clock=TickClock())
        out[cross] = {"results": results_view(svc.scheduler.run(qs)),
                      "svc": service_view(svc)}
    for a, b in zip(out[False]["results"], out[True]["results"]):
        assert a["query"] == b["query"] and a["value"] == b["value"]
    return out


def _sched(s, seed, **kw):
    csr = s.graph(40, 4, seed=seed)
    store = s.streaming.DynamicCSR.from_csr(csr)
    return csr, s.serving.MicrobatchScheduler(s.engine(store), **kw)


def _sched_view(sched):
    return {k: getattr(sched, k) for k in (
        "pending", "n_batches", "n_deadline_flushes", "n_priority_flushes",
        "n_shed_depth", "n_shed_deadline")} | {
        "sheds": sched.recorder.sheds, "latency": sched.latency_summary()}


def sc_scheduler_deadline_flush(s):
    clk = FakeClock()
    csr, sched = _sched(s, 26, max_batch=8, max_wait=0.5, clock=clk)
    Q = s.serving.Query
    sched.submit(Q.triangles(3))
    assert sched.poll() == []
    clk.t = 0.4
    sched.submit(Q.lcc(5))
    assert sched.poll() == []
    clk.t = 0.6
    res = sched.poll()
    assert [r.query.u for r in res] == [3, 5]
    assert sched.pending == 0 and sched.n_deadline_flushes == 1
    assert res[0].latency_s == pytest.approx(0.6)
    assert res[1].latency_s == pytest.approx(0.2)
    s.check(res, csr)
    return {"results": results_view(res), "sched": _sched_view(sched)}


def sc_scheduler_full_window_and_priority(s):
    clk = FakeClock()
    _, sched = _sched(s, 27, max_batch=4, max_wait=10.0, clock=clk)
    Q = s.serving.Query
    for v in range(5):
        sched.submit(Q.triangles(v))
    r1 = sched.poll()
    assert len(r1) == 4 and sched.pending == 1
    sched.submit(Q.lcc(7), urgent=True)
    r2 = sched.poll()
    assert [r.query.u for r in r2] == [4, 7]
    assert sched.n_priority_flushes == 1
    assert sched.poll() == []
    sched.submit(Q.triangles(9))
    r3 = sched.flush()
    assert len(r3) == 1
    return {"results": [results_view(r) for r in (r1, r2, r3)],
            "sched": _sched_view(sched)}


def sc_scheduler_poll_matches_flush(s):
    S = s.serving
    csr = s.graph(50, 4, seed=28)
    store = s.streaming.DynamicCSR.from_csr(csr)
    qs = S.make_queries(csr.degrees, 30, kind="zipf", seed=29)
    r_flush = S.MicrobatchScheduler(s.engine(store), max_batch=8,
                                    clock=TickClock()).run(qs)
    clk = FakeClock()
    sched = S.MicrobatchScheduler(s.engine(store), max_batch=8,
                                  max_wait=0.1, clock=clk)
    sched.submit_many(qs)
    clk.t = 1.0
    r_poll = sched.poll()
    for a, b in zip(r_flush, r_poll):
        assert a.query == b.query and a.value == b.value
    return {"flush": results_view(r_flush), "poll": results_view(r_poll),
            "sched": _sched_view(sched)}


def sc_service_shares_coherence_runtime(s):
    csr = s.graph(64, 4, seed=31)
    coh = s.coherence(csr, p=4, cache_rows=8, clampi_bytes=1 << 16)
    svc = s.service(csr, p=4, coherence=coh, max_batch=16,
                    clock=TickClock())
    assert svc.runtime is coh.runtime
    assert svc.stream.runtime is coh.runtime
    rng = np.random.default_rng(32)
    rounds = []
    for i in range(3):
        e = rng.integers(0, csr.n, size=(20, 2))
        svc.apply_updates(s.streaming.EdgeBatch.inserts(e[e[:, 0] != e[:, 1]]))
        res = svc.scheduler.run(s.serving.make_queries(
            svc.store.degrees, 24, kind="zipf", seed=40 + i))
        s.check(res, svc.store.to_csr())
        rounds.append(results_view(res))
    svc.verify()
    return {"rounds": rounds, "svc": service_view(svc),
            "report": coh.report}


def sc_scheduler_sheds_on_queue_depth(s):
    csr, sched = _sched(s, 31, max_batch=4, max_queue=6, clock=TickClock())
    Q = s.serving.Query
    accepted = [sched.submit(Q.triangles(v % 40)) for v in range(10)]
    assert accepted == [True] * 6 + [False] * 4
    assert sched.recorder.sheds == {"depth": 4}
    res = sched.flush()
    assert len(res) == 6
    s.check(res, csr)
    again = sched.submit(Q.lcc(1))
    many = sched.submit_many([Q.lcc(v) for v in range(10)])
    assert (again, many, sched.n_shed_depth) == (True, 5, 9)
    summ = sched.latency_summary()
    assert summ.shed == 9 and summ.shed_rate == pytest.approx(9 / 15)
    return {"accepted": accepted, "results": results_view(res),
            "sched": _sched_view(sched)}


def sc_scheduler_poll_sheds_stale(s):
    clk = FakeClock()
    csr, sched = _sched(s, 32, max_batch=8, max_wait=0.5, shed_wait=2.0,
                        clock=clk)
    Q = s.serving.Query
    sched.submit(Q.triangles(3))
    clk.t = 1.9
    sched.submit(Q.lcc(5))
    clk.t = 2.5
    res = sched.poll()
    assert [r.query.u for r in res] == [5]
    assert sched.n_shed_deadline == 1
    assert sched.recorder.sheds == {"deadline": 1}
    s.check(res, csr)
    return {"results": results_view(res), "sched": _sched_view(sched)}


def sc_service_admission_control(s):
    csr = s.graph(60, 5, seed=33)
    svc = s.service(csr, p=2, max_batch=8, max_queue=5, clock=TickClock())
    admitted = svc.submit_many(s.serving.make_queries(
        svc.store.degrees, 12, kind="uniform", seed=34))
    assert admitted == 5 and svc.scheduler.n_shed_depth == 7
    assert svc.submit(s.serving.Query.lcc(1)) is False
    res = svc.flush()
    assert len(res) == 5
    s.check(res, svc.store.to_csr())
    svc.verify()
    return {"admitted": admitted, "results": results_view(res),
            "svc": service_view(svc)}


def _tier_service(s, cross_rank, scope):
    csr = s.graph(96, 6, seed=50)
    svc = s.service(csr, p=4, cross_rank=cross_rank, max_batch=16,
                    device_slots=10, device_scope=scope, clock=TickClock())
    rounds = _service_rounds(s, svc, csr.n, 51, 4, 24, 40, "zipf", 52)
    assert svc.engine.n_pairs_resident > 0
    return {"rounds": rounds, "svc": service_view(svc),
            "oo_host": (svc.stream.oo_host_rows, svc.stream.oo_host_bytes)}


def sc_device_tier_single_rank(s):
    return _tier_service(s, False, "replicated")


def sc_device_tier_cross_rank(s):
    return _tier_service(s, True, "replicated")


def sc_device_tier_per_rank(s):
    return _tier_service(s, True, "per_rank")


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}


@functools.lru_cache(maxsize=None)
def reference(name):
    return SCENARIOS[name](Side("ref"))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, route):
    same(SCENARIOS[name](Side(route)), reference(name))


# --------------------------------------------------------------------------
# the routes themselves
# --------------------------------------------------------------------------
def test_use_kernel_follows_the_device():
    from repro_torch.serving import LiveQueryService, QueryEngine
    from repro_torch.streaming import DynamicCSR

    csr = Side("plain").graph(40, 4, seed=0)
    assert QueryEngine(DynamicCSR.from_csr(csr), device="cpu").use_kernel \
        is False
    svc = LiveQueryService(csr, p=2, device="cpu")
    assert svc.engine.use_kernel is False and svc.stream.use_kernel is False
    svc = LiveQueryService(csr, p=2, device="cpu", use_kernel=True,
                           cross_rank=True)
    assert svc.stream.use_kernel is True
    assert all(e.use_kernel for e in svc.engine.engines)


def test_kernel_route_calls_b1_and_b3_wrappers(monkeypatch):
    """On the kernel route the engine hands its pairs to B1
    (``batched_pair_counts(use_kernel=True)``) and its resident pairs to
    B3 with the tier's own tensors (``rows`` and ``lens``, never copied)
    on the engine's device; the plain route calls B3 never."""
    import repro_torch.serving.engine as eng_mod

    calls = {"b1": 0, "b3": 0}
    b1, b3 = eng_mod.batched_pair_counts, eng_mod.resident_intersect_counts

    def spy_b1(*a, **kw):
        if kw["use_kernel"]:
            calls["b1"] += 1
        return b1(*a, **kw)

    def spy_b3(residency, slots, packed, **kw):
        assert kw["device"].type == "cpu"
        svc_dev = svc.runtime.device
        assert residency is svc_dev.rows and kw["lengths"] is svc_dev.lens
        calls["b3"] += 1
        out = b3(residency, slots, packed, **kw)
        assert out.dtype == np.int64
        return out

    monkeypatch.setattr(eng_mod, "batched_pair_counts", spy_b1)
    monkeypatch.setattr(eng_mod, "resident_intersect_counts", spy_b3)
    out = {}
    for route in ROUTES:
        s = Side(route)
        svc = s.service(s.graph(96, 6, seed=50), p=4, device_slots=10,
                        max_batch=16, clock=TickClock())
        rounds = _service_rounds(s, svc, 96, 51, 3, 24, 40, "zipf", 52)
        out[route] = (rounds, engine_view(svc.engine), dict(calls))
        calls.update(b1=0, b3=0)
    assert out["kernel"][2]["b1"] > 0 and out["kernel"][2]["b3"] > 0
    assert out["plain"][2] == {"b1": 0, "b3": 0}
    same(out["kernel"][:2], out["plain"][:2])


def test_spmd_and_pipeline_not_ported():
    for flags in ([], ["--pipeline"]):
        _spmd_launcher_matches_reference(flags)


def _spmd_launcher_matches_reference(flags):
    """The SPMD plane runs (it raised before it was ported): the engine,
    the service and ``query_serve --smoke --spmd --ranks 2 [--pipeline]``
    on the CPU, every printed line equal to the reference's launcher run
    in a subprocess on forced host devices (times and rates excepted)."""
    import os
    import subprocess
    import sys

    from repro_torch.core.runtime import ShardedRuntime
    from repro_torch.launch import query_serve
    from repro_torch.serving import LiveQueryService, ShardedQueryEngine
    from repro_torch.streaming import DynamicCSR

    pipeline = "--pipeline" in flags
    csr = Side("plain").graph(20, 3, seed=0)
    store = DynamicCSR.from_csr(csr)
    rt = ShardedRuntime(store, 2)
    eng = ShardedQueryEngine(store, rt, device="cpu", execution="spmd",
                             pipeline=pipeline)
    assert eng.spmd is not None and eng.pipeline is pipeline
    svc = LiveQueryService(csr, p=2, cross_rank=True, execution="spmd",
                           pipeline=pipeline, device="cpu")
    assert svc.engine.spmd.device.type == "cpu"

    argv = ["--smoke", "--spmd", "--ranks", "2"] + flags
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)  # the launcher forces its host devices
    r = subprocess.run([sys.executable, "-m", "repro.launch.query_serve",
                        *argv], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    import contextlib
    import io

    buf = io.StringIO()
    res = {}
    with contextlib.redirect_stdout(buf):
        assert query_serve.main(argv + ["--device", "cpu"], result=res) == 0
    got = buf.getvalue()
    assert "SPMD device mesh" in got and "EXACT match" in got
    assert got.strip().splitlines()[-1].startswith("verified: ")
    assert _spmd_lines(got) == _spmd_lines(r.stdout)
    led = res["svc"].engine.spmd.ledger
    assert led.n_collectives > 0 and led.total_rows > 0


def _spmd_lines(text):
    """The launcher's lines with times and rates masked (the SPMD lines'
    device and overlap-wait seconds too)."""
    text = re.sub(r"on-device in [0-9.]+s", "on-device in <t>", text)
    text = re.sub(r"overlap wait [0-9.]+s", "overlap wait <t>", text)
    return _launch_lines(text, False)


# --------------------------------------------------------------------------
# the launcher: both packages on one argv, every printed line compared
# --------------------------------------------------------------------------
_TIMED = re.compile(
    r"in [0-9.]+s wall \([0-9,]+ q/s end-to-end; [0-9,]+ q/s in-engine\)"
    r"|p50 [0-9.]+ ms  p90 [0-9.]+ ms  p99 [0-9.]+ ms  max [0-9.]+ ms")


def _launch_lines(text, open_loop):
    lines = [_TIMED.sub("<timed>", ln) for ln in text.splitlines()]
    if open_loop:
        # HybridClock: admissions, sheds and latencies follow real time,
        # and with them how many queries are served and verified; only the
        # graph and the arrival trace (compared below) are comparable.
        # Each side's answers are checked by its own --verify
        # (_verified_all).
        keep = ("R-MAT", "arrival trace")
        lines = [ln for ln in lines if ln.startswith(keep)]
    return lines


def _verified_all(text, served):
    """The launcher's ``verified: N ... bit-exact vs recount, 0 stale
    cached rows`` line is there, with N its own count of served point
    queries: every answer was checked."""
    found = re.findall(r"^verified: (\d+) point queries bit-exact vs "
                       r"recount, 0 stale cached rows$", text, re.M)
    assert len(found) == 1, text[-2000:]
    assert int(found[0]) == served > 0, (found, served)


@pytest.mark.parametrize("flags", [
    [],
    ["--ranks", "4"],
    ["--device-tier"],
    ["--partition", "hub", "--rebalance"],
    ["--open-loop", "poisson", "--rate", "500", "--slo", "--tenants", "3",
     "--ewma-scores"],
], ids=["smoke", "ranks4", "device_tier", "hub_rebalance", "open_loop"])
def test_launcher_matches_reference(flags, capsys, tmp_path):
    from repro.launch import query_serve as ref_query_serve
    from repro.traffic import ArrivalTrace as RefArrivalTrace
    from repro_torch.launch import query_serve
    from repro_torch.traffic import ArrivalTrace

    open_loop = "--open-loop" in flags
    argv = ["--smoke"] + flags
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    extra = (lambda p: ["--arrivals-out", str(p)]) if open_loop else (
        lambda p: [])
    assert ref_query_serve.main(argv + extra(ref_out)) == 0
    want = capsys.readouterr().out
    res = {}
    assert query_serve.main(argv + extra(port_out) + ["--device", "cpu"],
                            result=res) == 0
    got = capsys.readouterr().out
    assert "verified: " in got and "bit-exact vs recount" in got
    want_lines = _launch_lines(want.replace(str(ref_out), "<trace>"),
                               open_loop)
    got_lines = _launch_lines(got.replace(str(port_out), "<trace>"),
                              open_loop)
    assert got_lines == want_lines
    assert res["served"] > 0 and res["latency"].count == res["served"]
    _verified_all(got, res["served"])
    ref_served = re.findall(r"^served (\d+) queries in ", want, re.M)
    assert len(ref_served) == 1
    _verified_all(want, int(ref_served[0]))
    if open_loop:
        a, b = RefArrivalTrace.load(str(ref_out)), ArrivalTrace.load(
            str(port_out))
        same(b.t, a.t)
        assert (b.process, b.offered_qps) == (a.process, a.offered_qps)
        assert "cache shares" in got and "open-loop[poisson]" in got
