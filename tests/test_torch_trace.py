"""The port's tracer (``repro_torch.obs.trace``) as the one source of the LCC
epoch's spans: free when nothing records, a ``torch.profiler`` range of the
same name while the profiler records (with or without a ``Tracer``), the
engine's and the schedule's phases nested as they run, the schedule's own
slot counts, and results bit-equal whatever records. CPU only: the engine
runs the kernels' plain versions."""
import contextlib
import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import async_engine, rma
from repro_torch.core.cache import build_static_degree_cache
from repro_torch.core.csr import from_edges
from repro_torch.graphs.rmat import rmat_edges
from repro_torch.kernels import epoch_count as ec
from repro_torch.launch import lcc_run
from repro_torch.obs import trace as obs_trace

ENGINE = ("lcc.epoch", "lcc.index", "lcc.round", "lcc.scores", "lcc.to_host")
SCHEDULE = ("schedule.rows", "schedule.requests", "schedule.serve",
            "schedule.finalize")


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    yield
    obs_trace.disable_tracing()


def small_problem(scale=7, p=4, rounds=4, cache_rows=16, seed=0):
    csr = from_edges(rmat_edges(scale, 8, seed=seed), 1 << scale)
    cache = build_static_degree_cache(csr.degrees, cache_rows)
    return csr, rma.build_sharded_problem(csr, p, n_rounds=rounds,
                                          cache=cache)


def cpu_ranges(prof):
    """(start, end, name) of the profiler's host ranges named like a span."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and "." in e.name and not e.name.startswith("aten::")]


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("name,args", [
    ("lcc.epoch", {}), ("lcc.round", {"r": 3}), ("schedule.build", {}),
    ("fetch_rows", {"rank": 2, "cat": "runtime", "n": 9}),
])
def test_span_is_the_shared_noop_when_nothing_records(name, args):
    assert obs_trace.get_tracer() is None
    assert not torch.autograd.profiler._is_profiler_enabled
    sp = obs_trace.span(name, **args)
    assert sp is obs_trace._NULL_SPAN
    with sp as s:
        s.set(device_ms=1.0)


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_profiler_sees_the_epochs_phases_nested(plain):
    _, prob = small_problem()
    dprob = prob.to_device("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        async_engine.lcc_pipelined(dprob, "cpu", method="hybrid",
                                   plain=plain)
    assert obs_trace.get_tracer() is None  # no tracer: profiler ranges only
    threads = {e.thread for e in prof.events() if e.name in ENGINE}
    assert len(threads) == 1
    ranges = cpu_ranges(prof)
    by = {n: [r for r in ranges if r[2] == n] for n in ENGINE}
    assert {n: len(v) for n, v in by.items()} == {
        "lcc.epoch": 1, "lcc.index": 1, "lcc.round": prob.n_rounds,
        "lcc.scores": 1, "lcc.to_host": 1}
    (epoch,) = by["lcc.epoch"]
    inner = [r for n in ENGINE[1:] for r in by[n]]
    assert all(inside(r, epoch) for r in inner)
    # the phases follow one another, without overlap, in program order
    order = sorted(inner)
    assert [r[2] for r in order] == (["lcc.index"]
                                     + ["lcc.round"] * prob.n_rounds
                                     + ["lcc.scores", "lcc.to_host"])
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


@contextlib.contextmanager
def recording(mode):
    tracer = obs_trace.enable_tracing() if "tracer" in mode else None
    prof = (profile(activities=[ProfilerActivity.CPU])
            if "profiler" in mode else contextlib.nullcontext())
    with prof:
        yield tracer
    obs_trace.disable_tracing()


@pytest.mark.parametrize("mode", ["tracer", "profiler", "tracer+profiler"])
@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_results_bit_equal_whatever_records(mode, plain):
    _, prob = small_problem(seed=1)
    dprob = prob.to_device("cpu")
    want = async_engine.lcc_pipelined(dprob, "cpu", method="hybrid",
                                      plain=plain)
    with recording(mode):
        got = async_engine.lcc_pipelined(dprob, "cpu", method="hybrid",
                                         plain=plain)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_tracer_and_profiler_record_the_same_spans():
    _, prob = small_problem()
    dprob = prob.to_device("cpu")
    tracer = obs_trace.enable_tracing()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        async_engine.lcc_pipelined(dprob, "cpu", method="bsearch")
    obs_trace.disable_tracing()
    spans = sorted(e["name"] for e in tracer.events if e["ph"] == "X")
    assert spans == sorted(r[2] for r in cpu_ranges(prof))
    (epoch,) = [e for e in tracer.events if e["name"] == "lcc.epoch"]
    assert epoch["args"] == {
        "rounds": prob.n_rounds, "method": "bsearch", "route": "kernels",
        "landed_ids": dprob.landed_ids,
        "landed_bytes": rma.ID_BYTES * dprob.landed_ids,
        "row_store_bytes": dprob.row_store_bytes(),
        "bitmap_slot_share": ec.bitmap_slot_share(dprob),
        "heavy_slot_share": ec.heavy_slot_share(dprob)}  # no device_ms here
    rounds = [e["args"]["r"] for e in tracer.events
              if e["name"] == "lcc.round"]
    assert rounds == list(range(prob.n_rounds))
    assert tracer.to_chrome()["otherData"]["producer"] == \
        "repro_torch.obs.trace"


def test_without_the_private_profiler_api_no_range_is_opened(monkeypatch):
    monkeypatch.setattr(obs_trace, "_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    monkeypatch.setattr(obs_trace, "_RecordFunctionFast", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs_trace.span("lcc.epoch") is obs_trace._NULL_SPAN
        tracer = obs_trace.enable_tracing()
        with obs_trace.span("lcc.round", r=0):
            torch.ones(2).add_(1)
        obs_trace.disable_tracing()
    assert [e["name"] for e in tracer.events] == ["lcc.round"]
    assert cpu_ranges(prof) == []


def test_set_up_spans_nest_and_carry_the_slot_counts():
    tracer = obs_trace.enable_tracing()
    csr, prob = small_problem()
    dprob = prob.to_device("cpu")
    obs_trace.disable_tracing()
    ev = {e["name"]: e for e in tracer.events if e["ph"] == "X"}
    assert set(ev) == {"csr.from_edges", "cache.build", "schedule.build",
                       *SCHEDULE, "schedule.upload"}
    assert set(ev) <= set(obs_trace.PHASES)
    build = ev["schedule.build"]
    for name in SCHEDULE:
        e = ev[name]
        assert build["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= build["ts"] + build["dur"]
    assert build["args"] == prob.slot_counts()
    assert dprob.landed_ids == int(prob.pulled_ids_per_round().sum())
    assert dprob.land_ids == int(prob.pulled_ids_per_round().max())


@pytest.mark.parametrize("p,cache_rows", [(1, 0), (4, 0), (4, 16), (8, 64)])
def test_slot_counts_classify_every_slot(p, cache_rows):
    csr, prob = small_problem(p=p, cache_rows=cache_rows, seed=2)
    c = prob.slot_counts()
    assert sum(c.values()) == prob.edge_mask.size
    assert c["padded"] == int((~prob.edge_mask).sum())
    # every directed edge once, by where its v row lies
    assert c["local"] + c["cached"] + c["pulled"] == csr.m
    part = prob.part
    owner = part.owner(csr.adjacencies.astype(np.int64))
    src = np.repeat(np.arange(csr.n), csr.degrees)
    remote = owner != part.owner(src)
    assert c["local"] == int((~remote).sum())
    cached = np.isin(csr.adjacencies, prob.cache_ids) & remote
    assert c["cached"] == int(cached.sum())
    if p == 1 or cache_rows == 0:
        assert c["cached"] == 0


def test_lcc_run_trace_names_the_epochs_phases(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    rc = lcc_run.main(["--scale", "7", "--p", "2", "--device", "cpu",
                       "--n-rounds", "2", "--cache-rows", "16",
                       "--trace", str(trace), "--metrics", str(metrics)])
    assert rc == 0
    capsys.readouterr()
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e["ph"] == "X"]
    assert "intersect_kernel" not in names and "delta_replay" not in names
    assert names.count("clampi_sim") == 1
    assert names.count("lcc.epoch") == 2  # warm-up and timed epoch
    assert names.count("lcc.round") == 4
    assert {"csr.from_edges", "cache.build", "schedule.build",
            "schedule.upload"} <= set(names)
    snap = json.loads(metrics.read_text())
    rows = {r["name"]: r for r in snap["counters"]}
    ids = rows["rma_ids_landed"]
    assert (ids["tier"], ids["phase"]) == ("wire", "lcc.epoch")
    assert ids["value"] > 0
    assert rows["rma_bytes_landed"]["value"] == rma.ID_BYTES * ids["value"]
    # the padded-width model stays, and lands no fewer bytes than the engine
    assert rows["rma_bytes_modeled"]["value"] >= \
        rows["rma_bytes_landed"]["value"]
    assert rows["epoch_wall_s"]["phase"] == "lcc.epoch"
