"""The streaming slice: the port's stream generators, ``DynamicCSR``,
``ShardedRuntime``, ``StreamingLCCEngine`` (``device="cpu"``: the plain
torch versions of B1 and B3) and ``stream_run`` held against the reference
package on the same seeded numpy inputs.

The reference engine runs its Pallas kernels in interpret mode on the CPU.
Everything compared is an integer or a float64 computed by the same host
arithmetic, so every comparison is exact, dtypes included: triangle counts,
``BatchResult``s, ledgers, coherence reports and residency stats
field for field, and ``lcc`` bit for bit at the reference's own float64.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.runtime import ShardedRuntime as RefRuntime
from repro.graphs import rmat as ref_rmat
from repro.graphs.datasets import powerlaw_graph as ref_powerlaw_graph
from repro.streaming import DynamicCSR as RefDynamicCSR
from repro.streaming import EdgeBatch as RefEdgeBatch
from repro.streaming import StreamingCacheCoherence as RefCoherence
from repro.streaming import StreamingLCCEngine as RefEngine
from repro.streaming import normalize_batch as ref_normalize_batch
from repro_torch.core.csr import CSRGraph
from repro_torch.core.runtime import ShardedRuntime
from repro_torch.core.triangles import lcc_scores, triangles_per_vertex
from repro_torch.graphs import rmat
from repro_torch.launch import stream_run
from repro_torch.streaming import (
    DynamicCSR,
    EdgeBatch,
    StreamingCacheCoherence,
    StreamingLCCEngine,
    normalize_batch,
)


def same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def same_fields(got, want):
    """Two dataclass instances (one per package) equal field for field,
    values and types."""
    assert type(got).__name__ == type(want).__name__
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k in g:
        if isinstance(w[k], np.ndarray):
            same_array(g[k], w[k])
        else:
            assert type(g[k]) is type(w[k]), (k, type(g[k]), type(w[k]))
            assert g[k] == w[k], (k, g[k], w[k])


def batch_pair(rng, n, size, p_delete=0.3):
    e = rng.integers(0, n, size=(size, 2))
    op = np.where(rng.random(size) < p_delete, -1, 1).astype(np.int8)
    return (RefEdgeBatch(u=e[:, 0], v=e[:, 1], op=op),
            EdgeBatch(u=e[:, 0], v=e[:, 1], op=op))


def churn_pair(rng, ref_eng, n, n_ins=30, n_del=8):
    """Inserts at random plus deletes of present edges (same for both)."""
    ins = rng.integers(0, n, size=(n_ins, 2))
    src, dst = ref_eng.store.to_csr().edge_list()
    keep = src < dst
    pool = np.stack([src[keep], dst[keep]], 1)
    pick = rng.choice(pool.shape[0], size=min(n_del, pool.shape[0]),
                      replace=False)
    u = np.concatenate([ins[:, 0], pool[pick][:, 0]])
    v = np.concatenate([ins[:, 1], pool[pick][:, 1]])
    op = np.concatenate([np.full(ins.shape[0], 1, np.int8),
                         np.full(pick.size, -1, np.int8)])
    return RefEdgeBatch(u=u, v=v, op=op), EdgeBatch(u=u, v=v, op=op)


# --------------------------------------------------------------------------
# stream generators
# --------------------------------------------------------------------------
@pytest.mark.parametrize("delete_frac", [0.0, 0.2])
def test_rmat_stream_batches_equal(delete_frac):
    want = list(ref_rmat.rmat_stream(8, 4, batch_size=200,
                                     delete_frac=delete_frac, seed=3))
    got = list(rmat.rmat_stream(8, 4, batch_size=200,
                                delete_frac=delete_frac, seed=3))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        same_array(g.u, w.u)
        same_array(g.v, w.v)
        same_array(g.op, w.op)


def test_rmat_adversarial_stream_batches_equal():
    want = list(ref_rmat.rmat_adversarial_stream(8, 4, batch_size=150,
                                                 seed=5))
    got = list(rmat.rmat_adversarial_stream(8, 4, batch_size=150, seed=5))
    assert len(got) == len(want) > 1
    assert any((w.op == -1).any() for w in want)
    for g, w in zip(got, want):
        same_array(g.u, w.u)
        same_array(g.v, w.v)
        same_array(g.op, w.op)


# --------------------------------------------------------------------------
# DynamicCSR
# --------------------------------------------------------------------------
def store_pair(n=60, avg_deg=4, seed=1, compact_threshold=0.25):
    g = ref_powerlaw_graph(n, avg_deg, seed=seed)
    return (RefDynamicCSR.from_csr(g, compact_threshold=compact_threshold),
            DynamicCSR.from_csr(CSRGraph.from_reference(g),
                                compact_threshold=compact_threshold))


def same_store(got, want):
    assert got.n == want.n
    same_array(got.degrees, want.degrees)
    assert got.delta_edges == want.delta_edges
    assert got.n_compactions == want.n_compactions
    assert got.n_mutations == want.n_mutations
    for v in range(want.n):
        same_array(got.row(v), want.row(v))
    vs = np.arange(want.n)
    same_array(got.padded_rows(vs, 32), want.padded_rows(vs, 32))
    snap_g, snap_w = got.to_csr(), want.to_csr()
    same_array(snap_g.offsets, snap_w.offsets)
    same_array(snap_g.adjacencies, snap_w.adjacencies)


def test_dynamic_csr_rows_equal_under_inserts_deletes_compactions():
    ref, port = store_pair(compact_threshold=0.05)
    rng = np.random.default_rng(7)
    for step in range(12):
        rb, pb = batch_pair(rng, ref.n, 40, p_delete=0.4)
        ins_w, del_w, noop_w = ref_normalize_batch(rb, ref)
        ins_g, del_g, noop_g = normalize_batch(pb, port)
        same_array(ins_g, ins_w)
        same_array(del_g, del_w)
        assert noop_g == noop_w
        for s in (ref, port):
            s.delete_edges(del_w)
            s.insert_edges(ins_w)
        u, v = rng.integers(0, ref.n, (2, 50))
        same_array(port.has_edges(u, v), ref.has_edges(u, v))
        if step % 4 == 3:
            assert port.maybe_compact() == ref.maybe_compact()
        else:
            ref.compact()
            port.compact()
        same_store(port, ref)
    assert ref.n_compactions > 0


def test_dynamic_csr_from_reference_mid_stream():
    ref, _ = store_pair(seed=4)
    rng = np.random.default_rng(8)
    for _ in range(3):
        rb, _ = batch_pair(rng, ref.n, 30, p_delete=0.4)
        ins, dele, _ = ref_normalize_batch(rb, ref)
        ref.delete_edges(dele)
        ref.insert_edges(ins)
    assert ref.delta_edges > 0  # carries outstanding deltas, not compacted
    port = DynamicCSR.from_reference(ref)
    same_store(port, ref)
    # the copy is independent of the reference's delta tables
    rb, pb = batch_pair(rng, ref.n, 30, p_delete=0.4)
    ins, dele, _ = ref_normalize_batch(rb, ref)
    for s in (ref, port):
        s.delete_edges(dele)
        s.insert_edges(ins)
    same_store(port, ref)


# --------------------------------------------------------------------------
# ShardedRuntime: the tests/test_runtime.py scenarios on both packages
# --------------------------------------------------------------------------
def runtime_pair(p=4, n=80, seed=0, port_kw=(), **kw):
    ref_store, port_store = store_pair(n, 5, seed)
    return (RefRuntime(ref_store, p, **kw), ref_store,
            ShardedRuntime(port_store, p, **kw, **dict(port_kw)), port_store)


def same_runtime(got, want):
    assert len(got.stats) == len(want.stats)
    for g, w in zip(got.stats, want.stats):
        same_fields(g, w)
    same_array(got.serve_rows, want.serve_rows)
    assert got.invalidations_sent == want.invalidations_sent
    assert (got.invalidations_broadcast_equiv
            == want.invalidations_broadcast_equiv)
    same_fields(got.merged_cache_stats(), want.merged_cache_stats())
    same_fields(got.aggregate_stats(), want.aggregate_stats())
    assert got.audit_freshness() == want.audit_freshness()


def same_rows(got, want):
    assert got.keys() == want.keys()
    for v in want:
        same_array(got[v], want[v])


@pytest.mark.parametrize("uncached", [False, True])
def test_runtime_transport_and_fanout_match(uncached):
    ref, ref_store, port, port_store = runtime_pair(uncached=uncached)
    rng = np.random.default_rng(2)
    for rank in range(4):
        vs = rng.integers(0, ref_store.n, 30).tolist()
        same_rows(port.fetch_rows(rank, vs), ref.fetch_rows(rank, vs))
    same_runtime(port, ref)
    hub = int(np.argmax(ref_store.degrees))
    absent = next(v for v in range(ref_store.n)
                  if v != hub and not ref_store.has_edge(hub, v))
    edge = np.array([[min(hub, absent), max(hub, absent)]])
    for s in (ref_store, port_store):
        s.insert_edges(edge)
    assert port.audit_freshness() == ref.audit_freshness()
    assert port.invalidate([hub, absent, 0]) == ref.invalidate([hub, absent, 0])
    same_runtime(port, ref)
    for rank in range(4):
        vs = list(range(ref_store.n))
        same_rows(port.fetch_rows(rank, vs), ref.fetch_rows(rank, vs))
    same_runtime(port, ref)


def test_runtime_device_tier_reads_match():
    ref, ref_store, port, port_store = runtime_pair(
        device_slots=8, port_kw={"device": "cpu"})
    for rank in range(4):
        vs = list(range(ref_store.n))
        same_rows(port.fetch_rows(rank, vs), ref.fetch_rows(rank, vs))
    same_runtime(port, ref)
    same_fields(port.merged_device_stats(), ref.merged_device_stats())


def test_runtime_maintain_schedule_matches():
    from repro.core.rma import build_sharded_problem as ref_build
    from repro_torch.core.rma import build_sharded_problem

    g = ref_powerlaw_graph(60, 4, seed=3)
    ref_store = RefDynamicCSR.from_csr(g)
    port_store = DynamicCSR.from_csr(CSRGraph.from_reference(g))
    ref, port = RefRuntime(ref_store, 4), ShardedRuntime(port_store, 4)
    ref.attach_problem(ref_build(g, 4, width=g.max_degree + 2))
    port.attach_problem(build_sharded_problem(CSRGraph.from_reference(g), 4,
                                              width=g.max_degree + 2))
    hub = int(np.argmax(g.degrees))
    absent = [v for v in range(g.n)
              if v != hub and not ref_store.has_edge(hub, v)]
    z = np.zeros((0, 2), np.int64)
    for picks in ([0], [1, 2]):
        ins = np.array([[min(hub, absent[i]), max(hub, absent[i])]
                        for i in picks], np.int64)
        ref_store.insert_edges(ins)
        port_store.insert_edges(ins)
        assert port.maintain_schedule(ins, z) == ref.maintain_schedule(ins, z)
        assert port.schedule_deltas == ref.schedule_deltas
        assert port.schedule_rebuilds == ref.schedule_rebuilds
        for name in ("rows_ext", "degrees", "edge_u", "edge_vc", "edge_mask",
                     "serve_idx"):
            same_array(getattr(port.problem, name), getattr(ref.problem, name))
    assert ref.schedule_rebuilds == 1


def test_runtime_migrate_matches():
    from repro.core.partition import partition_hub as ref_partition_hub
    from repro.core.repartition import plan_repartition as ref_plan
    from repro_torch.core.partition import partition_hub
    from repro_torch.core.repartition import plan_repartition

    ref, ref_store, port, port_store = runtime_pair(p=4)
    deg = ref_store.degrees
    ref = RefRuntime(ref_store, 4, partition=ref_partition_hub(
        np.zeros(ref_store.n, np.int64), 4))
    port = ShardedRuntime(port_store, 4, partition=partition_hub(
        np.zeros(port_store.n, np.int64), 4))
    for rank in range(4):
        vs = list(range(0, ref_store.n, 3))
        same_rows(port.fetch_rows(rank, vs), ref.fetch_rows(rank, vs))
    ref.part.refresh_hubs(deg)
    port.part.refresh_hubs(deg)
    plan_w = ref_plan(ref.part, deg, max_moves=6)
    plan_g = plan_repartition(port.part, deg, max_moves=6)
    same_array(plan_g.new_cuts, plan_w.new_cuts)
    same_array(plan_g.moved, plan_w.moved)
    assert port.migrate(plan_g.new_cuts) == ref.migrate(plan_w.new_cuts)
    same_array(port.part.cuts, ref.part.cuts)
    same_runtime(port, ref)


# --------------------------------------------------------------------------
# StreamingLCCEngine at p in {1, 4}: no tier, replicated tier, per-rank tier
# --------------------------------------------------------------------------
def engine_pair(g, p, tier, use_kernel, slots=12):
    """Both engines over a coherence layer and a runtime of p ranks."""
    port_g = CSRGraph.from_reference(g)
    ref_coh = RefCoherence(g.n, g.degrees, p=p, cache_rows=8,
                           clampi_bytes=1 << 14)
    port_coh = StreamingCacheCoherence(port_g.n, port_g.degrees, p=p,
                                       cache_rows=8, clampi_bytes=1 << 14,
                                       device="cpu")
    ref = RefEngine(g, use_kernel=use_kernel, coherence=ref_coh,
                    interpret=True)
    port = StreamingLCCEngine(port_g, use_kernel=use_kernel,
                              coherence=port_coh, device="cpu")
    if tier is not None:
        ref.runtime.enable_device_tier(slots, 64, scope=tier)
        port.runtime.enable_device_tier(slots, 64, scope=tier)
    return ref, port


def same_engine(got, want):
    same_array(got.t, want.t)
    same_array(got.lcc, want.lcc)
    same_array(got.shard_pairs, want.shard_pairs)
    for k in ("n_batches", "n_updates", "delta_pairs_total", "oo_host_rows",
              "oo_host_bytes", "oo_resident_pairs"):
        assert getattr(got, k) == getattr(want, k), k
    same_fields(got.coherence.report, want.coherence.report)
    ds_w = want.runtime.merged_device_stats()
    ds_g = got.runtime.merged_device_stats()
    assert (ds_g is None) == (ds_w is None)
    if ds_w is not None:
        same_fields(ds_g, ds_w)
        for dg, dw in zip(got.runtime.device_views(),
                          want.runtime.device_views()):
            same_array(dg.slot_ids, dw.slot_ids)
            same_array(dg.slot_epochs, dw.slot_epochs)
            same_array(dg.rows.numpy(), np.asarray(dw.rows))
    same_runtime(got.runtime, want.runtime)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("tier", [None, "replicated", "per_rank"])
@pytest.mark.parametrize("p", [1, 4])
def test_engine_matches_reference_batch_by_batch(p, tier, use_kernel):
    g = ref_powerlaw_graph(72, 5, seed=60 + p)
    ref, port = engine_pair(g, p, tier, use_kernel)
    same_engine(port, ref)
    rng = np.random.default_rng(61 + p)
    for _ in range(3):
        rb, pb = churn_pair(rng, ref, g.n)
        same_fields(port.apply_batch(pb), ref.apply_batch(rb))
        same_engine(port, ref)
    port.verify()
    if use_kernel and (tier == "replicated" or (tier and p > 1)):
        # the B3 route was taken (a per-rank hot set at p = 1 holds
        # nothing: the one rank owns every row)
        assert port.oo_resident_pairs > 0


def test_engine_from_empty_with_random_batches_matches():
    ref = RefEngine.empty(48, interpret=True)
    port = StreamingLCCEngine.empty(48, device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(6):
        rb, pb = batch_pair(rng, 48, 40)
        same_fields(port.apply_batch(pb), ref.apply_batch(rb))
        same_array(port.t, ref.t)
        same_array(port.lcc, ref.lcc)
    assert port.store.n_compactions == ref.store.n_compactions
    snap = port.store.to_csr()
    want_t = triangles_per_vertex(snap)
    same_array(port.t, want_t)
    same_array(port.lcc, lcc_scores(snap, want_t))


def test_engine_spmd_and_pipeline_not_ported():
    """The SPMD engine runs (it raised before it was ported): pipelined or
    not, batch by batch equal to the reference's loop engine over the same
    2-rank runtime, its counts cross-checked against the host masks."""
    g_ref = ref_powerlaw_graph(60, 4, seed=0)
    g = CSRGraph.from_reference(g_ref)
    for pipeline in (False, True):
        rt = ShardedRuntime(None, 2, n=g.n)
        port = StreamingLCCEngine(g, execution="spmd", runtime=rt,
                                  pipeline=pipeline, device="cpu")
        ref = RefEngine(g_ref, runtime=RefRuntime(None, 2, n=g.n))
        rng = np.random.default_rng(7)
        for _ in range(4):
            rb, pb = batch_pair(rng, 60, 40)
            same_fields(port.apply_batch(pb), ref.apply_batch(rb))
            same_array(port.t, ref.t)
            same_array(port.lcc, ref.lcc)
        assert port.spmd.ledger.n_pairs == port.delta_pairs_total > 0
        assert port.spmd.ledger.n_collectives > 0
        port.verify()


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_stream_run_main_cpu_verifies(capsys):
    res = {}
    rc = stream_run.main(["--scale", "8", "--batches", "4", "--device-tier",
                          "--device", "cpu", "--checkpoint-every", "2"],
                         result=res)
    out = capsys.readouterr().out
    assert rc == 0
    assert "final state verified bit-exact vs from-scratch recount" in out
    assert out.count("checkpoint: exact vs recount") == 2
    eng = res["engine"]
    assert eng.oo_resident_pairs > 0 and res["wall_s"] > 0
    eng.verify()


def test_stream_run_routes_cpu_match_reference(capsys):
    from repro.launch import stream_run as ref_stream_run

    argv = ["--scale", "7", "--batches", "3", "--adversarial",
            "--device-tier", "--device-scope", "per_rank", "--device-slots",
            "8", "--partition", "hub", "--rebalance", "--maintain-schedule"]
    assert ref_stream_run.main(argv) == 0
    want = capsys.readouterr().out
    assert stream_run.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def norm(text):
        import re

        text = re.sub(r"[0-9,.]+ upd/s", "", text)
        text = re.sub(r"in [0-9.]+s", "", text)
        return [ln for ln in text.splitlines() if not ln.startswith("R-MAT")]

    assert norm(got) == norm(want)
    assert "verified bit-exact" in got


def test_stream_run_spmd_not_ported():
    """``stream_run --spmd --pipeline --device cpu`` runs (it raised
    before the SPMD plane was ported): every printed line equal to the
    reference's launcher run in a subprocess on forced host devices, times
    and rates excepted."""
    import os
    import re
    import subprocess
    import sys

    argv = ["--scale", "8", "--batches", "4", "--p", "4", "--spmd",
            "--pipeline"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)  # the launcher forces its host devices
    r = subprocess.run([sys.executable, "-m", "repro.launch.stream_run",
                        *argv], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    import contextlib
    import io

    buf = io.StringIO()
    res = {}
    with contextlib.redirect_stdout(buf):
        assert stream_run.main(argv + ["--device", "cpu"], result=res) == 0
    got = buf.getvalue()

    def norm(text):
        text = re.sub(r"[0-9,.]+ upd/s", "", text)
        text = re.sub(r"in [0-9.]+s", "", text)
        text = re.sub(r"overlap wait [0-9.]+s", "", text)
        return [ln for ln in text.splitlines() if not ln.startswith("R-MAT")]

    assert norm(got) == norm(r.stdout)
    assert got.splitlines()[0].endswith("device=cpu  [SPMD device mesh]")
    assert got.strip().splitlines()[-1] == (
        "final state verified bit-exact vs from-scratch recount")
    eng = res["engine"]
    assert len(res["batches"]) == 4 and eng.spmd.ledger.n_collectives > 0
