"""Host modules and plain torch math of the port held against the
reference package on the same seeded inputs: graphs, padded rows, the
three ``count_*`` device functions, the regime rule, the compiled pull
schedule field for field, the reference-to-port state carry, and the
CLaMPI replay statistics. Integers compare bit-for-bit including dtype;
the float cache/communication model compares exactly too (same numpy
arithmetic in the same order)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as ref_cache
from repro.core import csr as ref_csr
from repro.core import intersect as ref_intersect
from repro.core import partition as ref_partition
from repro.core import rma as ref_rma
from repro.core import triangles as ref_triangles
from repro.graphs import datasets as ref_datasets
from repro.graphs import rmat as ref_rmat
from repro_torch.core import cache, csr, intersect, partition, rma, triangles
from repro_torch.graphs import datasets, rmat

ARRAY_FIELDS = ("rows_ext", "degrees", "edge_u", "edge_vc", "edge_mask",
                "serve_idx", "cache_rows", "cache_ids")
SCALAR_FIELDS = ("n", "p", "width", "n_loc", "e_max", "n_rounds", "s_max",
                 "n_rounds_requested", "dedup_rounds")


def same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


def same_graph(got, want):
    assert got.n == want.n and got.m == want.m
    same_array(got.offsets, want.offsets)
    same_array(got.adjacencies, want.adjacencies)


def same_problem(got, want):
    for f in SCALAR_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in ARRAY_FIELDS:
        same_array(getattr(got, f), getattr(want, f))
    same_array(got.comm_bytes_per_round(), want.comm_bytes_per_round())
    assert len(got.works) == len(want.works)
    for (gu, gv), (wu, wv) in zip(got.works, want.works):
        same_array(gu, wu)
        same_array(gv, wv)


def pad_sorted(rng, e, w, sentinel):
    out = np.full((e, w), sentinel, np.int32)
    for i in range(e):
        vals = np.unique(rng.integers(0, sentinel, size=rng.integers(0, w + 1)))
        out[i, : len(vals)] = vals
    return out


# --------------------------------------------------------------------------
# graphs and CSR
# --------------------------------------------------------------------------
def test_from_edges_and_padded_rows_equal():
    rng = np.random.default_rng(0)
    e = rng.integers(0, 90, size=(400, 2))
    got, want = csr.from_edges(e, 90), ref_csr.from_edges(e, 90)
    same_graph(got, want)
    same_array(csr.to_padded_rows(got), ref_csr.to_padded_rows(want))
    vs = np.array([3, 80, 11])
    same_array(csr.to_padded_rows(got, 5, sentinel=200, vertices=vs),
               ref_csr.to_padded_rows(want, 5, sentinel=200, vertices=vs))
    rows = csr.to_padded_rows(got)
    same_array(csr.rows_to_bitmap_words(rows, 90),
               ref_csr.rows_to_bitmap_words(rows, 90))


@pytest.mark.parametrize("scale,ef,seed", [(6, 4, 0), (8, 8, 0), (9, 16, 3)])
def test_rmat_graph_equal(scale, ef, seed):
    same_array(rmat.rmat_edges(scale, ef, seed=seed),
               ref_rmat.rmat_edges(scale, ef, seed=seed))
    same_graph(rmat.rmat_graph(scale, ef, seed=seed),
               ref_rmat.rmat_graph(scale, ef, seed=seed))


def test_dataset_generators_equal():
    same_graph(datasets.powerlaw_graph(200, 8, seed=1),
               ref_datasets.powerlaw_graph(200, 8, seed=1))
    same_graph(datasets.uniform_graph(200, 8, seed=1),
               ref_datasets.uniform_graph(200, 8, seed=1))
    same_graph(datasets.get("facebook_circles", max_n=300),
               ref_datasets.get("facebook_circles", max_n=300))
    assert datasets.GRAPHS.keys() == ref_datasets.GRAPHS.keys()


def test_csr_from_reference_round_trip():
    want = ref_rmat.rmat_graph(7, 8, seed=1)
    got = csr.CSRGraph.from_reference(want)
    assert isinstance(got, csr.CSRGraph)
    same_graph(got, want)
    assert got.offsets is not want.offsets


@pytest.mark.parametrize("p", [1, 4, 8])
def test_partition_equal(p):
    g, w = partition.partition_1d(101, p), ref_partition.partition_1d(101, p)
    vs = np.arange(101)
    same_array(g.owner(vs), w.owner(vs))
    same_array(g.sizes(), w.sizes())
    deg = ref_datasets.powerlaw_graph(101, 8, seed=0).degrees
    gh = partition.partition_hub(deg, p)
    wh = ref_partition.partition_hub(deg, p)
    same_array(gh.cuts, wh.cuts)
    same_array(gh.hubs, wh.hubs)
    assert gh.threshold == wh.threshold


# --------------------------------------------------------------------------
# intersection math: scalar, numpy, and the plain torch device versions
# --------------------------------------------------------------------------
def test_scalar_and_numpy_intersections_equal():
    rng = np.random.default_rng(4)
    for _ in range(20):
        a = np.unique(rng.integers(0, 300, size=rng.integers(0, 60)))
        b = np.unique(rng.integers(0, 300, size=rng.integers(0, 60)))
        want = np.intersect1d(a, b).size
        assert intersect.ssi_scalar(a, b) == want
        assert intersect.binary_search_scalar(a, b) == want
        assert intersect.hybrid_scalar(a, b) == want
        assert intersect.count_bsearch_np(a, b) == want
        assert intersect.count_pairwise_np(a, b) == want
        assert intersect.eq3_ssi_faster(a.size, b.size) == (
            ref_intersect.eq3_ssi_faster(a.size, b.size))


@pytest.mark.parametrize("e,wa,wb", [(64, 16, 32), (33, 9, 70), (5, 40, 3)])
def test_count_torch_vs_jnp(e, wa, wb):
    rng = np.random.default_rng(e)
    sent = 500
    a, b = pad_sorted(rng, e, wa, sent), pad_sorted(rng, e, wb, sent)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    same_array(intersect.count_bsearch_torch(ta, tb, sent).numpy(),
               ref_intersect.count_bsearch_jnp(ja, jb, sent))
    same_array(intersect.count_pairwise_torch(ta, tb, sent).numpy(),
               ref_intersect.count_pairwise_jnp(ja, jb, sent))
    deg_a, deg_b = (a < sent).sum(1).astype(np.int32), (b < sent).sum(1).astype(np.int32)
    same_array(
        intersect.count_hybrid_torch(ta, tb, torch.from_numpy(deg_a),
                                     torch.from_numpy(deg_b), sent).numpy(),
        ref_intersect.count_hybrid_jnp(ja, jb, jnp.asarray(deg_a),
                                       jnp.asarray(deg_b), sent))


def test_count_pairwise_torch_chunking_is_invisible(monkeypatch):
    rng = np.random.default_rng(7)
    a, b = pad_sorted(rng, 20, 12, 300), pad_sorted(rng, 20, 50, 300)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = intersect.count_pairwise_torch(ta, tb, 300)
    monkeypatch.setattr(intersect, "_PAIRWISE_CHUNK_ELEMS", 20 * 12 * 7)
    same_array(intersect.count_pairwise_torch(ta, tb, 300).numpy(),
               whole.numpy())


def test_count_bitmap_torch_vs_jnp():
    rng = np.random.default_rng(1)
    wa = rng.integers(0, 2**32, size=(64, 9), dtype=np.uint32)
    wb = rng.integers(0, 2**32, size=(64, 9), dtype=np.uint32)
    got = intersect.count_bitmap_torch(torch.from_numpy(wa.view(np.int32)),
                                       torch.from_numpy(wb.view(np.int32)))
    same_array(got.numpy(),
               ref_intersect.count_bitmap_jnp(jnp.asarray(wa), jnp.asarray(wb)))


@pytest.mark.parametrize("width_b", [1, 2, 7, 64, 909, 9754])
def test_regime_rule_vs_tpu_regime_rule(width_b):
    rng = np.random.default_rng(width_b)
    deg_a = rng.integers(0, 3000, size=500).astype(np.int32)
    deg_b = rng.integers(0, 3000, size=500).astype(np.int32)
    deg_a[:50] = rng.integers(0, 4, size=50)  # small/zero degrees too
    got = intersect.regime_rule(torch.from_numpy(deg_a),
                                torch.from_numpy(deg_b), width_b)
    want = ref_intersect.tpu_regime_rule(jnp.asarray(deg_a),
                                         jnp.asarray(deg_b), width_b)
    same_array(got.numpy(), want)
    # g is a parameter: a smaller constant can only shrink the pairwise regime
    tight = intersect.regime_rule(torch.from_numpy(deg_a),
                                  torch.from_numpy(deg_b), width_b, g=1.0)
    assert not (tight & ~got).any()


@pytest.mark.parametrize("method", ["bsearch", "pairwise"])
def test_triangles_padded_and_lcc_vs_reference(method):
    g = ref_datasets.powerlaw_graph(60, 6, seed=2)
    rows = ref_csr.to_padded_rows(g)
    deg = g.degrees.astype(np.int32)
    t = triangles.triangles_padded_torch(
        torch.from_numpy(rows), torch.from_numpy(deg), g.n, method=method)
    want = ref_triangles.triangles_padded_jnp(
        jnp.asarray(rows), jnp.asarray(deg), g.n, method=method)
    same_array(t.numpy(), want)
    port_g = csr.CSRGraph.from_reference(g)
    same_array(triangles.triangles_per_vertex(port_g),
               ref_triangles.triangles_per_vertex(g))
    assert np.array_equal(t.numpy(), triangles.triangles_per_vertex(port_g))
    lcc = triangles.lcc_from_counts_torch(t, torch.from_numpy(deg))
    assert lcc.dtype == torch.float32
    # same float32 formula in both frameworks
    np.testing.assert_allclose(
        lcc.numpy(), ref_triangles.lcc_from_counts_jnp(want, jnp.asarray(deg)),
        rtol=1e-6)
    # float64 host oracle
    same_array(triangles.lcc_scores(port_g), ref_triangles.lcc_scores(g))
    np.testing.assert_allclose(lcc.numpy(), triangles.lcc_scores(port_g),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# the compiled pull schedule, field for field
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cache_rows", [0, 16])
@pytest.mark.parametrize("p", [1, 4, 8])
def test_build_sharded_problem_equal(p, cache_rows):
    want_g = ref_datasets.powerlaw_graph(160, 8, seed=0)
    got_g = datasets.powerlaw_graph(160, 8, seed=0)
    want_c = got_c = None
    if cache_rows:
        want_c = ref_cache.build_static_degree_cache(want_g.degrees, cache_rows)
        got_c = cache.build_static_degree_cache(got_g.degrees, cache_rows)
        same_array(got_c.vertex_ids, want_c.vertex_ids)
    want = ref_rma.build_sharded_problem(want_g, p, n_rounds=3, cache=want_c)
    got = rma.build_sharded_problem(got_g, p, n_rounds=3, cache=got_c)
    same_problem(got, want)
    assert got.sentinel == want.sentinel
    # the port's own checker accepts the reference's object as well
    rma.assert_problems_equal(got, want)


def test_build_sharded_problem_rmat_hub_partition_no_dedup():
    want_g = ref_rmat.rmat_graph(8, 8, seed=0)
    got_g = rmat.rmat_graph(8, 8, seed=0)
    want = ref_rma.build_sharded_problem(
        want_g, 4, n_rounds=5, dedup_rounds=False,
        part=ref_partition.partition_hub(want_g.degrees, 4))
    got = rma.build_sharded_problem(
        got_g, 4, n_rounds=5, dedup_rounds=False,
        part=partition.partition_hub(got_g.degrees, 4))
    same_problem(got, want)


@pytest.mark.parametrize("p,cache_rows", [(1, 0), (4, 16), (8, 16)])
def test_from_reference_round_trip(p, cache_rows):
    g = ref_datasets.powerlaw_graph(120, 8, seed=3)
    c = (ref_cache.build_static_degree_cache(g.degrees, cache_rows)
         if cache_rows else None)
    want = ref_rma.build_sharded_problem(g, p, n_rounds=3, cache=c)
    got = rma.ShardedLCCProblem.from_reference(want)
    assert isinstance(got, rma.ShardedLCCProblem)
    same_problem(got, want)
    # a copy, not an alias: the store is the port's own
    assert not np.shares_memory(got.row_ids, np.asarray(want.rows_ext))
    assert isinstance(got.part, partition.Partition1D)
    assert (got.part.n, got.part.p) == (want.part.n, want.part.p)
    # the carried-over state is live: the same delta patches both alike
    adj = set(map(tuple, np.stack(g.edge_list(), 1).tolist()))
    ins = next(np.array([[u, v]]) for u in range(g.n) for v in range(u + 1, g.n)
               if (u, v) not in adj and g.degrees[u] < want.width
               and g.degrees[v] < want.width)
    dele = np.array([[int(g.edge_list()[0][0]), int(g.edge_list()[1][0])]])
    dele.sort(axis=1)
    want.apply_delta(ins, dele)
    got.apply_delta(ins, dele)
    same_problem(got, want)


def test_to_device_keeps_dtypes():
    g = datasets.powerlaw_graph(100, 6, seed=0)
    c = cache.build_static_degree_cache(g.degrees, 8)
    prob = rma.build_sharded_problem(g, 4, n_rounds=2, cache=c)
    dev = prob.to_device("cpu")
    for f in ("row_ids", "degrees", "edge_u", "edge_vc", "serve_idx",
              "cache_rows"):
        t = getattr(dev, f)
        assert t.dtype == torch.int32, f
        same_array(t.numpy(), getattr(prob, f))
    same_array(dev.row_off.numpy(), prob.row_off)  # int64 offsets
    same_array(dev.rows_ext.numpy(), prob.rows_ext)  # the padded views
    assert dev.edge_mask.dtype == torch.bool
    assert dev.device.type == "cpu" and dev.sentinel == prob.sentinel
    assert (dev.p, dev.n_loc, dev.e_max, dev.n_rounds, dev.s_max) == (
        prob.p, prob.n_loc, prob.e_max, prob.n_rounds, prob.s_max)


# --------------------------------------------------------------------------
# CLaMPI replay
# --------------------------------------------------------------------------
@pytest.mark.parametrize("p,score", [(2, False), (4, True)])
def test_simulate_rma_lcc_equal(p, score):
    want_g = ref_rmat.rmat_graph(8, 8, seed=0)
    got_g = rmat.rmat_graph(8, 8, seed=0)
    kw = dict(adj_cache_bytes=want_g.csr_nbytes() // 4,
              offsets_cache_bytes=want_g.n * 2, use_degree_score=score)
    want = ref_rma.simulate_rma_lcc(want_g, p, **kw)
    got = rma.simulate_rma_lcc(got_g, p, **kw)
    for f in dataclasses.fields(ref_rma.RMATraceStats):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("offsets_stats", "adj_stats"):
            assert len(g) == len(w) == p
            for gs, ws in zip(g, w):
                assert dataclasses.asdict(gs) == dataclasses.asdict(ws), f.name
        else:
            same_array(g, w)
    assert got.makespan == want.makespan
    assert [f.name for f in dataclasses.fields(rma.RMATraceStats)] == [
        f.name for f in dataclasses.fields(ref_rma.RMATraceStats)]
    assert [f.name for f in dataclasses.fields(cache.CacheStats)] == [
        f.name for f in dataclasses.fields(ref_cache.CacheStats)]
