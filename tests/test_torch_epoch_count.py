"""The epoch by index (``kernels/epoch_count.py``: packed landing, count by
index) against the JAX engine, the padded plain route and numpy oracles.

On the CPU the engine runs the same rounds as on a card, through the plain
versions of ``epoch_land`` and ``epoch_count``, so the index maps (pulled
lengths and offsets, the three regions of the combined index, the phantom
slots) are what these tests hold. The JAX engine's multi-rank results come
from ``test_torch_engine.py``'s subprocess fixture. Tolerances: ``t`` and
every count bit for bit; ``lcc`` float32 vs the JAX engine ``rtol=1e-6``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import async_engine, rma
from repro_torch.core.cache import build_static_degree_cache
from repro_torch.core.csr import from_edges
from repro_torch.graphs.datasets import powerlaw_graph
from repro_torch.kernels import epoch_count as ec
from test_torch_engine import (  # noqa: F401  (the fixture is used by name)
    carried_problem,
    reference_runs,
    same_engine_output,
)

METHODS = ("bsearch", "pairwise", "hybrid")


def hub_graph(seed=0, n=120):
    """Five hubs adjacent to every non-isolated vertex (hub x hub pairs on
    every rank), random edges beside them, and 4 isolated vertices."""
    rng = np.random.default_rng(seed)
    live = n - 4
    hubs = [0, 1, 37, 70, 71]
    edges = [(h, v) for h in hubs for v in range(live)]
    edges += [tuple(e) for e in rng.integers(0, live, size=(300, 2))]
    return from_edges(np.array(edges), n, undirected=True)


def problem(g, p, n_rounds, cache_rows):
    cache = (build_static_degree_cache(g.degrees, cache_rows)
             if cache_rows else None)
    return rma.build_sharded_problem(g, p, n_rounds=n_rounds, cache=cache)


def landing_oracle(prob, r):
    """Round r's packed landing, lengths and offsets by numpy loops."""
    ids, lens = [], []
    for dst in range(prob.p):
        for src in range(prob.p):
            for slot in range(prob.s_max):
                loc = prob.serve_idx[src, r, dst, slot]
                if loc >= prob.n_loc:
                    lens.append(0)
                    continue
                d = int(prob.degrees[src, loc])
                lens.append(d)
                ids.append(prob.rows_ext[src, loc, :d])
    lens = np.array(lens, np.int64)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = np.concatenate(ids) if ids else np.zeros(0, np.int32)
    return flat, lens, off


def count_oracle(prob, r):
    """Round r's S contributions by the padded route's definition: combined
    rows [local | cache | fetched], np.intersect1d per real slot."""
    p, n_loc, s_max, sent = prob.p, prob.n_loc, prob.s_max, prob.sentinel
    e_chunk = prob.e_max // prob.n_rounds
    acc = np.zeros(p * (n_loc + 1), np.int64)
    regions = np.zeros(3, np.int64)
    for k in range(p):
        fetched = [prob.rows_ext[src, prob.serve_idx[src, r, k, slot]]
                   for src in range(p) for slot in range(s_max)]
        comb = np.concatenate([prob.rows_ext[k], prob.cache_rows,
                               np.array(fetched).reshape(-1, prob.width)])
        for j in range(r * e_chunk, (r + 1) * e_chunk):
            if not prob.edge_mask[k, j]:
                continue
            u, vc = prob.edge_u[k, j], prob.edge_vc[k, j]
            a, b = prob.rows_ext[k, u], comb[vc]
            acc[k * (n_loc + 1) + u] += np.intersect1d(a[a < sent],
                                                       b[b < sent]).size
            regions[0 if vc <= n_loc else
                    1 if vc < n_loc + 1 + prob.cache_rows.shape[0] else 2] += 1
    return acc, regions


def round_counts(dprob, index, r, method):
    landing = torch.zeros(max(1, dprob.land_ids), dtype=torch.int32)
    ec.epoch_land(dprob, index, r, landing)
    acc = torch.zeros(dprob.p * (dprob.n_loc + 1), dtype=torch.int32)
    ec.epoch_count(dprob, index, r, landing, acc, method=method)
    return acc.numpy()


# --------------------------------------------------------------------------
# the engine against the JAX engine, p in {1, 4, 8}
# --------------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("cache_rows", [0, 16])
@pytest.mark.parametrize("p", [1, 4, 8])
def test_epoch_by_index_matches_jax_engine(reference_runs, p, cache_rows,
                                           method):
    if p == 1:
        from repro.core.async_engine import lcc_pipelined as ref_lcc
        from repro.core.cache import build_static_degree_cache as ref_cache
        from repro.core.rma import build_sharded_problem as ref_build
        from repro.graphs.datasets import powerlaw_graph as ref_graph

        g = ref_graph(160, 8, seed=0)
        c = ref_cache(g.degrees, cache_rows) if cache_rows else None
        ref_prob = ref_build(g, 1, n_rounds=3, cache=c)
        want = ref_lcc(ref_prob, method=method)
        prob = rma.ShardedLCCProblem.from_reference(ref_prob)
    else:
        key = f"p{p}_c{cache_rows}"
        prob = carried_problem(reference_runs, key)
        want = (reference_runs[f"{key}_{method}_t"],
                reference_runs[f"{key}_{method}_lcc"])
    dprob = prob.to_device("cpu")
    acc = async_engine._epoch_acc(dprob, method)
    same_engine_output(
        tuple(x.numpy() for x in async_engine._scores(dprob, acc)), want)
    # the padded plain route gives the same S, phantom rows included
    assert torch.equal(acc, async_engine._epoch_plain_acc(dprob, method))


# --------------------------------------------------------------------------
# epoch_land: packed valid prefixes at the exclusive-cumsum offsets
# --------------------------------------------------------------------------
@pytest.mark.parametrize("p,n_rounds,cache_rows", [
    (1, 2, 0), (4, 1, 0), (4, 3, 16), (8, 4, 0)])
def test_epoch_land_packs_valid_prefixes(p, n_rounds, cache_rows):
    g = hub_graph(seed=p)
    prob = problem(g, p, n_rounds, cache_rows)
    if p > 1:
        # a zero-degree row pulled, and a last round with no real serve slot
        isolated = g.n - 1  # owned by the last rank
        k = p - 1
        loc = isolated - prob.part.lo(k)
        assert prob.degrees[k, loc] == 0
        prob.serve_idx[k, 0, 0, -1] = loc
        if n_rounds > 1:
            prob.serve_idx[:, -1] = prob.n_loc
    dprob = prob.to_device("cpu")
    index = ec.epoch_index(dprob)
    totals = prob.pulled_ids_per_round()
    assert dprob.land_ids == int(totals.max(initial=0))
    for r in range(prob.n_rounds):
        flat, lens, off = landing_oracle(prob, r)
        assert np.array_equal(index.land_len[r].numpy(), lens)
        assert np.array_equal(index.land_off[r].numpy(), off)
        assert index.land_off.dtype == torch.int64
        landing = torch.full((max(1, dprob.land_ids),), -7, dtype=torch.int32)
        ec.epoch_land(dprob, index, r, landing)
        assert flat.size == totals[r]
        assert np.array_equal(landing[: flat.size].numpy(), flat)
        assert (landing[flat.size:] == -7).all()  # nothing past the round
    if p > 1 and n_rounds > 1:
        assert totals[-1] == 0
    # cache rows: their valid lengths
    want = (prob.cache_rows < prob.sentinel).sum(-1)
    assert np.array_equal(index.cache_len.numpy(), want)


# --------------------------------------------------------------------------
# epoch_count: the plain version against the padded route's definition
# --------------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("p,n_rounds,cache_rows", [
    (4, 1, 0), (4, 3, 8), (8, 2, 16), (2, 5, 4)])
def test_epoch_count_matches_padded_route(p, n_rounds, cache_rows, method):
    prob = problem(hub_graph(seed=n_rounds), p, n_rounds, cache_rows)
    assert (~prob.edge_mask).any()  # phantom slots are in the rounds
    dprob = prob.to_device("cpu")
    index = ec.epoch_index(dprob)
    regions = np.zeros(3, np.int64)
    for r in range(prob.n_rounds):
        want, reg = count_oracle(prob, r)
        regions += reg
        assert np.array_equal(round_counts(dprob, index, r, method), want)
    # rows of every region were read: local, cache (when kept), landing
    assert regions[0] > 0 and regions[2] > 0
    assert (regions[1] > 0) == (cache_rows > 0)
    hubs = np.flatnonzero(prob.degrees.ravel() > 100)
    assert hubs.size >= 3  # hub x hub pairs
    same_engine_output(
        async_engine.lcc_pipelined(prob, "cpu", method=method),
        async_engine.lcc_pipelined(prob, "cpu", method=method, plain=True))


@pytest.mark.parametrize("method", METHODS)
def test_phantom_slots_add_nothing_and_phantom_row_stays_zero(method):
    prob = problem(hub_graph(seed=5), 4, 3, 8)
    dprob = prob.to_device("cpu")
    want = async_engine._epoch_acc(dprob, method)
    # phantom slots pointing at real rows: the mask alone must keep them out
    phantom = ~prob.edge_mask
    rng = np.random.default_rng(0)
    bad = dataclasses.replace(prob)
    bad.edge_u = prob.edge_u.copy()
    bad.edge_vc = prob.edge_vc.copy()
    bad.edge_u[phantom] = rng.integers(0, prob.n_loc, phantom.sum())
    bad.edge_vc[phantom] = rng.integers(0, prob.n_loc, phantom.sum())
    got = async_engine._epoch_acc(bad.to_device("cpu"), method)
    assert torch.equal(got, want)
    per_rank = got.view(prob.p, prob.n_loc + 1)
    assert (per_rank[:, prob.n_loc] == 0).all()
    assert int(per_rank.sum()) > 0


def test_search_merge_hybrid_agree_on_plain_versions():
    prob = problem(powerlaw_graph(200, 10, seed=3), 4, 3, 16)
    dprob = prob.to_device("cpu")
    index = ec.epoch_index(dprob)
    for r in range(prob.n_rounds):
        got = [round_counts(dprob, index, r, m) for m in METHODS]
        assert np.array_equal(got[0], got[1])
        assert np.array_equal(got[0], got[2])
        assert got[0].sum() > 0


@pytest.mark.parametrize("na,nb,merge", [
    (0, 0, True),        # 0 <= 0
    (5, 0, False),       # 5 <= 0 * ...
    (1, 1, False),       # 2 <= 1 * 1
    (2, 2, True),        # 4 <= 2 * 2
    (3, 3, True),        # 6 <= 3 * 2
    (4, 4, True),        # 8 <= 4 * 3
    (1, 1000, False),    # 1001 <= 1 * 10
    (100, 1000, False),  # 1100 <= 100 * 10
    (111, 1000, False),  # 1111 <= 111 * 10
    (112, 1000, True),   # 1112 <= 112 * 10
    (1000, 112, True),   # the rule is symmetric
    (1023, 1023, True),  # 2046 <= 1023 * 10
    (103, 1023, False),  # 1126 <= 103 * 10: ceil(log2(1024)) = 10
    (103, 1024, True),   # 1127 <= 103 * 11: ceil(log2(1025)) = 11
])
def test_hybrid_choice_hand_checked(na, nb, merge):
    got = ec.hybrid_merges(torch.tensor([na]), torch.tensor([nb]))
    assert got.dtype == torch.bool and bool(got[0]) is merge


@pytest.mark.parametrize("n,bits", [
    (0, 0), (1, 1), (2, 2), (3, 2), (4, 3), (7, 3), (8, 4), (1023, 10),
    (1024, 11), (9754, 14), (2**30, 31), (2**31 - 1, 31)])
def test_bit_length_is_ceil_log2_of_n_plus_1(n, bits):
    assert int(ec.bit_length(torch.tensor([n], dtype=torch.int64))[0]) == bits


def test_epoch_kernels_reject_bad_input():
    prob = problem(hub_graph(), 4, 2, 0).to_device("cpu")
    index = ec.epoch_index(prob)
    landing = torch.zeros(max(1, prob.land_ids), dtype=torch.int32)
    acc = torch.zeros(prob.p * (prob.n_loc + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="method"):
        ec.epoch_count(prob, index, 0, landing, acc, method="merge")
    with pytest.raises(ValueError, match="round"):
        ec.epoch_land(prob, index, prob.n_rounds, landing)
    with pytest.raises(ValueError, match="landing holds"):
        ec.epoch_land(prob, index, 0, landing[: prob.land_ids - 1])
    with pytest.raises(ValueError, match="acc"):
        ec.epoch_count(prob, index, 0, landing, acc.long(), method="hybrid")
    assert ec.launches() == {"epoch_land": 0, "epoch_count": 0}
