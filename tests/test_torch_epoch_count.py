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


# --------------------------------------------------------------------------
# the run table (count_runs): hub runs counted against a bitmap
# --------------------------------------------------------------------------
SMALL_RUNS = {"_MIN_RUN": 8, "_PIECE_SLOTS": 16, "_BITMAP_Q": 64}


def runs_graph(n=600, hubs=(0, 149, 300, 599), seed=0, extra=900):
    """Hubs adjacent to every vertex (with p = 4 two are the last vertex of
    a rank, so a run ends at a rank's last slot), random edges beside."""
    rng = np.random.default_rng(seed)
    edges = [(h, v) for h in hubs for v in range(n) if v != h]
    edges += [tuple(e) for e in rng.integers(0, n, size=(extra, 2))]
    return from_edges(np.array(edges), n, undirected=True)


def flat_graph(n=512, deg=16, seed=0):
    """Uniform random edges: every degree far below a kept run."""
    rng = np.random.default_rng(seed)
    return from_edges(rng.integers(0, n, size=(n * deg // 2, 2)), n,
                      undirected=True)


def no_room(monkeypatch):
    """No shared memory left for a bitmap: a stage of 16 ids, nothing free
    beside it (the card then stages rows of at most 16 ids)."""
    monkeypatch.setattr(ec, "_STAGE_IDS", 16)
    monkeypatch.setattr(ec, "_FREE_SMEM", 0)


def rule_oracle(prob, g):
    """The kept runs by the rule, by loops over the host problem: [(rank,
    first slot, slots)]; each slot's v row has its degree's valid ids."""
    e_chunk = prob.e_max // prob.n_rounds
    words = 4 * -(-prob.n // 128)  # in whole 16-byte groups
    kept = []
    stage = 4 * min(prob.width, ec._STAGE_IDS)
    if 16 * -(-prob.n // 128) + ec._PIECE_SCRATCH > max(stage, ec._FREE_SMEM):
        return kept
    for k, (u_l, v_g) in enumerate(prob.works):
        j = 0
        while j < u_l.size:
            end = j + 1
            while (end < u_l.size and u_l[end] == u_l[j]
                   and end // e_chunk == j // e_chunk):
                end += 1
            na = int(prob.degrees[k, u_l[j]])
            compares = streamed = 0
            for v in v_g[j:end]:
                nb = int(g.degrees[v])
                ns, nl = min(na, nb), max(na, nb)
                merge = na + nb <= ns * int(nl).bit_length()
                compares += na + nb if merge else ns * int(nl).bit_length()
                streamed += nb
            pieces = -(-(end - j) // ec._PIECE_SLOTS)
            cost = pieces * (words + na) + streamed
            if end - j >= ec._MIN_RUN and 4 * cost <= ec._BITMAP_Q * compares:
                kept.append((k, j, end - j))
            j = end
    return kept


def coverage(prob, runs):
    """[p * e_max] times each slot is covered by a piece and by a tile."""
    pieces = np.zeros(prob.p * prob.e_max, np.int64)
    tiles = np.zeros_like(pieces)
    for e, n in zip(runs.piece_e.tolist(), runs.piece_n.tolist()):
        pieces[e: e + n] += 1
    if runs.tiles is not None:
        for t in runs.tiles.tolist():
            assert 1 <= t % 32 <= ec._TILE_SLOTS
            tiles[t // 32: t // 32 + t % 32] += 1
    return pieces, tiles


def real_slots(prob):
    return (prob.edge_mask & (prob.edge_u < prob.n_loc)).reshape(-1)


@pytest.mark.parametrize("small", [False, True], ids=["rule", "small_runs"])
@pytest.mark.parametrize("p,n_rounds,cache_rows", [
    (1, 1, 0), (4, 3, 8), (8, 2, 16), (2, 5, 4)])
def test_run_table_covers_each_kept_slot_once(monkeypatch, p, n_rounds,
                                              cache_rows, small):
    if small:
        for name, v in SMALL_RUNS.items():
            monkeypatch.setattr(ec, name, v)
    g = runs_graph(n=1200, hubs=(0, 299, 600, 1199), seed=p)
    prob = problem(g, p, n_rounds, cache_rows)
    runs = ec.count_runs(prob.to_device("cpu"))
    kept = rule_oracle(prob, g)
    assert kept  # the hubs' runs qualify
    want = np.zeros(p * prob.e_max, np.int64)
    for k, j, n in kept:
        want[k * prob.e_max + j: k * prob.e_max + j + n] = 1
    pieces, tiles = coverage(prob, runs)
    assert np.array_equal(pieces, want)
    real = real_slots(prob)
    # every other real slot is in exactly one tile; no phantom slot in any
    assert np.array_equal(tiles, (real & (want == 0)).astype(np.int64))
    e_chunk = prob.e_max // prob.n_rounds
    rounds = (runs.piece_e % prob.e_max // e_chunk).tolist()
    assert rounds == sorted(rounds)
    for r in range(prob.n_rounds):
        got = rounds[runs.piece_start[r]: runs.piece_start[r + 1]]
        assert got == [r] * len(got)
    flat_u = prob.edge_u.reshape(-1)
    for e, n in zip(runs.piece_e.tolist(), runs.piece_n.tolist()):
        assert 1 <= n <= ec._PIECE_SLOTS
        assert e // e_chunk == (e + n - 1) // e_chunk  # one (rank, round)
        assert len(set(flat_u[e: e + n].tolist())) == 1
    assert runs.covered == int(want.sum()) and runs.real == int(real.sum())
    assert ec.bitmap_slot_share(prob.to_device("cpu")) == pytest.approx(
        want.sum() / real.sum(), rel=1e-12)
    assert runs.piece_n.dtype == torch.int32
    if small:  # hub runs longer than one piece
        assert max(n for _, _, n in kept) > ec._PIECE_SLOTS


def urand_like_graph(seed=0):
    """Flat degrees (at most 61, the urand cell's largest) over the urand
    cell's id space of 2^19: 8,192 vertices with edges, spread over it."""
    rng = np.random.default_rng(seed)
    n = 1 << 19
    vs = rng.choice(n, 8192, replace=False)
    return from_edges(vs[rng.integers(0, vs.size, size=(8192 * 18, 2))], n,
                      undirected=True)


@pytest.mark.parametrize("graph", ["flat", "urand_like", "no_room"])
def test_run_table_without_a_piece(monkeypatch, graph):
    if graph == "no_room":
        g = runs_graph()
        no_room(monkeypatch)
    elif graph == "flat":
        g = flat_graph()
    else:  # a 64 KB bitmap would cost the tile blocks occupancy
        g = urand_like_graph()
        assert 40 <= g.degrees.max() <= 61
    prob = problem(g, 8 if graph == "urand_like" else 4, 3, 8)
    dprob = prob.to_device("cpu")
    runs = ec.count_runs(dprob)
    assert runs.piece_e.numel() == 0 and runs.covered == 0
    assert runs.tiles is None and runs.tile_start is None
    assert runs.piece_start == (0,) * (prob.n_rounds + 1)
    assert ec.bitmap_slot_share(dprob) == 0.0
    assert runs.real == int(real_slots(prob).sum()) > 0
    assert ec.bitmap_fits(dprob) == (graph == "flat")


def test_run_table_is_built_once_a_problem():
    dprob = problem(runs_graph(), 4, 3, 8).to_device("cpu")
    first = ec.count_runs(dprob)
    assert ec.count_runs(dprob) is first
    assert ec.epoch_index(dprob).runs is first
    assert ec.count_runs(problem(runs_graph(), 4, 3, 8).to_device(
        "cpu")) is not first


# --------------------------------------------------------------------------
# on the card: pieces and tiles against the plain version and padded route
# --------------------------------------------------------------------------
def card_counts_match(prob, min_pieces=0):
    """Round by round, every method: the card's epoch_count against the
    plain version on the CPU; the whole epoch against the padded route.
    Returns the problem's run table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    dprob, cprob = prob.to_device("cuda"), prob.to_device("cpu")
    index, cindex = ec.epoch_index(dprob), ec.epoch_index(cprob)
    assert index.runs.piece_e.numel() >= min_pieces
    width = prob.p * (prob.n_loc + 1)
    for r in range(prob.n_rounds):
        land = torch.full((max(1, dprob.land_ids),), -7, dtype=torch.int32,
                          device="cuda")
        ec.epoch_land(dprob, index, r, land)
        want = ec.epoch_count_ref(cprob, cindex, r, land.cpu(),
                                  torch.zeros(width, dtype=torch.int32),
                                  method="bsearch")
        for method in METHODS:
            acc = torch.zeros(width, dtype=torch.int32, device="cuda")
            ec.epoch_count(dprob, index, r, land, acc, method=method)
            torch.cuda.synchronize()
            assert torch.equal(acc.cpu(), want), (r, method)
    for method in METHODS:
        assert torch.equal(async_engine._epoch_acc(dprob, method).cpu(),
                           async_engine._epoch_plain_acc(cprob, method))
    return index.runs


def piece_regions(prob, runs):
    """Slots of the pieces by v's region: local, cache, landing."""
    c = prob.cache_rows.shape[0]
    vc = prob.edge_vc.reshape(-1)
    out = np.zeros(3, np.int64)
    for e, n in zip(runs.piece_e.tolist(), runs.piece_n.tolist()):
        v = vc[e: e + n]
        out += [(v <= prob.n_loc).sum(),
                ((v > prob.n_loc) & (v < prob.n_loc + 1 + c)).sum(),
                (v >= prob.n_loc + 1 + c).sum()]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("small", [False, True], ids=["rule", "small_runs"])
def test_hub_runs_by_bitmap_on_card(monkeypatch, small):
    """Hub runs longer than one piece, runs across a round chunk and at a
    rank's last slot, v rows of all three regions (the hubs cached, so a
    hub u's own row is a cache row on the other ranks)."""
    if small:
        for name, v in SMALL_RUNS.items():
            monkeypatch.setattr(ec, name, v)
    g = runs_graph(n=1200, hubs=(0, 299, 600, 1199))
    prob = problem(g, 4, 3, 8)
    runs = card_counts_match(prob, min_pieces=1)
    assert (piece_regions(prob, runs) > 0).all()
    assert max(n for _, _, n in rule_oracle(prob, g)) > ec._PIECE_SLOTS
    e_chunk = prob.e_max // prob.n_rounds
    ends = {(e + n) % prob.e_max for e, n in zip(runs.piece_e.tolist(),
                                                 runs.piece_n.tolist())}
    assert any(x % e_chunk == 0 for x in ends)  # a run cut by its chunk
    last = {int(prob.edge_mask[k].sum()) for k in range(prob.p)}
    assert ends & last  # a run at a rank's last real slot


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flat", "no_room", "one_rank"])
def test_count_without_pieces_or_on_one_rank_on_card(monkeypatch, case):
    """A flat graph (no piece), no room for a bitmap (no piece: the same
    integers), and one rank and round with small runs."""
    if case == "flat":
        prob = problem(flat_graph(), 4, 3, 8)
    elif case == "no_room":
        no_room(monkeypatch)
        prob = problem(runs_graph(), 4, 3, 8)
    else:
        for name, v in SMALL_RUNS.items():
            monkeypatch.setattr(ec, name, v)
        prob = problem(runs_graph(seed=3), 1, 1, 0)
    runs = card_counts_match(prob)
    assert (runs.piece_e.numel() > 0) == (case == "one_rank")
