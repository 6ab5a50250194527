"""The ragged row store of the LCC epoch (``core/rma.py``): each rank's local
rows held as offsets into one packed id array, never padded to the largest
degree on the engine's path.

On seeded small GAP kron and urand graphs (the benchmark's frozen
generators) and on a star whose hub is longer than the count's stage cap
(``_STAGE_IDS``, the ids the wrapper lets a heavy pair stage), at p in {1, 3,
8} and a degree cache of 0 or 16 rows: the kernels' route (its plain
versions on the CPU, reading the store), the padded plain route and the
benchmark's independent reference count the same triangles; the store's
padded view equals the JAX reference's padded rows field for field. On the
CPU the stage cap is cut to 256 ids, so the star's padded rows stay small
(the plain versions pad every slot's row to the hub's width); on a card
(``gpu`` marker) the star is 10,304 ids wide against the kernel's own cap of
10,240. A graph whose padded rows would take 8.6 GB is built and uploaded in
a subprocess that stays under 1 GB."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench.reference.generators import kron_edges, urand_edges
from gpubench.reference.triangles import lcc_float64, triangles_per_vertex
from repro_torch.core import async_engine, cache, csr, rma
from repro_torch.kernels import epoch_count as ec
from repro_torch.obs import trace as obs_trace

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
METHODS = ("bsearch", "pairwise", "hybrid")
# the stage cap of the CPU tests (the card's tests keep the wrapper's own)
CPU_STAGE_IDS = 256


def star_edges(seed: int, leaves: int) -> np.ndarray:
    """Hub 0 joined to ``leaves`` leaves 1..leaves, a ring over the leaves,
    and 8 sub-hubs (leaves 1-8) each joined to ``leaves // 32`` random
    leaves: hub x sub-hub pairs search the hub's row (at 10,304 leaves,
    heavy pairs whose longer row exceeds the stage)."""
    rng = np.random.default_rng(seed)
    ids = np.arange(1, leaves + 1)
    parts = [np.stack([np.zeros_like(ids), ids], 1),
             np.stack([ids, np.roll(ids, 1)], 1)]
    for h in range(1, 9):
        parts.append(np.stack([np.full(leaves // 32, h),
                               rng.choice(ids, leaves // 32)], 1))
    return np.concatenate(parts)


def graph(name: str, seed: int = 1):
    """(raw edges, n, CSR) of a seeded small graph; the star is one hub
    64 ids longer than the current ``_STAGE_IDS``."""
    if name == "kron":
        edges, n = kron_edges(8, 8, 0.57, 0.19, 0.19, seed), 256
    elif name == "urand":
        edges, n = urand_edges(9, 6, seed), 512
    else:
        leaves = ec._STAGE_IDS + 64
        edges, n = star_edges(seed, leaves), leaves + 1
    return edges, n, csr.from_edges(edges.copy(), n, undirected=True)


def problem(g, p: int, cache_rows: int, n_rounds: int = 4):
    c = (cache.build_static_degree_cache(g.degrees, cache_rows)
         if cache_rows else None)
    return rma.build_sharded_problem(g, p, n_rounds=n_rounds, cache=c)


def global_order(out: np.ndarray, n: int) -> np.ndarray:
    return np.asarray(out).reshape(-1)[:n]


@pytest.fixture
def cpu_stage(monkeypatch):
    monkeypatch.setattr(ec, "_STAGE_IDS", CPU_STAGE_IDS)


@pytest.mark.parametrize("cache_rows", [0, 16])
@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("name", ["kron", "urand", "star"])
def test_routes_and_reference_agree_on_the_store(name, p, cache_rows,
                                                 cpu_stage):
    """The kernels' route on the store, the padded plain route and the
    benchmark's reference: ``t`` equal exactly, LCC within float32."""
    edges, n, g = graph(name)
    prob = problem(g, p, cache_rows)
    # 1D blocks of ceil(n / p): rank-major output is vertex order
    assert prob.row_ids.size == g.m
    assert g.max_degree > ec._STAGE_IDS or name != "star"
    dprob = prob.to_device("cpu")
    t_ref, deg = triangles_per_vertex(edges, n)
    lcc_ref = lcc_float64(t_ref, deg).numpy()
    assert int(t_ref.sum()) > 0
    for method in METHODS:
        t, lcc = async_engine.lcc_pipelined(dprob, "cpu", method=method)
        t_p, lcc_p = async_engine.lcc_pipelined(dprob, "cpu", method=method,
                                                plain=True)
        np.testing.assert_array_equal(t, t_p)
        np.testing.assert_array_equal(lcc, lcc_p)
        np.testing.assert_array_equal(global_order(t, n), t_ref.numpy())
        np.testing.assert_allclose(global_order(lcc, n), lcc_ref, rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("cache_rows", [0, 16])
@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("name", ["kron", "urand", "star"])
def test_padded_view_equals_the_references_problem(name, p, cache_rows,
                                                   cpu_stage):
    from repro.core import cache as ref_cache
    from repro.core import csr as ref_csr
    from repro.core import rma as ref_rma

    edges, n, g = graph(name)
    want_g = ref_csr.from_edges(edges.copy(), n, undirected=True)
    want_c = (ref_cache.build_static_degree_cache(want_g.degrees, cache_rows)
              if cache_rows else None)
    want = ref_rma.build_sharded_problem(want_g, p, n_rounds=4, cache=want_c)
    got = problem(g, p, cache_rows)
    rma.assert_problems_equal(got, want)
    # and back: the reference's padded rows make the same store
    back = rma.ShardedLCCProblem.from_reference(want)
    np.testing.assert_array_equal(back.row_off, got.row_off)
    np.testing.assert_array_equal(back.row_ids, got.row_ids)
    rma.assert_problems_equal(back, got)


@pytest.mark.parametrize("name", ["kron", "star"])
def test_device_padded_rows_equal_the_host_view(name, cpu_stage):
    _, _, g = graph(name)
    prob = problem(g, 3, 16)
    dprob = prob.to_device("cpu")
    want = prob.rows_ext
    assert want.shape == (3, prob.n_loc + 1, prob.width)
    np.testing.assert_array_equal(dprob.rows_ext.numpy(), want)
    rows = torch.tensor([3 * (prob.n_loc + 1) - 1, 0, prob.n_loc, 5, 5])
    np.testing.assert_array_equal(
        dprob.padded_rows(rows).numpy(),
        rma.pad_rows(prob.row_off, prob.row_ids, rows.numpy(), prob.width,
                     prob.sentinel))
    assert dprob.row_off.dtype == torch.int64
    assert dprob.row_ids.dtype == torch.int32
    assert dprob.width == prob.width
    assert dprob.row_store_bytes() == (prob.row_ids.nbytes
                                       + prob.row_off.nbytes
                                       + prob.cache_rows.nbytes)


def test_a_width_below_a_degree_is_refused():
    _, _, g = graph("kron")
    with pytest.raises(rma.ScheduleWidthOverflow):
        rma.build_sharded_problem(g, 4, n_rounds=2, width=g.max_degree - 1)


@pytest.mark.parametrize("p", [1, 3])
def test_apply_delta_splices_the_store(p):
    """Deltas patch the store in place as a fresh build lays it out."""
    edges, n, g = graph("kron", seed=4)
    prob = problem(g, p, 16)
    wide = rma.build_sharded_problem(g, p, n_rounds=4, width=prob.width + 8,
                                     cache=cache.StaticDegreeCache(
                                         vertex_ids=prob.cache_ids))
    adj = set(map(tuple, np.stack(g.edge_list(), 1).tolist()))
    rng = np.random.default_rng(0)
    live = np.flatnonzero(g.degrees > 0)
    ins = []
    while len(ins) < 6:
        u, v = sorted(int(x) for x in rng.choice(live, 2, replace=False))
        if (u, v) not in adj and [u, v] not in ins:
            ins.append([u, v])
    ins = np.array(ins, np.int64)
    src, dst = g.edge_list()
    pick = rng.choice(np.flatnonzero(src < dst), 5, replace=False)
    dele = np.stack([src[pick], dst[pick]], 1).astype(np.int64)
    wide.apply_delta(ins, dele)
    new_edges = set(adj) | {tuple(e) for e in ins.tolist()} | {
        (b, a) for a, b in ins.tolist()}
    new_edges -= {tuple(e) for e in dele.tolist()} | {
        (b, a) for a, b in dele.tolist()}
    g2 = csr.from_edges(np.array(sorted(new_edges)), n, undirected=True)
    fresh = rma.build_sharded_problem(g2, p, n_rounds=4, width=wide.width,
                                      cache=cache.StaticDegreeCache(
                                          vertex_ids=wide.cache_ids))
    rma.assert_problems_equal(wide, fresh)
    assert wide.row_off[-1] == wide.row_ids.size == g2.m


def test_schedule_spans_carry_the_stores_sizes():
    _, _, g = graph("kron")
    tracer = obs_trace.enable_tracing()
    try:
        prob = problem(g, 8, 16)
        dprob = prob.to_device("cpu")
    finally:
        obs_trace.disable_tracing()
    ev = {e["name"]: e for e in tracer.events if e["ph"] == "X"}
    assert ev["schedule.rows"]["args"] == {
        "ids": g.m,
        "padded_ids_not_allocated": 8 * (prob.n_loc + 1) * prob.width - g.m}
    assert ev["schedule.upload"]["args"] == {
        "row_store_bytes": dprob.row_store_bytes()}


def numpy_heavy_share(prob, dprob) -> float:
    """Real slots outside the pieces whose hybrid work passes kHeavyWork,
    counted slot by slot from the host problem."""
    runs = ec.count_runs(dprob)
    covered = np.zeros(prob.edge_mask.size, bool)
    for e, k in zip(runs.piece_e.tolist(), runs.piece_n.tolist()):
        covered[e: e + k] = True
    covered = covered.reshape(prob.edge_mask.shape)
    n_loc, c = prob.n_loc, prob.cache_rows.shape[0]
    e_chunk = prob.e_max // prob.n_rounds
    cache_len = (prob.cache_rows < prob.sentinel).sum(-1)
    heavy = real = 0
    for k in range(prob.p):
        for j in np.flatnonzero(prob.edge_mask[k]):
            u, vc = int(prob.edge_u[k, j]), int(prob.edge_vc[k, j])
            if u >= n_loc:
                continue
            real += 1
            na = int(prob.degrees[k, u])
            if vc < n_loc:
                nb = int(prob.degrees[k, vc])
            elif vc == n_loc:
                nb = 0
            elif vc < n_loc + 1 + c:
                nb = int(cache_len[vc - n_loc - 1])
            else:
                item = vc - n_loc - 1 - c
                src, slot = divmod(item, prob.s_max)
                loc = int(prob.serve_idx[src, j // e_chunk, k, slot])
                nb = int(prob.degrees[src, loc]) if loc < n_loc else 0
            ns, nl = min(na, nb), max(na, nb)
            search = ns * int(nl).bit_length()
            work = na + nb if na + nb <= search else search
            heavy += int(not covered[k, j] and na > 0 and nb > 0
                         and work > ec._HEAVY_WORK)
    return heavy / real


@pytest.mark.parametrize("pieces", [True, False], ids=["pieces", "tiles"])
@pytest.mark.parametrize("name,p,cache_rows",
                         [("kron", 3, 16), ("star", 8, 0), ("star", 1, 16)])
def test_heavy_slot_share_counts_the_tiles_heavy_pairs(name, p, cache_rows,
                                                       pieces, monkeypatch):
    """The share against a slot-by-slot count, with the run table's pieces
    and without any (a bitmap too large for the block, as at 2^19 ids):
    the star's hub x sub-hub pairs are heavy there."""
    _, _, g = graph(name)
    prob = problem(g, p, cache_rows)
    if not pieces:
        monkeypatch.setattr(ec, "bitmap_fits", lambda prob: False)
    dprob = prob.to_device("cpu")
    got = ec.heavy_slot_share(dprob)
    assert got == pytest.approx(numpy_heavy_share(prob, dprob), abs=1e-12)
    assert 0.0 <= got + ec.bitmap_slot_share(dprob) <= 1.0
    if name == "star" and not pieces:
        assert ec.bitmap_slot_share(dprob) == 0.0 and got > 0.0


_NO_PADDED_ROWS = r"""
import json, resource, sys
import numpy as np
from repro_torch.core.cache import build_static_degree_cache
from repro_torch.core.csr import from_edges
from repro_torch.core.rma import build_sharded_problem

n, hub = 1 << 16, 1 << 15
rng = np.random.default_rng(0)
leaves = np.arange(1, hub + 1)
ring = np.stack([np.arange(n), np.roll(np.arange(n), 1)], 1)
edges = np.concatenate([np.stack([np.zeros_like(leaves), leaves], 1), ring,
                        rng.integers(0, n, size=(n, 2))])
g = from_edges(edges, n, undirected=True)
prob = build_sharded_problem(g, 8, n_rounds=4,
                             cache=build_static_degree_cache(g.degrees, 16))
dprob = prob.to_device("cpu")
print(json.dumps({
    "width": prob.width, "n_loc": prob.n_loc, "m": int(g.m),
    "ids": int(dprob.row_ids.numel()),
    "maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
}))
"""


# Linux carries the peak of the image an exec replaces into ru_maxrss, and a
# subprocess of a test worker starts as the worker's image: a small launcher
# starts the measured interpreter, so its peak is its own
_LAUNCH = ("import subprocess, sys; "
           "sys.exit(subprocess.run([sys.executable, '-c', sys.argv[1]])"
           ".returncode)")


def test_build_and_upload_allocate_no_padded_rows():
    """n = 2^16 with a hub of degree 2^15: its padded rows at p = 8 would
    take 8 x (8,192 + 1) x 32,768 x 4 B = 8.6 GB; the build and the upload
    stay under 1 GB of resident memory, interpreter and torch included."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _LAUNCH, _NO_PADDED_ROWS],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["width"] >= 1 << 15
    padded = 8 * (rec["n_loc"] + 1) * rec["width"] * 4
    assert padded > 8.5e9
    assert rec["ids"] == rec["m"]
    assert rec["maxrss_bytes"] < 1 << 30, rec


@pytest.mark.gpu
@pytest.mark.parametrize("bitmap", [True, False], ids=["pieces", "tiles"])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_wide_star_on_card_matches_the_reference(p, bitmap, monkeypatch):
    """The CUDA kernels on the store at the wrapper's own stage cap: a hub
    of 10,304 ids (64 past ``_STAGE_IDS``), its hub x sub-hub pairs heavy
    searches of a row the stage cannot hold; with the run table's pieces
    and with none, so the tiles count the hub's run. ``t`` equals the
    benchmark's reference and LCC is within float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: no CUDA device found")
    if not bitmap:
        monkeypatch.setattr(ec, "bitmap_fits", lambda prob: False)
    edges, n, g = graph("star")
    assert g.max_degree > ec._STAGE_IDS
    dprob = problem(g, p, 16).to_device("cuda")
    assert ec.heavy_slot_share(dprob) > 0.0 or bitmap
    t_ref, deg = triangles_per_vertex(edges, n, "cuda")
    lcc_ref = lcc_float64(t_ref, deg).cpu().numpy()
    for method in METHODS:
        t, lcc = async_engine.lcc_pipelined(dprob, "cuda", method=method)
        np.testing.assert_array_equal(global_order(t, n), t_ref.cpu().numpy())
        np.testing.assert_allclose(global_order(lcc, n), lcc_ref, rtol=1e-6,
                                   atol=0)
