"""B9's launch geometry and a numpy model of its split, on the CPU.

``kernels/segment_sum_sorted.py::geometry`` lays a call out from E, D, N and
the SM count; the kernel (``csrc/segment_sum_sorted.cu``) cannot run here,
so ``model_flushes`` mirrors what it does with that geometry: each warp's
run of edges, each lane group's consecutive edges with its head, interior
flushes and tail, and the join across the groups (the segmented scan of
shuffles, step by step). The model's flushes must be exactly the maximal
runs of equal adjacent ids in each warp's run, and their partial sums,
added by id, must equal the plain version and ``jax.ops.segment_sum``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import segment_sum_sorted as ss

N_SM = 132  # an H100 SXM
TOL = 1e-5  # the reference's segment-sum test tolerance
# the aggregations of the GNN paths: MACE's coupling paths (l = 2, 1, 0)
# and readout, gat-cora's messages and softmax denominator, gin-tu x
# ogb_products' layers 2-5 and 1: (E, D, N)
PATH_SHAPES = {
    "mace_l2": (8_192, 640, 3_840),
    "mace_l1": (8_192, 384, 3_840),
    "mace_l0": (8_192, 128, 3_840),
    "mace_readout": (3_840, 1, 128),
    "gat_msg": (10_556, 64, 2_708),
    "gat_denom": (10_556, 8, 2_708),
    "ogb_d64": (61_859_140, 64, 2_449_029),
    "ogb_d100": (61_859_140, 100, 2_449_029),
}
SMALL_SHAPES = {f"d{d}_e{e}": (e, d, 50) for d in (1, 3, 100)
                for e in (0, 1, 777)}
# the least warps an SM that the geometry gives at MACE's shapes
MACE_WARPS_PER_SM = {"mace_l2": 31, "mace_l1": 20, "mace_l0": 6}


def maximal_runs(seg, lo, hi):
    """The maximal runs of equal adjacent ids in ``seg[lo:hi]``:
    (id, first edge, end)."""
    out, q = [], lo
    while q < hi:
        r = q
        while r + 1 < hi and seg[r + 1] == seg[q]:
            r += 1
        out.append((int(seg[q]), q, r + 1))
        q = r + 1
    return out


def model_flushes(geo, seg):
    """What the kernel flushes, run by run: (id, sorted edge list), in the
    kernel's order of decisions. One lane's view stands for every chunk:
    all lanes of a group see the same ids."""
    e = len(seg)
    g = geo.groups
    out = []
    for run in range(geo.warps // geo.pieces):
        has, first, cur, split = [False] * g, [0] * g, [0] * g, [False] * g
        head, tail = [[] for _ in range(g)], [[] for _ in range(g)]
        for k in range(g):
            edges = geo.edges(run, k, e)
            if not edges:
                continue
            has[k] = True
            first[k] = cur[k] = int(seg[edges.start])
            acc = []
            for q in edges:
                if seg[q] != cur[k]:
                    if split[k]:
                        out.append((cur[k], acc))
                    else:
                        head[k], split[k] = acc, True
                    cur[k], acc = int(seg[q]), []
                acc.append(q)
            tail[k] = acc
        # the join: k joins k - 1 if its first id is k - 1's last
        joins = [has[k] and k > 0 and cur[k - 1] == first[k]
                 for k in range(g)]
        starts = [not (joins[k] and not split[k]) for k in range(g)]
        k0 = [max(j for j in range(k + 1) if starts[j]) for k in range(g)]
        s = 1
        while s < g:  # Hillis-Steele, each step reading the last step's
            tail = [tail[k] + tail[k - s] if k - s >= k0[k] else tail[k]
                    for k in range(g)]
            s *= 2
        for k in range(g):
            if not has[k]:
                continue
            if split[k]:
                out.append((first[k], head[k] + (tail[k - 1] if joins[k]
                                                 else [])))
            if not (k + 1 < g and joins[k + 1]):
                out.append((cur[k], tail[k]))
    return [(i, sorted(edges)) for i, edges in out]


def draw_ids(kind, e, n, rng):
    seg = np.sort(rng.integers(0, n, size=e))
    if kind == "padded":
        seg[-e // 4:] = n
    elif kind == "negative":
        seg[: e // 3] = -1 - rng.integers(0, 3, size=e // 3)
        seg = np.sort(seg)
    elif kind == "unsorted":
        seg = rng.permutation(seg)
    elif kind == "zipf":  # segment sizes ~ Zipf(1.5), sorted
        seg = np.sort((rng.zipf(1.5, e) - 1) % n)
    elif kind == "one":
        seg = np.full(e, n // 2)
    return seg.astype(np.int64)


def grid(vals, kind):
    """Values on a 2^-10 grid where segments are long: their fp32 sums are
    then exact in any order, so the plain version's own rounding cannot
    blur the check (as the card's checks do)."""
    return np.round(vals * 1024) / 1024 if kind in ("zipf", "one") else vals


def check_geometry(geo, e, d):
    assert geo.vec in (1, 2, 4) and d % geo.vec == 0
    assert geo.chunks * geo.vec == d
    assert 1 <= geo.lpr <= 32 and geo.groups == 32 // geo.lpr
    assert 1 <= geo.steps <= ss.MAX_STEPS
    runs, rest = divmod(geo.warps, geo.pieces)
    assert rest == 0
    # every edge in exactly one run: the runs tile [0, E)
    assert runs * geo.run >= e and (runs - 1) * geo.run < max(e, 1)
    if e <= 10_000:
        seen = np.zeros(e, np.int64)
        for r in range(runs):
            for k in range(geo.groups):
                for q in geo.edges(r, k, e):
                    seen[q] += 1
        assert (seen == 1).all()
    # every chunk in exactly one lane group of one piece, a lane each
    for k in range(geo.groups):
        taken = [geo.lane(lane, p) for p in range(geo.pieces)
                 for lane in range(k * geo.lpr, (k + 1) * geo.lpr)]
        chunks = sorted(c for t in taken if t is not None for c in t[1:])
        assert chunks == list(range(geo.chunks))
        assert all(t[0] == k for t in taken if t is not None)
    assert all(geo.lane(lane, p) is None for p in range(geo.pieces)
               for lane in range(geo.groups * geo.lpr, 32))
    # the grid within CUDA's limits
    assert geo.blocks * ss.KWARPS >= geo.warps > geo.blocks * ss.KWARPS - 8
    assert geo.blocks <= 2**31 - 1


@pytest.mark.parametrize("name", sorted(PATH_SHAPES) + sorted(SMALL_SHAPES))
def test_geometry_covers_every_edge_and_chunk(name):
    e, d, n = {**PATH_SHAPES, **SMALL_SHAPES}[name]
    geo = ss.geometry(e, d, n, N_SM)
    check_geometry(geo, e, d)
    if name in MACE_WARPS_PER_SM:
        assert geo.warps / N_SM >= MACE_WARPS_PER_SM[name]
    if name.startswith("ogb"):  # the long runs of the first design
        assert geo.steps == ss.MAX_STEPS
    if e:  # a run never spans fewer than RUN_SEGMENTS average segments
        assert (geo.run * n >= ss.RUN_SEGMENTS * e
                or geo.steps == ss.MAX_STEPS)


def test_geometry_widths_and_alignment():
    """Rows of 640 floats in five pieces of 32 lanes; 64 in two groups of
    16; 8 in sixteen groups of 2; 1 and 3 a float a lane; 100 in 25 lanes
    of 16 bytes; a misaligned 16-byte row in 8-byte loads."""
    got = {d: ss.geometry(8_192, d, 3_840, N_SM)
           for d in (640, 384, 128, 100, 64, 8, 3, 1)}
    assert [(got[d].vec, got[d].pieces, got[d].lpr, got[d].groups)
            for d in (640, 384, 128, 100, 64, 8, 3, 1)] == [
        (4, 5, 32, 1), (4, 3, 32, 1), (4, 1, 32, 1), (4, 1, 25, 1),
        (4, 1, 16, 2), (4, 1, 2, 16), (1, 1, 3, 10), (1, 1, 1, 32)]
    assert ss.geometry(100, 64, 10, N_SM, ptr=8).vec == 2
    assert ss.geometry(100, 64, 10, N_SM, ptr=4).vec == 1
    assert ss.geometry(100, 66, 10, N_SM).vec == 2
    assert ss.geometry(100, 130, 10, N_SM).pieces == 3  # 65 chunks of 2
    assert ss.geometry(0, 64, 10, N_SM).blocks == 0


@pytest.mark.parametrize("kind", ["sorted", "padded", "negative", "unsorted",
                                  "zipf", "one"])
@pytest.mark.parametrize("d", [1, 3, 8, 64, 100, 640])
def test_model_of_the_split_equals_the_plain_version(kind, d):
    """The kernel's split on the geometry the wrapper gives, at a small
    card (so that runs are short and groups join): flushes == the maximal
    runs of equal adjacent ids of each warp's run (one a segment and run
    for sorted ids), and their sums added by id == the plain version."""
    rng = np.random.default_rng(d + len(kind))
    e, n = 1_500, 60
    seg = draw_ids(kind, e, n, rng)
    vals = grid(rng.normal(size=(e, d)).astype(np.float32), kind)
    for n_sm in (1, 4, N_SM):
        geo = ss.geometry(e, d, n, n_sm)
        flushes = model_flushes(geo, seg)
        want = [(i, list(range(lo, hi)))
                for r in range(geo.warps // geo.pieces)
                for i, lo, hi in maximal_runs(seg, r * geo.run,
                                              min(e, (r + 1) * geo.run))]
        assert sorted(flushes) == sorted(want)
        out = np.zeros((n, d), np.float64)
        for i, edges in flushes:
            if 0 <= i < n:
                out[i] += vals[edges].astype(np.float64).sum(0)
        plain = ss.segment_sum_sorted_ref(
            torch.from_numpy(vals), torch.from_numpy(seg), num_segments=n)
        np.testing.assert_allclose(out, plain.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("groups", [1, 2, 3, 10, 16, 32])
@pytest.mark.parametrize("steps", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kind", ["sorted", "padded", "negative", "unsorted",
                                  "zipf", "one"])
def test_model_joins_groups_at_every_geometry(groups, steps, kind):
    """The join across lane groups at every group count the widths give
    (and 3: a count that is no power of two) and short walks, so that
    chains of single-run groups cross the scan's steps; E that no run
    divides leaves empty groups in the last run. Sums against
    ``jax.ops.segment_sum``."""
    rng = np.random.default_rng(groups * 31 + steps)
    e, n = 997, 40
    seg = draw_ids(kind, e, n, rng)
    run = groups * steps
    warps = -(-e // run)
    geo = ss.Geometry(1, 1, 1, 32 // groups, groups, steps, warps,
                      -(-warps // ss.KWARPS))
    flushes = model_flushes(geo, seg)
    want = [(i, list(range(lo, hi))) for r in range(warps)
            for i, lo, hi in maximal_runs(seg, r * run, min(e, (r + 1) * run))]
    assert sorted(flushes) == sorted(want)
    vals = grid(rng.normal(size=e).astype(np.float32), kind)
    out = np.zeros(n, np.float64)
    for i, edges in flushes:
        if 0 <= i < n:
            out[i] += vals[edges].astype(np.float64).sum()
    ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                              num_segments=n)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["mace_l2", "mace_l0", "gat_denom",
                                  "mace_readout"])
def test_flushes_near_one_a_segment_at_the_path_shapes(name):
    """At the path's own shapes and sorted ids drawn as the path draws them
    (MACE: each graph's 64 edges among its 30 nodes; gat-cora: uniform),
    the model flushes each nonempty segment once, plus at most one a run
    boundary: no more than N / RUN_SEGMENTS in all."""
    e, d, n = PATH_SHAPES[name]
    rng = np.random.default_rng(5)
    if name == "mace_readout":
        seg = np.arange(e) // 30
    elif name.startswith("mace"):
        seg = np.sort(np.arange(e) // 64 * 30 + rng.integers(0, 30, e))
    else:
        seg = np.sort(rng.integers(0, n, e))
    geo = ss.geometry(e, d, n, N_SM)
    flushes = model_flushes(geo, seg)
    segments = len(np.unique(seg))
    runs = geo.warps // geo.pieces
    assert segments <= len(flushes) <= segments + runs - 1
    assert runs <= -(-n // ss.RUN_SEGMENTS)
