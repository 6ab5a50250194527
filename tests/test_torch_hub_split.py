"""The port's neighbour sampler, hub-replication gather and GAT's hub-split
attention held against the reference on the same seeded numpy inputs.

Tolerances, each with its reason:

- the sampler's blocks, ``split_hot_cold``'s plans and ``hub_gather``:
  exact (the same numpy code and draws; a gather copies values);
- GAT logits and gradients, split against the reference's split and
  against the port's own unsplit batch: 1e-5, as the GNN tests of
  ``tests/test_torch_train.py`` (the same fp32 math summed in another
  order: the port sorts each stream by destination, B9 sums by segment).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import inputs as ref_inputs
from repro.distributed import hub_gather as ref_hub
from repro.graphs import datasets as ref_datasets
from repro.graphs import rmat as ref_rmat
from repro.graphs import sampler as ref_sampler
from repro.models.gnn import gat as ref_gat
from repro.train import train_loop as ref_tl
from repro_torch.configs import inputs, registry
from repro_torch.core.csr import CSRGraph
from repro_torch.distributed.hub_gather import (
    HotColdPlan,
    hub_gather,
    split_hot_cold,
)
from repro_torch.graphs.sampler import NeighborSampler, SampledBlock
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum_sorted as ss
from repro_torch.models.gnn import common, gat
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl
from repro_torch.tree import tree_leaves, tree_paths

from hub_split import hub_split_batch

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# the neighbour sampler
# --------------------------------------------------------------------------
def _graphs(kind):
    ref = (ref_rmat.rmat_graph(9, 8, seed=3) if kind == "rmat"
           else ref_datasets.powerlaw_graph(300, 6, seed=1))
    return ref, CSRGraph.from_reference(ref)


@pytest.mark.parametrize("fanout", [(15, 10), (3,), (4, 2, 2)])
@pytest.mark.parametrize("kind", ["rmat", "powerlaw"])
def test_sampler_blocks_equal_the_references(kind, fanout):
    """Four blocks drawn in sequence from one seeded sampler in each
    package, seeds including isolated and repeated-neighbour nodes: every
    field, dtype for dtype, bit for bit."""
    ref_g, port_g = _graphs(kind)
    ref_s = ref_sampler.NeighborSampler(ref_g, fanout, seed=5)
    port_s = NeighborSampler(port_g, fanout, seed=5)
    rng = np.random.default_rng(2)
    for batch in (1, 8, 32, 8):
        seeds = rng.choice(ref_g.n, batch, replace=False).astype(np.int64)
        want, got = ref_s.sample(seeds), port_s.sample(seeds)
        assert isinstance(got, SampledBlock)
        for f in ("nodes", "edge_src", "edge_dst", "edge_mask",
                  "seeds_local"):
            a, b = getattr(want, f), getattr(got, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert got.n_nodes == want.n_nodes
        assert port_s.max_sizes(batch) == ref_s.max_sizes(batch)


def test_sampler_max_sizes_are_the_cell_shapes():
    """``max_sizes(1024)`` at fanout (15, 10) is the minibatch_lg cell's
    (n, e) in both packages' ``configs/inputs.py``."""
    _, g = _graphs("powerlaw")
    want = ref_inputs._sampled_sizes(1024, (15, 10))
    assert NeighborSampler(g).max_sizes(1024) == want
    assert inputs._sampled_sizes(1024, (15, 10)) == want


# --------------------------------------------------------------------------
# split_hot_cold and hub_gather: the reference's four tests, and parity
# --------------------------------------------------------------------------
def test_split_hot_cold_plan():
    scores = np.array([1.0, 100.0, 2.0, 50.0, 3.0])
    ids = np.array([0, 1, 1, 3, 4, 2])
    plan = split_hot_cold(ids, scores, capacity=2)
    assert isinstance(plan, HotColdPlan)
    assert set(plan.hot_ids.tolist()) == {1, 3}
    assert plan.is_hot.tolist() == [False, True, True, True, False, False]


def test_hub_gather_matches_plain_gather():
    rng = np.random.default_rng(0)
    n, d, k, c = 50, 8, 30, 10
    table = rng.normal(size=(n, d)).astype(np.float32)
    scores = rng.random(n)
    ids = rng.integers(0, n, k)
    plan = split_hot_cold(ids, scores, capacity=c)
    hot_table = table[plan.hot_ids]
    got = hub_gather(t(table), t(hot_table), t(ids), t(plan.is_hot),
                     t(plan.hot_pos))
    assert torch.equal(got, t(table[ids]))
    want = ref_hub.hub_gather(jnp.asarray(table), jnp.asarray(hot_table),
                              jnp.asarray(ids), jnp.asarray(plan.is_hot),
                              jnp.asarray(plan.hot_pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hot_rate_on_powerlaw_traffic():
    """Zipf traffic + popularity-scored cache -> high hit fraction with a
    small cache (the paper's Observation 3.1 for embedding rows)."""
    rng = np.random.default_rng(1)
    n = 10_000
    traffic = (rng.zipf(1.3, size=5000) - 1) % n
    counts = np.bincount(traffic, minlength=n)
    plan = split_hot_cold(traffic, counts.astype(float), capacity=n // 100)
    assert plan.is_hot.mean() > 0.5, "1% cache should absorb >50% of zipf"


@pytest.mark.parametrize("capacity", [0, 1, 7, 64, 500])
def test_split_hot_cold_equals_the_references(capacity):
    """Plans field for field, dtype for dtype, with tied scores, ids
    outside the hot set above and below it, and a capacity above n."""
    rng = np.random.default_rng(capacity)
    n = 200
    scores = rng.integers(0, 6, n).astype(np.float64)  # many ties
    ids = rng.integers(0, n, 1000)
    got = split_hot_cold(ids, scores, capacity)
    want = ref_hub.split_hot_cold(ids, scores, capacity)
    for f in HotColdPlan._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_gat_hub_split_matches_plain():
    """The reference's GAT split test on the port: GAT with hub-split edge
    streams == plain GAT."""
    rng = np.random.default_rng(2)
    n, e, c = 40, 150, 8
    cfg = gat.GATConfig(n_layers=2, d_hidden=4, n_heads=2, d_in=12,
                        n_classes=3)
    params = gat.init_params(cfg, torch.Generator().manual_seed(0))
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    feat = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
    plain = {"node_feat": feat, "edge_src": src, "edge_dst": dst,
             "edge_mask": mask, "node_mask": np.ones(n, bool)}
    y_plain = gat.apply(params, {k: t(v) for k, v in plain.items()}, cfg)
    y_split = gat.apply(params, {k: t(v) for k, v in
                                 hub_split_batch(plain, c).items()}, cfg)
    torch.testing.assert_close(y_split, y_plain, rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# GAT's hub split against the reference's
# --------------------------------------------------------------------------
def _gat_case(seed=0, capacity=6):
    rng = np.random.default_rng(seed)
    ref_cfg, batch = ref_inputs.make_smoke_batch("gat-cora", "gnn_train", rng)
    tree = ref_gat.init_params(ref_cfg, jax.random.key(seed))
    tree = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.normal(
        size=np.shape(a))).astype(np.float32), tree)
    cfg = registry.get_arch("gat-cora").smoke_config()
    return cfg, ref_cfg, batch, hub_split_batch(batch, capacity), tree


def _loss_and_grads(apply_fn, cfg, params, batch, loss_fn):
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = loss_fn(apply_fn, cfg, params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("capacity", [1, 6, 48])
def test_gat_split_logits_and_gradients_match_reference(capacity, sort):
    """The reference's split batch and the port's (each stream sorted by
    its destinations, and as split): logits, loss and the gradient of
    every parameter, from the reference's (perturbed) parameters.
    Capacity 48 makes every edge hot, 1 nearly every edge cold."""
    cfg, ref_cfg, _, split, tree = _gat_case(capacity=capacity)
    jb = jax.tree.map(jnp.asarray, split)
    jp = jax.tree.map(jnp.asarray, tree)
    want = ref_gat.apply(jp, jb, ref_cfg)
    loss_w, grads_w = jax.value_and_grad(
        lambda p: ref_tl._gnn_loss(ref_gat.apply, ref_cfg, p, jb))(jp)
    pb = {k: t(v) for k, v in split.items()}
    if sort:
        pb = common.sort_edges_by_dst(pb)
    params = gat.params_from_reference(cfg, tree)
    got = gat.apply(params, pb, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    loss, grads = _loss_and_grads(gat.apply, cfg, params, pb, tl._gnn_loss)
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=TOL)
    for (path, gw), g in zip(tree_paths(jax.tree.map(np.asarray, grads_w)),
                             grads):
        atol = TOL * (1 + float(np.abs(gw).max()))
        np.testing.assert_allclose(g.numpy(), gw, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("capacity", [1, 6, 48])
def test_gat_split_equals_the_ports_unsplit(capacity):
    """Split and unsplit batches of the same edges through the port's own
    GAT: logits, loss and gradients."""
    cfg, _, batch, split, tree = _gat_case(seed=3, capacity=capacity)
    out = []
    for b in (batch, split):
        pb = common.sort_edges_by_dst({k: t(v) for k, v in b.items()})
        params = gat.params_from_reference(cfg, tree)
        logits = gat.apply(params, pb, cfg).detach()
        out.append((logits,) + _loss_and_grads(gat.apply, cfg, params, pb,
                                               tl._gnn_loss))
    (y0, l0, g0), (y1, l1, g1) = out
    torch.testing.assert_close(y1, y0, rtol=TOL, atol=TOL)
    torch.testing.assert_close(l1, l0, rtol=TOL, atol=TOL)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=TOL,
                                   atol=TOL * (1 + float(a.abs().max())))


def test_sort_edges_by_dst_sorts_each_stream():
    """A split batch: each stream's destinations ascending, its source,
    hub position and mask carried through the same permutation; the
    plain keys are absent and nothing else moves."""
    _, _, _, split, _ = _gat_case(capacity=6)
    pb = {k: t(v) for k, v in split.items()}
    sb = common.sort_edges_by_dst(pb)
    for dst, src, msk in common.SPLIT_EDGE_KEYS:
        d = sb[dst]
        assert bool((d[1:] >= d[:-1]).all()), dst
        perm = torch.sort(pb[dst], stable=True).indices
        for k in (dst, src, msk):
            assert torch.equal(sb[k], pb[k][perm]), k
    assert "edge_dst" not in sb
    for k in ("node_feat", "hub_ids", "labels"):
        assert sb[k] is pb[k]


def test_b9_launches_per_step_of_the_split():
    """A split GAT step calls B9's wrapper 4 times a layer (the denominator
    and the aggregation of each stream), 8 for the smoke config's 2
    layers, against 4 unsplit; on the CPU path every call takes the plain
    version and the kernel's counter stays 0."""
    cfg, _, batch, split, tree = _gat_case(capacity=6)
    calls = []
    real = ops.segment_sum_sorted
    ops.segment_sum_sorted = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        counts = []
        for b in (batch, split):
            params = gat.params_from_reference(cfg, tree)
            step = tl.make_gnn_train_step(
                gat.apply, cfg, opt.adamw(lr=1e-3, weight_decay=0.0))
            pb = common.sort_edges_by_dst({k: t(v) for k, v in b.items()})
            calls.clear()
            ss.reset_launches()
            step(params, opt.adamw().init(params), pb)
            counts.append((len(calls), ss.launches()))
    finally:
        ops.segment_sum_sorted = real
    assert counts == [(4, 0), (8, 0)]
