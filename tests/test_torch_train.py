"""The port's GNN training path held against the reference on the same
seeded numpy inputs and the reference's own initialised parameters: kernel
B9 (segment sum) through its plain torch version and its autograd
Function, the GIN / GAT / PNA models (MACE's own checks are in
``tests/test_torch_mace.py``; it joins the train steps here), AdamW, the train step, checkpoints,
the runner, the launcher and the GNN entries of the registry.

On the CPU the port's wrappers take the kernels' plain versions; the
reference runs its Pallas kernel in interpret mode and its jnp oracle.
Tolerances, each with its reason:

- B9 1e-5: the reference's own kernel test (``tests/test_kernels.py``)
  uses it for the same comparison (fp32 sums in another order);
- logits 1e-5 and gradients 1e-5 x (1 + max|g|) per leaf: the same fp32
  math over two small layers, summed in another order (the port sorts the
  edges by destination, the reference does not);
- AdamW 1e-6: the same elementwise fp32 update on equal inputs;
- five train steps: losses to rel 1e-5, parameters to atol 1e-4 (lr 1e-3:
  ten percent of one step, far above the fp32 noise carried through).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import inputs as ref_inputs
from repro.configs import registry as ref_registry
from repro.distributed import fault_tolerance as ref_ft
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models.gnn import gat as ref_gat
from repro.models.gnn import gin as ref_gin
from repro.models.gnn import mace as ref_mace
from repro.models.gnn import pna as ref_pna
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.configs import inputs, registry
from repro_torch.distributed.fault_tolerance import (
    StragglerMonitor,
    TrainRunner,
    elastic_restore,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_sum_sorted as ss
from repro_torch.launch import train
from repro_torch.models.gnn import common, gat, gin, mace, pna
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl
from repro_torch.train.checkpoint import (
    CheckpointManager,
    flatten_tree,
    unflatten_tree,
)
from repro_torch.tree import tree_leaves, tree_map, tree_paths

B9_TOL = 1e-5
LOGITS_TOL = 1e-5
GRAD_TOL = 1e-5
ADAM_TOL = 1e-6
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_ATOL = 1e-4

ARCHS = {"gin-tu": (gin, ref_gin), "gat-cora": (gat, ref_gat),
         "pna": (pna, ref_pna), "mace": (mace, ref_mace)}


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# B9: segment_sum_sorted
# --------------------------------------------------------------------------
@pytest.mark.parametrize("e,d,n,block_e,rows", [
    (512, 16, 64, 128, 32),
    (1024, 64, 200, 512, 128),
])
@pytest.mark.parametrize("ids", ["sorted", "padded", "negative", "unsorted"])
def test_segment_sum_ref_matches_pallas_kernel(e, d, n, block_e, rows, ids):
    """The reference's kernel test shapes: the port's plain version (and the
    wrapper's CPU path) against the Pallas kernel in interpret mode, with
    sorted ids, a padding tail of id N, negative ids and unsorted ids."""
    rng = np.random.default_rng(3)
    seg = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    if ids == "padded":
        seg[-e // 5:] = n
    elif ids == "negative":
        seg[: e // 7] = -1 - rng.integers(0, 3, size=e // 7)
    elif ids == "unsorted":
        seg = rng.permutation(seg)
    vals = rng.normal(size=(e, d)).astype(np.float32)
    want = ref_ops.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(seg),
                                      num_segments=n, block_e=block_e,
                                      rows=rows, interpret=True)
    got = ref.segment_sum_sorted_ref(t(vals), t(seg), num_segments=n)
    ss.reset_launches()
    via_ops = ops.segment_sum_sorted(t(vals), t(seg), num_segments=n)
    assert ss.launches() == 0  # a CPU tensor never reaches the kernel
    assert got.dtype == torch.float32 and got.shape == (n, d)
    close(got, want, B9_TOL)
    assert torch.equal(got, via_ops)


@pytest.mark.parametrize("e,d,n", [
    (0, 8, 5), (1, 1, 3), (777, 3, 50), (777, 1, 1), (1000, 100, 37),
    (333, 5, 400),  # more segments than edges: most stay 0
])
def test_segment_sum_ref_matches_jax_segment_sum(e, d, n):
    """E that no block divides, E = 0, D = 1 and odd D, ids in [-2, N]
    (N is the padding id) in any order, against ``jax.ops.segment_sum``;
    int64 ids and trailing dims ([E, 2, D]) give the same sums."""
    rng = np.random.default_rng(e + d)
    seg = rng.integers(-2, n + 1, size=e).astype(np.int32)
    vals = rng.normal(size=(e, d)).astype(np.float32)
    want = ref_ref.segment_sum_sorted_ref(jnp.asarray(vals), jnp.asarray(seg),
                                          num_segments=n)
    got = ops.segment_sum_sorted(t(vals), t(seg), num_segments=n)
    close(got, want, B9_TOL)
    got64 = ops.segment_sum_sorted(t(vals), t(seg.astype(np.int64)),
                                   num_segments=n)
    assert torch.equal(got, got64)
    vals3 = rng.normal(size=(e, 2, d)).astype(np.float32)
    want3 = jax.ops.segment_sum(jnp.asarray(vals3), jnp.asarray(seg),
                                num_segments=n)
    got3 = ops.segment_sum_sorted(t(vals3), t(seg), num_segments=n)
    assert got3.shape == (n, 2, d)
    close(got3, want3, B9_TOL)


def test_segment_sum_wrapper_rejects_bad_inputs():
    v = torch.zeros((4, 3))
    with pytest.raises(TypeError, match="seg_ids"):
        ops.segment_sum_sorted(v, torch.zeros(4), num_segments=2)
    with pytest.raises(TypeError, match="seg_ids"):
        ops.segment_sum_sorted(v, torch.zeros(3, dtype=torch.int32),
                               num_segments=2)
    with pytest.raises(TypeError, match="values"):
        ops.segment_sum_sorted(torch.zeros(4, 3, dtype=torch.int32),
                               torch.zeros(4, dtype=torch.int32),
                               num_segments=2)
    with pytest.raises(ValueError, match="num_segments"):
        ops.segment_sum_sorted(v, torch.zeros(4, dtype=torch.int32),
                               num_segments=-1)


def test_segment_sum_function_gradcheck():
    """The autograd Function in float64 (the plain version takes it on the
    CPU): gradcheck, ids out of range and unsorted included."""
    rng = np.random.default_rng(11)
    vals = torch.from_numpy(rng.normal(size=(23, 3))).requires_grad_(True)
    seg = torch.from_numpy(rng.integers(-1, 8, size=23).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda v: common.segment_sum(v, seg, 7), (vals,))
    vals3 = torch.from_numpy(rng.normal(size=(9, 2, 2))).requires_grad_(True)
    seg3 = torch.from_numpy(np.sort(rng.integers(0, 5, size=9)))  # int64
    assert torch.autograd.gradcheck(
        lambda v: common.segment_sum(v, seg3, 4), (vals3,))
    # num_segments = 0: every id is out of range, both directions agree
    out0 = common.segment_sum(vals, seg, 0)
    assert out0.shape == (0, 3)
    (g0,) = torch.autograd.grad(out0, vals, torch.zeros((0, 3),
                                                        dtype=vals.dtype))
    assert g0.shape == vals.shape and not g0.any()


def test_segment_sum_gradient_matches_jax():
    """The backward (a gather, 0 for ids out of range) against
    ``jax.grad`` of ``jax.ops.segment_sum`` with the same cotangent."""
    rng = np.random.default_rng(12)
    e, d, n = 300, 6, 40
    seg = rng.integers(-3, n + 2, size=e).astype(np.int32)
    vals = rng.normal(size=(e, d)).astype(np.float32)
    cot = rng.normal(size=(n, d)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax.ops.segment_sum(
        v, jnp.asarray(seg), num_segments=n) * cot))(jnp.asarray(vals))
    v = t(vals).requires_grad_(True)
    (common.segment_sum(v, t(seg), n) * t(cot)).sum().backward()
    close(v.grad, want, B9_TOL)
    assert not v.grad[(seg < 0) | (seg >= n)].any()


def test_segment_max_matches_jax_with_ties():
    """Values and gradient of ``segment_max`` against
    ``jax.ops.segment_max``: empty segments are -inf, ids outside [0, N)
    are dropped, and the gradient splits evenly over ties ([0, 0, 0 | 1, 1]
    gives 1/3 and 1/2, as in JAX)."""
    vals = np.array([0, 0, 0, 1, 1, 5, 2], np.float32)[:, None]
    seg = np.array([0, 0, 0, 1, 1, 4, -1], np.int32)
    n = 3

    def f_jax(v):
        return jax.ops.segment_max(v, jnp.asarray(seg), num_segments=n)

    want = f_jax(jnp.asarray(vals))
    got = common.segment_max(t(vals), t(seg), n)
    assert torch.isinf(got[2]).all() and (got[2] < 0).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cot = np.array([[1.0], [1.0], [0.0]], np.float32)
    gj = jax.grad(lambda v: jnp.sum(jnp.where(jnp.isfinite(f_jax(v)),
                                              f_jax(v), 0.0) * cot))(
        jnp.asarray(vals))
    v = t(vals).requires_grad_(True)
    out = common.segment_max(v, t(seg), n)
    (torch.where(torch.isfinite(out), out, 0.0) * t(cot)).sum().backward()
    close(v.grad, gj, 1e-7)
    close(v.grad[:5, 0], [1 / 3, 1 / 3, 1 / 3, 1 / 2, 1 / 2], 1e-7)


def test_sort_edges_by_dst_carries_every_edge_array():
    rng = np.random.default_rng(5)
    _, batch = inputs.make_smoke_batch("gat-cora", "gnn_train", rng)
    tb = {k: t(v) for k, v in batch.items()}
    sb = common.sort_edges_by_dst(tb)
    assert bool((sb["edge_dst"][1:] >= sb["edge_dst"][:-1]).all())
    order = np.argsort(batch["edge_dst"], kind="stable")
    for k in common.EDGE_KEYS:
        np.testing.assert_array_equal(sb[k].numpy(), batch[k][order])
    for k in set(batch) - set(common.EDGE_KEYS):
        assert sb[k] is tb[k]  # node arrays are not touched


# --------------------------------------------------------------------------
# models: logits and gradients against the reference
# --------------------------------------------------------------------------
def _perturbed(tree, rng, scale=0.1):
    """Noise in every leaf, so that zero-initialised biases and GIN's eps
    are exercised too."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a))
                   ).astype(np.float32), tree)


def _case(arch, seed=0):
    """(cfg, ref cfg, numpy batch, numpy params) for a smoke batch."""
    rng = np.random.default_rng(seed)
    ref_cfg, batch = ref_inputs.make_smoke_batch(arch, "gnn_train", rng)
    _, ref_mod = ARCHS[arch]
    tree = ref_mod.init_params(ref_cfg, jax.random.key(seed))
    tree = _perturbed(tree, np.random.default_rng(seed + 100))
    cfg = registry.get_arch(arch).smoke_config()
    return cfg, ref_cfg, batch, tree


def _port_batch(batch, sort):
    b = {k: t(v) for k, v in batch.items()}
    return common.sort_edges_by_dst(b) if sort else b


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("arch", ["gin-tu", "gat-cora", "pna"])
def test_model_logits_and_gradients_match_reference(arch, sort):
    """``apply`` on the reference's smoke batch (edges sorted by
    destination, and as drawn) and the gradient of ``_gnn_loss`` per leaf,
    with the reference's (perturbed) parameters copied across."""
    mod, ref_mod = ARCHS[arch]
    cfg, ref_cfg, batch, tree = _case(arch)
    jb = jax.tree.map(jnp.asarray, batch)
    jp = jax.tree.map(jnp.asarray, tree)
    want = ref_mod.apply(jp, jb, ref_cfg)
    loss_w, grads_w = jax.value_and_grad(
        lambda p: ref_tl._gnn_loss(ref_mod.apply, ref_cfg, p, jb))(jp)
    pb = _port_batch(batch, sort)
    for k, v in pb.items():  # the dtypes the loss branches on
        assert v.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32,
                           np.dtype(bool): torch.bool}[batch[k].dtype], k
    params = mod.params_from_reference(cfg, tree)
    got = mod.apply(params, pb, cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got.detach(), want, LOGITS_TOL)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = tl._gnn_loss(mod.apply, cfg, params, pb)
    grads = torch.autograd.grad(loss, leaves)
    close(loss.detach(), loss_w, LOGITS_TOL)
    ref_paths = [p for p, _ in tree_paths(jax.tree.map(np.asarray, grads_w))]
    assert ref_paths == [p for p, _ in tree_paths(params)]
    for (path, gw), g in zip(tree_paths(jax.tree.map(np.asarray, grads_w)),
                             grads):
        tol = GRAD_TOL * (1 + float(np.abs(gw).max()))
        np.testing.assert_allclose(g.numpy(), gw, rtol=0, atol=tol,
                                   err_msg=f"{arch} gradient {path}")


def test_b9_launch_counts_per_step_on_the_cpu_path():
    """The launches per step reckoned from the code (gin smoke 4, gat 4,
    pna 11, mace 23: 2 layers x 11 coupling paths + the graph readout) are
    the calls of the wrapper: counted here through the plain route, where
    the kernel's counter stays 0."""
    calls = {}
    real = ops.segment_sum_sorted

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    ops.segment_sum_sorted = counting
    try:
        for arch, want in (("gin-tu", 4), ("gat-cora", 4), ("pna", 11),
                           ("mace", 23)):
            mod, _ = ARCHS[arch]
            cfg, _, batch, tree = _case(arch)
            params = mod.params_from_reference(cfg, tree)
            calls["n"] = 0
            ss.reset_launches()
            step = tl.make_gnn_train_step(mod.apply, cfg,
                                          opt.adamw(lr=1e-3,
                                                    weight_decay=0.0))
            step(params, opt.adamw().init(params), _port_batch(batch, True))
            assert (calls["n"], ss.launches()) == (want, 0), arch
    finally:
        ops.segment_sum_sorted = real


def test_params_from_reference_checks_the_layout():
    cfg, _, _, tree = _case("gin-tu")
    bad = jax.tree.map(np.asarray, tree)
    bad["layers"][0]["eps"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="layout"):
        gin.params_from_reference(cfg, bad)
    bad["layers"][0]["eps"] = np.zeros((), np.float64)
    with pytest.raises(ValueError, match="layout"):
        gin.params_from_reference(cfg, bad)


def test_init_params_has_the_reference_layout():
    for arch, (mod, ref_mod) in ARCHS.items():
        cfg = registry.get_arch(arch).smoke_config()
        ref_cfg = ref_registry.get_arch(arch).smoke_config()
        want = ref_mod.init_params(ref_cfg, jax.random.key(0))
        got = mod.init_params(cfg, torch.Generator().manual_seed(0))
        assert [(p, tuple(x.shape)) for p, x in tree_paths(got)] == [
            (p, tuple(np.shape(x))) for p, x in
            tree_paths(jax.tree.map(np.asarray, want))], arch


# --------------------------------------------------------------------------
# AdamW and the train step
# --------------------------------------------------------------------------
def test_adamw_matches_reference():
    """Three updates with the same gradients (large enough that the clip
    engages) under a cosine schedule with warm-up and weight decay."""
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=4).astype(np.float32),
                    np.float32(0.3)]}
    grads = [jax.tree.map(lambda x: (3.0 * rng.normal(size=np.shape(x))
                                     ).astype(np.float32), params)
             for _ in range(3)]
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    r_opt = ref_opt.adamw(lr=ref_opt.cosine_schedule(1e-2, 2, 10), **kw)
    p_opt = opt.adamw(lr=opt.cosine_schedule(1e-2, 2, 10), **kw)
    rp = jax.tree.map(jnp.asarray, params)
    rs = r_opt.init(rp)
    pp = tree_map(t, params)
    ps = p_opt.init(pp)
    for g in grads:
        rp, rs = r_opt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps = p_opt.update(tree_map(t, g), ps, pp)
    assert ps.count.dtype == torch.int32 and int(ps.count) == 3
    for (path, a), b in zip(tree_paths(jax.tree.map(np.asarray, rp)),
                            tree_leaves(pp)):
        close(b, a, ADAM_TOL)
    for r_tree, p_tree in ((rs.mu, ps.mu), (rs.nu, ps.nu)):
        for a, b in zip(jax.tree.leaves(r_tree), tree_leaves(p_tree)):
            assert b.dtype == torch.float32
            close(b, a, ADAM_TOL)
    close(opt.global_norm(tree_map(t, grads[0])),
          ref_opt.global_norm(grads[0]), ADAM_TOL)
    for s in (0, 1, 2, 5, 10, 12):
        close(opt.cosine_schedule(1e-2, 2, 10)(torch.tensor(s)),
              ref_opt.cosine_schedule(1e-2, 2, 10)(s), 1e-9)


def test_state_from_reference_copies_moments_and_count():
    rp = {"w": jnp.ones((2, 3))}
    rs = ref_opt.adamw().init(rp)
    rs = rs._replace(count=jnp.int32(4))
    ps = opt.state_from_reference(rs)
    assert ps.count.dtype == torch.int32 and int(ps.count) == 4
    assert ps.mu["w"].shape == (2, 3) and ps.nu["w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["gin-tu", "gat-cora", "pna", "mace"])
def test_train_steps_match_reference(arch):
    """Five steps of the launcher's step (``adamw(lr=1e-3,
    weight_decay=0.0)``) from the reference's copied parameters and
    optimizer state; the port's batch has its edges sorted."""
    mod, ref_mod = ARCHS[arch]
    cfg, ref_cfg, batch, tree = _case(arch)
    r_opt = ref_opt.adamw(lr=1e-3, weight_decay=0.0)
    p_opt = opt.adamw(lr=1e-3, weight_decay=0.0)
    r_step = jax.jit(ref_tl.make_gnn_train_step(ref_mod.apply, ref_cfg,
                                                r_opt))
    p_step = tl.make_gnn_train_step(mod.apply, cfg, p_opt)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = r_opt.init(rp)
    pp = mod.params_from_reference(cfg, tree)
    ps = opt.state_from_reference(rs)
    jb = jax.tree.map(jnp.asarray, batch)
    pb = _port_batch(batch, True)
    before = [x.clone() for x in tree_leaves(pp)]
    for i in range(5):
        rp, rs, rm = r_step(rp, rs, jb)
        new_pp, ps, pm = p_step(pp, ps, pb)
        if i == 0:  # the step is functional: its inputs are unchanged
            assert all(torch.equal(a, b)
                       for a, b in zip(before, tree_leaves(pp)))
        pp = new_pp
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=STEP_LOSS_RTOL)
    for (path, a), b in zip(tree_paths(jax.tree.map(np.asarray, rp)),
                            tree_leaves(pp)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=STEP_PARAM_ATOL,
                                   err_msg=f"{arch} {path}")


def test_tree_helpers():
    rs = ref_opt.adamw().init({"w": jnp.ones(2), "a": [jnp.ones(1)]})
    ps = opt.adamw().init({"w": torch.ones(2), "a": [torch.ones(1)]})
    assert list(flatten_tree({"opt_state": ps})) == list(
        ref_ckpt.flatten_tree({"opt_state": rs}))
    a = {"x": torch.ones(2), "y": [torch.zeros(1)]}
    assert torch.equal(tl.tree_add(a, a)["x"], 2 * torch.ones(2))
    assert torch.equal(tl.tree_scale(a, 3.0)["y"][0], torch.zeros(1))
    z = tl.tree_zeros_f32({"h": torch.ones(3, dtype=torch.float16)})
    assert z["h"].dtype == torch.float32 and not z["h"].any()


# --------------------------------------------------------------------------
# checkpoints and the runner (tests/test_checkpoint_ft.py, on gin-tu)
# --------------------------------------------------------------------------
def _gin_setup(seed=0):
    rng = np.random.default_rng(seed)
    cfg, batch = inputs.make_smoke_batch("gin-tu", "gnn_train", rng)
    o = opt.adamw(lr=1e-3)
    step = tl.make_gnn_train_step(gin.apply, cfg, o)
    pb = _port_batch(batch, True)

    def fresh():
        p = gin.init_params(cfg, torch.Generator().manual_seed(1))
        return p, o.init(p)

    return step, pb, fresh


def test_flatten_roundtrip_and_reference_keys():
    tree = {"a": {"b": np.arange(6).reshape(2, 3)}, "c": [np.ones(4)]}
    flat = flatten_tree(tree)
    back = unflatten_tree(tree, flat)
    assert np.array_equal(back["a"]["b"], tree["a"]["b"])
    assert np.array_equal(back["c"][0], tree["c"][0])
    cfg, _, _, ref_tree = _case("pna")
    rs = ref_opt.adamw().init(jax.tree.map(jnp.asarray, ref_tree))
    state = {"params": pna.params_from_reference(cfg, ref_tree),
             "opt_state": opt.state_from_reference(rs)}
    want = ref_ckpt.flatten_tree({"params": ref_tree, "opt_state": rs})
    got = flatten_tree(state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    step, pb, fresh = _gin_setup()
    params, _ = fresh()
    cm.save(10, {"params": params}, meta={"next_step": 10})
    got, meta = cm.restore({"params": params})
    assert meta["step"] == 10 and meta["next_step"] == 10
    for a, b in zip(tree_leaves(params), tree_leaves(got["params"])):
        assert isinstance(b, np.ndarray) and np.array_equal(a.numpy(), b)
    got, _ = elastic_restore(cm, {"params": params}, "cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(got["params"])):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    assert (tmp_path / "step_0000000010" / "manifest.json").exists()


def test_keep_gc_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    x = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4):
        cm.save(s, x)
    assert cm.latest_step() == 4
    dirs = sorted(d.name for d in tmp_path.iterdir()
                  if d.name.startswith("step_"))
    assert len(dirs) == 2  # only last 2 kept


def test_async_save(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    w = torch.arange(5)
    fut = cm.save_async(7, {"w": w})
    w.zero_()  # the snapshot was taken when save_async returned
    fut.result(timeout=30)
    got, meta = cm.restore({"w": np.zeros(5)})
    assert np.array_equal(got["w"], np.arange(5)) and meta["step"] == 7


def test_restart_resumes_identically(tmp_path):
    """Train 6 steps straight vs train 3 + restart + 3: identical params."""
    step, pb, fresh = _gin_setup()
    p, s = fresh()
    for _ in range(6):
        p, s, _ = step(p, s, pb)
    straight = tree_leaves(p)

    cm = CheckpointManager(str(tmp_path))
    p, s = fresh()
    for _ in range(3):
        p, s, _ = step(p, s, pb)
    cm.save(3, {"params": p, "opt_state": s}, meta={"next_step": 3})
    p2, s2 = fresh()  # "restart": reload from disk
    state, meta = cm.restore({"params": p2, "opt_state": s2}, device="cpu")
    p2, s2 = state["params"], state["opt_state"]
    assert isinstance(s2, opt.AdamWState) and s2.count.dtype == torch.int32
    for _ in range(meta["next_step"], 6):
        p2, s2, _ = step(p2, s2, pb)
    for a, b in zip(straight, tree_leaves(p2)):
        assert torch.equal(a, b)


def test_train_runner_with_ckpt(tmp_path):
    step, pb, fresh = _gin_setup(3)
    params, opt_state = fresh()
    runner = TrainRunner(step_fn=step, data_fn=lambda s: pb,
                         ckpt=CheckpointManager(str(tmp_path)), ckpt_every=4)
    params, opt_state, log = runner.run(params, opt_state, start_step=0,
                                        n_steps=8)
    assert len(log) == 8 and all(isinstance(m["loss"], float) for m in log)
    assert runner.ckpt.latest_step() == 8
    assert int(opt_state.count) == 8


def test_train_runner_retries_then_raises():
    calls = []

    def flaky(params, opt_state, batch):
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return params, opt_state, {"loss": torch.tensor(1.0)}

    runner = TrainRunner(step_fn=flaky, data_fn=lambda s: None)
    _, _, log = runner.run({}, None, start_step=0, n_steps=1)
    assert len(calls) == 3 and log[0]["loss"] == 1.0

    def broken(*a):
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError, match="permanent"):
        TrainRunner(step_fn=broken, data_fn=lambda s: None).run(
            {}, None, start_step=0, n_steps=1)


def test_straggler_monitor_matches_reference():
    for cls in (StragglerMonitor, ref_ft.StragglerMonitor):
        m = cls(window=16, threshold=2.0)
        for i in range(10):
            m.record(i, 0.1)
        m.record(10, 0.5)  # 5x median
        assert m.straggler_suspected
        m2 = cls()
        m2.record(0, 0.1, per_device={"d0": 0.1, "d1": 0.1, "d2": 0.9})
        assert m2.straggler_suspected
        m3 = cls()
        for i in range(12):
            m3.record(i, 0.1)
        assert not m3.straggler_suspected


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
LINE = re.compile(r"^\[(gin-tu|gat-cora|pna|mace)\] loss -?[\d.]+ -> -?[\d.]+ "
                  r"over 4 steps \(\d+ ms/step\)$")


@pytest.mark.parametrize("arch", ["gin-tu", "gat-cora", "pna", "mace"])
def test_train_main_on_the_cpu(arch, capsys):
    result = {}
    assert train.main(["--arch", arch, "--steps", "4", "--device", "cpu"],
                      result=result) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and LINE.match(out[0]), out
    assert len(result["log"]) == 4
    assert all(np.isfinite(m["loss"]) for m in result["log"])
    assert int(result["opt_state"].count) == 4


@pytest.mark.parametrize("arch", ["gin-tu", "mace"])
def test_train_main_resumes_from_a_checkpoint(arch, tmp_path, capsys):
    """Six steps straight equal four, a checkpoint and two resumed, bit for
    bit; MACE's parameters hold nested ``str(l)`` keys."""
    argv = ["--arch", arch, "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    straight = {}
    train.main(["--arch", arch, "--steps", "6", "--device", "cpu"],
               result=straight)
    train.main(argv + ["--steps", "4"])
    resumed = {}
    train.main(argv + ["--steps", "6", "--resume"], result=resumed)
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert [m["step"] for m in resumed["log"]] == [4, 5]
    for a, b in zip(tree_leaves(straight["params"]),
                    tree_leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_wire_gnn_is_the_launchers_wiring():
    """``wire_gnn`` on the smoke batch is what ``build`` hands the runner:
    the same parameters, the batch's edges sorted by destination, the same
    losses over two steps."""
    arch_id, seed = "pna", 3
    cfg, batch = inputs.make_smoke_batch(arch_id, "gnn_train",
                                         np.random.default_rng(seed))
    wired = train.wire_gnn(arch_id, cfg, batch, seed, "cpu")
    built = train.build(arch_id, seed, "cpu")
    dst = wired[3](0)["edge_dst"]
    assert bool((dst[1:] >= dst[:-1]).all())
    for a, b in zip(tree_leaves(wired[0]), tree_leaves(built[0])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    losses = []
    for params, optim, step, data_fn in (wired, built):
        state = optim.init(params)
        run = []
        for s in range(2):
            params, state, m = step(params, state, data_fn(s))
            run.append(float(m["loss"]))
        losses.append(run)
    assert losses[0] == losses[1]


def test_train_main_raises_without_a_card_and_for_unported_families():
    """Every family raises without a card by default; the LM and recsys
    families train on the CPU when asked (``--smoke --device cpu``); the
    MoE LMs (their FFN is not ported) and paper-lcc raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for arch in ("gin-tu", "stablelm-1.6b", "din"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--arch", arch, "--smoke", "--steps", "1"])
    for arch in ("stablelm-1.6b", "din", "mace"):
        assert train.main(["--arch", arch, "--smoke", "--steps", "1",
                           "--device", "cpu"]) == 0
    with pytest.raises(NotImplementedError, match="not ported yet: moe"):
        train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke",
                    "--device", "cpu"])
    assert registry.get_arch("mace").family == "gnn"
    with pytest.raises(ValueError, match="no train step"):
        train.main(["--arch", "paper-lcc", "--device", "cpu"])


# --------------------------------------------------------------------------
# registry, configs and input shapes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gin-tu", "gat-cora", "pna", "mace"])
def test_gnn_registry_configs_and_cell_shapes_equal_the_reference(arch):
    want, got = ref_registry.get_arch(arch), registry.get_arch(arch)
    assert (got.family, got.skip_shapes) == (want.family, want.skip_shapes)
    assert {k: dataclasses.asdict(v) for k, v in got.shapes.items()} == {
        k: dataclasses.asdict(v) for k, v in want.shapes.items()}
    for make in ("config", "smoke_config"):
        a = dataclasses.asdict(getattr(want, make)())
        b = dataclasses.asdict(getattr(got, make)())
        assert str(b.pop("dtype"))[6:] == jnp.dtype(a.pop("dtype")).name
        assert a == b
    for sid, shape in want.shapes.items():
        rw = ref_inputs.cell_shapes(want, want.config(), shape)
        pw = inputs.cell_shapes(got, got.config(), got.shapes[sid])
        assert list(pw) == list(rw), sid
        for k, (s, dt) in rw.items():
            assert pw[k][0] == s and str(pw[k][1])[6:] == jnp.dtype(dt).name
        ra = ref_inputs._adapt_cfg(want, want.config(), sid, shape)
        pa = inputs._adapt_cfg(got, got.config(), sid, got.shapes[sid])
        a, b = dataclasses.asdict(ra), dataclasses.asdict(pa)
        a.pop("dtype"), b.pop("dtype")
        assert a == b, sid
        assert inputs.step_kind(got, shape) == ref_inputs.step_kind(
            want, shape)
        cfg, _, spec = inputs.input_specs(arch, sid)
        b = dataclasses.asdict(cfg)
        b.pop("dtype")
        assert b == a, sid
        assert all(x.device.type == "meta" for x in spec.values())
        assert {k: tuple(x.shape) for k, x in spec.items()} == {
            k: s for k, (s, _) in rw.items()}


@pytest.mark.parametrize("arch,kind", [
    ("gin-tu", "gnn_train"), ("gat-cora", "gnn_train"), ("pna", "gnn_train"),
    ("mace", "gnn_train"),
    ("stablelm-1.6b", "lm_train"), ("stablelm-1.6b", "lm_decode"),
    ("din", "recsys_serve"), ("din", "retrieval"),
])
def test_smoke_batches_are_bit_equal(arch, kind):
    _, want = ref_inputs.make_smoke_batch(arch, kind,
                                          np.random.default_rng(9))
    _, got = inputs.make_smoke_batch(arch, kind, np.random.default_rng(9))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_lm_and_recsys_cell_shapes_equal_the_reference():
    for arch in ("gemma2-27b", "din"):
        want, got = ref_registry.get_arch(arch), registry.get_arch(arch)
        for sid, shape in want.shapes.items():
            rw = ref_inputs.cell_shapes(want, want.config(), shape)
            pw = inputs.cell_shapes(got, got.config(), got.shapes[sid])
            assert {k: (s, jnp.dtype(d).name) for k, (s, d) in rw.items()} \
                == {k: (s, str(d)[6:]) for k, (s, d) in pw.items()}
