"""The port's recsys (DIN) training and retrieval held against the
reference on the same seeded numpy inputs and the reference's own
parameters: the train step over several steps, the rows no batch touched,
the retrieval step's top-k order among ties, and the launcher.

Tolerances, each with its reason:

- losses, parameters and moments after steps: 1e-5 relative (losses
  element by element, a leaf in relative L2), as ``DIN_TOL`` in
  ``tests/test_torch_serve.py``: a handful of small fp32 dense layers
  summed in another order, and the optimizer's elementwise update;
- top-k values and indices: exact against ``jax.lax.top_k`` on the same
  scores; retrieval scores against the reference's: 1e-5;
- rows no batch touched: exact (their gradient is 0 and weight decay 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data.recsys import CTRStream as RefCTRStream
from repro.models.recsys import din as ref_din
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.configs import registry
from repro_torch.data.recsys import CTRStream
from repro_torch.launch import train
from repro_torch.models.recsys import din
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl
from repro_torch.tree import tree_leaves, tree_paths

REL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _din_params(seed=0):
    """The reference's smoke parameters as numpy, biases and Dice's alpha
    replaced by noise."""
    rcfg = ref_registry.get_arch("din").smoke_config()
    tree = jax.tree.map(np.asarray, ref_din.init_params(
        rcfg, jax.random.key(seed)))
    rng = np.random.default_rng(2)
    for lyr in tree["attn"] + tree["mlp"]:
        lyr["b"] = (rng.normal(size=lyr["b"].shape) * 0.1).astype(np.float32)
    tree["dice_alpha"] = rng.normal(size=tree["dice_alpha"].shape).astype(
        np.float32)
    pcfg = registry.get_arch("din").smoke_config()
    return rcfg, pcfg, tree


def _rel_l2(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.1, None)])
def test_recsys_train_steps_match_reference(wd, clip):
    """Five steps (the launcher's ``adamw(lr=1e-3, weight_decay=0.0)``,
    and weight decay without the clip) from the reference's copied
    parameters and optimizer state on ``CTRStream`` batches of 64."""
    rcfg, pcfg, tree = _din_params()
    kw = dict(lr=1e-3, weight_decay=wd, clip_norm=clip)
    r_opt, p_opt = ref_opt.adamw(**kw), opt.adamw(**kw)
    r_step = jax.jit(ref_tl.make_recsys_train_step(ref_din.apply, rcfg,
                                                   r_opt))
    p_step = tl.make_recsys_train_step(din.apply, pcfg, p_opt)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = r_opt.init(rp)
    pp = din.params_from_reference(pcfg, tree)
    ps = opt.state_from_reference(rs)
    stream = CTRStream(rcfg.n_items, rcfg.n_cats, 64, seq_len=rcfg.seq_len,
                       d_profile=rcfg.d_profile, seed=4)
    before = [x.clone() for x in tree_leaves(pp)]
    for i in range(5):
        b = stream.batch_at(i)
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        new_pp, ps, pm = p_step(pp, ps, {k: t(v) for k, v in b.items()})
        if i == 0:  # the step is functional: its inputs are unchanged
            assert all(torch.equal(a, c)
                       for a, c in zip(before, tree_leaves(pp)))
        pp = new_pp
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=REL)
    for r_tree, p_tree in ((rp, pp), (rs.mu, ps.mu), (rs.nu, ps.nu)):
        for (path, w), g in zip(tree_paths(jax.tree.map(np.asarray, r_tree)),
                                tree_leaves(p_tree)):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            assert _rel_l2(g, w) <= REL, path


def test_rows_no_batch_touched_are_unchanged():
    """Weight decay 0 (the launcher's): an item or category row that no
    batch looked up keeps its bits, and its moments stay 0; a touched row
    moves. (The smoke config's 50 categories are all looked up.)"""
    _, pcfg, tree = _din_params(1)
    o = opt.adamw(lr=1e-3, weight_decay=0.0)
    step = tl.make_recsys_train_step(din.apply, pcfg, o)
    pp = din.params_from_reference(pcfg, tree)
    ps = o.init(pp)
    stream = CTRStream(pcfg.n_items, pcfg.n_cats, 32, seq_len=pcfg.seq_len,
                       d_profile=pcfg.d_profile, seed=9)
    seen = {"item_table": set(), "cat_table": set()}
    p0 = pp
    for i in range(3):
        b = stream.batch_at(i)
        seen["item_table"] |= set(b["hist_items"].ravel().tolist())
        seen["item_table"] |= set(b["target_item"].tolist())
        seen["cat_table"] |= set(b["hist_cats"].ravel().tolist())
        seen["cat_table"] |= set(b["target_cat"].tolist())
        pp, ps, _ = step(pp, ps, {k: t(v) for k, v in b.items()})
    for name, rows in seen.items():
        n = p0[name].shape[0]
        cold = torch.tensor(sorted(set(range(n)) - rows), dtype=torch.long)
        hot = torch.tensor(sorted(rows), dtype=torch.long)
        assert hot.numel() > 0 and (cold.numel() > 0
                                    or name == "cat_table"), name
        assert torch.equal(pp[name][cold], p0[name][cold]), name
        assert not ps.mu[name][cold].any() and not ps.nu[name][cold].any()
        assert not torch.equal(pp[name][hot], p0[name][hot]), name


def test_bce_matches_reference():
    rng = np.random.default_rng(3)
    logits = np.concatenate([rng.normal(size=50) * 8, [0.0, -0.0, 40.0,
                                                       -40.0]])
    labels = (rng.random(54) < 0.5).astype(np.float32)
    x = t(logits.astype(np.float32)).requires_grad_(True)
    got = tl._bce(x, t(labels))
    want, gw = jax.value_and_grad(ref_tl._bce)(
        jnp.asarray(logits, jnp.float32), jnp.asarray(labels))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=REL)
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=REL,
                               atol=1e-7)


# --------------------------------------------------------------------------
# top-k and the retrieval step
# --------------------------------------------------------------------------
def _tie_cases():
    rng = np.random.default_rng(5)
    return {
        "small_ints": (rng.integers(0, 4, 500).astype(np.float32), 100),
        "all_equal": (np.full(300, 1.5, np.float32), 100),
        "tie_at_k": (np.array([5, 3, 3, 3, 3, 1, 3, 0], np.float32), 3),
        "k_is_n": (rng.integers(-3, 3, 64).astype(np.float32), 64),
        "k_is_1": (np.array([2, 7, 7, 1, 7], np.float32), 1),
        "distinct": (rng.normal(size=1000).astype(np.float32), 100),
        "negative_zero": (np.array([0.0, -0.0, 0.0, -1.0, -0.0],
                                   np.float32), 3),
    }


@pytest.mark.parametrize("case", list(_tie_cases()))
def test_stable_top_k_matches_lax_top_k(case):
    """Values and indices of ``jax.lax.top_k`` exactly, dtype for dtype:
    among equal values the lower index first."""
    x, k = _tie_cases()[case]
    vals, idx = tl.stable_top_k(t(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_retrieval_step_matches_reference_with_ties():
    """One user against 400 candidates drawn from 25 items (so equal
    candidates tie): the port's step equals ``jax.lax.top_k`` of its own
    scores exactly, and its scores equal the reference's to 1e-5."""
    rcfg, pcfg, tree = _din_params()
    rng = np.random.default_rng(8)
    b = CTRStream(rcfg.n_items, rcfg.n_cats, 1, seq_len=rcfg.seq_len,
                  d_profile=rcfg.d_profile, seed=2).batch_at(0)
    items = rng.choice(rcfg.n_items, 25, replace=False)[
        rng.integers(0, 25, 400)].astype(np.int32)
    batch = {"hist_items": b["hist_items"], "hist_cats": b["hist_cats"],
             "hist_mask": b["hist_mask"], "user_profile": b["user_profile"],
             "cand_items": items,
             "cand_cats": (items % rcfg.n_cats).astype(np.int32)}
    pp = din.params_from_reference(pcfg, tree)
    pb = {k: t(v) for k, v in batch.items()}
    step = tl.make_retrieval_step(din.retrieval_score, pcfg, top_k=100)
    vals, idx = step(pp, pb)
    scores = din.retrieval_score(pp, pb, pcfg)
    assert len(set(scores.tolist())) <= 25  # ties among the candidates
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores.numpy()), 100)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    r_vals, _ = ref_tl.make_retrieval_step(ref_din.retrieval_score, rcfg,
                                           top_k=100)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(vals.numpy(), np.asarray(r_vals), rtol=REL,
                               atol=REL)
    assert not vals.requires_grad


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_train_main_din_on_the_cpu(capsys):
    assert train.main(["--arch", "din", "--smoke", "--steps", "3",
                       "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[din] loss ") and "over 3 steps" in line


def test_train_build_din_is_the_references_wiring():
    """The smoke config under ``--smoke``, ``CTRStream(n_items, n_cats,
    128, ...)`` seeded with ``--seed`` on the device, the reference's
    optimizer; parameters in the reference's layout."""
    params, optim, step, data_fn = train.build("din", 6, "cpu", smoke=True)
    cfg = registry.get_arch("din").smoke_config()
    want = RefCTRStream(cfg.n_items, cfg.n_cats, 128, seq_len=cfg.seq_len,
                        d_profile=cfg.d_profile, seed=6).batch_at(3)
    got = data_fn(3)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert (optim.lr, optim.weight_decay) == (1e-3, 0.0)
    rcfg = ref_registry.get_arch("din").smoke_config()
    shapes = jax.tree.map(lambda a: tuple(a.shape),
                          ref_din.init_params(rcfg, jax.random.key(0)))
    assert jax.tree.map(lambda x: tuple(x.shape), params) == shapes
    _, state, m = step(params, optim.init(params), got)
    assert np.isfinite(float(m["loss"])) and int(state.count) == 1
