"""The port's MoE FFN (``repro_torch.models.moe``) and the two MoE LMs held
against the reference (``repro.models.moe``, ``repro.models.transformer``)
on the same seeded numpy inputs and the reference's own parameters, copied
across (never two independent draws): the init's layout and scale, the
routing (``jax.lax.top_k``'s order, ties included) on the reference's own
probabilities, the capacity and every dispatch table bit for bit with its
dtype, ``moe_apply`` and ``moe_apply_local_ep`` forward and gradients,
both smoke configs through prefill, decode at batch 4 (where experts drop
tokens), the loss, its gradients and the train step with 2 microbatches,
the launchers and the checkpoint.

Tolerances, each with its reason:

- integer tables, routing on the same probabilities: exact;
- fp32 outputs, losses, gradients and parameters: 1e-5 relative (element
  by element for outputs and losses, relative L2 for a gradient or
  parameter leaf; as ``tests/test_torch_lm_train.py``): the same fp32 math
  in another summation order;
- bf16: 5e-2 absolute and relative L2 (``MODEL_BF16`` /
  ``BF16_TOL`` of the serve and train tests): the frameworks round to bf16
  at different places.

The end-to-end tests record every routing call of the port and hold its
expert ids against ``jax.lax.top_k`` of the reference's softmax on the
port's own input; the smallest margin between a token's k-th and
(k+1)-th probability is written to the test's junit properties
(``min_topk_margin``), so a flip at a near-tie would show as such.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import serve, train
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.common import stable_top_k
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl
from repro_torch.train.checkpoint import CheckpointManager, flatten_tree
from repro_torch.tree import tree_leaves, tree_paths

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
F32_REL = 1e-5
BF16_TOL = 5e-2
MOE_ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
# truncated standard normal on [-2, 2]: its standard deviation
TRUNC_STD = 0.8796


def _torch(a) -> torch.Tensor:
    """A numpy / JAX array (bf16 as ml_dtypes) as a CPU tensor, same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel_l2(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, what=""):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_REL,
                                   atol=F32_REL, err_msg=what)
    else:
        g, w = _f32(got), _f32(want)
        assert np.abs(g - w).max() <= BF16_TOL, what
        assert _rel_l2(g, w) <= BF16_TOL, what


def _leaf_close(got, want, dtype, what=""):
    err = _rel_l2(got, want)
    assert err <= (F32_REL if dtype == "float32" else BF16_TOL), (what, err)


def _margin(probs: np.ndarray, k: int) -> float:
    """Smallest gap between a row's k-th and (k+1)-th largest value."""
    s = -np.sort(-np.asarray(probs, np.float32), axis=-1)
    if s.shape[-1] <= k:
        return float("inf")
    return float((s[..., k - 1] - s[..., k]).min())


# --------------------------------------------------------------------------
# the reference's dispatch, its lines (moe.py:59-86) as they are
# --------------------------------------------------------------------------
def ref_tables(expert_ids, gates, e, k, c):
    t = expert_ids.shape[0]
    flat_e = expert_ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.zeros((e,), jnp.int32).at[sorted_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(t * k, dtype=jnp.int32) - starts[sorted_e]
    keep = pos_in_e < c
    slot = jnp.where(keep, sorted_e * c + pos_in_e, e * c)
    tok = (order // k).astype(jnp.int32)
    gate_sorted = gates.reshape(-1)[order]
    disp_tok = jnp.full((e * c + 1,), t, jnp.int32).at[slot].set(
        jnp.where(keep, tok, t))
    disp_gate = jnp.zeros((e * c + 1,), jnp.float32).at[slot].set(
        jnp.where(keep, gate_sorted, 0.0))
    return {"order": order, "sorted_e": sorted_e, "counts": counts,
            "starts": starts, "pos": pos_in_e, "keep": keep, "slot": slot,
            "tok": tok, "disp_tok": disp_tok, "disp_gate": disp_gate}


def ref_route(router, x, k):
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ router, axis=-1)
    gates, ids = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    return probs, gates, ids


def _layer(e, d=16, f=32, dtype="float32", seed=0):
    p = ref_moe.moe_init(jax.random.key(seed), d, f, e, getattr(jnp, dtype))
    return p, {name: _torch(v) for name, v in p.items()}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_layout_dtypes_and_fan_in(dtype):
    """The reference's shapes and dtypes (router fp32 whatever the dtype),
    and its scale: the experts' fan-in is E (``trunc_normal`` takes
    ``shape[0]`` of ``(E, d, f)``), the router's d."""
    e, d, f = 16, 256, 128
    want = ref_moe.moe_init(jax.random.key(0), d, f, e, getattr(jnp, dtype))
    got = moe.moe_init(torch.Generator().manual_seed(0), d, f, e,
                       getattr(torch, dtype))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype)[6:] == jnp.dtype(w.dtype).name, name
    assert got["router"].dtype == torch.float32
    for name, fan_in in (("router", d), ("w_gate", e), ("w_up", e),
                         ("w_down", e)):
        std = TRUNC_STD / np.sqrt(fan_in)
        got_std = float(got[name].float().std())
        want_std = float(np.asarray(want[name], np.float32).std())
        assert abs(got_std - std) <= 0.03 * std, (name, got_std, std)
        assert abs(want_std - std) <= 0.03 * std, (name, want_std, std)
        assert float(got[name].float().abs().max()) <= 2.0 / np.sqrt(
            fan_in) * 1.01


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_draws_each_block_with_fan_in_e(arch):
    """``tfm.init_params`` stacks one ``moe_init`` a block: every block's
    experts at ``1/sqrt(E)``, never ``1/sqrt(n_blocks)`` (a draw of the
    stack as one tensor), the router in fp32 at ``1/sqrt(d)``."""
    cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(),
                              n_layers=4)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    m = params["layers"]["sub0_global"]["moe"]
    assert set(m) == {"router", "w_gate", "w_up", "w_down"}
    assert m["router"].dtype == torch.float32
    assert tuple(m["router"].shape) == (4, cfg.d_model, cfg.moe_experts)
    for name in ("w_gate", "w_up", "w_down"):
        assert m[name].dtype == cfg.dtype
        for blk in range(4):
            std = float(m[name][blk].float().std())
            want = TRUNC_STD / np.sqrt(cfg.moe_experts)
            assert abs(std - want) <= 0.05 * want, (name, blk, std, want)
    std = float(m["router"][0].std())
    want = TRUNC_STD / np.sqrt(cfg.d_model)
    assert abs(std - want) <= 0.1 * want
    for name in ("w_gate", "w_up", "w_down"):
        assert name not in params["layers"]["sub0_global"]


# --------------------------------------------------------------------------
# routing on the reference's own probabilities
# --------------------------------------------------------------------------
def _probs_cases():
    rng = np.random.default_rng(3)
    return {
        # a zero router: every probability 1/E, the lowest indices win
        "uniform": (np.zeros((9, 16), np.float32), 2),
        "uniform_k6_e64": (np.zeros((5, 64), np.float32), 6),
        # logits on a coarse grid: many exact ties inside and at the k-th
        "grid_ties": (rng.integers(0, 3, (64, 8)).astype(np.float32), 2),
        "grid_ties_k6": (rng.integers(0, 4, (128, 64)).astype(np.float32),
                         6),
        "random_k1": (rng.normal(size=(50, 4)).astype(np.float32), 1),
        "random_k6": (rng.normal(size=(300, 64)).astype(np.float32) * 3, 6),
        "k_is_e": (rng.integers(0, 2, (20, 4)).astype(np.float32), 4),
    }


@pytest.mark.parametrize("case", list(_probs_cases()))
def test_routing_on_the_references_probabilities_is_bit_equal(case):
    """``top_k_gates`` on the reference's probabilities (its softmax, as
    numpy): ids, top-k values and renormalised gates equal to
    ``jax.lax.top_k`` and the reference's division, bit for bit, with
    their dtypes."""
    logits, k = _probs_cases()[case]
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want_v, want_i = jax.lax.top_k(probs, k)
    want_g = want_v / jnp.maximum(want_v.sum(-1, keepdims=True), 1e-9)
    vals, idx = stable_top_k(_torch(probs), k)
    gates, ids = moe.top_k_gates(_torch(probs), k)
    assert idx.dtype == ids.dtype == torch.int32
    assert gates.dtype == vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(gates.numpy(), np.asarray(want_g))
    if case.startswith("uniform"):
        assert (ids.numpy() == np.arange(k)).all()


def test_stable_top_k_orders_signed_zeros_and_ties_as_lax():
    """Rows with -0.0 / +0.0 and exact ties: XLA's total order."""
    x = np.array([[0.0, -0.0, 0.0, -1.0, -0.0], [3, 3, -3, 3, 1],
                  [-0.0, -0.0, -0.0, -0.0, -0.0]], np.float32)
    for k in (1, 2, 3, 5):
        v, i = stable_top_k(_torch(x), k)
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(np.signbit(v.numpy()),
                                      np.signbit(np.asarray(wv)))


# --------------------------------------------------------------------------
# capacity and dispatch tables
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.25, 1.25, "E"])
@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (37, 4, 1), (96, 64, 6)])
def test_dispatch_tables_are_bit_equal(t, e, k, cf):
    """Capacity, order, counts, starts, positions, keep, slots, tokens and
    both dispatch tables from the reference's routing, bit for bit, int32
    (``keep`` bool, ``disp_gate`` fp32); each token's slot list holds its
    kept slots in ascending order."""
    cf = float(e) if cf == "E" else cf
    rng = np.random.default_rng(t + e)
    logits = rng.integers(0, 3, (t, e)).astype(np.float32)  # with ties
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, ids = jax.lax.top_k(probs, k)
    c = max(int(cf * t * k / e), 1)
    assert moe.capacity(cf, t, k, e) == c
    want = ref_tables(ids, gates, e, k, c)
    got = moe.moe_dispatch(_torch(ids).reshape(-1), _torch(gates),
                           n_local=e, c=c, k=k)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        if name in ("counts", "starts"):  # a drop bucket, empty here
            assert name == "starts" or g[e] == 0
            g = g[:e]
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got["keep"].dtype == torch.bool
    assert got["disp_gate"].dtype == torch.float32
    disp_tok = np.asarray(want["disp_tok"])[:e * c]
    slots = got["slots"].numpy()
    assert slots.shape == (t, k) and slots.dtype == np.int32
    for tok in range(t):
        kept = np.nonzero(disp_tok == tok)[0]
        np.testing.assert_array_equal(slots[tok, :len(kept)], kept)
        assert (slots[tok, len(kept):] == e * c).all()
    if cf == 0.25:
        assert not np.asarray(want["keep"]).all()  # the case drops
    if cf == float(e):
        assert np.asarray(want["keep"]).all()


def test_capacity_at_the_served_shapes():
    """The capacities of the served shapes: prefill 8,192 tokens and
    decode at batch 4 and 1, for both published configs."""
    for arch, prefill in (("moonshot-v1-16b-a3b", 960),
                          ("phi3.5-moe-42b-a6.6b", 1280)):
        cfg = registry.get_arch(arch).config()
        e, k, cf = cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity
        assert moe.capacity(cf, 8192, k, e) == prefill
        assert moe.capacity(cf, 4, k, e) == 1
        assert moe.capacity(cf, 1, k, e) == 1


# --------------------------------------------------------------------------
# moe_apply: forward and gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("router", ["random", "zero"])
@pytest.mark.parametrize("cf", [0.25, 1.25, "E"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_forward_and_grads_match_reference(dtype, cf, router,
                                                     record_property):
    """Output and the gradient of every leaf (router included) and of x,
    of ``sum(y * w)``, against ``jax.value_and_grad``; the expert ids of
    the port's routing equal ``jax.lax.top_k``'s on the same inputs. A zero
    router sends every token to experts 0..k-1 (exact ties)."""
    t, d, f, e, k = 64, 16, 32, 8, 2
    cf = float(e) if cf == "E" else cf
    rp, pp = _layer(e, d, f, dtype)
    if router == "zero":
        rp["router"] = jnp.zeros_like(rp["router"])
        pp["router"] = torch.zeros_like(pp["router"])
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(t, d)).astype(np.float32)).astype(
        getattr(jnp, dtype))
    w = rng.normal(size=(t, d)).astype(np.float32)

    probs, _, want_ids = ref_route(rp["router"], x, k)
    _, got_ids = moe.moe_route(pp["router"], _torch(x), k)
    record_property("min_topk_margin", _margin(probs, k))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))

    def ref_loss(p, x_):
        y = ref_moe.moe_apply(p, x_, n_experts=e, top_k=k,
                              capacity_factor=cf)
        return jnp.sum(y.astype(jnp.float32) * w), y

    (_, want_y), (gp, gx) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(rp, x)
    leaves = {n: v.clone().requires_grad_(True) for n, v in pp.items()}
    xt = _torch(x).requires_grad_(True)
    y = moe.moe_apply(leaves, xt, n_experts=e, top_k=k, capacity_factor=cf)
    assert y.dtype == xt.dtype and y.shape == (t, d)
    _close(y, want_y, dtype, "y")
    loss = torch.sum(y.float() * torch.from_numpy(w))
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names] + [xt])
    for n, g in zip(names, grads):
        assert g.dtype == leaves[n].dtype, n
        _leaf_close(g, gp[n], dtype, n)
    _leaf_close(grads[-1], gx, dtype, "x")
    if router == "zero":  # experts k.. get nothing, in both packages
        assert not grads[names.index("w_gate")][k:].any()


def test_combine_is_bit_stable_and_needs_no_float_scatter(monkeypatch):
    """Two calls give the same bits, and the forward pass runs without
    ``index_add_`` / ``scatter_add`` on a float tensor."""
    rp, pp = _layer(8, dtype="bfloat16")
    x = _torch(jnp.asarray(np.random.default_rng(2).normal(
        size=(64, 16)).astype(np.float32)).astype(jnp.bfloat16))
    seen = []
    for name in ("index_add", "index_add_", "scatter_add", "index_put"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            if self.is_floating_point():
                seen.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, spy)
    a = moe.moe_apply(pp, x, n_experts=8, top_k=2)
    b = moe.moe_apply(pp, x, n_experts=8, top_k=2)
    assert seen == []
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# --------------------------------------------------------------------------
# moe_apply_local_ep on a (2, 4) mesh: the reference in one subprocess
# --------------------------------------------------------------------------
LOCAL_EP_SCRIPT = r"""
import sys
from repro.distributed.spmd_runtime import ensure_host_devices
ensure_host_devices(8)  # preserves external XLA_FLAGS; must precede jax init
import numpy as np
import jax, jax.numpy as jnp
from repro.models.moe import moe_apply_local_ep, moe_init
from repro.models.transformer import AxisRules

mesh = jax.make_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
t, d, f, e, k = 64, 16, 32, 8, 2
p = moe_init(jax.random.key(0), d, f, e, dtype=jnp.float32)
x = rng.normal(size=(t, d)).astype(np.float32)
w = rng.normal(size=(t, d)).astype(np.float32)
rules = AxisRules(data=("data",), model=("model",), mesh=mesh)
out = {"x": x, "w": w}
out.update({"p_" + n: np.asarray(v) for n, v in p.items()})
with mesh:
    for tag, cf in (("drops", 1.25), ("nodrops", float(e))):
        def loss(p_, x_):
            y = moe_apply_local_ep(p_, x_, n_experts=e, top_k=k,
                                   capacity_factor=cf, rules=rules,
                                   mesh=mesh)
            return jnp.sum(y * w), y
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
        out[tag + "_y"] = np.asarray(y)
        out[tag + "_gx"] = np.asarray(gx)
        out.update({tag + "_g_" + n: np.asarray(v) for n, v in gp.items()})
np.savez(sys.argv[1], **out)
print("ok")
"""


@pytest.fixture(scope="module")
def local_ep_reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("local_ep") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", LOCAL_EP_SCRIPT, path],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("tag", ["drops", "nodrops"])
def test_local_ep_matches_reference_on_a_2x4_mesh(local_ep_reference, tag):
    """The reference's shard_map path on 2 data x 4 model host devices
    (capacity per data shard, drop buckets, psum) against the port's on one
    device: output, every leaf's gradient and x's, fp32 1e-5. With 1.25
    some assignments drop, and the result then differs from
    ``moe_apply``'s, as the reference's does."""
    ref = local_ep_reference
    e, k = 8, 2
    cf = 1.25 if tag == "drops" else float(e)
    leaves = {n[2:]: torch.from_numpy(v).requires_grad_(True)
              for n, v in ref.items() if n.startswith("p_")}
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    y = moe.moe_apply_local_ep(leaves, x, n_experts=e, top_k=k,
                               capacity_factor=cf, data_shards=2,
                               model_shards=4)
    _close(y, ref[tag + "_y"], "float32", "y")
    names = sorted(leaves)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(ref["w"])),
                                [leaves[n] for n in names] + [x])
    for n, g in zip(names, grads):
        _leaf_close(g, ref[f"{tag}_g_{n}"], "float32", n)
    _leaf_close(grads[-1], ref[tag + "_gx"], "float32", "x")
    with torch.no_grad():
        gates, ids = moe.moe_route(leaves["router"], x, k)
        tables, e_loc, c = moe.local_ep_tables(
            ids, gates, n_experts=e, capacity_factor=cf, data_shards=2,
            model_shards=4)
        dense = moe.moe_apply(leaves, x, n_experts=e, top_k=k,
                              capacity_factor=cf)
    assert (e_loc, c) == (2, max(int(cf * 32 * k / e), 1))
    assert tables["slot"].shape == (2, 4, 32 * k)
    assert tables["disp_tok"].dtype == tables["slot"].dtype == torch.int32
    # every assignment is kept by one column at most: each column's keep
    # mapped back from its sorted order to the assignments' order
    kept = torch.zeros_like(tables["keep"]).scatter_(
        -1, tables["order"].long(), tables["keep"]).sum(1)
    assert int(kept.max()) <= 1
    if tag == "drops":
        assert int(kept.sum()) < ids.numel()
        assert not torch.allclose(y, dense, rtol=F32_REL, atol=F32_REL)
    else:
        assert int(kept.sum()) == ids.numel()
        _close(y.detach(), dense, "float32", "dense")


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_local_ep_with_one_data_shard_is_moe_apply(cf):
    """One data shard: every column keeps the positions the dense dispatch
    keeps, so the columns' sum is ``moe_apply``'s output."""
    _, pp = _layer(8, seed=3)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(48, 16)).astype(np.float32))
    a = moe.moe_apply_local_ep(pp, x, n_experts=8, top_k=2,
                               capacity_factor=cf, data_shards=1,
                               model_shards=4)
    b = moe.moe_apply(pp, x, n_experts=8, top_k=2, capacity_factor=cf)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=F32_REL,
                               atol=F32_REL)
    with pytest.raises(ValueError, match="columns"):
        moe.moe_apply_local_ep(pp, x, n_experts=8, top_k=2, data_shards=1,
                               model_shards=3)
    with pytest.raises(ValueError, match="data shards"):
        moe.moe_apply_local_ep(pp, x, n_experts=8, top_k=2, data_shards=5,
                               model_shards=2)


# --------------------------------------------------------------------------
# the MoE LMs end to end
# --------------------------------------------------------------------------
def _configs(arch, dtype, **kw):
    rcfg = ref_registry.get_arch(arch).smoke_config()
    pcfg = registry.get_arch(arch).smoke_config()
    rcfg = dataclasses.replace(rcfg, dtype=getattr(jnp, dtype), **kw)
    pcfg = dataclasses.replace(pcfg, dtype=getattr(torch, dtype), **kw)
    return rcfg, pcfg


def _tree(rcfg, seed=0):
    """The reference's initialised parameters as numpy, every norm weight
    replaced by noise."""
    tree = jax.tree.map(np.asarray,
                        ref_tfm.init_params(rcfg, jax.random.key(seed)))
    rng = np.random.default_rng(1)

    def noise(path, a):
        if "norm" in path[-1].key:
            return (rng.normal(size=a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(noise, tree)


# the bound of a near-tie, per dtype of the hidden state: the port's and
# the reference's router inputs differ by rounding (fp32: a few ulps; bf16:
# two ulps, 2^-7 relative), so expert e's logit may move by up to
# NEAR_TIE_ULPS * sum_i |x_i * router_ie|, and two experts whose logits lie
# closer than the sum of their moves may swap
NEAR_TIE_ULPS = {"float32": 2.0 ** -21, "bfloat16": 2.0 ** -7}


class Routing:
    """Both packages' routing in one end-to-end run. The port's calls are
    recorded (input, router, fp32 probabilities, ids). The reference's
    ``jax.lax.top_k`` (as ``repro.models.moe`` calls it) is then replaced:
    it computes its own top k, and returns the ids of the port's call with
    the nearest probabilities, the values taken at them (so the gradient
    flows as top_k's). ``check`` holds the port's ids against
    ``jax.lax.top_k`` on the port's own inputs (bit for bit) and the
    reference's own ids against the port's: equal, but at tokens whose
    swapped experts' logits lie within the near-tie bound of the inputs'
    rounding (``NEAR_TIE_ULPS``); those are counted and reported. Where
    none is found the reference ran its own routing."""

    def __init__(self, monkeypatch, cfg, dtype):
        self.cfg, self.dtype = cfg, dtype
        self.port, self.ref = [], []
        real_port, real_top_k = moe.moe_route, jax.lax.top_k

        def port_route(router, x, k):
            gates, ids = real_port(router, x, k)
            probs = torch.softmax(x.detach().float() @ router.detach(), -1)
            self.port.append((_f32(x), _f32(router), probs.numpy(),
                              ids.numpy().copy()))
            return gates, ids

        def nearest(probs):
            best = min((float(np.abs(p - probs).max()), j)
                       for j, (_, _, p, _) in enumerate(self.port)
                       if p.shape == probs.shape)
            assert best[0] < 0.05, best  # the same call in both packages
            return best[1]

        def ids_of(probs):
            return self.port[nearest(np.asarray(probs))][3]

        def record(probs, own, given):
            self.ref.append((np.asarray(probs), np.asarray(own),
                             np.asarray(given)))

        def ref_top_k(probs, k):
            _, own = real_top_k(probs, k)
            p = jax.lax.stop_gradient(probs)
            ids = jax.pure_callback(
                ids_of, jax.ShapeDtypeStruct(probs.shape[:-1] + (k,),
                                             jnp.int32), p)
            jax.debug.callback(record, p, own, ids)
            return jnp.take_along_axis(probs, ids, axis=-1), ids

        monkeypatch.setattr(moe, "moe_route", port_route)
        self._patch = lambda: monkeypatch.setattr(jax.lax, "top_k",
                                                  ref_top_k)

    def reference(self):
        """Call after the port's run, before the reference's."""
        self._patch()

    def check(self, record_property):
        k, e = self.cfg.moe_top_k, self.cfg.moe_experts
        margin, drops, flips = float("inf"), {}, 0
        for x, router, _, ids in self.port:
            probs, _, want = ref_route(jnp.asarray(router), x, k)
            np.testing.assert_array_equal(ids, np.asarray(want))
            assert ids.dtype == np.int32
            margin = min(margin, _margin(probs, k))
            t = x.shape[0]
            c = moe.capacity(self.cfg.moe_capacity, t, k, e)
            n = np.bincount(ids.reshape(-1), minlength=e)
            drops[t] = drops.get(t, 0) + int(np.maximum(n - c, 0).sum())
        assert self.ref, "the reference made no routing call"
        for probs, own, given in self.ref:
            x, router, _, _ = self.port[min(
                (float(np.abs(p - probs).max()), j)
                for j, (_, _, p, _) in enumerate(self.port)
                if p.shape == probs.shape)[1]]
            move = NEAR_TIE_ULPS[self.dtype] * (np.abs(x) @ np.abs(router))
            logits = np.log(probs)
            for tok in np.nonzero((own != given).any(-1))[0]:
                rank_own = {ex: r for r, ex in enumerate(own[tok])}
                rank_given = {ex: r for r, ex in enumerate(given[tok])}
                moved = [ex for ex in set(rank_own) | set(rank_given)
                         if rank_own.get(ex, k) != rank_given.get(ex, k)]
                gap = logits[tok, moved].max() - logits[tok, moved].min()
                bound = 2 * move[tok, moved].max()
                assert gap <= bound, ("not a near-tie", tok, own[tok],
                                      given[tok], gap, bound)
                flips += 1
        record_property("min_topk_margin", margin)
        record_property("near_tie_flips", flips)
        record_property("drops_by_tokens", json.dumps(drops))
        return margin, drops, flips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_at_batch_4_match_reference(arch, dtype,
                                                       monkeypatch,
                                                       record_property):
    """Prefill logits and KV caches, then 4 decode steps at batch 4 — the
    capacity of a step's 4 tokens drops some (moonshot's smoke config:
    c = 1 for 8 assignments over 8 experts), in both packages — fed the
    reference's greedy tokens; routing held as ``Routing`` says."""
    rcfg, pcfg = _configs(arch, dtype)
    tree = _tree(rcfg)
    rp = jax.tree.map(jnp.asarray, tree)
    pp = tfm.params_from_reference(pcfg, tree)
    b, s, n_dec = 4, 16, 4
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab, size=(b, s)).astype(np.int32)
    routing = Routing(monkeypatch, pcfg, dtype)
    with torch.inference_mode():
        pl, pc = tfm.forward_prefill(pp, torch.from_numpy(toks), pcfg,
                                     max_len=s + n_dec)
        got = [(pl.clone(), {key: {n: v.clone() for n, v in c.items()}
                             for key, c in pc.items()})]
    routing.reference()
    rl, rc = ref_tfm.forward_prefill(rp, jnp.asarray(toks), rcfg,
                                     max_len=s + n_dec)
    want = [(rl, rc)]
    tok = jnp.argmax(rl, -1).astype(jnp.int32)
    for i in range(n_dec):
        with torch.inference_mode():
            pl, pc = tfm.forward_decode(pp, _torch(tok), s + i, pc, pcfg)
        got.append((pl.clone(), None))
        rl, rc = ref_tfm.forward_decode(rp, tok, jnp.int32(s + i), rc, rcfg)
        want.append((rl, None))
        tok = jnp.argmax(rl, -1).astype(jnp.int32)
    for i, ((pl, pc), (rl, rc)) in enumerate(zip(got, want)):
        _close(pl, rl, dtype, f"logits {i}")
        for key in rc or {}:
            for leaf in ("k", "v"):
                _close(pc[key][leaf], rc[key][leaf], dtype, f"{key}.{leaf}")
            np.testing.assert_array_equal(pc[key]["pos"].numpy(),
                                          np.asarray(rc[key]["pos"]))
    _, drops, _ = routing.check(record_property)
    assert len(routing.port) == pcfg.n_layers * (1 + n_dec)
    if arch == "moonshot-v1-16b-a3b":
        assert drops[b] > 0  # decode at batch 4 drops tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_train_loss_and_grads_match_reference(arch, dtype,
                                                      monkeypatch,
                                                      record_property):
    """Logits, loss and every parameter's gradient (the fp32 router's and
    the experts' included) against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, remat on; routing held as ``Routing`` says."""
    rcfg, pcfg = _configs(arch, dtype, remat=True)
    tree = _tree(rcfg, seed=1)
    batch = TokenStream(rcfg.vocab, 2, 32, seed=4).batch_at(0)
    tok, lab = batch["tokens"], batch["labels"]
    rp = jax.tree.map(jnp.asarray, tree)
    pp = tfm.params_from_reference(pcfg, tree)
    routing = Routing(monkeypatch, pcfg, dtype)
    got_logits = tfm.forward_train(pp, torch.from_numpy(tok), pcfg)
    leaves = [x.requires_grad_(True) for x in tree_leaves(pp)]
    p_loss = tfm.loss_fn(pp, torch.from_numpy(tok), torch.from_numpy(lab),
                         pcfg)
    grads = torch.autograd.grad(p_loss, leaves)
    routing.reference()
    want_logits = ref_tfm.forward_train(rp, jnp.asarray(tok), rcfg)
    r_loss, r_grads = jax.value_and_grad(ref_tfm.loss_fn)(
        rp, jnp.asarray(tok), jnp.asarray(lab), rcfg)
    _close(got_logits, want_logits, dtype, "logits")
    tol = F32_REL if dtype == "float32" else BF16_TOL
    assert abs(float(p_loss.detach()) - float(r_loss)) <= tol * abs(
        float(r_loss))
    want = tree_paths(jax.tree.map(np.asarray, r_grads))
    assert len(want) == len(grads)
    for (path, w), g, x in zip(want, grads, leaves):
        assert g.dtype == x.dtype, path
        _leaf_close(g, w, dtype, path)
    routing.check(record_property)


@pytest.mark.parametrize("arch,dtype", [("moonshot-v1-16b-a3b", "float32"),
                                        ("phi3.5-moe-42b-a6.6b", "float32"),
                                        ("moonshot-v1-16b-a3b", "bfloat16")])
def test_train_steps_with_two_microbatches_match_reference(
        arch, dtype, monkeypatch, record_property):
    """Three steps of the launcher's optimizer with 2 microbatches: each
    microbatch (2 x 16 tokens) is routed alone, with its own capacity, as
    the reference routes it; every loss, parameter and moment; routing
    held as ``Routing`` says."""
    rcfg, pcfg = _configs(arch, dtype)
    tree = _tree(rcfg, seed=2)
    steps = 3
    r_opt = ref_opt.adamw(lr=ref_opt.cosine_schedule(3e-4, 2, steps))
    p_opt = opt.adamw(lr=opt.cosine_schedule(3e-4, 2, steps))
    p_step = tl.make_lm_train_step(pcfg, p_opt, n_microbatches=2)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = r_opt.init(rp)
    pp = tfm.params_from_reference(pcfg, tree)
    ps = opt.state_from_reference(rs)
    stream = TokenStream(rcfg.vocab, 4, 16, seed=5)
    routing = Routing(monkeypatch, pcfg, dtype)
    p_losses = []
    for i in range(steps):
        pp, ps, pm = p_step(pp, ps, {k: torch.from_numpy(v)
                                     for k, v in stream.batch_at(i).items()})
        p_losses.append(float(pm["loss"]))
    assert {x.shape[0] for x, _, _, _ in routing.port} == {2 * 16}
    assert len(routing.port) == steps * 2 * pcfg.n_layers
    routing.reference()
    r_step = jax.jit(ref_tl.make_lm_train_step(rcfg, r_opt,
                                               n_microbatches=2))
    tol = F32_REL if dtype == "float32" else BF16_TOL
    for i in range(steps):
        b = stream.batch_at(i)
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        want = float(rm["loss"])
        assert abs(p_losses[i] - want) <= tol * abs(want), (i, p_losses[i],
                                                            want)
    for (path, w), g in zip(tree_paths(jax.tree.map(np.asarray, rp)),
                            tree_leaves(pp)):
        _leaf_close(g, w, dtype, path)
        assert str(g.dtype)[6:] == w.dtype.name, path
    for r_tree, p_tree in ((rs.mu, ps.mu), (rs.nu, ps.nu)):
        for (path, w), g in zip(tree_paths(jax.tree.map(np.asarray, r_tree)),
                                tree_leaves(p_tree)):
            assert g.dtype == torch.float32
            _leaf_close(g, w, dtype, path)
    routing.check(record_property)


def test_remat_recomputes_the_same_routing():
    """Under remat the backward pass recomputes each block: the loss and
    every gradient equal those without remat, bit for bit."""
    out = []
    for remat in (False, True):
        rcfg, pcfg = _configs("moonshot-v1-16b-a3b", "bfloat16", remat=remat)
        pp = tfm.params_from_reference(pcfg, _tree(rcfg))
        batch = TokenStream(pcfg.vocab, 2, 32, seed=3).batch_at(0)
        leaves = [x.requires_grad_(True) for x in tree_leaves(pp)]
        loss = tfm.loss_fn(pp, torch.from_numpy(batch["tokens"]),
                           torch.from_numpy(batch["labels"]), pcfg)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_reference_keeps_the_router_fp32(arch):
    """The router stays fp32 in a bf16 tree; a router of another dtype, a
    missing MoE leaf or a dense leaf beside it is refused."""
    rcfg, pcfg = _configs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, ref_tfm.init_params(rcfg,
                                                        jax.random.key(0)))
    pp = tfm.params_from_reference(pcfg, tree)
    m = pp["layers"]["sub0_global"]["moe"]
    assert m["router"].dtype == torch.float32
    assert all(m[n].dtype == torch.bfloat16
               for n in ("w_gate", "w_up", "w_down"))
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["sub0_global"]["moe"]["router"] = np.asarray(
        tree["layers"]["sub0_global"]["moe"]["router"]).astype(
        jnp.bfloat16)
    with pytest.raises(TypeError, match="config says"):
        tfm.params_from_reference(pcfg, bad)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["layers"]["sub0_global"]["moe"]["w_up"]
    with pytest.raises(ValueError, match="leaves"):
        tfm.params_from_reference(pcfg, bad)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["sub0_global"]["w_up"] = bad["layers"]["sub0_global"][
        "moe"]["w_up"]
    with pytest.raises(ValueError, match="leaves"):
        tfm.params_from_reference(pcfg, bad)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_counts_equal_the_references(arch):
    for make in ("config", "smoke_config"):
        want = getattr(ref_registry.get_arch(arch), make)()
        got = getattr(registry.get_arch(arch), make)()
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.active_param_count() < got.param_count()
    cfg = registry.get_arch("stablelm-1.6b").config()
    assert cfg.active_param_count() == cfg.param_count()


# --------------------------------------------------------------------------
# launchers and checkpoint
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_main_moe_on_the_cpu(arch, capsys):
    import re

    result = {}
    assert serve.main(["--arch", arch, "--smoke", "--batch", "4",
                       "--tokens", "3", "--device", "cpu"],
                      result=result) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and re.match(
        rf"^\[{re.escape(arch)}\] prefill [\d.]+ ms \| decode [\d.]+ "
        r"ms/tok \| throughput \d+ tok/s$", out[0]), out
    assert result["tokens"].shape == (4, 4)
    assert torch.isfinite(result["prefill_logits"]).all()
    assert result["params"]["layers"]["sub0_global"]["moe"][
        "router"].dtype == torch.float32


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_main_moe_on_the_cpu(arch, capsys):
    result = {}
    assert train.main(["--arch", arch, "--smoke", "--steps", "3",
                       "--device", "cpu"], result=result) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{arch}] loss ") and "over 3 steps" in line
    losses = [m["loss"] for m in result["log"]]
    assert np.isfinite(losses).all()
    assert result["params"]["layers"]["sub0_global"]["moe"][
        "router"].dtype == torch.float32


def test_checkpoint_round_trip_of_an_moe_tree(tmp_path):
    """A bf16 MoE tree with its fp32 router: the reference's flattened
    keys and bytes (bf16 as ``|V2``, the router as float32), and a restore
    with the same bits and dtypes."""
    rcfg, pcfg = _configs("moonshot-v1-16b-a3b", "bfloat16")
    tree = _tree(rcfg)
    pp = tfm.params_from_reference(pcfg, tree)
    want = ref_ckpt.flatten_tree({"params": tree})
    got = flatten_tree({"params": pp})
    assert list(got) == list(want)
    assert any(k.endswith("moe/router") for k in got)
    for k in want:
        assert got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
        if k.endswith("router"):
            assert got[k].dtype == want[k].dtype == np.float32
        else:  # how numpy writes the reference's bfloat16 arrays
            assert got[k].dtype == np.dtype("V2")
            assert want[k].dtype.name == "bfloat16"
    cm = CheckpointManager(str(tmp_path))
    state = {"params": pp, "opt_state": opt.adamw(lr=1e-3).init(pp)}
    cm.save(3, state, meta={"next_step": 3})
    back, meta = cm.restore(state, device="cpu")
    assert meta["next_step"] == 3
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        else:
            assert torch.equal(a, b)
