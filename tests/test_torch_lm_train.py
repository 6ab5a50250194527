"""The port's LM training path held against the reference on the same
seeded numpy inputs and the reference's own initialised parameters:
``TokenStream``, ``forward_train`` / ``loss_fn`` (dense and flash branches,
remat on and off), their gradients against ``jax.grad``, the train step
with 1 and 2 microbatches and fp32 / bf16 accumulation over several steps,
checkpoints of bf16 parameters, and the launcher.

Tolerances, each with its reason:

- ``TokenStream``: exact (the same numpy draws);
- fp32 losses, logits, gradients and parameters after steps: 1e-5
  relative (logits and losses element by element; a gradient or a
  parameter leaf in relative L2): the same fp32 math in another summation
  order over two small layers, and the optimizer's elementwise update;
- bf16: the serve tests' bf16 tolerance, 5e-2 absolute and relative L2
  (``tests/test_torch_serve.py``): the frameworks round to bf16 at
  different places;
- remat on against remat off: exact (the same ops run again).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data.tokens import TokenStream as RefTokenStream
from repro.models import transformer as ref_tfm
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl
from repro_torch.train.checkpoint import CheckpointManager, flatten_tree
from repro_torch.tree import tree_leaves, tree_paths

F32_REL = 1e-5
BF16_TOL = 5e-2


def _configs(arch, dtype, *, flash=False, remat=None):
    rcfg = ref_registry.get_arch(arch).smoke_config()
    pcfg = registry.get_arch(arch).smoke_config()
    kw = {}
    if flash:  # a 64-token batch takes the flash branch in blocks of 16
        kw.update(flash_cutoff=32, flash_block=16)
    if remat is not None:
        kw.update(remat=remat)
    rcfg = dataclasses.replace(rcfg, dtype=getattr(jnp, dtype), **kw)
    pcfg = dataclasses.replace(pcfg, dtype=getattr(torch, dtype), **kw)
    return rcfg, pcfg


def _tree(rcfg, seed=0):
    """The reference's initialised parameters as numpy, every norm weight
    (zeros or ones at init) replaced by noise."""
    tree = jax.tree.map(np.asarray,
                        ref_tfm.init_params(rcfg, jax.random.key(seed)))
    rng = np.random.default_rng(1)

    def noise(path, a):
        if "norm" in path[-1].key:
            return (rng.normal(size=a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(noise, tree)


def _tokens(rcfg, b, s, seed=0):
    stream = TokenStream(rcfg.vocab, b, s, seed=seed)
    return stream.batch_at(0)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel_l2(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _check_leaves(got_tree, want_tree, dtype, what):
    want = tree_paths(jax.tree.map(np.asarray, want_tree))
    got = tree_leaves(got_tree)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        assert tuple(g.shape) == w.shape, (what, path)
        err = _rel_l2(g, w)
        assert err <= (F32_REL if dtype == "float32" else BF16_TOL), (
            what, path, err)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,b,s,seed", [(512, 4, 64, 0),
                                            (100_352, 2, 33, 7)])
def test_token_stream_batches_are_bit_equal(vocab, b, s, seed):
    ref_s, port_s = RefTokenStream(vocab, b, s, seed), TokenStream(vocab, b,
                                                                   s, seed)
    for step in (0, 1, 5, 1000):
        want, got = ref_s.batch_at(step), port_s.batch_at(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert port_s.state(3) == ref_s.state(3)
    again = TokenStream.from_state(vocab, b, s, port_s.state(3))
    np.testing.assert_array_equal(again.batch_at(2)["tokens"],
                                  ref_s.batch_at(2)["tokens"])


# --------------------------------------------------------------------------
# forward_train, loss_fn and their gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma2-27b"])
def test_forward_train_loss_and_grads_match_reference(arch, dtype, flash,
                                                      monkeypatch):
    """Logits, loss and every parameter's gradient. gemma2: window,
    softcaps, post-norms, zero-centred norms, tied embeddings, remat off
    (its smoke config's); stablelm: remat on (its published config's),
    G = 1. ``flash`` lowers the cutoff so a 64-token batch takes the flash
    branch: the blocked softmax, never B8."""
    rcfg, pcfg = _configs(arch, dtype, flash=flash,
                          remat=arch == "stablelm-1.6b")
    tree = _tree(rcfg)
    batch = _tokens(rcfg, 2, 64 if flash else 32)
    rp = jax.tree.map(jnp.asarray, tree)
    pp = tfm.params_from_reference(pcfg, tree)
    tok, lab = batch["tokens"], batch["labels"]
    monkeypatch.setattr(ops, "flash_attention_gqa", None)  # never reached

    want_logits = ref_tfm.forward_train(rp, jnp.asarray(tok), rcfg)
    got_logits = tfm.forward_train(pp, torch.from_numpy(tok), pcfg)
    assert got_logits.dtype == pcfg.dtype
    r_loss, r_grads = jax.value_and_grad(ref_tfm.loss_fn)(
        rp, jnp.asarray(tok), jnp.asarray(lab), rcfg)
    leaves = [x.requires_grad_(True) for x in tree_leaves(pp)]
    p_loss = tfm.loss_fn(pp, torch.from_numpy(tok), torch.from_numpy(lab),
                         pcfg)
    grads = torch.autograd.grad(p_loss, leaves)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got_logits), _f32(want_logits),
                                   rtol=F32_REL, atol=F32_REL)
        np.testing.assert_allclose(float(p_loss.detach()), float(r_loss),
                                   rtol=F32_REL)
    else:
        got, want = _f32(got_logits), _f32(want_logits)
        assert np.abs(got - want).max() <= BF16_TOL
        assert _rel_l2(got, want) <= BF16_TOL
        assert abs(float(p_loss.detach()) - float(r_loss)) <= BF16_TOL * abs(
            float(r_loss))
    _check_leaves(grads, r_grads, dtype, "grad")
    for g, x in zip(grads, leaves):
        assert g.dtype == x.dtype


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_remat_on_equals_remat_off(flash):
    """Recomputing each block in the backward pass changes no bit of the
    loss or of any gradient."""
    out = []
    for remat in (False, True):
        rcfg, pcfg = _configs("gemma2-27b", "float32", flash=flash,
                              remat=remat)
        tree = _tree(rcfg)
        batch = _tokens(rcfg, 2, 64 if flash else 32, seed=3)
        pp = tfm.params_from_reference(pcfg, tree)
        leaves = [x.requires_grad_(True) for x in tree_leaves(pp)]
        loss = tfm.loss_fn(pp, torch.from_numpy(batch["tokens"]),
                           torch.from_numpy(batch["labels"]), pcfg)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_keeps_only_block_inputs():
    """Under remat a block's activations are not saved for the backward
    pass: fewer tensors are held by the graph than without it."""
    def saved(remat):
        _, pcfg = _configs("stablelm-1.6b", "float32", remat=remat)
        pp = tfm.init_params(pcfg, torch.Generator().manual_seed(0))
        for x in tree_leaves(pp):
            x.requires_grad_(True)
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        tok = torch.zeros((2, 32), dtype=torch.int32)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tfm.loss_fn(pp, tok, tok, pcfg)
        return n[0]

    assert saved(True) < saved(False)


def test_b8_refuses_tensors_that_require_grad():
    """B8 has no backward, in the reference too: its wrapper raises for an
    input that requires grad (on either device) and runs under no_grad."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 16, 2, 1, 64), generator=g)
    k = torch.randn((1, 16, 2, 64), generator=g)
    v = torch.randn((1, 16, 2, 64), generator=g)
    for grad_on in ((q,), (k,), (v,)):
        args = [x.clone().requires_grad_(x is grad_on[0]) for x in (q, k, v)]
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention_gqa(*args, scale=0.125)
        with torch.no_grad():
            out = ops.flash_attention_gqa(*args, scale=0.125)
        assert out.shape == q.shape and not out.requires_grad
    assert fa.launches() == 0


def test_prefill_still_reaches_b8_and_training_does_not(monkeypatch):
    """At the flash cutoff prefill calls B8's wrapper once a layer and
    training never does (the wrapper would raise on its tensors)."""
    _, pcfg = _configs("stablelm-1.6b", "float32", flash=True)
    pp = tfm.init_params(pcfg, torch.Generator().manual_seed(0))
    tok = torch.zeros((1, 64), dtype=torch.int32)
    calls = []
    real = ops.flash_attention_gqa
    monkeypatch.setattr(ops, "flash_attention_gqa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.inference_mode():
        tfm.forward_prefill(pp, tok, pcfg, max_len=64)
    assert len(calls) == pcfg.n_layers
    for x in tree_leaves(pp):
        x.requires_grad_(True)
    tfm.loss_fn(pp, tok, tok, pcfg).backward()
    assert len(calls) == pcfg.n_layers


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_configs_train_through_the_flash_branch(arch, monkeypatch):
    """The MoE LMs at the flash branch of training (a 64-token batch with
    the cutoff lowered, the blocked softmax, never B8), remat on, fp32:
    logits, loss and every gradient (the fp32 router's too) against
    ``jax.grad``."""
    rcfg, pcfg = _configs(arch, "float32", flash=True, remat=True)
    tree = _tree(rcfg, seed=3)
    batch = _tokens(rcfg, 2, 64, seed=2)
    rp = jax.tree.map(jnp.asarray, tree)
    pp = tfm.params_from_reference(pcfg, tree)
    tok, lab = batch["tokens"], batch["labels"]
    monkeypatch.setattr(ops, "flash_attention_gqa", None)  # never reached
    want_logits = ref_tfm.forward_train(rp, jnp.asarray(tok), rcfg)
    r_loss, r_grads = jax.value_and_grad(ref_tfm.loss_fn)(
        rp, jnp.asarray(tok), jnp.asarray(lab), rcfg)
    got_logits = tfm.forward_train(pp, torch.from_numpy(tok), pcfg)
    np.testing.assert_allclose(_f32(got_logits), _f32(want_logits),
                               rtol=F32_REL, atol=F32_REL)
    leaves = [x.requires_grad_(True) for x in tree_leaves(pp)]
    p_loss = tfm.loss_fn(pp, torch.from_numpy(tok), torch.from_numpy(lab),
                         pcfg)
    np.testing.assert_allclose(float(p_loss.detach()), float(r_loss),
                               rtol=F32_REL)
    _check_leaves(torch.autograd.grad(p_loss, leaves), r_grads, "float32",
                  "grad")
    router = pp["layers"]["sub0_global"]["moe"]["router"]
    assert router.dtype == torch.float32


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype,n_mb,accum", [
    ("stablelm-1.6b", "float32", 1, "float32"),
    ("stablelm-1.6b", "float32", 2, "float32"),
    ("gemma2-27b", "float32", 2, "float32"),
    ("stablelm-1.6b", "bfloat16", 2, "float32"),
    ("stablelm-1.6b", "bfloat16", 2, "bfloat16"),
    ("gemma2-27b", "bfloat16", 1, "bfloat16"),
])
def test_lm_train_steps_match_reference(arch, dtype, n_mb, accum):
    """Four steps of the launcher's optimizer (cosine schedule with warm-up,
    clip, weight decay) from the reference's copied parameters and
    optimizer state, on ``TokenStream`` batches of 4 x 32: every loss,
    then every parameter and both moments. stablelm with remat on."""
    rcfg, pcfg = _configs(arch, dtype, remat=arch == "stablelm-1.6b")
    tree = _tree(rcfg, seed=2)
    steps = 4
    r_opt = ref_opt.adamw(lr=ref_opt.cosine_schedule(3e-4, 2, steps))
    p_opt = opt.adamw(lr=opt.cosine_schedule(3e-4, 2, steps))
    r_step = jax.jit(ref_tl.make_lm_train_step(
        rcfg, r_opt, n_microbatches=n_mb, accum_dtype=getattr(jnp, accum)))
    p_step = tl.make_lm_train_step(pcfg, p_opt, n_microbatches=n_mb,
                                   accum_dtype=getattr(torch, accum))
    rp = jax.tree.map(jnp.asarray, tree)
    rs = r_opt.init(rp)
    pp = tfm.params_from_reference(pcfg, tree)
    ps = opt.state_from_reference(rs)
    stream = TokenStream(rcfg.vocab, 4, 32, seed=5)
    before = [x.clone() for x in tree_leaves(pp)]
    for i in range(steps):
        b = stream.batch_at(i)
        rp, rs, rm = r_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        new_pp, ps, pm = p_step(pp, ps, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        if i == 0:  # the step is functional: its inputs are unchanged
            assert all(torch.equal(a, c)
                       for a, c in zip(before, tree_leaves(pp)))
        pp = new_pp
        want, got = float(rm["loss"]), float(pm["loss"])
        tol = F32_REL if dtype == "float32" else BF16_TOL
        assert abs(got - want) <= tol * abs(want), (i, got, want)
    _check_leaves(pp, rp, dtype, "param")
    for x in tree_leaves(pp):
        assert x.dtype == pcfg.dtype
    assert int(ps.count) == steps and ps.count.dtype == torch.int32
    for r_tree, p_tree in ((rs.mu, ps.mu), (rs.nu, ps.nu)):
        for x in tree_leaves(p_tree):
            assert x.dtype == torch.float32
        _check_leaves(p_tree, r_tree, dtype, "moment")


def test_microbatches_sum_to_the_full_batch():
    """Two microbatches of 2 rows with fp32 accumulation give the mean of
    the two halves' gradients: the same update as the reference's."""
    _, pcfg = _configs("stablelm-1.6b", "float32")
    pp = tfm.init_params(pcfg, torch.Generator().manual_seed(4))
    b = {k: torch.from_numpy(v) for k, v in
         TokenStream(pcfg.vocab, 4, 16, seed=1).batch_at(0).items()}
    o = opt.adamw(lr=1e-3, clip_norm=None)
    _, _, m2 = tl.make_lm_train_step(pcfg, o, n_microbatches=2)(
        pp, o.init(pp), b)
    halves = [float(tfm.loss_fn(pp, b["tokens"][r], b["labels"][r], pcfg))
              for r in (slice(0, 2), slice(2, 4))]
    np.testing.assert_allclose(float(m2["loss"]), np.mean(halves),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# checkpoints of bf16 parameters
# --------------------------------------------------------------------------
def test_bf16_leaves_are_stored_as_the_reference_stores_them(tmp_path):
    """A bf16 leaf goes to the ``.npz`` as 2-byte void values holding its
    bits, under the reference's key, as numpy writes the reference's
    bfloat16 arrays; restored onto a device it is bf16 with the same
    bits."""
    rcfg, pcfg = _configs("gemma2-27b", "bfloat16")
    tree = _tree(rcfg)
    pp = tfm.params_from_reference(pcfg, tree)
    want = ref_ckpt.flatten_tree({"params": tree})
    got = flatten_tree({"params": pp})
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.dtype("V2") and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"params": pp})
    back, _ = cm.restore({"params": pp}, device="cpu")
    for a, b in zip(tree_leaves(pp), tree_leaves(back["params"])):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    raw, _ = cm.restore({"params": pp})
    assert all(isinstance(x, np.ndarray) and x.dtype == np.dtype("V2")
               for x in tree_leaves(raw["params"]))


def test_restart_resumes_identically_with_bf16_leaves(tmp_path):
    """Train 4 steps straight vs train 2 + checkpoint + restore + 2, bf16
    parameters and fp32 moments: identical parameters and moments."""
    _, pcfg = _configs("gemma2-27b", "bfloat16")
    o = opt.adamw(lr=opt.cosine_schedule(3e-4, 2, 4))
    step = tl.make_lm_train_step(pcfg, o, n_microbatches=2)
    stream = TokenStream(pcfg.vocab, 4, 16, seed=2)

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in stream.batch_at(i).items()}

    def fresh():
        p = tfm.init_params(pcfg, torch.Generator().manual_seed(1))
        return p, o.init(p)

    p, s = fresh()
    for i in range(4):
        p, s, _ = step(p, s, batch(i))
    straight = tree_leaves({"params": p, "opt_state": s})

    cm = CheckpointManager(str(tmp_path))
    p, s = fresh()
    for i in range(2):
        p, s, _ = step(p, s, batch(i))
    cm.save(2, {"params": p, "opt_state": s}, meta={"next_step": 2})
    p2, s2 = fresh()
    state, meta = cm.restore({"params": p2, "opt_state": s2}, device="cpu")
    p2, s2 = state["params"], state["opt_state"]
    assert isinstance(s2, opt.AdamWState) and s2.count.dtype == torch.int32
    for i in range(meta["next_step"], 4):
        p2, s2, _ = step(p2, s2, batch(i))
    resumed = tree_leaves({"params": p2, "opt_state": s2})
    for a, b in zip(straight, resumed):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma2-27b",
                                  "qwen2.5-14b"])
def test_train_main_lm_on_the_cpu(arch, capsys):
    assert train.main(["--arch", arch, "--smoke", "--steps", "3",
                       "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{arch}] loss ") and "over 3 steps" in line


def test_train_build_lm_is_the_references_wiring():
    """The launcher's LM wiring: the smoke config under ``--smoke``, the
    reference's schedule, ``TokenStream(vocab, 4, 64, seed)`` on the
    device, two microbatches; the full config without ``--smoke``."""
    params, optim, step, data_fn = train.build("stablelm-1.6b", 3, "cpu",
                                               smoke=True, steps=12)
    cfg = registry.get_arch("stablelm-1.6b").smoke_config()
    b = data_fn(2)
    want = RefTokenStream(cfg.vocab, 4, 64, seed=3).batch_at(2)
    for k in want:
        assert isinstance(b[k], torch.Tensor)
        np.testing.assert_array_equal(b[k].numpy(), want[k])
    ref_lr = ref_opt.cosine_schedule(3e-4, min(20, 12 // 4 + 1), 12)
    for s in (0, 1, 4, 12):
        np.testing.assert_allclose(float(optim.lr(torch.tensor(s))),
                                   float(ref_lr(s)), rtol=1e-6)
    assert tree_leaves(params)[0].shape[-1] == cfg.d_model
    state = optim.init(params)
    _, state, m = step(params, state, b)
    assert np.isfinite(float(m["loss"])) and int(state.count) == 1


def test_lm_resume_from_a_checkpoint(tmp_path, capsys):
    """Four steps straight (checkpoints at 2 and 4) against a restart from
    the step-2 checkpoint: the same parameters, bit for bit."""
    import shutil

    first, second = tmp_path / "a", tmp_path / "b"
    argv = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--steps", "4", "--ckpt-every", "2"]
    out = {}
    assert train.main(argv + ["--ckpt-dir", str(first)], result=out) == 0
    second.mkdir()
    shutil.copytree(first / "step_0000000002", second / "step_0000000002")
    (second / "latest").write_text("step_0000000002")
    resumed = {}
    assert train.main(argv + ["--ckpt-dir", str(second), "--resume"],
                      result=resumed) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    assert [m["step"] for m in resumed["log"]] == [2, 3]
    for a, b in zip(tree_leaves(out["params"]),
                    tree_leaves(resumed["params"])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
