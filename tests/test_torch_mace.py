"""The port's MACE (``repro_torch.models.gnn.{so3,mace}``) held against the
reference on the same seeded numpy inputs and the reference's own
parameters, and every case of ``tests/test_so3_mace.py`` rerun on the port.

Tolerances, each with its reason:

- ``cg_real``, ``cg_real_racah`` and ``wigner_d_real``: bit for bit (the
  same numpy code on probe harmonics that are bit-equal in float32);
- ``real_sph_harm`` 1e-6: the same float32 formulas, whose vectorised
  evaluation may round differently in the last place;
- node energies, graph energies and the loss 1e-5 (``LOGITS_TOL``), every
  leaf's gradient and the forces 1e-5 x (1 + max|g|) (``GRAD_TOL``): the
  other GNNs' tolerances. The port contracts the three-operand einsums in
  another order (the coupling tensor first) and sums edges in destination
  order; the measured difference on the smoke batch is below 2e-7 relative;
- rotation and translation invariance rtol 1e-4, as the reference's own
  tests: the coupling tensors are equivariant to the lstsq Wigner matrices'
  floor (~1e-6), and the sums are fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import inputs as ref_inputs
from repro.models.gnn import mace as ref_mace
from repro.models.gnn import so3 as ref_so3
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.configs import registry
from repro_torch.models.gnn import common, mace, so3
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop as tl
from repro_torch.train.checkpoint import flatten_tree
from repro_torch.tree import tree_leaves, tree_paths

SH_TOL = 1e-6
LOGITS_TOL = 1e-5
GRAD_TOL = 1e-5
INVARIANCE_RTOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def random_rotation(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def _sh(v, l):
    return so3.real_sph_harm(torch.as_tensor(v), l)[l].numpy()


# --------------------------------------------------------------------------
# so3: the coupling tensors and the harmonics against the reference
# --------------------------------------------------------------------------
COUPLINGS_L3 = [(l1, l2, l3) for l1 in range(4) for l2 in range(4)
                for l3 in range(abs(l1 - l2), min(l1 + l2, 3) + 1)]


@pytest.mark.parametrize("l1,l2,l3", COUPLINGS_L3)
def test_cg_real_is_bit_equal_to_the_reference(l1, l2, l3):
    for fn in ("cg_real", "cg_real_racah"):
        want = getattr(ref_so3, fn)(l1, l2, l3)
        got = getattr(so3, fn)(l1, l2, l3)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn


def test_wigner_d_real_is_bit_equal_to_the_reference():
    rot = random_rotation(11)
    for l in range(4):
        assert np.array_equal(so3.wigner_d_real(l, rot),
                              ref_so3.wigner_d_real(l, rot)), l
    assert so3.irrep_dims(3) == ref_so3.irrep_dims(3)


@pytest.mark.parametrize("l_max", [0, 1, 2, 3])
def test_real_sph_harm_matches_the_reference(l_max):
    """Random vectors of any length, zero vectors, vectors so short that
    ``r = sqrt(|v|^2 + 1e-12)`` rounds to the degenerate radius (Y_l = 0
    for l >= 1 where r <= 1e-6) and vectors just above it."""
    rng = np.random.default_rng(20 + l_max)
    v = rng.normal(size=(200, 3)).astype(np.float32) * 3.0
    v[:4] = 0.0
    v[4:8] = rng.normal(size=(4, 3)) * 1e-10
    v[8] = [1e-6, 0.0, 0.0]
    v[9] = [2e-6, 0.0, 0.0]
    want = ref_so3.real_sph_harm(jnp.asarray(v), l_max)
    got = so3.real_sph_harm(t(v), l_max)
    assert sorted(got) == sorted(want) == list(range(l_max + 1))
    for l in want:
        assert got[l].dtype == torch.float32
        assert got[l].shape == tuple(want[l].shape)
        close(got[l], want[l], SH_TOL)
        if l >= 1:
            assert not got[l][:8].any()
            assert got[l][8:10].abs().amax(1).min() > 0.1


def test_real_sph_harm_above_l3_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        so3.real_sph_harm(torch.ones(2, 3), 4)


# --------------------------------------------------------------------------
# the cases of tests/test_so3_mace.py, on the port
# --------------------------------------------------------------------------
def test_cg_selection_rules():
    for (l1, l2, l3) in [(1, 1, 0), (1, 1, 1), (1, 1, 2), (2, 1, 1),
                         (2, 2, 2), (2, 2, 0)]:
        c = so3.cg_real(l1, l2, l3)
        assert c.shape == (2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1)
        assert np.abs(c).max() > 1e-3, (l1, l2, l3)


def test_cg_l1l1_l0_is_dot_product():
    c = so3.cg_real(1, 1, 0)[:, :, 0]
    off = c - np.diag(np.diag(c))
    assert np.abs(off).max() < 1e-5
    d = np.diag(c)
    assert np.allclose(d, d[0], atol=1e-5) and abs(d[0]) > 0.1


def test_sph_harm_norm_invariance():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(32, 3))
    rot = random_rotation(2)
    for l in range(4):
        np.testing.assert_allclose(
            np.linalg.norm(_sh(v, l), axis=-1),
            np.linalg.norm(_sh(v @ rot.T, l), axis=-1), rtol=1e-5)


def test_sph_harm_wigner_consistency():
    rot = random_rotation(3)
    rng = np.random.default_rng(4)
    v = rng.normal(size=(64, 3))
    for l in (1, 2):
        d = so3.wigner_d_real(l, rot)
        np.testing.assert_allclose(_sh(v @ rot.T, l), _sh(v, l) @ d.T,
                                   atol=1e-5)
        np.testing.assert_allclose(d @ d.T, np.eye(2 * l + 1), atol=1e-5)


def test_cg_coupling_rotation_invariant_norm():
    rng = np.random.default_rng(5)
    v1 = rng.normal(size=(16, 3))
    v2 = rng.normal(size=(16, 3))
    rot = random_rotation(6)
    for (l1, l2, l3) in [(1, 1, 2), (2, 1, 1), (2, 2, 2)]:
        c = so3.cg_real(l1, l2, l3)

        def coupled(a, b):
            return np.einsum("na,nb,abc->nc", _sh(a, l1), _sh(b, l2), c)

        np.testing.assert_allclose(
            np.linalg.norm(coupled(v1, v2), axis=-1),
            np.linalg.norm(coupled(v1 @ rot.T, v2 @ rot.T), axis=-1),
            rtol=1e-5)


def mace_batch(rng, n=20, e=60):
    """The reference test's batch, as numpy arrays."""
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return {
        "node_feat": rng.integers(0, 4, n).astype(np.int32),
        "positions": pos,
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": np.ones(e, bool),
        "node_mask": np.ones(n, bool),
    }


def _test_model():
    cfg = mace.MACEConfig(channels=8, n_rbf=4, n_species=4)
    return cfg, mace.init_params(cfg, torch.Generator().manual_seed(0))


def test_mace_energy_rotation_invariant():
    cfg, params = _test_model()
    batch = {k: t(v) for k, v in
             mace_batch(np.random.default_rng(7)).items()}
    _, e1 = mace.apply(params, batch, cfg)
    rot = t(random_rotation(8).astype(np.float32))
    _, e2 = mace.apply(params, dict(batch, positions=batch["positions"]
                                    @ rot.T), cfg)
    np.testing.assert_allclose(float(e1), float(e2), rtol=INVARIANCE_RTOL)


def test_mace_energy_translation_invariant():
    cfg, params = _test_model()
    batch = {k: t(v) for k, v in
             mace_batch(np.random.default_rng(9)).items()}
    _, e1 = mace.apply(params, batch, cfg)
    _, e2 = mace.apply(params, dict(batch, positions=batch["positions"]
                                    + 5.0), cfg)
    np.testing.assert_allclose(float(e1), float(e2), rtol=INVARIANCE_RTOL)


def test_mace_forces_exist():
    cfg, params = _test_model()
    batch = {k: t(v) for k, v in
             mace_batch(np.random.default_rng(10)).items()}
    pos = batch["positions"].clone().requires_grad_(True)
    (f,) = torch.autograd.grad(
        mace.apply(params, dict(batch, positions=pos), cfg)[1], pos)
    assert torch.isfinite(f).all() and f.abs().max() > 0


# --------------------------------------------------------------------------
# the model against the reference, from the reference's parameters
# --------------------------------------------------------------------------
def _case(seed=0):
    """(cfg, ref cfg, numpy smoke batch, perturbed numpy parameters)."""
    rng = np.random.default_rng(seed)
    ref_cfg, batch = ref_inputs.make_smoke_batch("mace", "gnn_train", rng)
    tree = ref_mace.init_params(ref_cfg, jax.random.key(seed))
    noise = np.random.default_rng(seed + 100)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * noise.normal(size=np.shape(a))
                   ).astype(np.float32), tree)
    return registry.get_arch("mace").smoke_config(), ref_cfg, batch, tree


def _port_batch(batch, sort):
    b = {k: t(v) for k, v in batch.items()}
    return common.sort_edges_by_dst(b) if sort else b


def _grads(loss, leaves):
    """Per leaf, 0 where the loss does not use it (as ``jax.grad``)."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, gs)]


@pytest.mark.parametrize("sort", [True, False])
def test_mace_energies_loss_and_gradients_match_reference(sort):
    """``apply`` on the reference's smoke batch (edges sorted by
    destination, and as drawn; self-loops among them) and the gradient of
    ``_gnn_loss`` per leaf, with the reference's parameters copied across."""
    cfg, ref_cfg, batch, tree = _case()
    assert (batch["edge_src"] == batch["edge_dst"]).any()  # self-loops
    jb = jax.tree.map(jnp.asarray, batch)
    jp = jax.tree.map(jnp.asarray, tree)
    ne_w, e_w = ref_mace.apply(jp, jb, ref_cfg)
    loss_w, grads_w = jax.value_and_grad(
        lambda p: ref_tl._gnn_loss(ref_mace.apply, ref_cfg, p, jb))(jp)
    pb = _port_batch(batch, sort)
    assert pb["node_feat"].dtype == torch.int32
    params = mace.params_from_reference(cfg, tree)
    ne, e = mace.apply(params, pb, cfg)
    assert ne.shape == ne_w.shape and e.shape == e_w.shape
    assert ne.dtype == e.dtype == torch.float32
    close(ne.detach(), ne_w, LOGITS_TOL)
    close(e.detach(), e_w, LOGITS_TOL)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = tl._gnn_loss(mace.apply, cfg, params, pb)
    close(loss.detach(), loss_w, LOGITS_TOL)
    gw_paths = tree_paths(jax.tree.map(np.asarray, grads_w))
    assert [p for p, _ in gw_paths] == [p for p, _ in tree_paths(params)]
    for (path, gw), g in zip(gw_paths, _grads(loss, leaves)):
        tol = GRAD_TOL * (1 + float(np.abs(gw).max()))
        np.testing.assert_allclose(g.numpy(), gw, rtol=0, atol=tol,
                                   err_msg=f"mace gradient {path}")


def test_mace_forces_match_jax_and_rotate_with_the_positions():
    """F = -dE/dpos (E the sum of the graph energies) against ``jax.grad``'s,
    and F(R x) = R F(x) for a seeded rotation R."""
    cfg, ref_cfg, batch, tree = _case(1)
    jp = jax.tree.map(jnp.asarray, tree)
    params = mace.params_from_reference(cfg, tree)
    pb = _port_batch(batch, True)
    rot = random_rotation(12).astype(np.float32)

    def ref_forces(pos):
        jb = dict(jax.tree.map(jnp.asarray, batch), positions=pos)
        return -np.asarray(jax.grad(
            lambda x: ref_mace.apply(jp, dict(jb, positions=x),
                                     ref_cfg)[1].sum())(pos))

    def forces(pos):
        x = t(pos).requires_grad_(True)
        (g,) = torch.autograd.grad(
            mace.apply(params, dict(pb, positions=x), cfg)[1].sum(), x)
        return -g.numpy()

    pos = batch["positions"]
    f = forces(pos)
    want = ref_forces(jnp.asarray(pos))
    np.testing.assert_allclose(
        f, want, rtol=0, atol=GRAD_TOL * (1 + float(np.abs(want).max())))
    f_rot = forces(pos @ rot.T)
    np.testing.assert_allclose(
        f_rot, f @ rot.T, rtol=0,
        atol=INVARIANCE_RTOL * (1 + float(np.abs(f).max())))


def _basis_and_slope(fn, x, cot):
    val = (fn(x, 8, 5.0) * cot).sum()
    return val, torch.autograd.grad(val, x)[0]


@pytest.mark.parametrize("r", [2.5, 5.0, 7.0])
def test_bessel_rbf_and_its_gradient_match_jax(r):
    """Values and ``d/dr`` of the basis against JAX's inside the cutoff, at
    ``r = r_cut`` (the tie of the envelope's clip) and beyond it."""
    cot = np.random.default_rng(3).normal(size=8).astype(np.float32)
    val_w, grad_w = jax.value_and_grad(
        lambda x: jnp.sum(ref_mace.bessel_rbf(x, 8, 5.0) * cot))(
        jnp.float32(r))
    x = torch.tensor(r, dtype=torch.float32, requires_grad=True)
    val, g = _basis_and_slope(mace.bessel_rbf, x, t(cot))
    np.testing.assert_allclose(float(val.detach()), float(val_w), rtol=1e-5)
    np.testing.assert_allclose(float(g), float(grad_w), rtol=1e-5,
                               atol=1e-5 * (1 + abs(float(grad_w))))


@pytest.mark.parametrize("self_loop", [True, False])
def test_bessel_rbf_floor_splits_the_gradient_as_jax(self_loop):
    """At the 1e-6 floor: a self-loop's distance ``sqrt(0 + 1e-12)`` ties it
    exactly in float32. The values equal JAX's; the floor splits the
    gradient at the tie as ``jnp.maximum`` does (not as ``clamp``), so
    ``d/dr`` there is half the basis's slope. The slope is checked in
    float64: in float32 it is the difference of two terms near 6e5 and
    rounding noise in both frameworks."""
    if self_loop:
        rj = jnp.sqrt(jnp.float32(0.0) + 1e-12)
        rt = torch.sqrt(torch.tensor(0.0) + 1e-12)
    else:
        rj, rt = jnp.float32(1e-6), torch.tensor(1e-6, dtype=torch.float32)
    assert float(rt) == float(rj) == float(np.float32(1e-6))
    cot = np.random.default_rng(3).normal(size=8).astype(np.float32)
    val_w = jnp.sum(ref_mace.bessel_rbf(rj, 8, 5.0) * cot)
    val = (mace.bessel_rbf(rt, 8, 5.0) * t(cot)).sum()
    np.testing.assert_allclose(float(val.detach()), float(val_w), rtol=1e-5)
    split_w = jax.grad(lambda x: jnp.maximum(x, 1e-6))(rj)
    x = rt.clone().requires_grad_(True)
    (split,) = torch.autograd.grad(torch.maximum(x, x.new_tensor(1e-6)), x)
    assert float(split) == float(split_w) == 0.5
    x64 = torch.tensor(1e-6, dtype=torch.float64, requires_grad=True)
    _, g_tie = _basis_and_slope(mace.bessel_rbf, x64, t(cot).double())
    above = torch.tensor(1e-6 * (1 + 1e-9), dtype=torch.float64,
                         requires_grad=True)
    _, g_above = _basis_and_slope(mace.bessel_rbf, above, t(cot).double())
    np.testing.assert_allclose(float(g_tie), 0.5 * float(g_above), rtol=1e-4)


def test_init_params_layout_couplings_and_checkpoint_keys():
    """The port's init has the reference's layout (nested ``str(l)`` keys),
    its 11 coupling paths at l_max 2, one cached coupling tensor per key,
    and the checkpoint keys of params + AdamW state are the reference's."""
    cfg, ref_cfg, _, tree = _case()
    got = mace.init_params(cfg, torch.Generator().manual_seed(0))
    assert [(p, tuple(x.shape)) for p, x in tree_paths(got)] == [
        (p, tuple(np.shape(x))) for p, x in tree_paths(tree)]
    assert mace._couplings(2) == ref_mace._couplings(2)
    assert len(mace._couplings(2)) == 11
    cpu = torch.device("cpu")
    c1 = mace._cg(1, 1, 2, cpu, torch.float32)
    assert c1 is mace._cg(1, 1, 2, cpu, torch.float32)
    assert torch.equal(c1, torch.as_tensor(ref_so3.cg_real(1, 1, 2),
                                           dtype=torch.float32))
    rs = ref_opt.adamw().init(jax.tree.map(jnp.asarray, tree))
    state = {"params": mace.params_from_reference(cfg, tree),
             "opt_state": opt.state_from_reference(rs)}
    want = ref_ckpt.flatten_tree({"params": tree, "opt_state": rs})
    assert list(flatten_tree(state)) == list(want)
