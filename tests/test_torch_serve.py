"""The port's serving path held against the reference on the same seeded
numpy inputs: kernels B8 (flash attention) and B10 (embedding bag) through
their plain torch versions, the model building blocks, LM prefill and
decode (dense and flash branches), DIN scoring, the serve launcher and the
registry.

On the CPU the port's wrappers take the kernels' plain versions; the
reference runs its Pallas kernels in interpret mode and its jnp oracles.
Tolerances, each with its reason:

- fp32 attention 2e-5 and embedding bags 2e-3: the reference's own kernel
  tests (``tests/test_kernels.py``) use them for the same comparisons;
- fp32 model outputs 1e-4: the same math in another summation order over
  a few layers, two orders of magnitude above fp32 rounding;
- DIN in fp32 1e-5: a handful of small dense layers;
- bf16 model logits 5e-2 absolute and relative L2: the two frameworks round
  to bf16 at different places (XLA rounds a fused elementwise chain once,
  torch after every op), 2^-9 relative each, over two layers of norms,
  products and softcaps.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.data.recsys import CTRStream as RefCTRStream
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.flash_attention import flash_attention as ref_flash_folded
from repro.models import common as ref_common
from repro.models import transformer as ref_tfm
from repro.models.attention import flash_attention_jnp
from repro.models.recsys import din as ref_din
from repro.models.recsys import embedding as ref_emb
from repro.train import train_loop as ref_tl
from repro_torch.configs import registry
from repro_torch.data.recsys import CTRStream
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import common, transformer as tfm
from repro_torch.models.attention import flash_attention_torch
from repro_torch.models.recsys import din, embedding
from repro_torch.train import train_loop as tl

F32_ATTN = 2e-5
BAG_TOL = 2e-3
MODEL_F32 = 1e-4
DIN_TOL = 1e-5
MODEL_BF16 = 5e-2


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# B8: flash attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0), (False, 0, 0.0),
])
def test_flash_attention_ref_matches_pallas_kernel(causal, window, softcap):
    """The cases of the reference's kernel test, folded-head layout: the
    port's plain version against the Pallas kernel (interpret mode) and the
    reference's dense oracle."""
    rng = np.random.default_rng(4)
    b, s, dh = 2, 256, 32
    q, k, v = (rng.normal(size=(b, s, dh)).astype(np.float32)
               for _ in range(3))
    kw = dict(scale=0.2, causal=causal, window=window, softcap=softcap)
    got = ref.flash_attention_ref(t(q), t(k), t(v), **kw)
    pallas = ref_flash_folded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=64, block_k=64, interpret=True, **kw)
    dense = ref_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, s, dh)
    close(got, pallas, F32_ATTN)
    close(got, dense, F32_ATTN)


@pytest.mark.parametrize("b,s,kh,g,dh,window,softcap", [
    (1, 128, 2, 2, 16, 0, 0.0),  # the reference's GQA wrapper test
    (2, 192, 2, 2, 16, 48, 50.0),  # G = 2 with window and softcap
    (1, 128, 4, 1, 8, 32, 0.0),  # G = 1
])
def test_flash_attention_gqa_matches_reference(b, s, kh, g, dh, window,
                                               softcap):
    """``ops.flash_attention_gqa`` (plain version on the CPU) against the
    reference's Pallas GQA wrapper in interpret mode and the jnp flash
    path; the plain version ``flash_attention_torch`` in blocks of 64
    too (the wrapper's CPU call takes it in one block)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, s, kh, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    kw = dict(scale=0.25, causal=True, window=window, softcap=softcap)
    fa.reset_launches()
    got = ops.flash_attention_gqa(t(q), t(k), t(v), **kw)
    assert fa.launches() == 0  # a CPU tensor never reaches the kernel
    pallas = ref_ops.flash_attention_gqa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
        block_k=64, interpret=True, **kw)
    jnp_flash = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_q=64, block_k=64,
                                    **kw)
    blocked = flash_attention_torch(t(q), t(k), t(v), block_q=64, block_k=64,
                                    **kw)
    assert got.shape == (b, s, kh, g, dh) and got.dtype == torch.float32
    close(got, pallas, F32_ATTN)
    close(got, jnp_flash, F32_ATTN)
    close(blocked, jnp_flash, F32_ATTN)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 50.0), (True, 32, 50.0),
    (False, 0, 0.0),
])
def test_flash_attention_torch_matches_jnp(causal, window, softcap):
    """The blocked oracle against ``flash_attention_jnp`` on the cases of
    the reference's ``tests/test_attention.py``."""
    rng = np.random.default_rng(0)
    b, s, kh, g, dh = 2, 256, 2, 2, 16
    q = rng.normal(size=(b, s, kh, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    kw = dict(scale=1.0 / math.sqrt(dh), causal=causal, window=window,
              softcap=softcap, block_q=64, block_k=64)
    got = flash_attention_torch(t(q), t(k), t(v), **kw)
    want = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    close(got, want, F32_ATTN)


@pytest.mark.parametrize("s,window", [(100, 0), (77, 20), (130, 64)])
def test_flash_attention_ragged_s_matches_dense_reference(s, window):
    """S that no block divides: the port's wrapper, and its plain version
    in blocks of 48 queries x 32 keys (short last blocks), against the
    reference's dense oracle, fed the folded, group-repeated layout it
    takes."""
    rng = np.random.default_rng(6)
    b, kh, g, dh = 1, 2, 2, 16
    q = rng.normal(size=(b, s, kh, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    kw = dict(scale=0.3, causal=True, window=window, softcap=50.0)
    got = ops.flash_attention_gqa(t(q), t(k), t(v), **kw).numpy()
    qf = q.transpose(0, 2, 3, 1, 4).reshape(b * kh * g, s, dh)
    kf = np.repeat(k.transpose(0, 2, 1, 3).reshape(b * kh, s, dh), g, 0)
    vf = np.repeat(v.transpose(0, 2, 1, 3).reshape(b * kh, s, dh), g, 0)
    want = np.asarray(ref_ref.flash_attention_ref(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), **kw))
    want = want.reshape(b, kh, g, s, dh).transpose(0, 3, 1, 2, 4)
    close(got, want, F32_ATTN)
    blocked = flash_attention_torch(t(q), t(k), t(v), block_q=48,
                                    block_k=32, **kw)
    close(blocked, want, F32_ATTN)


def test_flash_attention_gqa_rejects_bad_inputs():
    q = torch.zeros((1, 8, 2, 2, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="does not match"):
        ops.flash_attention_gqa(q, torch.zeros((1, 8, 3, 16)),
                                torch.zeros((1, 8, 3, 16)), scale=1.0)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.flash_attention_gqa(q, k.half(), k.half(), scale=1.0)
    with pytest.raises(TypeError, match="float32"):
        ops.flash_attention_gqa(q.long(), k.long(), k.long(), scale=1.0)
    with pytest.raises(ValueError, match="k .* and v .* differ"):
        ops.flash_attention_gqa(q, k, k[:, :4], scale=1.0)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_gqa(q, k, k, scale=1.0, window=-1)


# --------------------------------------------------------------------------
# B10: embedding bag
# --------------------------------------------------------------------------
BAG_CASES = [
    (64, 16, 16, 4, "sum", np.float32),  # the reference's kernel tests
    (128, 32, 8, 7, "mean", np.float32),
    (64, 8, 16, 3, "sum", np.float16),
    (1000, 18, 4, 100, "sum", np.float32),  # DIN's D and L
    (1000, 18, 4, 100, "mean", np.float32),
]


@pytest.mark.parametrize("n,d,b,l,mode,dtype", BAG_CASES)
def test_embedding_bag_matches_pallas_kernel(n, d, b, l, mode, dtype):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(n, d)).astype(dtype)
    ids = rng.integers(0, n, size=(b, l)).astype(np.int32)
    mask = rng.random((b, l)) < 0.8
    mask[1] = False  # an all-masked bag is 0
    eb.reset_launches()
    got = ops.embedding_bag(t(table), t(ids), t(mask), mode=mode)
    assert eb.launches() == 0
    pallas = ref_ops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(mask), mode=mode, block_b=4,
                                   interpret=True)
    oracle = ref_ref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(mask), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    close(got, pallas, BAG_TOL)
    close(got, oracle, BAG_TOL)
    assert not got[1].any()


def test_embedding_bag_any_batch_and_reference_id_semantics():
    """B not a multiple of 8 (the Pallas kernel's block), int64 ids, and
    the reference oracle's ``jnp.take``: a negative id counts from the end,
    an id outside [-N, N) gives NaN."""
    rng = np.random.default_rng(3)
    n, d, b, l = 50, 6, 13, 9
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-n, n, size=(b, l)).astype(np.int32)
    ids[3, 2] = n + 5
    ids[4, 0] = -n - 1
    mask = rng.random((b, l)) < 0.7
    mask[4, 0] = False  # NaN even where masked, as 0 * NaN
    want = np.asarray(ref_ref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask)))
    for ids_t in (t(ids), t(ids).long()):
        got = ops.embedding_bag(t(table), ids_t, t(mask)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[3]).all() and np.isnan(got[4]).all()
        close(np.nan_to_num(got), np.nan_to_num(want), BAG_TOL)
    with pytest.raises(ValueError, match="max"):
        ops.embedding_bag(t(table), t(ids), t(mask), mode="max")
    with pytest.raises(TypeError, match="mask"):
        ops.embedding_bag(t(table), t(ids), t(mask).int())


@pytest.mark.parametrize("mode,weighted,masked", [
    ("sum", False, True), ("mean", False, True), ("sum", False, False),
    ("max", False, True), ("sum", True, True), ("mean", True, False),
])
def test_bag_fixed_matches_reference(mode, weighted, masked):
    rng = np.random.default_rng(7)
    n, d, b, l = 200, 18, 11, 20
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, l)).astype(np.int32)
    mask = rng.random((b, l)) < 0.6 if masked else None
    if masked:
        mask[0] = False
    w = rng.random((b, l)).astype(np.float32) if weighted else None
    eb.reset_launches()
    got = embedding.bag_fixed(t(table), t(ids),
                              None if mask is None else t(mask), mode=mode,
                              weights=None if w is None else t(w))
    want = ref_emb.bag_fixed(jnp.asarray(table), jnp.asarray(ids),
                             None if mask is None else jnp.asarray(mask),
                             mode=mode,
                             weights=None if w is None else jnp.asarray(w))
    assert got.dtype == torch.float32 and got.shape == (b, d)
    close(got, want, BAG_TOL)
    assert eb.launches() == 0


@pytest.mark.parametrize("mode,weighted", [
    ("sum", False), ("mean", False), ("max", False), ("sum", True)])
def test_bag_ragged_matches_reference(mode, weighted):
    rng = np.random.default_rng(8)
    n, d = 100, 5
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, size=40).astype(np.int32)
    offsets = np.array([0, 3, 3, 10, 25, 39], np.int32)  # an empty bag
    w = rng.random(40).astype(np.float32) if weighted else None
    got = embedding.bag_ragged(t(table), t(ids), t(offsets), 6, mode=mode,
                               weights=None if w is None else t(w))
    want = ref_emb.bag_ragged(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(offsets), 6, mode=mode,
                              weights=None if w is None else jnp.asarray(w))
    close(got, want, BAG_TOL)


# --------------------------------------------------------------------------
# models/common
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches_reference(dtype, zero_centered):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (rng.normal(size=64) * 0.3).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_common.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                               zero_centered=zero_centered)
    got = common.rms_norm(t(x).to(td), t(w).to(td),
                          zero_centered=zero_centered)
    assert got.dtype == td
    # bf16: the fp32 norm agrees, then both round once to bf16 (one ulp)
    close(got.float(), np.asarray(want, np.float32),
          MODEL_F32 if dtype == "float32" else 2 ** -7)


def test_elementwise_blocks_match_reference():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(4, 33)).astype(np.float32) * 3
    w = rng.normal(size=33).astype(np.float32)
    bias = rng.normal(size=33).astype(np.float32)
    close(common.layer_norm(t(x), t(w), t(bias)),
          ref_common.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias)), MODEL_F32)
    close(common.gelu(t(x)), ref_common.gelu(jnp.asarray(x)), MODEL_F32)
    close(common.silu(t(x)), ref_common.silu(jnp.asarray(x)), MODEL_F32)
    close(common.softcap(t(x) * 20, 30.0),
          ref_common.softcap(jnp.asarray(x) * 20, 30.0), MODEL_F32)
    m = rng.normal(size=(33, 7)).astype(np.float32)
    close(common.dense(t(x), t(m), t(bias[:7])),
          ref_common.dense(jnp.asarray(x), jnp.asarray(m),
                           jnp.asarray(bias[:7])), MODEL_F32)


def test_rope_matches_reference():
    rng = np.random.default_rng(11)
    pos = np.arange(37, dtype=np.int32)
    x = rng.normal(size=(2, 37, 4, 16)).astype(np.float32)
    s_ref, c_ref = ref_common.rope_table(jnp.asarray(pos), 16, 1e6)
    s, c = common.rope_table(t(pos), 16, 1e6)
    close(s, s_ref, 1e-5)
    close(c, c_ref, 1e-5)
    close(common.apply_rope(t(x), s, c),
          ref_common.apply_rope(jnp.asarray(x), s_ref, c_ref), 1e-5)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(12)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(-1, 50, size=(3, 7)).astype(np.int32)
    close(common.cross_entropy_loss(t(logits), t(labels), z_loss=z_loss),
          ref_common.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels), z_loss=z_loss),
          1e-5)


def test_trunc_normal_shape_range_and_scale():
    g = torch.Generator().manual_seed(0)
    x = common.trunc_normal(g, (400, 300), scale=2.0, dtype=torch.bfloat16)
    assert x.shape == (400, 300) and x.dtype == torch.bfloat16
    std = 2.0 / math.sqrt(400)
    assert float(x.float().abs().max()) <= 2 * std * (1 + 2 ** -7)
    # a normal truncated at 2 sigma has std 0.880 of the untruncated one
    assert abs(float(x.float().std()) / std - 0.880) < 0.02
    again = common.trunc_normal(torch.Generator().manual_seed(0), (400, 300),
                                scale=2.0, dtype=torch.bfloat16)
    assert torch.equal(x, again)


# --------------------------------------------------------------------------
# the LM: prefill, KV caches, decode
# --------------------------------------------------------------------------
def _perturbed_tree(cfg, dtype):
    """The reference's initialised parameters as numpy, with every bias and
    norm weight (zeros or ones at init) replaced by noise, so the tests see
    QKV biases and the zero-centred +1."""
    tree = jax.tree.map(np.asarray, ref_tfm.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(1)

    def noise(path, a):
        name = path[-1].key
        if name in ("bq", "bk", "bv") or "norm" in name:
            return (rng.normal(size=a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(noise, tree)


def _configs(arch, dtype, flash):
    rcfg = ref_registry.get_arch(arch).smoke_config()
    pcfg = registry.get_arch(arch).smoke_config()
    rcfg = dataclasses.replace(rcfg, dtype=getattr(jnp, dtype))
    pcfg = dataclasses.replace(pcfg, dtype=getattr(torch, dtype))
    if flash:  # the reference's jnp flash path in blocks of 16
        rcfg = dataclasses.replace(rcfg, flash_cutoff=32, flash_block=16)
        pcfg = dataclasses.replace(pcfg, flash_cutoff=32)
    return rcfg, pcfg


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _snapshot(cache):
    """The port updates its cache in place: copy it at each step."""
    return {key: {leaf: x.clone() for leaf, x in c.items()}
            for key, c in cache.items()}


def _run_both(arch, dtype, flash, monkeypatch, n_decode=4):
    rcfg, pcfg = _configs(arch, dtype, flash)
    tree = _perturbed_tree(rcfg, dtype)
    rparams = jax.tree.map(jnp.asarray, tree)
    pparams = tfm.params_from_reference(pcfg, tree)
    s = 64 if flash else 32
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab, size=(2, s)).astype(np.int32)
    calls = []
    real = ops.flash_attention_gqa
    monkeypatch.setattr(ops, "flash_attention_gqa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    max_len = s + n_decode
    rl, rc = ref_tfm.forward_prefill(rparams, jnp.asarray(toks), rcfg,
                                     max_len=max_len)
    pl, pc = tfm.forward_prefill(pparams, t(toks), pcfg, max_len=max_len)
    # the flash branch runs B8's wrapper once per layer, the dense one never
    assert len(calls) == (pcfg.n_layers if flash else 0)
    steps = [(_f32(rl), pl.float().numpy(), rc, _snapshot(pc))]
    rt = jnp.argmax(rl, -1).astype(jnp.int32)
    pt = torch.argmax(pl, -1).to(torch.int32)
    for i in range(n_decode):
        rl, rc = ref_tfm.forward_decode(rparams, rt, jnp.int32(s + i), rc,
                                        rcfg)
        pl, pc = tfm.forward_decode(pparams, pt, s + i, pc, pcfg)
        steps.append((_f32(rl), pl.float().numpy(), rc, _snapshot(pc)))
        rt = jnp.argmax(rl, -1).astype(jnp.int32)
        pt = torch.argmax(pl, -1).to(torch.int32)
    return steps


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2.5-14b",
                                  "stablelm-1.6b"])
def test_lm_prefill_and_decode_match_reference_fp32(arch, flash,
                                                    monkeypatch):
    """Prefill logits, every KV cache leaf and 4 greedy decode steps, in
    fp32. gemma2: window + softcaps + post-norms + zero-centred norms;
    qwen: QKV bias; stablelm: G = 1. ``flash`` lowers the cutoff so a
    64-token prompt takes the flash branch (B8's plain version here)."""
    steps = _run_both(arch, "float32", flash, monkeypatch)
    for want, got, rc, pc in steps:
        close(got, want, MODEL_F32)
        assert np.array_equal(want.argmax(-1), got.argmax(-1))
        for key in rc:
            for leaf in ("k", "v"):
                close(pc[key][leaf].numpy(), rc[key][leaf], MODEL_F32)
            np.testing.assert_array_equal(pc[key]["pos"].numpy(),
                                          np.asarray(rc[key]["pos"]))


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_lm_prefill_matches_reference_bf16(flash, monkeypatch):
    """gemma2 in its working dtype, bf16, at the looser tolerance of the
    module docstring; the caches' positions are exact."""
    steps = _run_both("gemma2-27b", "bfloat16", flash, monkeypatch,
                      n_decode=1)
    for want, got, rc, pc in steps:
        assert np.abs(got - want).max() <= MODEL_BF16
        assert np.linalg.norm(got - want) <= MODEL_BF16 * np.linalg.norm(want)
        for key in rc:
            np.testing.assert_array_equal(pc[key]["pos"].numpy(),
                                          np.asarray(rc[key]["pos"]))


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2.5-14b",
                                  "stablelm-1.6b"])
def test_init_params_has_the_reference_layout(arch):
    rcfg = ref_registry.get_arch(arch).smoke_config()
    pcfg = registry.get_arch(arch).smoke_config()
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        ref_tfm.init_params(rcfg, jax.random.key(0)))
    params = tfm.init_params(pcfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]), params)
    assert got == want
    assert pcfg.param_count() == rcfg.param_count()
    # zero-centred norms start at 0, the others at 1; biases at 0
    layer = params["layers"][f"sub0_{pcfg.pattern[0]}"]
    assert float(layer["attn_norm"].float().abs().sum()) == (
        0.0 if pcfg.zero_centered_norm else pcfg.n_blocks * pcfg.d_model)
    for name in ("bq", "bk", "bv"):
        if name in layer:
            assert not layer[name].any()


def test_moe_configs_raise_not_ported():
    for arch in ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"):
        cfg = registry.get_arch(arch).smoke_config()
        with pytest.raises(NotImplementedError, match="not ported yet: moe"):
            tfm.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(NotImplementedError, match="not ported yet: moe"):
            tfm.forward_prefill({}, torch.zeros((1, 4), dtype=torch.int32),
                                cfg, max_len=8)


def test_params_from_reference_checks_dtype_and_leaves():
    rcfg, pcfg = _configs("qwen2.5-14b", "float32", False)
    tree = jax.tree.map(np.asarray, ref_tfm.init_params(rcfg,
                                                        jax.random.key(0)))
    with pytest.raises(TypeError, match="config says"):
        tfm.params_from_reference(dataclasses.replace(
            pcfg, dtype=torch.bfloat16), tree)
    del tree["layers"]["sub0_global"]["bq"]
    with pytest.raises(ValueError, match="leaves"):
        tfm.params_from_reference(pcfg, tree)


# --------------------------------------------------------------------------
# DIN serving
# --------------------------------------------------------------------------
def test_ctr_stream_batches_are_bit_equal():
    ref_s = RefCTRStream(1000, 50, 16, seq_len=12, d_profile=8, seed=3)
    port_s = CTRStream(1000, 50, 16, seq_len=12, d_profile=8, seed=3)
    for step in (0, 1, 7):
        a, b = ref_s.batch_at(step), port_s.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _din_params():
    rcfg = ref_registry.get_arch("din").smoke_config()
    tree = jax.tree.map(np.asarray, ref_din.init_params(rcfg,
                                                        jax.random.key(0)))
    rng = np.random.default_rng(2)
    for lyr in tree["attn"] + tree["mlp"]:
        lyr["b"] = (rng.normal(size=lyr["b"].shape) * 0.1).astype(np.float32)
    tree["dice_alpha"] = rng.normal(size=tree["dice_alpha"].shape).astype(
        np.float32)
    pcfg = registry.get_arch("din").smoke_config()
    return rcfg, pcfg, tree, din.params_from_reference(pcfg, tree)


def test_din_serve_step_matches_reference():
    rcfg, pcfg, tree, pparams = _din_params()
    rparams = jax.tree.map(jnp.asarray, tree)
    stream = CTRStream(rcfg.n_items, rcfg.n_cats, 64, seq_len=rcfg.seq_len,
                       d_profile=rcfg.d_profile, seed=0)
    ref_step = ref_tl.make_recsys_serve_step(ref_din.apply, rcfg)
    step = tl.make_recsys_serve_step(din.apply, pcfg)
    for i in range(3):
        b = stream.batch_at(i)
        want = ref_step(rparams, {k: jnp.asarray(v) for k, v in b.items()})
        got = step(pparams, {k: t(v) for k, v in b.items()})
        assert got.shape == (64,) and got.dtype == torch.float32
        close(got, want, DIN_TOL)
        close(din.apply(pparams, {k: t(v) for k, v in b.items()}, pcfg),
              ref_din.apply(rparams, {k: jnp.asarray(v) for k, v in b.items()},
                            rcfg), DIN_TOL)


def test_din_retrieval_matches_reference():
    rcfg, pcfg, tree, pparams = _din_params()
    rparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(4)
    n, l = 300, rcfg.seq_len
    batch = {
        "hist_items": rng.integers(0, rcfg.n_items, (1, l)).astype(np.int32),
        "hist_cats": rng.integers(0, rcfg.n_cats, (1, l)).astype(np.int32),
        "hist_mask": np.arange(l)[None] < 7,
        "cand_items": rng.integers(0, rcfg.n_items, n).astype(np.int32),
        "cand_cats": rng.integers(0, rcfg.n_cats, n).astype(np.int32),
        "user_profile": rng.normal(size=(1, rcfg.d_profile)).astype(
            np.float32),
    }
    close(din.retrieval_score(pparams, {k: t(v) for k, v in batch.items()},
                              pcfg),
          ref_din.retrieval_score(rparams, {k: jnp.asarray(v)
                                            for k, v in batch.items()}, rcfg),
          DIN_TOL)


def test_dice_uses_the_population_variance():
    x = torch.tensor([[1.0], [3.0]])
    # mean 2, population variance 1: gates sigmoid(-1), sigmoid(1)
    got = din._dice(x, torch.tensor(0.5))
    ps = torch.sigmoid(torch.tensor([[-1.0], [1.0]]) / math.sqrt(1 + 1e-8))
    assert torch.allclose(got, ps * x + (1 - ps) * 0.5 * x)


# --------------------------------------------------------------------------
# the launcher and the registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("argv,line", [
    (["--arch", "gemma2-27b", "--smoke", "--batch", "2", "--tokens", "3"],
     r"^\[gemma2-27b\] prefill [\d.]+ ms \| decode [\d.]+ ms/tok \| "
     r"throughput \d+ tok/s$"),
    (["--arch", "din", "--smoke"], r"^\[din\] 8 reqs in [\d.]+ ms "
                                   r"\(\d+ req/s\)$"),
])
def test_serve_main_on_the_cpu(argv, line, capsys):
    import re

    result = {}
    assert serve.main(argv + ["--device", "cpu"], result=result) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and re.match(line, out[0]), out
    if "gemma2-27b" in argv:
        assert result["tokens"].shape == (2, 4)  # prefill's token + 3
        assert torch.isfinite(result["prefill_logits"]).all()
    else:
        assert all(((p >= 0) & (p <= 1)).all() for p in result["probs"])


def test_serve_lm_tokens_match_the_reference_greedy_decode():
    """The launcher's greedy tokens equal the reference's decode loop on
    the same (converted) weights in fp32."""
    rcfg, pcfg = _configs("stablelm-1.6b", "float32", False)
    tree = _perturbed_tree(rcfg, "float32")
    rparams = jax.tree.map(jnp.asarray, tree)
    pparams = tfm.params_from_reference(pcfg, tree)
    prompts = np.random.default_rng(0).integers(
        0, rcfg.vocab, size=(3, 16)).astype(np.int32)
    prefill = ref_tl.make_lm_prefill_step(rcfg, max_len=21)
    decode = ref_tl.make_lm_decode_step(rcfg)
    logits, cache = prefill(rparams, jnp.asarray(prompts))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(5):
        logits, cache = decode(rparams, tok, jnp.int32(16 + i), cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    p_prefill = tl.make_lm_prefill_step(pcfg, max_len=21)
    p_decode = tl.make_lm_decode_step(pcfg)
    logits, cache = p_prefill(pparams, t(prompts))
    tok = torch.argmax(logits, -1).to(torch.int32)
    got = [tok.numpy()]
    for i in range(5):
        logits, cache = p_decode(pparams, tok, 16 + i, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_serve_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for argv in (["--arch", "gemma2-27b", "--smoke"], ["--arch", "din",
                                                         "--smoke"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(argv)


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2.5-14b",
                                  "stablelm-1.6b", "moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b", "din", "paper-lcc"])
def test_registry_configs_equal_the_reference(arch):
    """Every field of the full and smoke configs, dtypes mapped across;
    the reference's mesh and MoE routing knobs have no counterpart
    (``remat`` and ``flash_block`` do, for training)."""
    want, got = ref_registry.get_arch(arch), registry.get_arch(arch)
    assert (got.family, got.skip_shapes) == (want.family, want.skip_shapes)
    assert got.shapes.keys() == want.shapes.keys()
    for make in ("config", "smoke_config"):
        a = dataclasses.asdict(getattr(want, make)())
        b = dataclasses.asdict(getattr(got, make)())
        for knob in ("moe_impl", "moe_shard_capacity", "moe_top_k",
                     "moe_capacity"):
            a.pop(knob, None)
        if "dtype" in a:
            assert str(b.pop("dtype"))[6:] == jnp.dtype(a.pop("dtype")).name
        assert a == b


@pytest.mark.parametrize("arch", ["mace", "pna", "gin-tu", "gat-cora"])
def test_registry_gnn_ids_raise(arch):
    """Every GNN id resolves to family ``gnn``, which has no serving path
    (the reference's ``SystemExit``)."""
    assert arch in ref_registry.ARCHS
    assert registry.get_arch(arch).family == "gnn"
    with pytest.raises(SystemExit, match=f"{arch}: no serving path for gnn"):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_registry_unknown_id_and_coverage():
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")
    # every id of the reference is ported, in the reference's order
    assert list(registry.ARCHS) == list(ref_registry.ARCHS)
