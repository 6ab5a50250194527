"""Decoder-only LM transformer, the counterpart of
``repro.models.transformer`` for every LM architecture of the registry:
training (``forward_train``, ``loss_fn``), prefill and greedy decode.

One config-driven implementation, as in the reference:
  - GQA attention (any H/K ratio), RoPE, optional QKV bias (qwen2.5)
  - alternating local (sliding-window) / global layers, attention and final
    logit soft-capping, post-norms, zero-centred RMSNorm (gemma2)
  - SwiGLU MLP or the top-k MoE FFN of ``models.moe`` (moonshot 64
    experts / top-6, phi3.5 16 / top-2), routed per call, so each
    microbatch of a train step and each decode step has its own capacity
  - train (full-sequence logits; with ``remat`` each block of the pattern
    is recomputed in the backward pass, as the reference's
    ``jax.checkpoint``), prefill (builds the KV cache) and decode (one token
    against a ring-buffer KV cache; local layers cache only the window),
    sharing the same layer code.

Parameters are a dictionary in the reference's pytree layout: weights in
``[in, out]`` (so ``x @ w`` as there), and the layers of each block-pattern
entry stacked over ``n_blocks`` under ``params["layers"]["sub{i}_{kind}"]``;
an MoE layer holds its FFN under ``"moe"`` (the router in fp32).
``params_from_reference`` copies the reference's initialised pytree across.
The config keeps the reference's fields but the mesh knobs (``AxisRules``,
``moe_impl``, ``moe_shard_capacity``), which have no counterpart on one
device. Layers run in a Python loop (the reference's ``scan``); the KV
cache is updated in place (the reference returns a new one).

At ``s >= cfg.flash_cutoff`` attention takes the flash path. In prefill it
goes through ``kernels.ops.flash_attention_gqa``: the hand-written kernel
B8 on the card, its plain version on the CPU. B8 has no backward (nor has
the reference's Pallas kernel), so training runs the blocked online
softmax ``models.attention.flash_attention_torch`` in blocks of
``cfg.flash_block``, as the reference trains through
``flash_attention_jnp``; B8's wrapper refuses a tensor that requires grad.
Below the cutoff the dense path runs, which — as in the reference — casts
the softmax weights to ``v``'s dtype before the product with ``v``; the
flash path does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from . import moe
from .attention import flash_attention_torch
from .common import (apply_rope, cross_entropy_loss, rms_norm, rope_table,
                     silu, softcap, trunc_normal)

__all__ = [
    "TransformerConfig",
    "init_params",
    "params_from_reference",
    "forward_train",
    "loss_fn",
    "forward_prefill",
    "forward_decode",
    "init_kv_cache",
]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    zero_centered_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0  # >0: block pattern alternates (local, global)
    post_norms: bool = False
    norm_eps: float = 1e-6
    # MoE (0 experts = dense MLP)
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity: float = 1.25
    dtype: Any = torch.bfloat16
    query_scale: Optional[float] = None  # None -> 1/sqrt(d_head)
    tie_embeddings: bool = False
    remat: bool = True  # training recomputes each block in the backward
    # sequence length at/above which attention takes the flash path (kernel
    # B8 in prefill), and the blocks of the training flash path
    flash_cutoff: int = 8192
    flash_block: int = 1024

    @property
    def pattern(self) -> Tuple[str, ...]:
        return ("local", "global") if self.sliding_window > 0 else ("global",)

    @property
    def n_blocks(self) -> int:
        lp = len(self.pattern)
        if self.n_layers % lp:
            raise ValueError(f"{self.n_layers} layers do not tile the "
                             f"pattern {self.pattern}")
        return self.n_layers // lp

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def window_for(self, kind: str) -> int:
        return self.sliding_window if kind == "local" else 0

    def param_count(self) -> int:
        """Total parameters (as the reference counts them)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        attn += self.n_heads * self.d_head * d
        if self.is_moe:
            ffn = self.moe_experts * 3 * d * f + d * self.moe_experts
        else:
            ffn = 3 * d * f
        norms = d * (4 if self.post_norms else 2)
        per_layer = attn + ffn + norms
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: ``moe_top_k`` of the experts;
        as the reference counts them)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_ffn = self.moe_top_k * 3 * d * f + d * self.moe_experts
        full_ffn = self.moe_experts * 3 * d * f + d * self.moe_experts
        return self.param_count() - self.n_layers * (full_ffn - dense_ffn)


# --------------------------------------------------------------------------
# init + conversion from the reference
# --------------------------------------------------------------------------
def _layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    d, h, k_, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    shapes = {"attn_norm": (d,), "wq": (d, h * dh), "wk": (d, k_ * dh),
              "wv": (d, k_ * dh), "wo": (h * dh, d), "ffn_norm": (d,)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * dh,), bk=(k_ * dh,), bv=(k_ * dh,))
    if cfg.post_norms:
        shapes.update(attn_post_norm=(d,), ffn_post_norm=(d,))
    if cfg.is_moe:
        e = cfg.moe_experts
        shapes["moe"] = {"router": (d, e), "w_gate": (e, d, f),
                         "w_up": (e, d, f), "w_down": (e, f, d)}
    else:
        shapes.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    return shapes


def _leaf_dtype(cfg: TransformerConfig, name: str) -> torch.dtype:
    """The MoE router is fp32 (the reference's); every other leaf is
    ``cfg.dtype``."""
    return torch.float32 if name == "router" else cfg.dtype


_RANDOM = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _norm_init(cfg: TransformerConfig, shape, device) -> torch.Tensor:
    fill = 0.0 if cfg.zero_centered_norm else 1.0
    return torch.full(shape, fill, dtype=cfg.dtype, device=device)


def init_params(cfg: TransformerConfig,
                generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device, in the reference's
    layout and init (truncated normal scaled by fan-in; norms 0 or 1;
    biases 0; an MoE layer's FFN as ``moe.moe_init`` draws it, its experts
    with a fan-in of E as in the reference). The draws differ from the
    reference's: parity tests copy its parameters with
    ``params_from_reference``. Each stacked leaf is allocated once and
    filled block by block, so the fp32 draw of one layer's matrix is the
    only transient."""
    dev = generator.device
    params: Dict[str, Any] = {
        "embed": trunc_normal(generator, (cfg.vocab, cfg.d_model), 1.0,
                              cfg.dtype),
        "final_norm": _norm_init(cfg, (cfg.d_model,), dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = trunc_normal(generator, (cfg.d_model, cfg.vocab),
                                         1.0, cfg.dtype)
    layers: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        leaves = {}
        for name, shape in _layer_shapes(cfg).items():
            if name == "moe":
                leaves[name] = _moe_init(cfg, shape, generator)
                continue
            full = (cfg.n_blocks,) + shape
            if name in _RANDOM:
                t = torch.empty(full, dtype=cfg.dtype, device=dev)
                for blk in range(cfg.n_blocks):
                    t[blk] = trunc_normal(generator, shape, 1.0, cfg.dtype)
            elif name.startswith("b"):  # qkv biases
                t = torch.zeros(full, dtype=cfg.dtype, device=dev)
            else:
                t = _norm_init(cfg, full, dev)
            leaves[name] = t
        layers[f"sub{i}_{kind}"] = leaves
    params["layers"] = layers
    return params


def _moe_init(cfg: TransformerConfig, shapes, generator):
    """The MoE leaves stacked over ``n_blocks``, each block drawn by
    ``moe.moe_init`` (never the stack as one draw: fan-in is E)."""
    out = {name: torch.empty((cfg.n_blocks,) + shape,
                             dtype=_leaf_dtype(cfg, name),
                             device=generator.device)
           for name, shape in shapes.items()}
    for blk in range(cfg.n_blocks):
        layer = moe.moe_init(generator, cfg.d_model, cfg.d_ff,
                             cfg.moe_experts, cfg.dtype)
        for name, t in layer.items():
            out[name][blk] = t
    return out


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array (bf16 arrays as ml_dtypes bfloat16) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if t.dtype != dtype:
        raise TypeError(f"parameter of dtype {t.dtype}, config says {dtype}")
    return t


def params_from_reference(cfg: TransformerConfig, tree) -> Dict[str, Any]:
    """The port's parameters from the reference's pytree (numpy arrays,
    layers stacked over ``n_blocks``): the same leaves in the same layout,
    as CPU tensors (the MoE router fp32, every other leaf ``cfg.dtype``)."""
    out: Dict[str, Any] = {k: _tensor(tree[k], cfg.dtype)
                           for k in ("embed", "final_norm", "unembed")
                           if k in tree}

    def copy(key, sub, want):
        if set(sub) != set(want):
            raise ValueError(f"{key}: leaves {sorted(sub)}, expected "
                             f"{sorted(want)}")
        leaves = {}
        for name, shape in want.items():
            if isinstance(shape, dict):
                leaves[name] = copy(f"{key}.{name}", sub[name], shape)
                continue
            t = _tensor(sub[name], _leaf_dtype(cfg, name))
            if tuple(t.shape) != (cfg.n_blocks,) + shape:
                raise ValueError(f"{key}.{name}: shape {tuple(t.shape)}")
            leaves[name] = t
        return leaves

    out["layers"] = {
        f"sub{i}_{kind}": copy(f"sub{i}_{kind}",
                               tree["layers"][f"sub{i}_{kind}"],
                               _layer_shapes(cfg))
        for i, kind in enumerate(cfg.pattern)}
    return out


# --------------------------------------------------------------------------
# attention / layer bodies
# --------------------------------------------------------------------------
def _scale(cfg: TransformerConfig) -> float:
    return (cfg.query_scale if cfg.query_scale is not None
            else 1.0 / math.sqrt(cfg.d_head))


def _embed(params, tokens, cfg: TransformerConfig):
    x = params["embed"][tokens].to(cfg.dtype)
    # the scale is rounded to the model dtype first, as in the reference
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                            device=x.device)


def _unembed(params, x, cfg: TransformerConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ w.to(cfg.dtype)
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def _norm(x, w, cfg: TransformerConfig):
    return rms_norm(x, w, eps=cfg.norm_eps,
                    zero_centered=cfg.zero_centered_norm)


def _qkv(x, p, cfg: TransformerConfig):
    b, s, _ = x.shape
    h, k_, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, h, dh), k.reshape(b, s, k_, dh),
            v.reshape(b, s, k_, dh))


def _attn_scores(q, k, cfg: TransformerConfig):
    """q: [B,S,H,dh]; k: [B,T,K,dh] -> scores [B,K,G,S,T] (GQA grouped)."""
    b, s, h, dh = q.shape
    k_heads = k.shape[2]
    q = q.reshape(b, s, k_heads, h // k_heads, dh)
    scores = torch.einsum("bskgd,btkd->bkgst",
                          q.to(torch.float32) * _scale(cfg),
                          k.to(torch.float32))
    if cfg.attn_softcap > 0:
        scores = softcap(scores, cfg.attn_softcap)
    return scores


def _attn_out(scores, v, mask, p, cfg: TransformerConfig):
    """scores [B,K,G,S,T], v [B,T,K,dh], mask broadcastable to scores."""
    b, k_heads, g, s, t = scores.shape
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(b, s, k_heads * g * cfg.d_head) @ p["wo"]


def _causal_mask(s: int, window: int, device):
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    m = kp <= qp
    if window > 0:
        m &= (qp - kp) < window
    return m  # [S, T]


def _mlp(x, p):
    return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _ffn(x_flat, p, cfg: TransformerConfig):
    """The FFN of ``x_flat [T, d]``: the MoE of ``p["moe"]`` (routed over
    these T tokens) or the dense MLP."""
    if cfg.is_moe:
        return moe.moe_apply(p["moe"], x_flat, n_experts=cfg.moe_experts,
                             top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity)
    return _mlp(x_flat, p)


def _block(stacked: Dict[str, Any], blk: int):
    """Block ``blk`` of every stacked leaf, nested dictionaries too."""
    return {name: _block(t, blk) if isinstance(t, dict) else t[blk]
            for name, t in stacked.items()}


def _layer(x, p, kind: str, cfg: TransformerConfig, sin, cos, *,
           train: bool = False):
    """Full-sequence layer (train / prefill). x: [B,S,d] -> (x, (k, v)).
    At the flash cutoff ``train`` takes the differentiable blocked softmax,
    prefill kernel B8."""
    b, s, d = x.shape
    h = _norm(x, p["attn_norm"], cfg)
    q, k, v = _qkv(h, p, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if s >= cfg.flash_cutoff:
        kh = cfg.n_kv_heads
        q5 = q.reshape(b, s, kh, cfg.n_heads // kh, cfg.d_head)
        kw = dict(scale=_scale(cfg), causal=True, window=cfg.window_for(kind),
                  softcap=cfg.attn_softcap)
        if train:
            ctx = flash_attention_torch(q5, k, v, block_q=cfg.flash_block,
                                        block_k=cfg.flash_block, **kw)
        else:
            ctx = ops.flash_attention_gqa(q5, k, v, **kw)
        attn = ctx.reshape(b, s, cfg.n_heads * cfg.d_head) @ p["wo"]
    else:
        scores = _attn_scores(q, k, cfg)
        mask = _causal_mask(s, cfg.window_for(kind), x.device)
        attn = _attn_out(scores, v, mask, p, cfg)
    if cfg.post_norms:
        attn = _norm(attn, p["attn_post_norm"], cfg)
    x = x + attn
    hn = _norm(x, p["ffn_norm"], cfg)
    y = _ffn(hn.reshape(b * s, d), p, cfg).reshape(b, s, d)
    if cfg.post_norms:
        y = _norm(y, p["ffn_post_norm"], cfg)
    return x + y, (k, v)


# --------------------------------------------------------------------------
# train forward (a Python loop over blocks, each recomputed under remat)
# --------------------------------------------------------------------------
def _train_block(x, block_params, cfg: TransformerConfig, sin, cos):
    for i, kind in enumerate(cfg.pattern):
        x, _ = _layer(x, block_params[f"sub{i}_{kind}"], kind, cfg, sin, cos,
                      train=True)
    return x


def forward_train(params, tokens, cfg: TransformerConfig):
    """``tokens [B, S]`` -> logits ``[B, S, V]``. With ``cfg.remat`` each
    block of the pattern keeps only its input for the backward pass and is
    run again there (``torch.utils.checkpoint``, non-reentrant)."""
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    sin, cos = rope_table(torch.arange(s, device=tokens.device), cfg.d_head,
                          cfg.rope_theta)
    for blk in range(cfg.n_blocks):
        bp = {key: _block(stacked, blk)
              for key, stacked in params["layers"].items()}
        if cfg.remat:
            x = checkpoint(_train_block, x, bp, cfg, sin, cos,
                           use_reentrant=False)
        else:
            x = _train_block(x, bp, cfg, sin, cos)
    x = _norm(x, params["final_norm"], cfg)
    return _unembed(params, x, cfg)


def loss_fn(params, tokens, labels, cfg: TransformerConfig):
    """Mean token cross-entropy of ``forward_train``'s logits."""
    return cross_entropy_loss(forward_train(params, tokens, cfg), labels)


# --------------------------------------------------------------------------
# KV cache (ring buffer; local layers cache only the window)
# --------------------------------------------------------------------------
def _cache_len(cfg: TransformerConfig, kind: str, max_len: int) -> int:
    w = cfg.window_for(kind)
    return min(w, max_len) if w > 0 else max_len


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device):
    """Empty caches: k/v zeros ``[n_blocks, B, t, K, dh]``, pos -1."""
    cache = {}
    for i, kind in enumerate(cfg.pattern):
        t = _cache_len(cfg, kind, max_len)
        shape = (cfg.n_blocks, batch, t, cfg.n_kv_heads, cfg.d_head)
        cache[f"sub{i}_{kind}"] = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.full((cfg.n_blocks, batch, t), -1,
                              dtype=torch.int32, device=device),
        }
    return cache


def forward_prefill(params, tokens, cfg: TransformerConfig, *, max_len: int):
    """Run the prompt ``tokens [B, S]``; returns (last-token logits
    ``[B, V]``, KV cache)."""
    b, s = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, cfg)
    sin, cos = rope_table(torch.arange(s, device=dev), cfg.d_head,
                          cfg.rope_theta)
    cache = init_kv_cache(cfg, b, max_len, dev)
    for blk in range(cfg.n_blocks):
        for i, kind in enumerate(cfg.pattern):
            key = f"sub{i}_{kind}"
            x, (k, v) = _layer(x, _block(params["layers"][key], blk), kind,
                               cfg, sin, cos)
            t = _cache_len(cfg, kind, max_len)
            start = max(s - t, 0)
            pos = start + torch.arange(min(t, s), device=dev)
            idx = pos % t
            c = cache[key]
            c["k"][blk][:, idx] = k[:, start:]
            c["v"][blk][:, idx] = v[:, start:]
            c["pos"][blk][:, idx] = pos.to(torch.int32)
    x = _norm(x, params["final_norm"], cfg)
    return _unembed(params, x[:, -1], cfg), cache


def _decode_layer(x, p, kind, cache, pos: int, cfg: TransformerConfig,
                  sin, cos):
    """One-token layer. x: [B,1,d]; cache entries [B,T,K,dh], written in
    place at slot ``pos % T``."""
    b = x.shape[0]
    t = cache["k"].shape[1]
    h = _norm(x, p["attn_norm"], cfg)
    q, k, v = _qkv(h, p, cfg)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    slot = pos % t
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][:, slot] = pos
    pc = cache["pos"]
    scores = _attn_scores(q, cache["k"], cfg)  # [B,K,G,1,T]
    valid = (pc >= 0) & (pc <= pos)
    w = cfg.window_for(kind)
    if w > 0:
        valid &= (pos - pc) < w
    attn = _attn_out(scores, cache["v"], valid[:, None, None, None, :], p, cfg)
    if cfg.post_norms:
        attn = _norm(attn, p["attn_post_norm"], cfg)
    x = x + attn
    hn = _norm(x, p["ffn_norm"], cfg)
    y = _ffn(hn.reshape(b, -1), p, cfg).reshape(b, 1, -1)
    if cfg.post_norms:
        y = _norm(y, p["ffn_post_norm"], cfg)
    return x + y


def forward_decode(params, token, pos: int, cache, cfg: TransformerConfig):
    """``token [B]`` at position ``pos`` -> (logits ``[B, V]``, cache); the
    cache is updated in place and returned."""
    x = _embed(params, token, cfg)[:, None, :]
    pos = int(pos)
    sin, cos = rope_table(torch.tensor([pos], device=x.device), cfg.d_head,
                          cfg.rope_theta)
    for blk in range(cfg.n_blocks):
        for i, kind in enumerate(cfg.pattern):
            key = f"sub{i}_{kind}"
            x = _decode_layer(x, _block(params["layers"][key], blk), kind,
                              _block(cache[key], blk), pos, cfg, sin[None],
                              cos[None])
    x = _norm(x, params["final_norm"], cfg)
    return _unembed(params, x[:, 0], cfg), cache
