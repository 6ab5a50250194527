"""Step factories, the counterpart of ``repro.train.train_loop``: one
train or serve step per architecture family — LM training (gradient
accumulation over microbatches), prefill and decode; the GNN train step;
recsys (DIN) training, CTR scoring and candidate retrieval.

A step is a plain function over tensors; the reference wraps its steps in
``jax.jit``, the port runs them eagerly (the serving steps under
``torch.inference_mode`` or ``no_grad``). The train steps are functional,
as the reference's are: the gradient by ``torch.autograd.grad`` on detached
copies of the parameters, then ``opt.update`` under ``no_grad``; each
returns new parameters and optimizer state and changes none of its
arguments, so ``TrainRunner``'s retry of a failed step never applies half
an update twice. The LM step accumulates its microbatches' gradients in a
buffer of ``accum_dtype`` that it owns (the reference's ``lax.scan`` carry),
so one microbatch's activations are alive at a time.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..models import transformer as tfm
from ..models.common import cross_entropy_loss, stable_top_k
from ..models.gnn.common import segment_mean
from ..tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import adamw

__all__ = [
    "make_lm_train_step",
    "make_lm_prefill_step",
    "make_lm_decode_step",
    "make_gnn_train_step",
    "make_recsys_train_step",
    "make_recsys_serve_step",
    "make_retrieval_step",
    "stable_top_k",
    "tree_add",
    "tree_scale",
    "tree_zeros_f32",
]


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_f32(t):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), t)


def _value_and_grad(loss_of: Callable, params, *args):
    """(loss, gradient leaves in ``tree_leaves(params)`` order) of
    ``loss_of(params, *args)``; a leaf the loss does not use gets a zero
    gradient, as in JAX."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = loss_of(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for x, g in zip(leaves, grads)]


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------
def make_lm_train_step(cfg: tfm.TransformerConfig, opt: adamw, *,
                       n_microbatches: int = 1,
                       accum_dtype: torch.dtype = torch.float32):
    """``step(params, opt_state, {"tokens", "labels"})``. With
    ``n_microbatches > 1`` the batch's rows are cut into that many
    consecutive microbatches whose gradients are summed in
    ``accum_dtype`` (bf16 halves the accumulator) and scaled by
    ``1 / n_microbatches``, the losses averaged; the optimizer's moments
    stay fp32 either way."""

    def loss_of(params, tokens, labels):
        return tfm.loss_fn(params, tokens, labels, cfg)

    def step(params, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if n_microbatches > 1:
            mb = tokens.shape[0] // n_microbatches
            acc = [torch.zeros(x.shape, dtype=accum_dtype, device=x.device)
                   for x in tree_leaves(params)]
            loss = None
            for i in range(n_microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                l, g = _value_and_grad(loss_of, params, tokens[rows],
                                       labels[rows])
                for a, x in zip(acc, g):
                    a.add_(x.to(accum_dtype))
                del g
                loss = l if loss is None else loss + l
            grads = [a.mul_(1.0 / n_microbatches) for a in acc]
            loss = loss / n_microbatches
        else:
            loss, grads = _value_and_grad(loss_of, params, tokens, labels)
        params, opt_state = opt.update(tree_unflatten(params, grads),
                                       opt_state, params)
        return params, opt_state, {"loss": loss}

    return step


def make_lm_prefill_step(cfg, *, max_len: int):
    def step(params, tokens):
        return tfm.forward_prefill(params, tokens, cfg, max_len=max_len)

    return step


def make_lm_decode_step(cfg):
    def step(params, token, pos, cache):
        return tfm.forward_decode(params, token, pos, cache, cfg)

    return step


# --------------------------------------------------------------------------
# GNN
# --------------------------------------------------------------------------
def _gnn_loss(apply_fn, cfg, params, batch):
    """The reference's GNN loss: cross-entropy for integer labels (masked
    when the batch has ``label_mask``; graph labels over node logits are
    mean-pooled first), mean squared error for float labels, and for a
    model that returns a tuple (MACE's node and graph energies) the mean
    squared error of the graph energies."""
    out = apply_fn(params, batch, cfg)
    if isinstance(out, tuple):  # MACE: (node_e, graph_e) — energy regression
        _, energy = out
        return torch.mean(torch.square(energy.to(torch.float32)
                                       - batch["labels"].to(torch.float32)))
    labels = batch["labels"]
    if labels.dtype in (torch.int32, torch.int64):  # classification
        logits = out
        if "graph_ids" in batch and labels.shape[0] != logits.shape[0]:
            # graph-level labels over node-level logits: mean-pool readout
            logits = segment_mean(logits, batch["graph_ids"], labels.shape[0])
        if "label_mask" in batch:
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            ll = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
            msk = batch["label_mask"].to(torch.float32)
            return -(ll * msk).sum() / torch.clamp(msk.sum(), min=1.0)
        return cross_entropy_loss(logits, labels)
    return torch.mean(torch.square(out[..., 0].to(torch.float32)
                                   - labels.to(torch.float32)))


def make_gnn_train_step(apply_fn: Callable, cfg, opt: adamw):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``:
    the gradient by ``torch.autograd.grad`` on detached copies of the
    parameters (0 for a leaf the loss does not use, as in JAX), then
    ``opt.update`` under ``no_grad``."""
    loss_of = functools.partial(_gnn_loss, apply_fn, cfg)

    def step(params, opt_state, batch):
        loss, grads = _value_and_grad(loss_of, params, batch)
        params, opt_state = opt.update(tree_unflatten(params, grads),
                                       opt_state, params)
        return params, opt_state, {"loss": loss}

    return step


# --------------------------------------------------------------------------
# recsys (DIN)
# --------------------------------------------------------------------------
def _bce(logits, labels):
    """Mean binary cross-entropy of logits, the reference's stable form.
    |x| is written as a select so that its gradient at 0 is 1, as JAX's
    (``torch.abs`` gives 0 there)."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    absolute = torch.where(logits >= 0, logits, -logits)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * labels
                      + torch.log1p(torch.exp(-absolute)))


def make_recsys_train_step(apply_fn, cfg, opt: adamw):
    """``step(params, opt_state, batch)``: BCE of the CTR logits against
    ``batch["label"]``. The embedding tables' gradients are dense, as the
    reference's are (rows no batch touched get 0)."""

    def loss_of(params, batch):
        return _bce(apply_fn(params, batch, cfg), batch["label"])

    def step(params, opt_state, batch):
        loss, grads = _value_and_grad(loss_of, params, batch)
        params, opt_state = opt.update(tree_unflatten(params, grads),
                                       opt_state, params)
        return params, opt_state, {"loss": loss}

    return step


def make_recsys_serve_step(apply_fn, cfg):
    def step(params, batch):
        return torch.sigmoid(apply_fn(params, batch, cfg))

    return step


def make_retrieval_step(score_fn, cfg, *, top_k: int = 100):
    """``step(params, batch) -> (values, indices)``: the ``top_k`` best
    scores of ``score_fn`` (one user against N candidates), in the
    reference's order."""
    @torch.no_grad()
    def step(params, batch):
        return stable_top_k(score_fn(params, batch, cfg), top_k)

    return step
