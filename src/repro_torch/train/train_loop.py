"""Step factories, the counterpart of ``repro.train.train_loop``: the
serving steps (LM prefill and decode, recsys CTR scoring) and the GNN train
step. The LM and recsys train steps come with a later slice.

A step is a plain function over tensors; the reference wraps its steps in
``jax.jit``, the port runs them eagerly (the serving steps under
``torch.inference_mode``). The GNN train step is functional, as the
reference's is: it returns new parameters and optimizer state and changes
none of its arguments, so ``TrainRunner``'s retry of a failed step never
applies half an update twice.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..models import transformer as tfm
from ..models.common import cross_entropy_loss
from ..models.gnn.common import segment_mean
from ..tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import adamw

__all__ = [
    "make_lm_prefill_step",
    "make_lm_decode_step",
    "make_gnn_train_step",
    "make_recsys_serve_step",
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
    mean-pooled first), mean squared error for float labels. MACE's
    energy branch comes with MACE."""
    out = apply_fn(params, batch, cfg)
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
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        loss = loss_of(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)])
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return step


def make_recsys_serve_step(apply_fn, cfg):
    def step(params, batch):
        return torch.sigmoid(apply_fn(params, batch, cfg))

    return step
