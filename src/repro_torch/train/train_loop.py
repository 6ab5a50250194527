"""Step factories, the counterpart of ``repro.train.train_loop``: for now
the serving steps (LM prefill and decode, recsys CTR scoring). The training
steps, the optimizer and the checkpoints come with the training slice.

A step is a plain function over tensors; the reference wraps its steps in
``jax.jit``, the port runs them eagerly under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from ..models import transformer as tfm

__all__ = [
    "make_lm_prefill_step",
    "make_lm_decode_step",
    "make_recsys_serve_step",
]


def make_lm_prefill_step(cfg, *, max_len: int):
    def step(params, tokens):
        return tfm.forward_prefill(params, tokens, cfg, max_len=max_len)

    return step


def make_lm_decode_step(cfg):
    def step(params, token, pos, cache):
        return tfm.forward_decode(params, token, pos, cache, cfg)

    return step


def make_recsys_serve_step(apply_fn, cfg):
    def step(params, batch):
        return torch.sigmoid(apply_fn(params, batch, cfg))

    return step
