"""Shared model building blocks (plain functions on tensors, parameters in
dictionaries), the counterparts of ``repro.models.common``.

Type promotion follows the reference: an fp32 tensor times a bf16 one is
fp32 in both frameworks, and a Python float next to a bf16 tensor keeps
bf16. The reference's ``shard`` (a sharding constraint) has no counterpart
on one device and is dropped.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "rms_norm",
    "layer_norm",
    "dense",
    "gelu",
    "silu",
    "softcap",
    "rope_table",
    "apply_rope",
    "trunc_normal",
    "cross_entropy_loss",
    "stable_top_k",
]


def trunc_normal(generator: torch.Generator, shape, scale=1.0,
                 dtype=torch.float32) -> torch.Tensor:
    """Fan-in-scaled truncated normal init on ``generator``'s device: drawn
    in fp32 from [-2, 2], scaled by ``scale / sqrt(shape[0])``, then cast."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)


def rms_norm(x, weight, *, eps=1e-6, zero_centered=False):
    """The norm in fp32; a zero-centred weight gets 1 added in its own
    dtype (bf16 on the path), as the reference does."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + weight) if zero_centered else weight
    return (x * w).to(dt)


def layer_norm(x, weight, bias, *, eps=1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dt)


def dense(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def silu(x):
    return torch.nn.functional.silu(x)


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def rope_table(positions, d_head: int, theta: float = 10000.0):
    """Returns (sin, cos) of shape [..., d_head/2], fp32."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: [..., S, H, d_head]; sin/cos: [..., S, d_head/2] (broadcast over H)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0):
    """Mean token cross-entropy in f32; labels < 0 are masked out."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None].long()
                      )[..., 0]
    loss = lse - ll
    if z_loss > 0:
        loss = loss + z_loss * torch.square(lse)
    mask = (labels >= 0).to(torch.float32)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def stable_top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis of a float tensor of any rank:
    the ``k`` largest values of each row in descending order and their
    int32 indices, in XLA's total order of floats (-0.0 below +0.0) and
    the lower index first among equal values (``torch.topk`` promises no
    order among ties). Each value's place in the total order and its index
    are packed into one int64 key, unique within a row, so one
    ``torch.topk`` of the keys gives the order without a sort or a sync."""
    bits = x.to(torch.float32).view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    n = x.shape[-1]
    rev = n - 1 - torch.arange(n, dtype=torch.int64, device=x.device)
    idx = torch.topk((order << 32) | rev, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx.to(torch.int32)
