"""AdamW on trees of tensors, the counterpart of ``repro.train.optimizer``.

``adamw()`` holds an (init, update) pair over arbitrary trees with
global-norm gradient clipping and decoupled weight decay. Moments are fp32
whatever the parameters' dtype. The update is the reference's, written
out: the clip scale is ``min(1, clip / (norm + 1e-9))``, the moments are
bias-corrected with ``b ** count`` in fp32, the decay sits inside the step
``u``, and the learning rate is read at the new count. (``torch.optim.AdamW``
clips nowhere and decays the parameter before the step, so it is not
used.) ``update`` returns new tensors and changes none of its arguments;
it fills each leaf's new moments and parameter chunk by chunk, so that
beside them only two chunk-sized scratch tensors are alive.
The reference's ZeRO-1 moment sharding (``zero1_specs``) has no one-card
counterpart and is dropped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["adamw", "AdamWState", "cosine_schedule", "global_norm",
           "state_from_reference"]


# elements of a leaf updated at once: a chunk's two fp32 scratch tensors are
# 256 MiB each, however large the leaf (DIN's item table: 1.8e9 elements)
UPDATE_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32, 0-d


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class adamw:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")

        def f32(x):
            return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

        return AdamWState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                          count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        count = state.count + 1
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
        lr = self.lr(count) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        t = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=t.device), t)

        def chunk(p, g, m, v, p_out, m_out, v_out):
            """The update of one chunk of a leaf into its slices of the
            new leaves, in the reference's order, with two scratch tensors
            of the chunk's size."""
            # the clip in fp32, as JAX promotes g (bf16 too) times the
            # fp32 scale
            g32 = (g.to(torch.float32) * scale if scale is not None
                   else g.to(torch.float32, copy=True))
            buf = torch.mul(g32, 1 - b1)
            torch.mul(m, b1, out=m_out).add_(buf)
            torch.square(g32, out=buf).mul_(1 - b2)
            torch.mul(v, b2, out=v_out).add_(buf)
            p32 = p.to(torch.float32)
            # u = (mu / c1) / (sqrt(nu / c2) + eps) + wd * p, in g32
            torch.div(v_out, c2, out=buf).sqrt_().add_(self.eps)
            torch.div(m_out, c1, out=g32).div_(buf)
            g32.add_(torch.mul(p32, self.weight_decay, out=buf))
            # p - lr * u, rounded to the parameter's dtype
            p_out.copy_(torch.sub(p32, torch.mul(g32, lr, out=buf), out=g32))

        def leaf(p, g, m, v):
            """One leaf's new (parameter, mu, nu): fresh tensors filled
            chunk by chunk (``UPDATE_CHUNK`` elements), so that beside them
            only two chunk-sized scratch tensors are alive."""
            outs = [torch.empty_like(x) for x in (p, m, v)]
            flat = [x.reshape(-1) for x in (p, g, m, v, *outs)]
            for lo in range(0, p.numel(), UPDATE_CHUNK):
                chunk(*(x[lo:lo + UPDATE_CHUNK] for x in flat))
            return outs

        new = [leaf(*x) for x in zip(*(tree_leaves(t) for t in (
            params, grads, state.mu, state.nu)))]
        p, mu, nu = (tree_unflatten(tree, [x[i] for x in new])
                     for i, tree in enumerate((params, state.mu, state.nu)))
        return p, AdamWState(mu=mu, nu=nu, count=count)


def state_from_reference(state, device="cpu") -> AdamWState:
    """The reference's ``AdamWState`` (numpy or jax leaves) as tensors on
    ``device``; ``count`` stays int32."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return AdamWState(mu=tree_map(t, state.mu), nu=tree_map(t, state.nu),
                      count=t(state.count))
