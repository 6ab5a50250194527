"""AdamW on trees of tensors, the counterpart of ``repro.train.optimizer``.

``adamw()`` holds an (init, update) pair over arbitrary trees with
global-norm gradient clipping and decoupled weight decay. Moments are fp32
whatever the parameters' dtype. The update is the reference's, written
out: the clip scale is ``min(1, clip / (norm + 1e-9))``, the moments are
bias-corrected with ``b ** count`` in fp32, the decay sits inside the step
``u``, and the learning rate is read at the new count. (``torch.optim.AdamW``
clips nowhere and decays the parameter before the step, so it is not
used.) ``update`` returns new tensors and changes none of its arguments.
The reference's ZeRO-1 moment sharding (``zero1_specs``) has no one-card
counterpart and is dropped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map

__all__ = ["adamw", "AdamWState", "cosine_schedule", "global_norm",
           "state_from_reference"]


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
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        lr = self.lr(count) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        t = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=t.device), t)

        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state.nu, grads)

        def upd(p, m, v):
            p32 = p.to(torch.float32)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps) \
                + self.weight_decay * p32
            return (p32 - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(mu=mu, nu=nu, count=count)


def state_from_reference(state, device="cpu") -> AdamWState:
    """The reference's ``AdamWState`` (numpy or jax leaves) as tensors on
    ``device``; ``count`` stays int32."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return AdamWState(mu=tree_map(t, state.mu), nu=tree_map(t, state.nu),
                      count=t(state.count))
