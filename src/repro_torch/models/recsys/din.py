"""DIN — Deep Interest Network (Zhou et al., arXiv:1706.06978): the
counterpart of ``repro.models.recsys.din``.

Assigned config: embed_dim=18, seq_len=100, attention MLP 80-40,
output MLP 200-80, interaction = target attention.

- item-id + category-id embedding tables (18-d each; item repr = concat,
  36-d);
- local activation unit: per (history item, target): MLP([h, t, h-t, h*t])
  -> 80 -> 40 -> 1, *unnormalized* weights (DIN does not softmax), weighted
  sum-pool of the history;
- concat(pooled history, target, user profile) -> 200 -> 80 -> 1 with Dice
  activations -> CTR logit.

Dice normalises with the batch's own statistics (population variance) at
serving time too, so one request's score depends on its batch, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..common import trunc_normal
from .embedding import embedding_init, lookup

__all__ = ["DINConfig", "init_params", "params_from_reference", "apply",
           "retrieval_score"]


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 100_000_000
    n_cats: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    d_profile: int = 8
    attn_hidden: tuple = (80, 40)
    mlp_hidden: tuple = (200, 80)
    dtype: Any = torch.float32

    @property
    def d_item(self) -> int:
        return 2 * self.embed_dim  # item ++ category


def _mlp_init(generator, sizes, dtype):
    return [{"w": trunc_normal(generator, (a, b)).to(dtype),
             "b": torch.zeros((b,), dtype=dtype, device=generator.device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def init_params(cfg: DINConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device (the reference's init;
    other draws)."""
    d = cfg.d_item
    attn_sizes = (4 * d,) + cfg.attn_hidden + (1,)
    mlp_sizes = (2 * d + cfg.d_profile,) + cfg.mlp_hidden + (1,)
    return {
        "item_table": embedding_init(generator, cfg.n_items, cfg.embed_dim,
                                     cfg.dtype),
        "cat_table": embedding_init(generator, cfg.n_cats, cfg.embed_dim,
                                    cfg.dtype),
        "attn": _mlp_init(generator, attn_sizes, cfg.dtype),
        "mlp": _mlp_init(generator, mlp_sizes, cfg.dtype),
        "dice_alpha": torch.zeros((len(cfg.mlp_hidden),), dtype=cfg.dtype,
                                  device=generator.device),
    }


def params_from_reference(cfg: DINConfig, tree):
    """The port's parameters from the reference's pytree (numpy arrays),
    as CPU tensors."""
    def t(a):
        x = torch.from_numpy(np.array(a))
        if x.dtype != cfg.dtype:
            raise TypeError(f"parameter of dtype {x.dtype}, config says "
                            f"{cfg.dtype}")
        return x

    return {
        "item_table": t(tree["item_table"]),
        "cat_table": t(tree["cat_table"]),
        "attn": [{"w": t(l["w"]), "b": t(l["b"])} for l in tree["attn"]],
        "mlp": [{"w": t(l["w"]), "b": t(l["b"])} for l in tree["mlp"]],
        "dice_alpha": t(tree["dice_alpha"]),
    }


def _dice(x, alpha):
    """Dice activation: adaptive PReLU gated by batch statistics."""
    mu = x.mean(dim=0, keepdim=True)
    var = x.var(dim=0, keepdim=True, correction=0)
    ps = torch.sigmoid((x - mu) * torch.rsqrt(var + 1e-8))
    return ps * x + (1.0 - ps) * alpha * x


def _mlp(params, x, alphas=None):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            x = _dice(x, alphas[i]) if alphas is not None else torch.relu(x)
    return x


def _item_repr(params, items, cats):
    return torch.cat([lookup(params["item_table"], items),
                      lookup(params["cat_table"], cats)], dim=-1)


def _attention_pool(params, hist, target, mask):
    """hist [B, L, D], target [B, D] -> pooled [B, D] (local activation)."""
    b, l, d = hist.shape
    t = target[:, None, :].expand(b, l, d)
    feats = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = _mlp(params["attn"], feats)[..., 0]  # [B, L], unnormalized
    w = torch.where(mask, w, 0.0)
    return torch.einsum("bl,bld->bd", w, hist)


def apply(params, batch: Dict[str, torch.Tensor], cfg: DINConfig):
    """Returns CTR logits [B]."""
    hist = _item_repr(params, batch["hist_items"], batch["hist_cats"])
    target = _item_repr(params, batch["target_item"], batch["target_cat"])
    pooled = _attention_pool(params, hist, target, batch["hist_mask"])
    x = torch.cat([pooled, target, batch["user_profile"]], dim=-1)
    return _mlp(params["mlp"], x, alphas=params["dice_alpha"])[..., 0]


def retrieval_score(params, batch: Dict[str, torch.Tensor], cfg: DINConfig):
    """One user vs N candidates [N]: batched attention, no loop.

    batch: hist_items/hist_cats/hist_mask [1, L]; cand_items/cand_cats [N];
    user_profile [1, d_profile].
    """
    hist = _item_repr(params, batch["hist_items"], batch["hist_cats"])
    cands = _item_repr(params, batch["cand_items"], batch["cand_cats"])
    n = cands.shape[0]
    l = hist.shape[1]
    h = hist.expand((n,) + hist.shape[1:])  # [N, L, D] (view)
    pooled = _attention_pool(params, h, cands,
                             batch["hist_mask"].expand(n, l))
    prof = batch["user_profile"].expand(n, batch["user_profile"].shape[-1])
    x = torch.cat([pooled, cands, prof], dim=-1)
    return _mlp(params["mlp"], x, alphas=params["dice_alpha"])[..., 0]
