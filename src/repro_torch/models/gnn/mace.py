"""MACE (Batatia et al., arXiv:2206.07697), the counterpart of
``repro.models.gnn.mace`` — assigned config: 2 interaction layers, 128
channels, l_max=2, correlation order 3, 8 radial Bessel functions,
E(3)-equivariant (ACE product basis).

Compact from-scratch implementation (no e3nn) on top of ``so3.py``:

- node features are dicts {l: [N, 2l+1, C]} for l = 0..l_max
- **interaction**: for each edge, couple the sender's l1 features with the
  spherical harmonics Y_l2 of the edge direction through real CG tensors
  into l3 channels, weighted by a learned radial MLP over Bessel RBFs;
  scatter-sum into receivers (the A-basis of MACE) through
  ``common.segment_sum`` (kernel B9), one call per coupling path
- **product basis**: correlation order 3 via iterated CG self-couplings of
  the A-basis (A x A -> B2, B2 x A -> B3), per-channel weights
- **readout**: per-layer linear on the l=0 channel -> per-node scalar,
  summed over layers and nodes (B9 again, per graph) for the energy.

The reference's three-operand einsums are two contractions here, the
coupling tensor first, so that no ``[E, a, b, C]`` (or ``[N, a, b, C]``)
product is built; the sums run in another fp32 order than the reference's.
The coupling tensors are cached on each device and dtype they are used on.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Tuple

import torch

from ..common import silu, trunc_normal
from ._params import from_reference
from .common import GraphBatch, mlp_apply, mlp_init, segment_sum
from .so3 import cg_real, real_sph_harm

__all__ = ["MACEConfig", "init_params", "apply", "params_from_reference"]


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    channels: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    n_species: int = 4
    r_cut: float = 5.0
    radial_hidden: int = 64
    dtype: Any = torch.float32

    @property
    def ls(self) -> Tuple[int, ...]:
        return tuple(range(self.l_max + 1))


def _couplings(l_max: int) -> List[Tuple[int, int, int]]:
    """All (l1, l2, l3) with l1,l2,l3 <= l_max satisfying the triangle rule
    and parity (l1+l2+l3 even — SH tensor products of polynomial features)."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if (l1 + l2 + l3) % 2 == 0:
                    out.append((l1, l2, l3))
    return out


@functools.lru_cache(maxsize=None)
def _cg(l1: int, l2: int, l3: int, device: torch.device,
        dtype: torch.dtype) -> torch.Tensor:
    """``cg_real(l1, l2, l3)`` as a tensor, copied to ``device`` once."""
    return torch.as_tensor(cg_real(l1, l2, l3), dtype=dtype, device=device)


def bessel_rbf(r, n_rbf: int, r_cut: float):
    """Radial Bessel basis with smooth cutoff (DimeNet-style). The floor and
    the clip are ``torch.maximum`` / ``torch.minimum``, which split the
    gradient at a tie as ``jnp.maximum`` and ``jnp.clip`` do (a self-loop's
    distance can tie the floor)."""
    r = torch.maximum(r, r.new_tensor(1e-6))
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rb = (math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * r[..., None] / r_cut)
          / r[..., None])
    # polynomial cutoff envelope
    u = torch.minimum(torch.maximum(r / r_cut, r.new_tensor(0.0)),
                      r.new_tensor(1.0))
    env = 1.0 - 10.0 * u**3 + 15.0 * u**4 - 6.0 * u**5
    return rb * env[..., None]


def init_params(cfg: MACEConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``generator``'s device (the reference's init;
    other draws)."""
    n_paths = len(_couplings(cfg.l_max))
    c = cfg.channels

    def per_l():
        return {str(l): trunc_normal(generator, (c, c), dtype=cfg.dtype)
                for l in cfg.ls}

    layers = [{
        # radial MLP: rbf -> weight per coupling path & channel
        "radial": mlp_init(generator,
                           (cfg.n_rbf, cfg.radial_hidden, n_paths * c),
                           cfg.dtype),
        "mix": per_l(),    # linear mix per l after aggregation
        "prod2": per_l(),  # product-basis weights (correlation 2 and 3)
        "prod3": per_l(),
        "readout": mlp_init(generator, (c, 16, 1), cfg.dtype),
    } for _ in range(cfg.n_layers)]
    return {"embed": trunc_normal(generator, (cfg.n_species, c),
                                  dtype=cfg.dtype),
            "layers": layers}


def params_from_reference(cfg: MACEConfig, tree) -> Dict[str, Any]:
    """The reference's parameters (numpy leaves) as CPU tensors."""
    return from_reference(tree, init_params(cfg, torch.Generator()))


def _interaction(p, feats, batch, sh, rbf, cfg: MACEConfig):
    """A-basis: edge-wise CG coupling + radial weights + scatter to nodes."""
    src, dst, mask = batch["edge_src"], batch["edge_dst"], batch["edge_mask"]
    n = feats[0].shape[0]
    c = cfg.channels
    coup = _couplings(cfg.l_max)
    radial = mlp_apply(p["radial"], rbf, act=silu)  # [E, P*C]
    radial = radial.reshape(radial.shape[0], len(coup), c)
    agg = {l: feats[0].new_zeros((n, 2 * l + 1, c)) for l in cfg.ls}
    for pi, (l1, l2, l3) in enumerate(coup):
        cgt = _cg(l1, l2, l3, rbf.device, cfg.dtype)  # [m1, m2, m3]
        h_src = feats[l1][src]  # [E, 2l1+1, C]
        yc = torch.einsum("eb,abk->eka", sh[l2], cgt)  # [E, 2l3+1, 2l1+1]
        w = radial[:, pi, :]  # [E, C]
        msg = torch.bmm(yc, h_src) * w[:, None, :]  # [E, 2l3+1, C]
        msg = torch.where(mask[:, None, None], msg, 0.0)
        agg[l3] = agg[l3] + segment_sum(msg, dst, n)
    # per-l linear mix
    return {l: agg[l] @ p["mix"][str(l)] for l in cfg.ls}


def _couple(x, y, cgt):
    """``einsum("nac,nbc,abk->nkc", x, y, cgt)``: ``x`` with ``cgt`` first
    (one GEMM to ``[N, C, b, k]``), then with ``y`` per node and channel."""
    a, b, k = cgt.shape
    t = x.transpose(1, 2) @ cgt.reshape(a, b * k)
    t = t.reshape(x.shape[0], x.shape[2], b, k)
    return torch.einsum("ncbk,nbc->nkc", t, y)


def _product_basis(p, a, cfg: MACEConfig):
    """B-basis: iterated CG self-couplings, channel-wise (correlation <= 3)."""
    dev = a[0].device
    # nu=2: (A x A)_l
    b2 = {l: torch.zeros_like(a[l]) for l in cfg.ls}
    for (l1, l2, l3) in _couplings(cfg.l_max):
        b2[l3] = b2[l3] + _couple(a[l1], a[l2], _cg(l1, l2, l3, dev,
                                                    a[0].dtype))
    # nu=3: (B2 x A)_l
    b3 = {l: torch.zeros_like(a[l]) for l in cfg.ls}
    for (l1, l2, l3) in _couplings(cfg.l_max):
        b3[l3] = b3[l3] + _couple(b2[l1], a[l2], _cg(l1, l2, l3, dev,
                                                     a[0].dtype))
    return {l: a[l] + b2[l] @ p["prod2"][str(l)] + b3[l] @ p["prod3"][str(l)]
            for l in cfg.ls}


def apply(params, batch: GraphBatch, cfg: MACEConfig):
    """Returns (node_energies [N], graph_energy scalar or [n_graphs])."""
    src, dst = batch["edge_src"], batch["edge_dst"]
    pos = batch["positions"].to(cfg.dtype)
    species = batch["node_feat"].reshape(-1)  # integer ids
    n = pos.shape[0]
    c = cfg.channels

    vec = pos[dst] - pos[src]  # [E, 3]
    dist = torch.sqrt((vec * vec).sum(-1) + 1e-12)
    sh = real_sph_harm(vec, cfg.l_max)  # {l: [E, 2l+1]}
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.r_cut)  # [E, n_rbf]

    h0 = params["embed"][species]  # [N, C]
    feats = {l: pos.new_zeros((n, 2 * l + 1, c)) for l in cfg.ls}
    feats[0] = h0[:, None, :]

    node_e = pos.new_zeros((n,))
    for p in params["layers"]:
        a = _interaction(p, feats, batch, sh, rbf, cfg)
        feats = _product_basis(p, a, cfg)
        scalar = feats[0][:, 0, :]  # invariant channel
        node_e = node_e + mlp_apply(p["readout"], scalar, act=silu)[:, 0]
    node_e = torch.where(batch["node_mask"], node_e, 0.0)
    if "graph_ids" in batch:
        n_graphs = batch["labels"].shape[0]  # static: one energy per graph
        e = segment_sum(node_e, batch["graph_ids"], n_graphs)
    else:
        e = node_e.sum()
    return node_e, e
