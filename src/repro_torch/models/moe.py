"""Top-k MoE FFN with sort-based capacity dispatch, the counterpart of
``repro.models.moe``.

Dispatch, as in the reference step by step: route in fp32 (softmax, then
``jax.lax.top_k``'s order through ``stable_top_k``, gates renormalised),
flatten the (token, k) assignments, stable-sort them by expert, number
each within its expert, drop those at or past the capacity ``c`` to a
phantom slot ``e * c``, gather the tokens into ``[E, C, d]`` (a zero row
for empty slots), run the SwiGLU experts as batched matrix products in the
parameters' dtype, and combine with the gates. Every integer table is
int32, as the reference's.

The combine adds no float by scatter: the reference's
``zeros.at[disp_tok].add(...)`` becomes, for each token, its at most ``k``
kept slots in ascending slot order (the order the reference's scatter adds
them), gathered and added one after another in the experts' dtype. So the
forward pass gives the same bits from run to run on the card, and under
``torch.utils.checkpoint`` its recomputation equals it (``index_add_`` on a
CUDA float tensor uses atomics).

``moe_apply_local_ep`` is the reference's ``shard_map`` expert parallelism
on one device: the mesh becomes its two extents, ``data_shards`` row shards
and ``model_shards`` expert columns, carried as leading tensor dimensions,
and the ``psum`` over columns a sum in column order. ``moe_param_specs``
is not ported: it is mesh placement, which has no analogue on one card.
"""
from __future__ import annotations

from typing import Dict

import torch

from .common import silu, stable_top_k, trunc_normal

__all__ = ["moe_init", "capacity", "top_k_gates", "moe_route",
           "moe_dispatch", "moe_apply", "local_ep_tables",
           "moe_apply_local_ep"]


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype) -> Dict[str, torch.Tensor]:
    """One layer's parameters on ``generator``'s device, in the reference's
    layout and scale: the router ``[d, E]`` in fp32 (fan-in d), the
    experts ``w_gate`` / ``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f,
    d]`` in ``dtype``, each drawn as one ``(E, ...)`` tensor, so that —
    as in the reference — their fan-in is E."""
    return {
        "router": trunc_normal(generator, (d_model, n_experts), 1.0,
                               torch.float32),
        "w_gate": trunc_normal(generator, (n_experts, d_model, d_ff), 1.0,
                               dtype),
        "w_up": trunc_normal(generator, (n_experts, d_model, d_ff), 1.0,
                             dtype),
        "w_down": trunc_normal(generator, (n_experts, d_ff, d_model), 1.0,
                               dtype),
    }


def capacity(capacity_factor: float, t: int, k: int, e: int) -> int:
    """Slots an expert, the reference's expression in its order."""
    return max(int(capacity_factor * t * k / e), 1)


def top_k_gates(probs: torch.Tensor, top_k: int):
    """(gates ``[T, K]`` renormalised to sum 1, expert ids ``[T, K]``
    int32) of the router's fp32 ``probs``: their top k in
    ``jax.lax.top_k``'s order."""
    gates, expert_ids = stable_top_k(probs, top_k)
    # summed left to right, the order in which XLA reduces a short row on
    # the host, so that the gates equal the reference's bit for bit
    total = gates[..., :1]
    for j in range(1, top_k):
        total = total + gates[..., j:j + 1]
    gates = gates / torch.clamp(total, min=1e-9)
    return gates, expert_ids


def moe_route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """``top_k_gates`` of the softmax of ``x @ router`` in fp32."""
    return top_k_gates(torch.softmax(x.to(torch.float32) @ router, dim=-1),
                       top_k)


def moe_dispatch(local_e: torch.Tensor, gates: torch.Tensor, *,
                 n_local: int, c: int, k: int) -> Dict[str, torch.Tensor]:
    """The dispatch tables of the reference's body over assignments
    ``local_e [..., T*K]`` (int32 expert of each (token, k) pair, row-major;
    ``n_local`` marks one routed to another column) with their ``gates``.
    Leading dimensions are independent dispatches. Returns the reference's
    tables — ``order``, ``sorted_e``, ``counts`` (``n_local + 1`` bins),
    ``starts``, ``pos``, ``keep``, ``slot``, ``tok`` (int32) and
    ``disp_tok`` (fill T), ``disp_gate`` (fp32, fill 0), each of ``n_local
    * c + 1`` entries — and ``slots [..., T, K]``: each token's slots in
    ascending order, ``n_local * c`` where none was kept."""
    lead, n = local_e.shape[:-1], local_e.shape[-1]
    t = n // k
    dev = local_e.device
    order = torch.argsort(local_e, dim=-1, stable=True)
    sorted_e = torch.gather(local_e, -1, order)
    counts = torch.zeros(lead + (n_local + 1,), dtype=torch.int32,
                         device=dev).scatter_add_(
        -1, sorted_e.long(), torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, -1, dtype=torch.int32) - counts
    pos = (torch.arange(n, dtype=torch.int32, device=dev)
           - torch.gather(starts, -1, sorted_e.long()))
    keep = (sorted_e < n_local) & (pos < c)
    phantom = n_local * c
    slot = torch.where(keep, sorted_e * c + pos, phantom)
    tok = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    gate_sorted = torch.gather(gates.reshape(lead + (n,)), -1, order)
    # every dropped assignment writes the same fill to the phantom slot
    disp_tok = torch.full(lead + (phantom + 1,), t, dtype=torch.int32,
                          device=dev).scatter(
        -1, slot.long(), torch.where(keep, tok, t))
    disp_gate = torch.zeros(lead + (phantom + 1,), dtype=torch.float32,
                            device=dev).scatter(
        -1, slot.long(), torch.where(keep, gate_sorted, 0.0))
    # assignment order[i] = tok * k + j holds slot[i]: a permutation
    slots = torch.empty_like(slot).scatter_(-1, order, slot)
    slots = torch.sort(slots.reshape(lead + (t, k)), dim=-1).values
    return {"order": order.to(torch.int32), "sorted_e": sorted_e,
            "counts": counts, "starts": starts, "pos": pos, "keep": keep,
            "slot": slot, "tok": tok, "disp_tok": disp_tok,
            "disp_gate": disp_gate, "slots": slots}


def _experts(xe, w_gate, w_up, w_down):
    """SwiGLU of each expert's rows: ``xe [..., E, C, d]`` -> ``[..., E, C,
    d]``, batched matrix products in the operands' dtype."""
    return (silu(torch.matmul(xe, w_gate))
            * torch.matmul(xe, w_up)) @ w_down


def _gather_rows(x, idx):
    """``x [..., R, d]`` rows at ``idx [..., *]`` (leading dims shared)."""
    if x.dim() == 2:
        return x.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (x.shape[-1],))
    flat = idx.reshape(idx.shape[:x.dim() - 2] + (-1,)).long()
    out = torch.gather(x, -2, flat[..., None].expand(
        flat.shape + (x.shape[-1],)))
    return out.reshape(idx.shape + (x.shape[-1],))


def _gather_tokens(x, tables, *, n_local: int, c: int):
    """``x [..., T, d]`` -> ``[..., n_local, c, d]``: each slot's token, a
    zero row for an empty slot."""
    lead, d = x.shape[:-2], x.shape[-1]
    x_pad = torch.cat([x, x.new_zeros(lead + (1, d))], dim=-2)
    xe = _gather_rows(x_pad, tables["disp_tok"][..., :n_local * c])
    return xe.reshape(lead + (n_local, c, d))


def _combine(ye, tables):
    """``ye [..., n_local, c, d]`` -> ``[..., T, d]`` in its dtype: each
    slot's row times its gate (cast to ``ye``'s dtype before the product,
    as the reference), then each token's kept rows added in ascending slot
    order."""
    lead, d = ye.shape[:-3], ye.shape[-1]
    n_slots = ye.shape[-3] * ye.shape[-2]
    ye = ye.reshape(lead + (n_slots, d)) * tables["disp_gate"][
        ..., :n_slots, None].to(ye.dtype)
    ye_pad = torch.cat([ye, ye.new_zeros(lead + (1, d))], dim=-2)
    rows = _gather_rows(ye_pad, tables["slots"])  # [..., T, K, d]
    y = torch.zeros(rows.shape[:-2] + (d,), dtype=ye.dtype, device=ye.device)
    for j in range(rows.shape[-2]):
        y = y + rows[..., j, :]
    return y


def moe_apply(p, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """``x [T, d]`` -> ``[T, d]`` in ``x``'s dtype, the reference's
    ``moe_apply`` on one device. The capacity follows this call's T."""
    t = x.shape[0]
    e, k = n_experts, top_k
    c = capacity(capacity_factor, t, k, e)
    gates, expert_ids = moe_route(p["router"], x, k)
    tables = moe_dispatch(expert_ids.reshape(-1), gates, n_local=e, c=c,
                          k=k)
    xe = _gather_tokens(x, tables, n_local=e, c=c)
    ye = _experts(xe, p["w_gate"], p["w_up"], p["w_down"])
    return _combine(ye, tables).to(x.dtype)


def local_ep_tables(expert_ids: torch.Tensor, gates: torch.Tensor, *,
                    n_experts: int, capacity_factor: float,
                    data_shards: int, model_shards: int):
    """The dispatch tables of every (data shard, column) of
    ``moe_apply_local_ep`` as ``[data_shards, model_shards, ...]``
    tensors: (tables, e_loc, c)."""
    t, k = expert_ids.shape
    e, dp, m = n_experts, data_shards, model_shards
    if e % m:
        raise ValueError(f"{e} experts do not split over {m} columns")
    if t % dp:
        raise ValueError(f"{t} tokens do not split over {dp} data shards")
    e_loc, t_loc = e // m, t // dp
    c = capacity(capacity_factor, t_loc, k, e)
    flat_e = expert_ids.reshape(dp, 1, t_loc * k)
    e_lo = (torch.arange(m, dtype=torch.int32, device=expert_ids.device)
            * e_loc)[None, :, None]
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    local_e = torch.where(mine, flat_e - e_lo, e_loc)  # e_loc: drop bucket
    g = gates.reshape(dp, 1, t_loc * k).expand(dp, m, t_loc * k)
    return moe_dispatch(local_e, g, n_local=e_loc, c=c, k=k), e_loc, c


def moe_apply_local_ep(p, x: torch.Tensor, *, n_experts: int, top_k: int,
                       capacity_factor: float = 1.25, data_shards: int,
                       model_shards: int) -> torch.Tensor:
    """The reference's ``moe_apply_local_ep`` on a ``(data_shards,
    model_shards)`` mesh, on one device. Routing runs on the whole ``x``;
    the rows split into ``data_shards`` contiguous shards, each with its
    own capacity (of its ``T / data_shards`` tokens); column ``j``
    dispatches experts ``[j * E/m, (j+1) * E/m)`` and sends other tokens
    to its drop bucket; the columns' outputs are summed in column order.
    With drops and ``data_shards > 1`` it differs from ``moe_apply``, as
    the reference's does."""
    t, d = x.shape
    dp, m = data_shards, model_shards
    gates, expert_ids = moe_route(p["router"], x, top_k)
    tables, e_loc, c = local_ep_tables(
        expert_ids, gates, n_experts=n_experts,
        capacity_factor=capacity_factor, data_shards=dp, model_shards=m)
    x_loc = x.reshape(dp, 1, t // dp, d).expand(dp, m, t // dp, d)

    def cols(w):  # [E, ...] -> [m, e_loc, ...]: each column's experts
        return w.reshape((m, e_loc) + w.shape[1:])

    xe = _gather_tokens(x_loc, tables, n_local=e_loc, c=c)
    y = _combine(_experts(xe, cols(p["w_gate"]), cols(p["w_up"]),
                          cols(p["w_down"])), tables)
    out = y[:, 0]
    for j in range(1, m):  # the psum over the columns
        out = out + y[:, j]
    return out.reshape(t, d).to(x.dtype)
