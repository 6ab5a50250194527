"""Memory-efficient (flash-style) attention in plain torch: the counterpart
of ``repro.models.attention.flash_attention_jnp``, and the plain version
kernel B8 (``kernels/flash_attention.py``) is held against and runs on the
CPU.

Online softmax over KV blocks, looped over Q blocks — peak memory is one
``[B, K, G, block_q, block_k]`` score tile instead of the full ``[S, T]``
matrix. KV blocks wholly outside the causal limit or the sliding window are
never visited (the loop bounds skip them). Supports causal masking, sliding
windows (gemma2 local layers) and attention-logit soft-capping. Unlike the
reference, any S and T are taken: the last block of each may be short. The
reference's ``static_unroll`` variant (a JAX compile-time device) computes
the same function and has no counterpart, and ``q_offset`` (for chunked
prefill, which the port does not do) is dropped.
"""
from __future__ import annotations

import torch

__all__ = ["flash_attention_torch"]

NEG = -1e30


def flash_attention_torch(
    q: torch.Tensor,  # [B, S, K, G, dh] (GQA-grouped)
    k: torch.Tensor,  # [B, T, K, dh]
    v: torch.Tensor,  # [B, T, K, dh]
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,  # 0 = global
    softcap: float = 0.0,
    block_q: int = 2048,
    block_k: int = 2048,
) -> torch.Tensor:
    b, s, kh, g, dh = q.shape
    t = k.shape[1]
    dev = q.device
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    for q_lo in range(0, s, block_q):
        bq = min(block_q, s - q_lo)
        qb = q[:, q_lo:q_lo + bq].permute(0, 2, 3, 1, 4)
        qb = qb.to(torch.float32) * scale  # [B, K, G, bq, dh]
        m = torch.full((b, kh, g, bq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kh, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, bq, dh), dtype=torch.float32, device=dev)
        k_hi = min(q_lo + bq, t) if causal else t
        k_lo = max(q_lo - window + 1, 0) // block_k * block_k if window > 0 else 0
        qpos = q_lo + torch.arange(bq, device=dev)[:, None]
        for lo in range(k_lo, k_hi, block_k):
            hi = min(lo + block_k, t)
            kb = k[:, lo:hi].to(torch.float32)
            vb = v[:, lo:hi].to(torch.float32)
            srs = torch.einsum("bkgqd,bckd->bkgqc", qb, kb)
            if softcap > 0:
                srs = softcap * torch.tanh(srs / softcap)
            kpos = torch.arange(lo, hi, device=dev)[None, :]
            mask = torch.ones((bq, hi - lo), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos <= qpos
            if window > 0:
                mask &= (qpos - kpos) < window
            srs = torch.where(mask, srs, NEG)
            m_new = torch.maximum(m, srs.amax(-1))
            p = torch.exp(srs - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, vb)
            m = m_new
        acc = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q_lo:q_lo + bq] = acc.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out
