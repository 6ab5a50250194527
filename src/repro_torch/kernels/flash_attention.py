"""Blocked (flash) attention with online softmax: the hand-written CUDA
kernel (``csrc/flash_attention.cu``, B8) and its wrapper. Its plain torch
version is ``models.attention.flash_attention_torch``, the same blocked
online softmax.

The LM's long-prompt attention (``models/transformer.py`` takes it at
``s >= cfg.flash_cutoff``), in the GQA layout of the model:

  in:   q [B, S, K, G, dh], k/v [B, T, K, dh] — fp32, bf16 or fp16, all one
        dtype; any strides whose last one is 1
  out:  [B, S, K, G, dh] in q's dtype; scores, softmax and accumulation in
        fp32; causal mask, sliding window (``window > 0``) and logit
        softcap (``softcap > 0``) as in the reference

``flash_attention_gqa`` launches the kernel for CUDA tensors (dh 64, 128
or 256; anything else raises) and takes the plain version for CPU tensors
— the choice follows the tensors' device and nothing else. The reference's
``block_q``/``block_k``/``interpret`` have no meaning here and are dropped.
A row with no key left by its mask (only possible without ``causal``)
has no defined value: each version averages whatever keys its own blocks
visited. The model never builds one.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.attention import flash_attention_torch
from . import _build

__all__ = [
    "flash_attention_gqa",
    "flash_attention_ref",
    "launches",
    "reset_launches",
]

_LIB = "flash_attention"
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_launches = 0


def launches() -> int:
    """How many times the wrapper has launched the CUDA kernel."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def flash_attention_ref(q, k, v, *, scale, causal=True, window=0,
                        softcap=0.0):
    """The reference's oracle layout: q [B, S, dh], k/v [B, T, dh] (heads
    folded into B) -> [B, S, dh]."""
    out = flash_attention_torch(
        q[:, :, None, None], k[:, :, None], v[:, :, None], scale=scale,
        causal=causal, window=window, softcap=softcap)
    return out[:, :, 0, 0]


def _check(q, k, v) -> None:
    for name, t, nd in (("q", q, 5), ("k", k, 4), ("v", v, 4)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dim() != nd:
            raise ValueError(f"{name}: expected {nd} dims, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: expected float32, bfloat16 or float16, "
                            f"got {t.dtype}")
    b, _, kh, _, dh = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kh, dh):
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}: [B, S, K, G, dh] vs [B, T, K, dh]")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if k.shape[1] == 0:
        raise ValueError("no keys: T = 0")


def _function():
    fn = _build.load(_LIB).flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 10
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_gqa(q, k, v, *, scale, causal=True, window=0,
                        softcap=0.0):
    """Attention of ``q [B,S,K,G,dh]`` over ``k, v [B,T,K,dh]`` ->
    ``[B,S,K,G,dh]`` in q's dtype, on the tensors' device. Launches on the
    current stream and does not synchronise."""
    _check(q, k, v)
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, kh, g, dh = q.shape
    t = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernel takes {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need a last stride of 1")
    out = torch.empty((b, s, kh, g, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # 16-byte loads need every row start 16-byte aligned
    per16 = 16 // q.element_size()
    vec = int(all(x.data_ptr() % 16 == 0
                  and all(st % per16 == 0 for st in x.stride()[:-1])
                  for x in (q, k, v)))
    fn = _function()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], dh, b, s, t, kh, g,
            *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
            float(scale), float(softcap), int(bool(causal)), int(window), vec,
            torch.cuda.current_stream().cuda_stream,
        )
    global _launches
    _launches += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err} "
            f"(q {tuple(q.shape)}, T={t}, {q.dtype})"
        )
    return out
