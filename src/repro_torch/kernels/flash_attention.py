"""Blocked (flash) attention with online softmax: the two hand-written CUDA
kernels of B8 and their wrapper. Its plain torch version is
``models.attention.flash_attention_torch``, the same blocked online softmax.

The LM's long-prompt attention in prefill (``models/transformer.py`` takes
it at ``s >= cfg.flash_cutoff``; training takes the plain version, which is
differentiable), in the GQA layout of the model:

  in:   q [B, S, K, G, dh], k/v [B, T, K, dh] — fp32, bf16 or fp16, all one
        dtype; any strides whose last one is 1 (else it raises, on either
        device)
  out:  [B, S, K, G, dh] in q's dtype; scores, softmax and accumulation in
        fp32; causal mask, sliding window (``window > 0``) and logit
        softcap (``softcap > 0``) as in the reference

``flash_attention_gqa`` launches a kernel for CUDA tensors and takes the
plain version for CPU tensors — the choice follows the tensors' device and
nothing else. Which kernel depends on dtype and dh only (``variant``):

  ``wgmma``  bf16 and fp16 at dh 64 and 128: ``csrc/flash_attention_wgmma.cu``,
             both products on the tensor cores, K/V tiles by TMA;
  ``fma``    fp32 (the tensor cores cannot meet its check without TF32) and
             dh 256: ``csrc/flash_attention.cu``, fp32 FMA;

any other dh raises. A build or launch failure of either raises; neither
gives way to the other or to the plain version. The reference's
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
    "launches_by_variant",
    "reset_launches",
    "variant",
]

_LIBS = {"fma": "flash_attention", "wgmma": "flash_attention_wgmma"}
HEAD_DIMS = (64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_launches = {"wgmma": 0, "fma": 0}


def variant(dtype: torch.dtype, dh: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernels take {HEAD_DIMS}")
    if dtype in (torch.bfloat16, torch.float16) and dh in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def launches() -> int:
    """How many times the wrapper has launched a CUDA kernel (both)."""
    return sum(_launches.values())


def launches_by_variant() -> dict:
    """Launches of each kernel: ``{"wgmma": n, "fma": m}``."""
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


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


def _function(kind: str):
    fn = getattr(_build.load(_LIBS[kind]), f"{_LIBS[kind]}_launch")
    if fn.argtypes is None:  # the last int: vec (fma) or pack (wgmma)
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 10
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _aligned16(x) -> bool:
    """Every row of ``x`` starts 16-byte aligned: its start, and every
    stride but the last a positive multiple of 16 bytes."""
    per16 = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(st > 0 and st % per16 == 0
                                          for st in x.stride()[:-1])


def _launch(kind, q, k, v, out, *, scale, causal, window, softcap, last):
    """One launch of kernel ``kind`` into ``out``; ``last`` is the C
    interface's final int (fma: 16-byte loads; wgmma: pack, -1 = auto)."""
    b, s, kh, g, dh = q.shape
    fn = _function(kind)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], dh, b, s, k.shape[1], kh, g,
            *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
            float(scale), float(softcap), int(bool(causal)), int(window),
            int(last), torch.cuda.current_stream().cuda_stream,
        )
    _launches[kind] += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention {kind} kernel launch failed: error {err} "
            f"(q {tuple(q.shape)}, T={k.shape[1]}, {q.dtype})"
        )
    return out


def flash_attention_gqa(q, k, v, *, scale, causal=True, window=0,
                        softcap=0.0):
    """Attention of ``q [B,S,K,G,dh]`` over ``k, v [B,T,K,dh]`` ->
    ``[B,S,K,G,dh]`` in q's dtype, on the tensors' device. On the card:
    the ``wgmma`` kernel for bf16/fp16 at dh 64 and 128, the ``fma`` kernel
    for fp32 and dh 256 (``variant``). Launches on the current stream and
    does not synchronise. The kernels have no backward (nor has the
    reference's): an input that requires grad raises, on either device."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention_gqa has no backward: training takes "
            "models.attention.flash_attention_torch")
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be >= 0")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need a last stride of 1")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, kh, g, dh = q.shape
    kind = variant(q.dtype, dh)
    out = torch.empty((b, s, kh, g, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if kind == "wgmma":  # tensor maps need aligned rows: copy any other
        q, k, v = (x if _aligned16(x)
                   else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
        return _launch(kind, q, k, v, out, last=-1, **kw)
    # the FMA kernel's 16-byte loads need aligned rows
    vec = all(_aligned16(x) for x in (q, k, v))
    return _launch(kind, q, k, v, out, last=vec, **kw)
