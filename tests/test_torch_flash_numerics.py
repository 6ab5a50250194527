"""B8's tensor-core design (``csrc/flash_attention_wgmma.cu``) checked on the
CPU, before a card runs it, and the wrapper's choice between its two
kernels.

The kernel computes P V on the tensor cores from 16-bit P, where the
reference and the plain version multiply fp32 P. ``wgmma_design`` below is
a test-only copy of the kernel's arithmetic: 64-row query tiles over
128-key tiles, only the live ones, scores in log2 units, exp2, the
softcap's tanh as the kernel takes it (its series below 1/2, else
1 - 2 / (1 + 2^(2y log2 e))), and P split into hi + lo of the input dtype,
each multiplied by V with an fp32 sum. It is held against the reference's
Pallas kernel (interpret mode) and against ``flash_attention_torch`` at the
limits the card's checks use (``chip_smoke.py``): per element,
ulp * |reference| + 1e-4, ulp = 2^-7 for bf16 and 2^-10 for fp16, on
16-bit inputs at S = 300, which the tiles do not divide. A single rounded
P misses those limits; the last test shows it, which is why the kernel
pays for the second product.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.attention import flash_attention_torch

FLASH_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
FLASH_ATOL = 1e-4
NEG = -1e30
LOG2E = math.log2(math.e)
BQ, BK = 64, 128  # the kernel's query rows per consumer and keys per tile
TANH = (1.0, -1 / 3, 2 / 15, -17 / 315, 62 / 2835, -1382 / 155925,
        21844 / 6081075)


def kernel_tanh(y):
    """tanh as the kernel takes it: the series to y^13 below 1/2, else
    1 - 2 / (1 + 2^(2 y log2 e)), in fp32."""
    y2 = y * y
    series = torch.full_like(y, TANH[-1])
    for c in TANH[-2::-1]:
        series = series * y2 + c
    series = y * series
    exp_form = 1 - 2 / (1 + torch.exp2(2 * LOG2E * y))
    return torch.where(y.abs() < 0.5, series, exp_form)


def wgmma_design(q, k, v, *, scale, causal, window, softcap, split=True):
    """Test-only copy of the wgmma kernel's arithmetic on q [B,S,K,G,dh],
    k/v [B,T,K,dh] (16-bit) -> [B,S,K,G,dh] in q's dtype. ``split`` False
    rounds P once instead of carrying hi + lo."""
    b, s, kh, g, dh = q.shape
    t = k.shape[1]
    dt = q.dtype
    qf = q.float().permute(0, 2, 3, 1, 4)  # [B, K, G, S, dh]
    kf = k.float().permute(0, 2, 1, 3)  # [B, K, T, dh]
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty(b, kh, g, s, dh)
    for q0 in range(0, s, BQ):
        n = min(BQ, s - q0)
        k_first = max(0, q0 - window + 1) if window > 0 else 0
        k_end = min(t, q0 + n) if causal else t
        qpos = torch.arange(q0, q0 + n)[:, None]
        m = torch.full((b, kh, g, n), NEG)
        l = torch.zeros((b, kh, g, n))
        acc = torch.zeros((b, kh, g, n, dh))
        for lo in range(k_first // BK * BK, k_end, BK):
            hi = min(lo + BK, t)
            raw = torch.einsum("bkgqd,bkcd->bkgqc", qf[..., q0:q0 + n, :],
                               kf[:, :, lo:hi])
            if softcap > 0:
                x = softcap * LOG2E * kernel_tanh(raw * (scale / softcap))
            else:
                x = raw * (scale * LOG2E)
            kpos = torch.arange(lo, hi)[None, :]
            mask = torch.ones((n, hi - lo), dtype=torch.bool)
            if causal:
                mask &= kpos <= qpos
            if window > 0:
                mask &= (qpos - kpos) < window
            x = torch.where(mask, x, NEG)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            p_hi = p.to(dt)
            parts = [p_hi, (p - p_hi.float()).to(dt)] if split else [p_hi]
            pv = sum(torch.einsum("bkgqc,bkcd->bkgqd", part.float(),
                                  vf[:, :, lo:hi]) for part in parts)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[..., q0:q0 + n, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(dt)


def inputs(dtype, b=1, s=300, kh=2, g=2, dh=128, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
            .to(dtype) for sh in ((b, s, kh, g, dh), (b, s, kh, dh),
                                  (b, s, kh, dh))]


def over_limit(got, want, dtype):
    """The largest |got - want| / (ulp * |want| + atol): at most 1 passes."""
    want = want.float()
    diff = (got.float() - want).abs()
    return float((diff / (FLASH_ULP[dtype] * want.abs() + FLASH_ATOL)).max())


def pallas(q, k, v, **kw):
    """The reference's Pallas kernel in interpret mode, in blocks of 100
    (it needs blocks that divide S)."""
    out = ref_ops.flash_attention_gqa(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16
                                                if x.dtype == torch.bfloat16
                                                else jnp.float16)
          for x in (q, k, v)),
        block_q=100, block_k=100, interpret=True, **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("dtype,causal,window,softcap,dh", [
    (torch.bfloat16, True, 64, 50.0, 128),
    (torch.bfloat16, True, 0, 50.0, 64),
    (torch.bfloat16, True, 0, 0.0, 128),
    (torch.bfloat16, False, 0, 0.0, 64),
    (torch.float16, True, 64, 50.0, 128),
])
def test_wgmma_design_within_the_card_limits(dtype, causal, window, softcap,
                                             dh):
    q, k, v = inputs(dtype, dh=dh)
    kw = dict(scale=dh ** -0.5, causal=causal, window=window,
              softcap=softcap)
    got = wgmma_design(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert over_limit(got, flash_attention_torch(q, k, v, **kw), dtype) <= 1
    assert over_limit(got, pallas(q, k, v, **kw), dtype) <= 1


def test_single_rounded_p_misses_the_card_limits():
    """One 16-bit P (no lo part) moves outputs past ulp * |out| + 1e-4."""
    q, k, v = inputs(torch.bfloat16)
    kw = dict(scale=128 ** -0.5, causal=True, window=64, softcap=50.0)
    want = flash_attention_torch(q, k, v, **kw)
    assert over_limit(wgmma_design(q, k, v, **kw), want, torch.bfloat16) <= 1
    assert over_limit(wgmma_design(q, k, v, split=False, **kw), want,
                      torch.bfloat16) > 1


def test_kernel_tanh_is_fp32_accurate():
    """Both forms of the kernel's tanh, across the switch at 1/2, to fp32
    rounding of tanh (tanh.approx.f32's ~2^-11 would fail this)."""
    y = torch.linspace(-3, 3, 200_001, dtype=torch.float64)
    got = kernel_tanh(y.float()).double()
    assert float((got - torch.tanh(y)).abs().max()) < 3e-7


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.bfloat16, 256, "fma"), (torch.float16, 256, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 256, "fma"),
])
def test_variant_follows_dtype_and_head_dim(dtype, dh, want):
    assert fa.variant(dtype, dh) == want


@pytest.mark.parametrize("case", ["dh48", "mixed_dtypes", "last_stride"])
def test_wrapper_refusals(case):
    q, k, v = inputs(torch.bfloat16, s=16, dh=64)
    fa.reset_launches()
    if case == "dh48":
        with pytest.raises(ValueError, match="head dim 48"):
            fa.variant(torch.bfloat16, 48)
    elif case == "mixed_dtypes":
        with pytest.raises(TypeError, match="dtypes differ"):
            ops.flash_attention_gqa(q, k.half(), v, scale=1.0)
    else:
        wide = torch.zeros((1, 16, 2, 2, 128), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="last stride"):
            ops.flash_attention_gqa(wide[..., ::2], k, v, scale=1.0)
    assert fa.launches_by_variant() == {"wgmma": 0, "fma": 0}
