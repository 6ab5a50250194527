"""gemma2-27b [dense] — arXiv:2408.00118.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, alternating
local(window 4096)/global attention, attn logit softcap 50, final logit
softcap 30, zero-centered RMSNorm with post-norms, tied embeddings,
query scale (d_model/n_heads)^-1/2 = 144^-1/2.

Alternating local layers make long_500k runnable (local layers cache only
the window; global-layer KV shards over the mesh).
"""
from ..models.transformer import TransformerConfig

ARCH_ID = "gemma2-27b"
FAMILY = "lm"
SKIP_SHAPES = ()


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=36864,
        vocab=256000,
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        zero_centered_norm=True,
        tie_embeddings=True,
        query_scale=(4608 / 32) ** -0.5,
        rope_theta=10000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=256,
        vocab=512,
        sliding_window=16,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        zero_centered_norm=True,
        tie_embeddings=True,
        query_scale=(64 / 4) ** -0.5,
        remat=False,
    )
