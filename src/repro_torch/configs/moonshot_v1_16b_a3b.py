"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048 16H (GQA kv=16 => MHA-width KV) d_ff=1408 vocab=163840,
MoE 64 experts top-6. Full attention -> long_500k is a documented skip.
"""
from ..models.transformer import TransformerConfig

ARCH_ID = "moonshot-v1-16b-a3b"
FAMILY = "lm"
SKIP_SHAPES = ("long_500k",)  # pure full attention


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab=163840,
        moe_experts=64,
        moe_top_k=6,
        rope_theta=50000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        vocab=512,
        moe_experts=8,
        moe_top_k=2,
        remat=False,
    )
