"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
Full attention -> long_500k is a documented skip.
"""
from ..models.transformer import TransformerConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"
FAMILY = "lm"
SKIP_SHAPES = ("long_500k",)


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=6400,
        vocab=32064,
        moe_experts=16,
        moe_top_k=2,
        rope_theta=10000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=128,
        vocab=256,
        moe_experts=4,
        moe_top_k=2,
        remat=False,
    )
