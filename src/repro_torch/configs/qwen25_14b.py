"""qwen2.5-14b [dense] — hf:Qwen/Qwen2.5-14B family.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.
Full attention -> long_500k is a documented skip.
"""
from ..models.transformer import TransformerConfig

ARCH_ID = "qwen2.5-14b"
FAMILY = "lm"
SKIP_SHAPES = ("long_500k",)


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=13824,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=192,
        vocab=512,
        qkv_bias=True,
        remat=False,
    )
