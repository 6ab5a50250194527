"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b.

24L d_model=2048 32H (GQA kv=32 => MHA) d_ff=5632 vocab=100352.
Full attention -> long_500k is a documented skip.
"""
from ..models.transformer import TransformerConfig

ARCH_ID = "stablelm-1.6b"
FAMILY = "lm"
SKIP_SHAPES = ("long_500k",)


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=5632,
        vocab=100352,
        rope_theta=10000.0,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=160,
        vocab=512,
        remat=False,
    )
