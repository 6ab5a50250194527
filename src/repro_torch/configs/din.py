"""din [recsys] — arXiv:1706.06978.

embed_dim=18, seq_len=100, attention MLP 80-40, output MLP 200-80,
target-attention interaction. Tables: 1e8 items / 1e6 categories
(taxonomy §RecSys: 10^6-10^9 rows), rows sharded over 'model'.
"""
from ..models.recsys.din import DINConfig

ARCH_ID = "din"
FAMILY = "recsys"
SKIP_SHAPES = ()


def config() -> DINConfig:
    return DINConfig(
        name=ARCH_ID,
        n_items=100_000_000,
        n_cats=1_000_000,
        embed_dim=18,
        seq_len=100,
        attn_hidden=(80, 40),
        mlp_hidden=(200, 80),
    )


def smoke_config() -> DINConfig:
    return DINConfig(
        name=ARCH_ID + "-smoke",
        n_items=1000,
        n_cats=50,
        embed_dim=8,
        seq_len=12,
        attn_hidden=(16, 8),
        mlp_hidden=(24, 12),
    )
