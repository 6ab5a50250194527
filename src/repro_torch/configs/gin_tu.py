"""gin-tu [gnn] — arXiv:1810.00826.

n_layers=5, d_hidden=64, sum aggregator, learnable eps (GIN-eps).
"""
from ..models.gnn.gin import GINConfig

ARCH_ID = "gin-tu"
FAMILY = "gnn"
SKIP_SHAPES = ()


def config() -> GINConfig:
    return GINConfig(name=ARCH_ID, n_layers=5, d_hidden=64)


def smoke_config() -> GINConfig:
    return GINConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16, d_in=4)
