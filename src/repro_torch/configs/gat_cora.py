"""gat-cora [gnn] — arXiv:1710.10903.

n_layers=2, d_hidden=8, n_heads=8, attention aggregator (Cora: 1433 input
features, 7 classes).
"""
from ..models.gnn.gat import GATConfig

ARCH_ID = "gat-cora"
FAMILY = "gnn"
SKIP_SHAPES = ()


def config() -> GATConfig:
    return GATConfig(name=ARCH_ID, n_layers=2, d_hidden=8, n_heads=8,
                     d_in=1433, n_classes=7)


def smoke_config() -> GATConfig:
    return GATConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=4,
                     n_heads=2, d_in=16, n_classes=3)
