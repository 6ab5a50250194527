"""pna [gnn] — arXiv:2004.05718.

n_layers=4, d_hidden=75, aggregators mean-max-min-std,
scalers identity-amplification-attenuation.
"""
from ..models.gnn.pna import PNAConfig

ARCH_ID = "pna"
FAMILY = "gnn"
SKIP_SHAPES = ()


def config() -> PNAConfig:
    return PNAConfig(name=ARCH_ID, n_layers=4, d_hidden=75)


def smoke_config() -> PNAConfig:
    return PNAConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=12, d_in=8)
