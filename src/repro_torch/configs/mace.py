"""mace [gnn] — arXiv:2206.07697.

n_layers=2, d_hidden=128 channels, l_max=2, correlation_order=3, n_rbf=8,
E(3)-equivariant ACE product basis. Needs 3D positions: every input set of
the GNN shapes carries ``positions`` and species ids for it
(``configs/inputs.py``).
"""
from ..models.gnn.mace import MACEConfig

ARCH_ID = "mace"
FAMILY = "gnn"
SKIP_SHAPES = ()


def config() -> MACEConfig:
    return MACEConfig(
        name=ARCH_ID, n_layers=2, channels=128, l_max=2, correlation=3,
        n_rbf=8, n_species=16,
    )


def smoke_config() -> MACEConfig:
    return MACEConfig(
        name=ARCH_ID + "-smoke", n_layers=2, channels=8, l_max=2,
        correlation=3, n_rbf=4, n_species=4,
    )
