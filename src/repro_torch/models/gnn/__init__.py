"""GNNs of the port: GIN, GAT, PNA and MACE (with its SO(3) machinery,
``so3``). Every aggregation goes through ``common.segment_sum``, kernel
B9."""
from . import common, gat, gin, mace, pna, so3  # noqa: F401
