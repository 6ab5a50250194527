"""paper-lcc — the paper's own workload as a selectable config.

Distributed LCC over an R-MAT/power-law graph with the async RMA-style
engine + degree-score cache. Not one of the 10 assigned architectures —
included so the launcher exposes the paper technique end to end
(`--arch paper-lcc`), and the dry-run can lower the shard_map engine on
the production mesh.
"""
import dataclasses

ARCH_ID = "paper-lcc"
FAMILY = "graph-analytics"
SKIP_SHAPES = ()


@dataclasses.dataclass(frozen=True)
class LCCRunConfig:
    name: str = ARCH_ID
    n_vertices: int = 1 << 20
    avg_degree: int = 16
    row_width: int = 512  # padded adjacency width on device
    n_rounds: int = 8
    cache_rows: int = 4096
    method: str = "hybrid"


def config() -> LCCRunConfig:
    return LCCRunConfig()


def smoke_config() -> LCCRunConfig:
    return LCCRunConfig(
        name=ARCH_ID + "-smoke", n_vertices=256, avg_degree=8,
        row_width=64, n_rounds=2, cache_rows=16,
    )
