"""Architecture registry: --arch <id> resolution for the port's launchers
and tests. The GNN architectures of the reference are known by id but not
ported yet: ``get_arch`` raises ``NotImplementedError`` for them."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from . import (
    din,
    gemma2_27b,
    moonshot_v1_16b_a3b,
    paper_lcc,
    phi35_moe_42b_a6_6b,
    qwen25_14b,
    stablelm_1_6b,
)
from .shapes import LM_SHAPES, RECSYS_SHAPES

__all__ = ["ArchEntry", "ARCHS", "NOT_PORTED", "get_arch", "shape_table"]

_MODULES = [
    moonshot_v1_16b_a3b,
    phi35_moe_42b_a6_6b,
    stablelm_1_6b,
    gemma2_27b,
    qwen25_14b,
    din,
    paper_lcc,
]

# ids of the reference's registry whose family is not ported yet
NOT_PORTED = {"mace": "gnn", "pna": "gnn", "gin-tu": "gnn", "gat-cora": "gnn"}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str
    config: Callable[[], Any]
    smoke_config: Callable[[], Any]
    skip_shapes: Tuple[str, ...]

    @property
    def shapes(self) -> Dict[str, Any]:
        return shape_table(self.family)


def shape_table(family: str):
    return {
        "lm": LM_SHAPES,
        "recsys": RECSYS_SHAPES,
        "graph-analytics": {},
    }[family]


ARCHS: Dict[str, ArchEntry] = {
    m.ARCH_ID: ArchEntry(
        arch_id=m.ARCH_ID,
        family=m.FAMILY,
        config=m.config,
        smoke_config=m.smoke_config,
        skip_shapes=tuple(m.SKIP_SHAPES),
    )
    for m in _MODULES
}


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(f"not ported yet: {NOT_PORTED[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(ARCHS) + sorted(NOT_PORTED)}")
    return ARCHS[arch_id]

