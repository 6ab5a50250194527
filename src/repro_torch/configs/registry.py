"""Architecture registry: --arch <id> resolution for the port's launchers
and tests; every id of the reference's registry."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from . import (
    din,
    gat_cora,
    gemma2_27b,
    gin_tu,
    mace,
    moonshot_v1_16b_a3b,
    paper_lcc,
    phi35_moe_42b_a6_6b,
    pna,
    qwen25_14b,
    stablelm_1_6b,
)
from .shapes import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES

__all__ = ["ArchEntry", "ARCHS", "get_arch", "list_archs", "shape_table",
           "cells"]

_MODULES = [
    moonshot_v1_16b_a3b,
    phi35_moe_42b_a6_6b,
    stablelm_1_6b,
    gemma2_27b,
    qwen25_14b,
    mace,
    pna,
    gin_tu,
    gat_cora,
    din,
    paper_lcc,
]


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
        "gnn": GNN_SHAPES,
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
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]



def list_archs(assigned_only: bool = False):
    """Every arch id, sorted; ``assigned_only`` leaves out ``paper-lcc``."""
    out = sorted(ARCHS)
    if assigned_only:
        out = [a for a in out if a != "paper-lcc"]
    return out


def cells(include_skipped: bool = False):
    """All (arch_id, shape_id) baseline cells (36 runnable + 4 skips), in
    the reference's order."""
    out = []
    for aid in list_archs(assigned_only=True):
        e = ARCHS[aid]
        for sid in e.shapes:
            if sid in e.skip_shapes and not include_skipped:
                continue
            out.append((aid, sid))
    return out
