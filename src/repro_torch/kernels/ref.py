"""Plain torch versions of the kernels (the oracles the hand-written
kernels are held against). Each lives beside its kernel and is re-exported
here; a kernel that is not ported yet has no entry."""
from __future__ import annotations

from .intersect_count import intersect_count_ref

__all__ = ["intersect_count_ref"]
