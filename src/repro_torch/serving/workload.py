"""Alias of :mod:`repro_torch.serving.closed_loop` (its historical name).

The generators here are *closed-loop* (next request waits for the
previous response); the module was renamed to say so once the
open-loop traffic plane (``repro_torch.traffic``) landed. Existing imports
keep working through this re-export — no deprecation shims, both
names are first-class.
"""
from .closed_loop import (  # noqa: F401
    DEFAULT_MIX,
    ReadWriteEvent,
    make_queries,
    read_write_stream,
    sample_vertices,
)

__all__ = [
    "DEFAULT_MIX",
    "sample_vertices",
    "make_queries",
    "ReadWriteEvent",
    "read_write_stream",
]
