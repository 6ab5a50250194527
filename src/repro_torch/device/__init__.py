"""Where device work runs, and the device-resident hot-row cache tier.

``resolve_device`` is the device rule of the port, in one place: every
entry point that does device work takes ``device`` (default ``"cuda"``)
and resolves it here, which raises when that device is missing.

The tier maps the paper's caching story (a CLaMPI cache of the hottest
remote adjacency rows, degree centrality as the application score,
§III-B2) one level further down — host memory vs device memory:

===================  ==============================  =====================
paper / host tier    concept                          device tier (here)
===================  ==============================  =====================
``ClampiCache``      bounded cache of hot rows        ``ResidencyManager``
CLaMPI score         degree centrality picks          same degree score
(§III-B2)            what is worth keeping            picks the hot set
eviction             weakest-score victim when full   strict score-driven
                                                      evict/admit on drift
RMA get on miss      remote fetch into the cache      host row merge + pack
                                                      + upload into a slot
invalidation         drop mutated rows so a hit is    in-place row patch
(streaming)          never stale                      (small deltas) or
                                                      evict; epoch-bumped
                                                      slots make a stale
                                                      hit impossible
hit                  payload served from the cache    kernels gather the
                                                      row from the resident
                                                      ``[slots, max_width]``
                                                      tensor — zero upload
===================  ==============================  =====================

``ShardedRuntime.fetch_rows`` consults the residency tier *before* the
host cache; ``invalidate`` fans out to both tiers. The compute path is
``kernels.resident_intersect`` (kernel B3): the streaming engine runs its
old∩old delta intersections against resident hub rows without
re-materializing or re-uploading them each batch.
"""
from .resolve import resolve_device  # noqa: F401
from .residency import ResidencyManager, ResidencyStats  # noqa: F401

__all__ = ["resolve_device", "ResidencyManager", "ResidencyStats"]
