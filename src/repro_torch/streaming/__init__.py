"""Streaming graph subsystem: exact incremental triangle counting + LCC
under batched edge insertions/deletions.

Layers (mirroring the static pipeline's architecture):

- ``updates``      — ``EdgeBatch`` op batches + normalization against a store
- ``store``        — ``DynamicCSR``: base CSR + delta buffers + compaction
- ``incremental``  — ``StreamingLCCEngine``: exact ΔT / ΔLCC per batch via
                     the batched delta-intersect kernels (B1, and B3 for
                     rows resident in the device tier)
- ``coherence``    — cache-coherence hooks: ``ClampiCache`` replay of the
                     delta access stream + ``StaticDegreeCache`` rescoring
"""
from .updates import INSERT, DELETE, EdgeBatch, normalize_batch  # noqa: F401
from .store import DynamicCSR  # noqa: F401
from .incremental import BatchResult, StreamingLCCEngine  # noqa: F401
from .coherence import CoherenceReport, StreamingCacheCoherence  # noqa: F401
