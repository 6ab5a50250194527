"""Online graph query serving over the 1D-partitioned live graph.

Turns the batch-epoch reproduction into a request-driven service:

- ``requests``  — ``Query``/``QueryResult`` types (lcc, triangles,
                  common_neighbors, top_k_lcc)
- ``provider``  — row read path: rank views over the shared
                  ``core.runtime.ShardedRuntime`` (``DirectRowProvider``
                  uncached, ``CacheBackedRowProvider`` degree-scored
                  ClampiCache carrying real payloads, runtime-fanout
                  coherence)
- ``engine``    — ``QueryEngine``: batched point-query execution with
                  batch-wide row-fetch + pair dedup over the CUDA
                  intersect kernels (B1, and B3 for rows resident in
                  the device tier); ``ShardedQueryEngine``: p engines
                  routing each query to its owner rank
- ``scheduler`` — ``MicrobatchScheduler``: request coalescing with FIFO
                  + deadline (``max_wait``) + priority (urgent) drains,
                  per-class SLO deadlines with EDF window selection,
                  tenant-quota admission, p50/p99 latency accounting
- ``closed_loop`` — uniform / Zipf(hub-skewed) / read-write generators
                  (closed-loop: next request waits for the previous
                  response; ``workload`` is its historical alias). The
                  open-loop arrival side lives in ``repro_torch.traffic``.
- ``service``   — ``LiveQueryService``: queries + streaming updates over
                  one shared store/runtime with a verified staleness
                  bound (single-rank or cross-rank), plus the traffic
                  plane hooks (SLO policy, tenant quotas, workload
                  scorer, injectable clock)
"""
from .requests import Query, QueryKind, QueryResult  # noqa: F401
from .provider import (  # noqa: F401
    CacheBackedRowProvider,
    DirectRowProvider,
    ProviderCoherenceHook,
    ProviderStats,
    RuntimeRowProvider,
)
from .engine import QueryEngine, ShardedQueryEngine  # noqa: F401
from .scheduler import MicrobatchScheduler  # noqa: F401
from .metrics import LatencyRecorder, LatencySummary  # noqa: F401
from .closed_loop import (  # noqa: F401
    ReadWriteEvent,
    make_queries,
    read_write_stream,
    sample_vertices,
)
from .service import LiveQueryService  # noqa: F401
