"""repro_torch: asynchronous distributed-memory TC/LCC with RMA caching,
on PyTorch and CUDA (NVIDIA Hopper).

The port of the ``repro`` package, slice by slice; module and function
names follow the reference so a reader finds the counterpart. It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.

Layout so far (the paper's LCC pipeline):
  core/      CSR, partitions, intersection, RMA pull schedule, CLaMPI
             cache simulator, the epoch engine, TriC baseline
  graphs/    R-MAT and power-law generators (seeded numpy)
  kernels/   hand-written CUDA kernels (``csrc/``), their wrappers and
             plain torch versions, width bucketing
  obs/       span tracer, metric registry, cachescope (host-only)
  launch/    ``lcc_run`` entry point

Device rule: every entry point that does device work takes ``device``
(default ``"cuda"``) and raises when that device is missing; nothing
switches to the CPU on its own. Pass ``device="cpu"`` to run the plain
torch versions of the kernels.
"""

__version__ = "0.1.0"
