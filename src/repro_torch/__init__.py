"""repro_torch: asynchronous distributed-memory TC/LCC with RMA caching,
on PyTorch and CUDA (NVIDIA Hopper).

The port of the ``repro`` package, slice by slice; module and function
names follow the reference so a reader finds the counterpart. It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.

Layout so far (the paper's LCC pipeline, the streaming path, serving, GNN
training):
  core/      CSR, partitions, intersection, RMA pull schedule, CLaMPI
             cache simulator, the epoch engine, TriC baseline, the sharded
             runtime and repartitioning
  device/    the device rule (``resolve_device``) and the device-resident
             hot-row tier
  streaming/ exact incremental TC/LCC under batched edge updates
  graphs/    R-MAT and power-law generators (seeded numpy)
  kernels/   hand-written CUDA kernels (``csrc/``: B1 intersect_count, B2
             bitmap_popcount, B3 resident_intersect, B8 flash_attention,
             B9 segment_sum_sorted, B10 embedding_bag), their wrappers and
             plain torch versions, width bucketing
  configs/   the LM / GNN / recsys / paper-lcc configs, the ``--arch``
             registry (MACE raises: not ported yet) and the cell shapes
  models/    the dense LM transformer (prefill, decode; B8 on the long
             prompt path), DIN and embedding bags (B10), GIN / GAT / PNA
             (every aggregation through B9)
  data/      the seeded CTR stream
  train/     step factories (serving, GNN training), AdamW, checkpoints
  distributed/  the restartable training loop and straggler monitor
  tree.py    nested containers of tensors (map, leaves, paths)
  obs/       span tracer, metric registry, cachescope (host-only)
  launch/    ``lcc_run``, ``stream_run``, ``serve`` and ``train`` entry
             points

Device rule: every entry point that does device work takes ``device``
(default ``"cuda"``) and raises when that device is missing; nothing
switches to the CPU on its own. Pass ``device="cpu"`` to run the plain
torch versions of the kernels.
"""

__version__ = "0.1.0"
