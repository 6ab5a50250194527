"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 gpubench/run.py --workload kron-s18.epoch --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a deployment (graph, ranks, rounds, cache, the
  guarantees and the limits of the comparison that decides ``correct``);
- ``mixes/<traffic>.json``: a traffic mix as data; its ``driver`` names the
  module in ``drivers/`` that sets the port up, steps it and judges it;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader
  each, ``read(run) -> float | None``;
- ``rooflines/<name>.py``: the least bytes of one kernel or step;
- ``peaks.json``: the card's published rates.

``reference/`` holds the frozen generators and the plain reference (PyTorch,
no code of the port). Nothing here imports ``jax`` or the JAX package.
"""
