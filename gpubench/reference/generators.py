"""Frozen graph generators of the benchmark's configurations (numpy only).

These are the yardstick's own copies: later changes to the program's
generators do not move the benchmark's inputs, and ``test_gpubench_reference``
pins each by a checksum of its edges at a fixed seed.

- ``kron``: the Graph500 Kronecker (R-MAT) generator that the GAP Benchmark
  Suite's *kron* graph uses: ``edge_factor * 2**scale`` directed draws, each
  endpoint pair chosen level by level with quadrant probabilities
  ``a, b, c`` and ``d = 1 - a - b - c``.
- ``urand``: GAP's *urand* graph: ``edge_factor * 2**scale`` draws, both
  endpoints uniform over the ``2**scale`` vertices.

Both then pass through ``relabel``: the Graph500 scramble of the vertex
labels, drawn like the structure from the configuration's fixed
``graph_seed``, and then the run's seed deals the scrambled labels' ``ranks``
equal blocks out to the ranks in a random order. So every seed gives the
same graph and the same work a rank does in each round (the same degrees,
widths, rounds and triangle counts) under other labels, pulled from other
ranks: the same set of sizes in another order. A full scramble drawn from
the run's seed changed the epoch's time by 2.4% from seed to seed, four
times the spread of two runs of one seed.
"""
from __future__ import annotations

import numpy as np

__all__ = ["kron_edges", "urand_edges", "relabel", "raw_edges", "rng_of"]


def rng_of(seed: int) -> np.random.Generator:
    """A numpy generator for any whole number (negative ones wrap)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def kron_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               seed: int) -> np.ndarray:
    """``[edge_factor * 2**scale, 2]`` int64 R-MAT draws (self loops and
    repeats included, as the generator makes them)."""
    rng = rng_of(seed)
    m = edge_factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        q = rng.random(m)
        src_bit = q >= ab
        dst_bit = ((q >= a) & (q < ab)) | (q >= abc)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return np.stack([src, dst], axis=1)


def urand_edges(scale: int, edge_factor: int, seed: int) -> np.ndarray:
    """``[edge_factor * 2**scale, 2]`` int64 uniform draws."""
    rng = rng_of(seed)
    n = 1 << scale
    return rng.integers(0, n, size=(edge_factor << scale, 2), dtype=np.int64)


def relabel(edges: np.ndarray, n: int, graph_seed: int, seed: int,
            blocks: int) -> np.ndarray:
    """The edges under the scramble of ``graph_seed``, then with the
    scrambled labels' ``blocks`` equal blocks dealt out in the order that
    ``seed`` draws."""
    if n % blocks:
        raise ValueError(f"{n} labels do not split into {blocks} equal blocks")
    size = n // blocks
    scramble = np.random.default_rng([int(graph_seed), 1]).permutation(n)
    order = rng_of(seed).permutation(blocks).astype(np.int64)
    label = order[scramble // size] * size + scramble % size
    return label[edges]


def raw_edges(cfg: dict, seed: int) -> np.ndarray:
    """The raw edge list of configuration ``cfg`` for the run's ``seed``."""
    kind, scale, ef = cfg["generator"], int(cfg["scale"]), int(cfg["edge_factor"])
    graph_seed = int(cfg["assumed"]["graph_seed"])
    if kind == "kron":
        e = kron_edges(scale, ef, cfg["a"], cfg["b"], cfg["c"], graph_seed)
    elif kind == "urand":
        e = urand_edges(scale, ef, graph_seed)
    else:
        raise ValueError(f"unknown generator {kind!r}")
    return relabel(e, 1 << scale, graph_seed, seed,
                   int(cfg["assumed"]["ranks"]))
