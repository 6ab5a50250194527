"""Driver of the port's static LCC epoch: exact per-vertex triangle counts and
LCC of a graph split 1D over ``ranks`` logical ranks on one card, remote rows
pulled round by round by the compiled schedule, hot rows from the degree
cache (``repro_torch.core.async_engine.lcc_pipelined``).

Set-up: the raw edge list from the configuration's frozen generator and the
run's seed; the port's ``from_edges``, ``build_static_degree_cache``,
``build_sharded_problem`` (the span ``schedule_build``) and ``to_device``;
one warm-up epoch, which also builds or loads the kernels. A step is one
whole ``lcc_pipelined`` call, ``t`` and ``lcc`` back on the host.

Judging: the plain reference (``gpubench/reference``) counts the triangles of
the same raw edge list again, independently, and takes LCC in float64. Each
sampled step's ``t`` must equal it exactly (``t_wrong``: the vertices that
differ, summed over the sampled steps) and its ``lcc`` lie within
``lcc_rel_err`` of it (the largest relative gap; where the reference is 0 the
gap is taken against 1e-12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np

from gpubench.reference.generators import raw_edges
from gpubench.reference.triangles import (lcc_float64, lcc_lower_precision,
                                          triangles_per_vertex)

_TINY = 1e-12
_NOT_FINITE = 1e30  # what a NaN or infinite gap reads as


@dataclasses.dataclass
class State:
    cfg: Dict[str, Any]
    n: int
    edges: np.ndarray  # the raw edge list both sides were given
    host_prob: Any  # the compiled schedule (``ShardedLCCProblem``)
    dev_prob: Any  # its tensors on the device (``DeviceLCCProblem``)
    device: str
    method: str
    engine: Any  # ``lcc_pipelined``


def set_up(cfg, mix, seed: int, device: str, span) -> State:
    from repro_torch.core.async_engine import lcc_pipelined
    from repro_torch.core.cache import build_static_degree_cache
    from repro_torch.core.csr import from_edges
    from repro_torch.core.rma import build_sharded_problem

    a = cfg["assumed"]
    n = 1 << int(cfg["scale"])
    with span("inputs"):
        edges = raw_edges(cfg, seed)
    with span("csr_and_cache"):
        csr = from_edges(edges.copy(), n, undirected=True)
        cache = (build_static_degree_cache(csr.degrees, int(a["cache_rows"]))
                 if int(a["cache_rows"]) > 0 else None)
    with span("schedule_build"):
        host = build_sharded_problem(csr, int(a["ranks"]),
                                     n_rounds=int(a["rounds"]), cache=cache)
    with span("upload"):
        dev = host.to_device(device)
    state = State(cfg=cfg, n=n, edges=edges, host_prob=host, dev_prob=dev,
                  device=device, method=str(a["method"]), engine=lcc_pipelined)
    with span("warm_up"):
        step(state)
    return state


def inputs_only(cfg, seed: int, device: str) -> State:
    """A state with the raw edge list alone: what the reference and the
    control need, with no program behind it."""
    return State(cfg=cfg, n=1 << int(cfg["scale"]), edges=raw_edges(cfg, seed),
                 host_prob=None, dev_prob=None, device=device, method="",
                 engine=None)


def step(state: State) -> Tuple[np.ndarray, np.ndarray]:
    return state.engine(state.dev_prob, state.device, method=state.method)


def release(state: State) -> None:
    import torch

    state.dev_prob = None
    if state.device.startswith("cuda"):
        torch.cuda.synchronize(state.device)
        torch.cuda.empty_cache()


def reference(state: State, device: str):
    """(t int64 [n], degrees [n]) of the raw edge list, on ``device``."""
    return triangles_per_vertex(state.edges, state.n, device)


def _global(out: np.ndarray, state: State) -> np.ndarray:
    """``[p, n_loc]`` rank-major output -> ``[n]`` in vertex order (rank k
    holds the contiguous block ``[k * n_loc, (k + 1) * n_loc)``)."""
    p = int(state.cfg["assumed"]["ranks"])
    n_loc = -(-state.n // p)
    out = np.asarray(out)
    if out.shape != (p, n_loc):
        raise ValueError(f"output of shape {out.shape}, expected {(p, n_loc)}")
    return out.reshape(-1)[: state.n]


def compare(outputs: List[Tuple[np.ndarray, np.ndarray]], t_ref: np.ndarray,
            lcc_ref: np.ndarray, state: State, limits: Dict[str, float]):
    """(checks, n_failed) of ``outputs`` against the reference."""
    t_wrong, worst, failed = 0, 0.0, 0
    for t, lcc in outputs:
        try:
            t_g = _global(t, state).astype(np.int64)
            lcc_g = _global(lcc, state).astype(np.float64)
        except ValueError:
            wrong, gap = state.n, _NOT_FINITE
        else:
            wrong = int(np.count_nonzero(t_g != t_ref))
            rel = np.abs(lcc_g - lcc_ref) / np.maximum(lcc_ref, _TINY)
            rel = np.where(np.isfinite(rel), rel, _NOT_FINITE)
            gap = float(rel.max(initial=0.0))
        t_wrong += wrong
        worst = max(worst, gap)
        failed += int(wrong > limits["t_wrong"]
                      or gap > limits["lcc_rel_err"])
    checks = {"t_wrong": {"value": t_wrong, "limit": limits["t_wrong"]},
              "lcc_rel_err": {"value": worst,
                              "limit": limits["lcc_rel_err"]}}
    return checks, failed


def judge(state: State, outputs, device: str):
    t, deg = reference(state, device)
    lcc = lcc_float64(t, deg)
    return compare(outputs, t.cpu().numpy(), lcc.cpu().numpy(), state,
                   state.cfg["limits"])


def control_output(state: State, device: str):
    """The control: the reference in the program's place, its LCC computed in
    bfloat16 (the precision below the configurations' float32), laid out as
    the program lays out its output."""
    t, deg = reference(state, device)
    lcc = lcc_lower_precision(t, deg)
    p = int(state.cfg["assumed"]["ranks"])
    n_loc = -(-state.n // p)

    def lay_out(x, dtype):
        out = np.zeros(p * n_loc, dtype)
        out[: state.n] = x.cpu().numpy()
        return out.reshape(p, n_loc)

    return lay_out(t, np.int32), lay_out(lcc, np.float32)
