"""One-card census of every (arch, shape) cell, the counterpart of
``repro.launch.dryrun``.

The reference lowers and compiles each cell on the production TPU mesh
over ``ShapeDtypeStruct`` stand-ins and reads XLA's memory and cost
analyses. The port keeps what that is for — does the cell fit one device,
what does its step cost, what bounds it — on the one H100 it runs on:

- each cell's step is built as the port's launchers build it, from
  ``configs/inputs.py::input_specs`` / ``step_kind``, and traced on fake
  tensors by ``op_census.trace`` (no card, nothing allocated): peak
  memory, FLOPs, bytes;
- an LM is traced at two depths one layer period apart (1 and 2 layers;
  gemma2's period is 2, local and global) and extrapolated linearly to its
  published depth, the port's stand-in for the reference's loop trip
  counts;
- LM training uses the reference's dryrun microbatching (4 microbatches,
  ``dryrun.py:187``); microbatches run one after another, so a step's peak
  follows the microbatch size, not their number: the cut search traces 2
  microbatches of each candidate size;
- ``fits``: the peak (set-up and step) within ``HW.usable_bytes()`` (the
  card's bytes less the CUDA context and cuBLAS workspace); a cell that does
  not fit gets ``cut``, the largest value that fits along one axis per
  kind, found by bisection: LM serving batch, then sequence, then depth;
  LM training microbatch size, then depth; a GNN its edges; retrieval its
  candidates; other recsys cells their batch;
- ``roofline``: ``flops / HW.PEAK_FLOPS_BF16`` against ``bytes_min /
  HW.HBM_BW`` (``bytes_min``: the parameters read once, plus gradients,
  moments and parameters written once where the step trains, plus the
  batch, plus the KV cache where it prefills or decodes);
- ``chip_phase``: the ``chip_smoke.py`` phase that runs the cell on the
  card, and at what cut, or null.

``gat-cora`` x ``ogb_products`` / ``minibatch_lg`` also get the reference's
hub-split variant (``dryrun.py:257-282``: C = 65,536 hub rows carrying 35%
of the edges) as a second entry of the same file. ``--include-lcc`` adds
``paper-lcc`` at the reference's shape arithmetic (``_setup_lcc``) on the
single mesh's p = 256 ranks: its tensors' bytes and the
``CollectiveLedger``'s modeled all-to-all bytes.

Not ported: ``--mesh`` (the single / multi-pod TPU meshes) and ``--opt``
(the reference's sharding and flash choices for those meshes): one card has
no mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --include-lcc --table
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import importlib
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.inputs import cell_shapes, input_specs, step_kind
from ..configs.registry import cells, get_arch
from ..models import transformer as tfm
from ..train import train_loop as tl
from ..train.optimizer import adamw
from ..tree import tree_leaves
from .mesh import HW
from .op_census import tensor_bytes, trace

MESH = "h100x1"
OUT = os.path.join("results", "dryrun_torch")
LM_MICROBATCHES = 4  # the reference's dryrun (dryrun.py:187)
CARD_LM_TRAIN = (4, 2)  # chip_smoke.py's LM train cells: batch 4 in 2
HUB_C = 65_536  # the reference's hub split (dryrun.py:257-282)
HUB_HOT_SHARE = 0.35
SEQ_STEP = 1024  # the sequence and candidate cuts move in these steps
# an extrapolated LM whose peak comes within this share of the card's
# usable bytes is traced at full depth: the allocator's fragmentation,
# which decides an out-of-memory error there, does not extrapolate
NEAR = 0.85
GNN_MODULES = {"mace": "repro_torch.models.gnn.mace",
               "pna": "repro_torch.models.gnn.pna",
               "gin-tu": "repro_torch.models.gnn.gin",
               "gat-cora": "repro_torch.models.gnn.gat"}
# the chip_smoke.py phase that runs each cell on the card, and at what cut
CHIP_PHASES = {
    ("gemma2-27b", "prefill_32k"): ("serve_lm", "8,192 x 1 (+16 decode)"),
    ("moonshot-v1-16b-a3b", "prefill_32k"): ("serve_moe",
                                             "8,192 x 1 (+16 decode)"),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k"): (
        "serve_moe", "8,192 x 1 (+16 decode), 24 of 32 layers"),
    ("moonshot-v1-16b-a3b", "train_4k"): ("train_moe",
                                          "batch 4 in 2, 1 of 48 layers"),
    ("stablelm-1.6b", "train_4k"): ("train_lm", "batch 4 in 2"),
    ("gin-tu", "ogb_products"): ("train_gnn", "not cut"),
    ("gat-cora", "full_graph_sm"): ("train_gnn", "not cut"),
    ("gat-cora", "ogb_products"): ("train_gnn",
                                   "a tenth of the edges, hub split"),
    ("mace", "molecule"): ("train_gnn", "not cut"),
    ("din", "serve_p99"): ("serve_din", "not cut"),
    ("din", "train_batch"): ("train_din", "not cut"),
    ("din", "retrieval_cand"): ("train_din", "262,144 candidates"),
}
I32 = torch.int32


def _zeros(spec):
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype)


def _generator() -> torch.Generator:
    """A generator on the default device (the CPU's fake tensors in a
    census; the card's under ``with torch.device("cuda")``)."""
    return torch.Generator(torch.get_default_device())


def _bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# per-cell setup: (build, step, meta); build() makes the step's arguments
# (params, optimizer state, batch, cache) on whatever tensors the caller's
# mode makes, step(*args) runs the step
# --------------------------------------------------------------------------
def _lm_setup(cfg, kind: str, batch: int, seq: int, micro: int):
    if kind == "lm_train":
        optim = adamw(lr=3e-4)
        step = tl.make_lm_train_step(cfg, optim,
                                     n_microbatches=max(batch // micro, 1))

        def build():
            params = tfm.init_params(cfg, _generator())
            toks = torch.zeros((batch, seq), dtype=I32)
            return params, optim.init(params), {"tokens": toks,
                                                "labels": toks.clone()}
        return build, step

    if kind == "lm_prefill":
        prefill = tl.make_lm_prefill_step(cfg, max_len=seq)

        def build():
            return (tfm.init_params(cfg, _generator()),
                    torch.zeros((batch, seq), dtype=I32))

        def step(params, tokens):
            with torch.inference_mode():
                return prefill(params, tokens)
        return build, step

    decode = tl.make_lm_decode_step(cfg)

    def build():
        return (tfm.init_params(cfg, _generator()),
                torch.zeros((batch,), dtype=I32),
                tfm.init_kv_cache(cfg, batch, seq,
                                    torch.get_default_device()))

    def step(params, token, cache):
        with torch.inference_mode():
            return decode(params, token, seq - 1, cache)
    return build, step


def hub_split_specs(specs: Dict[str, tuple], capacity: int = HUB_C,
                    hot_share: float = HUB_HOT_SHARE):
    """A GNN batch's specs split as the reference's dryrun splits them:
    ``capacity`` hub rows, ``hot_share`` of the edges hot."""
    e = specs["edge_src"][0][0]
    e_hot = int(e * hot_share)
    e_cold = e - e_hot
    out = {k: v for k, v in specs.items()
           if k not in ("edge_src", "edge_dst", "edge_mask")}
    out.update(edge_src_cold=((e_cold,), I32),
               edge_src_hub_pos=((e_hot,), I32),
               hub_ids=((capacity,), I32),
               edge_dst_cold=((e_cold,), I32), edge_dst_hot=((e_hot,), I32),
               edge_mask_cold=((e_cold,), torch.bool),
               edge_mask_hot=((e_hot,), torch.bool))
    return out


def _gnn_setup(arch_id: str, cfg, specs):
    mod = importlib.import_module(GNN_MODULES[arch_id])
    optim = adamw(lr=1e-3, weight_decay=0.0)
    step = tl.make_gnn_train_step(mod.apply, cfg, optim)
    if arch_id == "mace":
        from ..models.gnn import so3

        for l1, l2, l3 in mod._couplings(cfg.l_max):  # numpy, host-cached
            so3.cg_real(l1, l2, l3)
        train_step = step

        def step(*args):
            # MACE caches its coupling tensors by device: drop the fake
            # ones this trace made, so no later real call is handed one
            try:
                return train_step(*args)
            finally:
                mod._cg.cache_clear()

    def build():
        params = mod.init_params(cfg, _generator())
        return (params, optim.init(params),
                {k: _zeros(v) for k, v in specs.items()})
    return build, step


def _recsys_setup(cfg, kind: str, specs):
    from ..models.recsys import din

    def build_params():
        return din.init_params(cfg, _generator())

    if kind == "recsys_train":
        optim = adamw(lr=1e-3, weight_decay=0.0)
        step = tl.make_recsys_train_step(din.apply, cfg, optim)

        def build():
            params = build_params()
            return (params, optim.init(params),
                    {k: _zeros(v) for k, v in specs.items()})
        return build, step
    if kind == "recsys_serve":
        step = tl.make_recsys_serve_step(din.apply, cfg)
    else:
        step = tl.make_retrieval_step(din.retrieval_score, cfg, top_k=100)

    def build():
        return build_params(), {k: _zeros(v) for k, v in specs.items()}

    def run(params, batch):
        with torch.inference_mode():
            return step(params, batch)
    return build, run


def _with_edges(specs, edges: int):
    """The specs with every per-edge array cut to ``edges``."""
    out = dict(specs)
    for k, (shape, dt) in specs.items():
        if k.startswith("edge_"):
            out[k] = ((edges,) + tuple(shape[1:]), dt)
    return out


def setup_cell(arch_id: str, shape_id: str, *, layers: Optional[int] = None,
               batch: Optional[int] = None, seq: Optional[int] = None,
               micro: Optional[int] = None, edges: Optional[int] = None,
               candidates: Optional[int] = None, hub: bool = False):
    """(build, step, meta) of one cell, at its published size or at the
    cut given: ``layers`` (LM depth), ``batch``, ``seq`` (LM sequence or
    decode context), ``micro`` (LM train microbatch size), ``edges`` (GNN
    edges), ``candidates`` (retrieval), ``hub`` (the hub-split GNN
    batch)."""
    arch = get_arch(arch_id)
    cfg, shape, _ = input_specs(arch_id, shape_id)
    kind = step_kind(arch, shape)
    meta = {"arch": arch_id, "shape": shape_id, "kind": kind}
    if arch.family == "lm":
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        b = batch or shape.global_batch
        s = seq or shape.seq_len
        m = micro or max(b // LM_MICROBATCHES, 1)
        meta.update(layers=cfg.n_layers, batch=b, seq=s,
                    params=int(cfg.param_count()),
                    active_params=int(cfg.active_param_count()))
        if kind == "lm_train":
            meta.update(microbatch=m, n_microbatches=max(b // m, 1),
                        tokens_per_step=b * s)
        build, step = _lm_setup(cfg, kind, b, s, m)
        return build, step, meta
    specs = cell_shapes(arch, arch.config(), shape)
    if arch.family == "gnn":
        if edges is not None:
            specs = _with_edges(specs, edges)
        if hub:
            specs = hub_split_specs(specs)
            meta["hub_split"] = {"C": HUB_C, "hot_share": HUB_HOT_SHARE}
        meta["edges"] = sum(v[0][0] for k, v in specs.items()
                            if k.startswith("edge_dst"))
        build, step = _gnn_setup(arch_id, cfg, specs)
        return build, step, meta
    if candidates is not None:
        specs = dict(specs, cand_items=((candidates,), I32),
                     cand_cats=((candidates,), I32))
        meta["candidates"] = candidates
    elif kind == "retrieval":
        meta["candidates"] = specs["cand_items"][0][0]
    if batch is not None:
        specs = {k: ((batch,) + tuple(s[1:]), dt)
                 for k, (s, dt) in specs.items()}
    if kind != "retrieval":
        meta["batch"] = next(iter(specs.values()))[0][0]
    build, step = _recsys_setup(cfg, kind, specs)
    return build, step, meta


# --------------------------------------------------------------------------
# one trace, and the LM's depth extrapolation
# --------------------------------------------------------------------------
def _arg_bytes(kind: str, args) -> Dict[str, int]:
    """Bytes of the step's parameters, optimizer state, batch and cache."""
    out = {"param_bytes": _bytes(args[0]), "opt_bytes": 0, "batch_bytes": 0,
           "cache_bytes": 0}
    if kind.endswith("_train"):
        out["opt_bytes"] = _bytes(args[1])
        out["batch_bytes"] = _bytes(args[2])
    elif kind == "lm_decode":
        out["batch_bytes"] = _bytes(args[1])
        out["cache_bytes"] = _bytes(args[2])
    else:
        out["batch_bytes"] = _bytes(args[1])
    return out


def cell_bytes(arch_id: str, shape_id: str, **cut) -> Dict[str, int]:
    """The bytes of a cell's parameters, optimizer state, batch and KV
    cache, from its set-up alone (fake tensors, no step run)."""
    build, _, meta = setup_cell(arch_id, shape_id, **cut)
    return trace(build, lambda *args: None, keep=lambda args, out:
                 _arg_bytes(meta["kind"], args)).result


def _measure(build, step, meta) -> Dict[str, Any]:
    """One trace: the numbers ``run_cell`` reports."""
    kind = meta["kind"]

    def keep(args, out):
        got = _arg_bytes(kind, args)
        if kind == "lm_prefill":  # the cache it fills
            got["cache_bytes"] = _bytes(out[1])
        return got

    c = trace(build, step, keep=keep, capacity=HW.usable_bytes())
    return {"meta": meta, **c.result,
            "argument_bytes": c.argument_bytes,
            "output_bytes": c.output_bytes,
            "step_peak_bytes": c.step_peak_bytes,
            "peak_bytes": c.peak_bytes, "temp_bytes": c.temp_bytes,
            "flops": c.flops, "dot_flops": c.dot_flops,
            "dot_flops_by_op": c.dot_flops_by_op,
            "bytes_accessed": c.bytes_accessed, "ops": c.ops,
            "kernels": c.kernels, "segment_peaks": c.segment_peaks,
            "reserved_peak_bytes": c.reserved_peak_bytes, "oom": c.oom}


def measure(arch_id: str, shape_id: str, **cut) -> Dict[str, Any]:
    """One trace of the cell at ``cut`` (``setup_cell``'s keywords); the
    cut searches ask for some more than once."""
    return copy.deepcopy(_measure_cached(arch_id, shape_id,
                                         tuple(sorted(cut.items()))))


@functools.lru_cache(maxsize=256)
def _measure_cached(arch_id, shape_id, cut):
    return _measure(*setup_cell(arch_id, shape_id, **dict(cut)))


def _lerp(a, b, t):
    """``a + t (b - a)`` over matching nested dicts of numbers; other
    leaves are ``b``'s."""
    if isinstance(a, dict):  # a key of b's alone keeps b's value
        return {k: _lerp(a.get(k, v), v, t) for k, v in b.items()}
    if isinstance(b, bool) or not isinstance(b, (int, float)):
        return b
    v = a + t * (b - a)
    return int(round(v)) if isinstance(b, int) else v


def lm_period(arch_id: str) -> int:
    return len(get_arch(arch_id).config().pattern)


def at_depth(at: Callable[[int], Dict[str, Any]], period: int,
             layers: int) -> Dict[str, Any]:
    """``at(layers)`` from traces at two and three layer periods (one
    period apart), extrapolated linearly (the traffic, quadratic, through
    one, two and three periods); traced directly up to three periods and
    where the extrapolated peak is ``NEAR`` the card's limit.
    Costs are linear in depth. The peak is taken segment by segment (the
    set-up, forward, backward, work without grad: each keeps one place of
    its peak beyond the first period or two, where the head or a draw of
    the set-up may still hold it) and is the largest of them."""
    if layers > 3 * period:
        one, lo, hi = at(period), at(2 * period), at(3 * period)
        out = _lerp(lo, hi, (layers - 2 * period) / period)
        # a train step's traffic is quadratic in depth: each block's slice
        # of a stacked leaf gets a gradient of the whole stack
        # (SelectBackward0), and the blocks' gradients are summed
        x = layers / period
        y1, y2, y3 = (r["bytes_accessed"] for r in (one, lo, hi))
        c = (y3 - 2 * y2 + y1) / 2
        out["bytes_accessed"] = y1 + (y2 - y1 - 3 * c) * (x - 1) \
            + c * (x * x - 1)
        seg = out["segment_peaks"]
        out["peak_bytes"] = max(seg.values())
        if not NEAR * HW.usable_bytes() <= out["peak_bytes"] \
                <= HW.usable_bytes():
            out["step_peak_bytes"] = max(v for k, v in seg.items()
                                         if k != "build")
            out["temp_bytes"] = max(out["step_peak_bytes"]
                                    - out["argument_bytes"]
                                    - out["output_bytes"], 0)
            # the allocator's history does not extrapolate
            out.update(reserved_peak_bytes=None, oom=None)
            out["meta"] = dict(hi["meta"], layers=layers)
            out["depth"] = {"traced": [period, 2 * period, 3 * period],
                            "layers": layers}
            return out
    out = at(layers)  # shallow, or near the card's limit: in full
    out["depth"] = {"traced": [layers], "layers": layers}
    return out


def measure_depth(arch_id: str, shape_id: str, layers: Optional[int] = None,
                  **cut) -> Dict[str, Any]:
    """An LM cell at ``layers`` (its published depth by default), by
    ``at_depth``."""
    return at_depth(lambda n: measure(arch_id, shape_id, layers=n, **cut),
                    lm_period(arch_id),
                    layers or get_arch(arch_id).config().n_layers)


# --------------------------------------------------------------------------
# the configurations chip_smoke.py's phases run, holding what they hold
# --------------------------------------------------------------------------
# name -> (phase, arch, what runs, size; phase None: the card has not run
# it). A serve run draws the weights, then prefills a prompt and decodes
# (as launch/serve.py); a train run draws the weights and moments, then
# takes two steps while the caller still holds the first step's arguments
# (as chip_smoke.py's timed_steps over TrainRunner); a GNN run also holds
# its unsorted batch (train_cell), a hub run the other edge set
# (hub_split_cells). A serve run's peak spans the whole run, a train run's
# its steps; the card's figure is the phase's peak less the memory it held
# before the run (its base).
CHIP_RUNS = {
    "gemma2-27b serve 8192 x 1": ("serve_lm", "gemma2-27b", "serve",
                                  dict(prompt=8192, tokens=16)),
    "moonshot-v1-16b-a3b serve 8192 x 1": (
        "serve_moe", "moonshot-v1-16b-a3b", "serve",
        dict(prompt=8192, tokens=16)),
    "phi3.5-moe-42b-a6.6b serve 8192 x 1, 24 layers": (
        "serve_moe", "phi3.5-moe-42b-a6.6b", "serve",
        dict(prompt=8192, tokens=16, layers=24)),
    "phi3.5-moe-42b-a6.6b serve 8192 x 1, 32 layers": (
        None, "phi3.5-moe-42b-a6.6b", "serve",
        dict(prompt=8192, tokens=16, layers=32)),
    "gin-tu x ogb_products": ("train_gnn", "gin-tu", "gnn",
                              dict(shape="ogb_products")),
    "gat-cora x full_graph_sm": ("train_gnn", "gat-cora", "gnn",
                                 dict(shape="full_graph_sm")),
    "mace x molecule": ("train_gnn", "mace", "gnn", dict(shape="molecule")),
    "gat-cora x ogb_products, hub split, a tenth of the edges": (
        "train_gnn", "gat-cora", "gnn",
        dict(shape="ogb_products", edge_cut=10, hub=True)),
    "gat-cora x ogb_products, unsplit, a tenth of the edges": (
        "train_gnn", "gat-cora", "gnn",
        dict(shape="ogb_products", edge_cut=10, hub=False)),
    "stablelm-1.6b x train_4k, batch 4 in 2": (
        "train_lm", "stablelm-1.6b", "train_lm", dict(batch=4, micro=2)),
    "moonshot-v1-16b-a3b x train_4k, batch 4 in 2, 1 layer": (
        "train_moe", "moonshot-v1-16b-a3b", "train_lm",
        dict(batch=4, micro=2, layers=1)),
    "moonshot-v1-16b-a3b x train_4k, batch 4 in 2, 2 layers": (
        "census", "moonshot-v1-16b-a3b", "train_lm",
        dict(batch=4, micro=2, layers=2)),
    "din x train_batch": ("train_din", "din", "train_din", {}),
}


def _twice(step):
    """Two train steps, the first step's arguments held by this frame
    during the second (as ``timed_steps`` holds them)."""
    def run(params, state, batch):
        p1, s1, _ = step(params, state, batch)
        return step(p1, s1, batch)
    return run


def chip_setup(name: str, layers: Optional[int] = None):
    """(build, step, meta) of the ``CHIP_RUNS`` entry ``name`` (an LM at
    ``layers`` when given, for the depth extrapolation)."""
    from ..models.gnn.common import sort_edges_by_dst

    phase, arch_id, how, kw = CHIP_RUNS[name]
    cfg = get_arch(arch_id).config()
    meta = {"run": name, "phase": phase, "arch": arch_id}
    if how == "serve":
        cfg = dataclasses.replace(cfg, n_layers=layers or kw.get(
            "layers", cfg.n_layers))
        prompt, tokens = kw["prompt"], kw["tokens"]
        prefill = tl.make_lm_prefill_step(cfg, max_len=prompt + tokens)
        decode = tl.make_lm_decode_step(cfg)

        def build():
            return (tfm.init_params(cfg, _generator()),
                    torch.zeros((1, prompt), dtype=I32))

        def step(params, prompts):  # decode's memory is steady: 2 tokens
            with torch.inference_mode():
                first, cache = prefill(params, prompts)
                logits = first
                for t in range(2):
                    tok = torch.argmax(logits, -1).to(I32)
                    logits, cache = decode(params, tok, prompt + t, cache)
            return first, logits, cache
        meta.update(kind="lm_prefill", layers=cfg.n_layers, window="run")
        return build, step, meta
    if how == "train_lm":
        cfg = dataclasses.replace(cfg, n_layers=layers or kw.get(
            "layers", cfg.n_layers))
        build, step = _lm_setup(cfg, "lm_train", kw["batch"], 4096,
                                kw["micro"])
        meta.update(kind="lm_train", layers=cfg.n_layers, window="step")
        return build, _twice(step), meta
    meta.update(kind="train", window="step")
    if how == "train_din":
        build, step, _ = setup_cell("din", "train_batch")
        return build, _twice(step), meta
    shape = kw["shape"]
    arch = get_arch(arch_id)
    specs = cell_shapes(arch, arch.config(), arch.shapes[shape])
    cut = kw.get("edge_cut")
    if cut:
        specs = _with_edges(specs, specs["edge_src"][0][0] // cut)
    split = hub_split_specs(specs)
    mine = split if kw.get("hub") else specs
    other = (specs if kw.get("hub") else split) if cut else {}
    build_gnn, step = _gnn_setup(arch_id, input_specs(arch_id, shape)[0],
                                 mine)

    def build():
        params, state, raw = build_gnn()
        held = {k: _zeros(v) for k, v in other.items()
                if k.startswith("edge_") or k == "hub_ids"}
        return params, state, sort_edges_by_dst(raw), raw, held

    def run(params, state, batch, raw, held):
        return _twice(step)(params, state, batch)
    return build, run, meta


def chip_run(name: str) -> Dict[str, Any]:
    """The census of one ``CHIP_RUNS`` configuration; its ``peak`` is the
    figure to hold against the phase's ``max_memory_allocated`` less its
    base."""
    _, arch_id, how, kw = CHIP_RUNS[name]
    if how in ("serve", "train_lm"):
        full = kw.get("layers") or get_arch(arch_id).config().n_layers
        rec = at_depth(lambda n: _measure(*chip_setup(name, n)),
                       lm_period(arch_id), full)
    else:
        rec = _measure(*chip_setup(name))
    window = rec["meta"]["window"]
    rec["peak"] = rec["peak_bytes" if window == "run" else "step_peak_bytes"]
    rec["fits"] = fits(rec)
    return rec


def audit(name: str) -> Dict[str, Any]:
    """The ``CHIP_RUNS`` configuration ``name`` run on the card (real
    tensors, its kernels launched) under ``op_census.CardAudit``: the card's
    peak and reserved bytes beside the census's live bytes and allocator
    model, and each op's scratch memory beyond its inputs and outputs."""
    from .op_census import CardAudit

    free, _ = torch.cuda.mem_get_info()
    census = CardAudit(free + torch.cuda.memory_reserved())
    build, step, meta = chip_setup(name)
    with torch.device("cuda"), census:
        args = build()
        census.start()
        out = step(*args)
        census.stop(out)
    torch.cuda.synchronize()
    del args, out
    return {"run": name, "card_peak_bytes": census.card_peak,
            "census_peak_bytes": census.peak,
            "card_reserved_peak_bytes": census.card_reserved_peak,
            "model_reserved_peak_bytes": census.allocator.peak_reserved,
            "model_oom": census.allocator.oom,
            "largest_gap_bytes": census.max_gap,
            "scratch": dict(sorted(census.scratch.items(),
                                   key=lambda kv: -kv[1]["max_bytes"]))}


# --------------------------------------------------------------------------
# verdicts
# --------------------------------------------------------------------------
def fits(rec) -> bool:
    """The run's allocations replayed through the allocator model ran out
    of no memory, and its peak is within the card's usable bytes."""
    return rec.get("oom") is None and rec["peak_bytes"] <= HW.usable_bytes()


def _largest(lo: int, hi: int, ok: Callable[[int], bool]) -> Optional[int]:
    """Largest v in [lo, hi] with ok(v), by bisection (ok monotone), or
    None when ok(lo) fails."""
    if not ok(lo):
        return None
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _depth_cut(arch_id, shape_id, **cut):
    """The deepest multiple of the layer period that fits at ``cut``, by
    bisection (None if one period does not)."""
    p = lm_period(arch_id)
    full = get_arch(arch_id).config().n_layers
    k = _largest(1, full // p - 1, lambda v: fits(
        measure_depth(arch_id, shape_id, v * p, **cut)))
    return None if k is None else k * p


def find_cut(arch_id: str, shape_id: str, meta) -> Optional[dict]:
    """The largest value along the cell's axis that fits (see the module
    docstring), as {"axis", "value", "published", ...}."""
    kind = meta["kind"]
    if kind == "lm_train":
        # 2 microbatches of each size m: the peak of any number of them
        sizes = [m for m in (64, 32, 16, 8, 4, 2, 1) if m <= meta["microbatch"]]
        runs = {m: measure_depth(arch_id, shape_id, batch=2 * m, micro=m)
                for m in sizes}
        peaks = {m: r["peak_bytes"] for m, r in runs.items()}
        fitting = [m for m in sizes if fits(runs[m])]
        if fitting:
            return {"axis": "microbatch", "value": fitting[0],
                    "published": meta["microbatch"],
                    "n_microbatches": meta["batch"] // fitting[0],
                    "peak_bytes_by_microbatch": peaks}
        n = _depth_cut(arch_id, shape_id, batch=2, micro=1)
        return {"axis": "layers", "value": n, "published": meta["layers"],
                "at": "microbatch 1", "peak_bytes_by_microbatch": peaks}
    if kind in ("lm_prefill", "lm_decode"):
        b = _largest(1, meta["batch"] - 1, lambda v: fits(
            measure_depth(arch_id, shape_id, batch=v)))
        if b is not None:
            return {"axis": "batch", "value": b, "published": meta["batch"]}
        cfg = get_arch(arch_id).config()
        s_full = meta["seq"]
        # attention takes another path at the flash cutoff: search above
        # it first, then below (each side's memory grows with the length)
        ranges = [(cfg.flash_cutoff, s_full - 1), (1, cfg.flash_cutoff - 1)]
        if kind == "lm_decode":
            ranges = [(1, s_full - 1)]
        for lo, hi in ranges:
            if lo > hi:
                continue
            k = _largest(-(-lo // SEQ_STEP), hi // SEQ_STEP, lambda v: fits(
                measure_depth(arch_id, shape_id, batch=1, seq=v * SEQ_STEP)))
            if k is not None:
                return {"axis": "seq", "value": k * SEQ_STEP,
                        "published": s_full, "at": "batch 1"}
        n = _depth_cut(arch_id, shape_id, batch=1, seq=SEQ_STEP)
        return {"axis": "layers", "value": n, "published": meta["layers"],
                "at": f"batch 1, {SEQ_STEP} tokens"}
    if kind == "gnn_train":
        e = meta["edges"]
        step = max(e // 1000, 1)
        k = _largest(1, e // step, lambda v: fits(
            measure(arch_id, meta["shape"], edges=v * step,
                    hub=bool(meta.get("hub_split")))))
        value = None if k is None else k * step
        return {"axis": "edges", "value": value, "published": e,
                "fraction": None if k is None else value / e}
    if kind == "retrieval":
        n = meta["candidates"]
        k = _largest(1, n // SEQ_STEP, lambda v: fits(
            measure(arch_id, meta["shape"], candidates=v * SEQ_STEP)))
        return {"axis": "candidates",
                "value": None if k is None else k * SEQ_STEP, "published": n}
    b = _largest(1, meta["batch"] - 1, lambda v: fits(
        measure(arch_id, meta["shape"], batch=v)))
    return {"axis": "batch", "value": b, "published": meta["batch"]}


def bytes_min(kind: str, rec) -> float:
    """The floor of a step's HBM traffic: the parameters read once, plus
    gradients, optimizer moments and parameters written once where it
    trains, plus the batch, plus the KV cache where it prefills (written)
    or decodes (read)."""
    p, b = rec["param_bytes"], rec["batch_bytes"]
    if kind.endswith("_train"):
        return float(2 * p + rec["opt_bytes"] + p + b)
    return float(p + b + rec["cache_bytes"])


def roofline(flops: float, nbytes: float) -> Dict[str, Any]:
    compute_s = flops / HW.PEAK_FLOPS_BF16
    memory_s = nbytes / HW.HBM_BW
    return {"compute_s": compute_s, "memory_s": memory_s,
            "bound_s": max(compute_s, memory_s),
            "bound_by": "compute" if compute_s >= memory_s else "memory"}


def _entry(rec) -> Dict[str, Any]:
    """The reference's fields of one traced configuration."""
    kind = rec["meta"]["kind"]
    bmin = bytes_min(kind, rec)
    return {
        "memory": {k: rec[k] for k in ("argument_bytes", "output_bytes",
                                        "temp_bytes", "step_peak_bytes",
                                        "peak_bytes")},
        "bytes": {k: rec[k] for k in ("param_bytes", "opt_bytes",
                                       "batch_bytes", "cache_bytes")},
        "cost": {"flops": rec["flops"], "dot_flops": rec["dot_flops"],
                 "dot_flops_by_op": rec["dot_flops_by_op"],
                 "bytes_accessed": rec["bytes_accessed"], "bytes_min": bmin},
        "kernels": rec["kernels"], "ops": rec["ops"],
        "fits": fits(rec),
        "roofline": roofline(rec["flops"], bmin)}


# --------------------------------------------------------------------------
# paper-lcc: the reference's shape arithmetic on the single mesh's p ranks
# --------------------------------------------------------------------------
def lcc_shapes(cfg, p: int) -> Dict[str, Any]:
    """The reference's ``_setup_lcc`` shapes (``dryrun.py:355``) as the
    port holds them: name -> (shape, bytes an element), and the per-rank
    sizes. The local rows are the port's ragged store (``avg_degree`` ids a
    row and an int64 offset a row, the phantom rows' included), not the
    reference's ``[p, n_loc + 1, W]`` padded rows."""
    n = cfg.n_vertices
    n_loc = -(-n // p)
    w = cfg.row_width
    e_max = -(-(n_loc * cfg.avg_degree) // cfg.n_rounds) * cfg.n_rounds
    s_max = max(e_max // cfg.n_rounds // max(p - 1, 1), 8)
    return {"n_loc": n_loc, "e_max": e_max, "s_max": s_max, "tensors": {
        "row_ids": ((p * n_loc * cfg.avg_degree,), 4),
        "row_off": ((p * (n_loc + 1) + 1,), 8), "degrees": ((p, n_loc), 4),
        "edge_u": ((p, e_max), 4), "edge_vc": ((p, e_max), 4),
        "edge_mask": ((p, e_max), 1),
        "serve_idx": ((p, cfg.n_rounds, p, s_max), 4),
        "cache_rows": ((cfg.cache_rows, w), 4)}}


def lcc_census(p: int = 256) -> Dict[str, Any]:
    """paper-lcc on p = 256 logical ranks (the reference's single mesh):
    the device bytes of the problem's tensors, and the modeled all-to-all
    of the ``CollectiveLedger`` (``spmd_runtime``'s charge of a collective:
    ``p (p - 1) s w`` ids, the self chunk excluded) for one collective of
    ``s_max`` rows of width W a round, unchanged."""
    from ..distributed.spmd_runtime import CollectiveLedger

    cfg = get_arch("paper-lcc").config()
    sh = lcc_shapes(cfg, p)
    tensors = {k: math.prod(s) * nb for k, (s, nb) in sh["tensors"].items()}
    wire = p * (p - 1) * sh["s_max"] * cfg.row_width * 4
    ledger = CollectiveLedger.zero(p)
    ledger.rows_shipped += cfg.n_rounds * sh["s_max"] * (
        1 - np.eye(p, dtype=np.int64))
    ledger.n_collectives = cfg.n_rounds
    ledger.bytes_on_wire = ledger.bytes_on_wire_single = cfg.n_rounds * wire
    ledger.bytes_payload = int(ledger.rows_shipped.sum()) * cfg.row_width * 4
    total = sum(tensors.values())
    bmin = float(total + ledger.bytes_on_wire)
    return {"arch": "paper-lcc", "shape": "default", "kind": "lcc",
            "mesh": MESH, "ok": True, "p": p,
            "config": dataclasses.asdict(cfg),
            "n_loc": sh["n_loc"], "e_max": sh["e_max"], "s_max": sh["s_max"],
            "tensor_bytes": tensors,
            "memory": {"argument_bytes": total, "peak_bytes": total},
            "collectives": ledger.to_dict(),
            "cost": {"flops": 0.0, "dot_flops": 0.0, "bytes_min": bmin,
                     "note": "the epoch's int32 compares depend on the "
                             "graph; no FLOP is counted"},
            "fits": total <= HW.usable_bytes(), "cut": None,
            "roofline": roofline(0.0, bmin), "counted": "analytic",
            "chip_phase": None,
            "chip_phase_note": "phases entry and full run the engine at "
                               "R-MAT S12 / S16 on p = 8, not this shape",
            "note": "paper LCC engine; p = 256 logical ranks on one card"}


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------
def run_cell(arch_id: str, shape_id: str) -> Dict[str, Any]:
    t0 = time.time()
    if arch_id == "paper-lcc":
        out = lcc_census()
        out["total_s"] = round(time.time() - t0, 2)
        return out
    out = {"arch": arch_id, "shape": shape_id, "mesh": MESH, "ok": False}
    try:
        family = get_arch(arch_id).family
        rec = (measure_depth(arch_id, shape_id) if family == "lm"
               else measure(arch_id, shape_id))
        meta = rec["meta"]
        out.update(meta)
        if "params" not in out:
            out["params"] = rec["param_bytes"] // 4  # fp32 GNN / DIN leaves
            out["active_params"] = out["params"]
        out.update(_entry(rec), counted="traced", depth=rec.get("depth"))
        out["cut"] = None if out["fits"] else find_cut(arch_id, shape_id,
                                                       meta)
        phase = CHIP_PHASES.get((arch_id, shape_id))
        out["chip_phase"] = phase[0] if phase else None
        out["chip_phase_cut"] = phase[1] if phase else None
        variants = {}
        if meta["kind"] == "gnn_train" and arch_id == "gat-cora" and \
                shape_id in ("ogb_products", "minibatch_lg"):
            hub = measure(arch_id, shape_id, hub=True)
            v = {**hub["meta"], **_entry(hub)}
            v["cut"] = None if v["fits"] else find_cut(arch_id, shape_id,
                                                       hub["meta"])
            variants["hub_split"] = v
        if meta["kind"] == "lm_train" and phase is not None:
            layers = 1 if arch_id == "moonshot-v1-16b-a3b" else None
            b, n = CARD_LM_TRAIN
            card = measure_depth(arch_id, shape_id, layers, batch=b,
                                 micro=b // n)
            variants["card_run"] = {**card["meta"], **_entry(card)}
        if variants:
            out["variants"] = variants
        out["ok"] = True
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-4000:]
    out["total_s"] = round(time.time() - t0, 2)
    return out


# --------------------------------------------------------------------------
# the table
# --------------------------------------------------------------------------
def _gb(x) -> str:
    return f"{x / 1e9:.2f}"


def table_rows(results):
    """One line a cell: cell, kind, peak GB, fits, cut, bound ms (by),
    chip phase."""
    rows = []
    for r in results:
        if not r.get("ok"):
            rows.append((f"{r['arch']} x {r['shape']}", "-", "-", "error",
                         r.get("error", "")[:60], "-", "-"))
            continue
        cut = r.get("cut")
        if not cut:
            cut_s = "-"
        elif cut["value"] is None:
            cut_s = f"none fits along {cut['axis']}"
        else:
            cut_s = (f"{cut['axis']} {cut['value']} of {cut['published']}"
                     + (f" ({cut['at']})" if cut.get("at") else ""))
        rl = r["roofline"]
        phase = r.get("chip_phase") or "-"
        if r.get("chip_phase_cut"):
            phase += f" ({r['chip_phase_cut']})"
        rows.append((f"{r['arch']} x {r['shape']}", r["kind"],
                     _gb(r["memory"]["peak_bytes"]),
                     "yes" if r["fits"] else "no", cut_s,
                     f"{rl['bound_s'] * 1e3:.3f} ({rl['bound_by']})", phase))
    return rows


def format_table(results) -> str:
    head = ("cell", "kind", "peak GB", "fits", "cut", "bound ms (by)",
            "chip phase")
    lines = ["| " + " | ".join(head) + " |",
             "|" + " --- |" * len(head)]
    lines += ["| " + " | ".join(map(str, row)) + " |"
              for row in table_rows(results)]
    return "\n".join(lines)


def _tag(aid: str, sid: str) -> str:
    return f"{aid}__{sid}__{MESH}".replace("/", "_").replace(".", "_")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-lcc", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true",
                    help="print cell ids (for per-cell subprocess sweeps)")
    ap.add_argument("--table", action="store_true",
                    help="print the table of the cells run, and write it "
                         "to <out>/table.md")
    ap.add_argument("--chip-runs", action="store_true",
                    help="the census of every configuration chip_smoke.py's "
                         "phases run (CHIP_RUNS), to <out>/chip_runs.json")
    ap.add_argument("--audit", action="append", metavar="RUN",
                    help="on the card: run this CHIP_RUNS configuration "
                         "under op_census.CardAudit and print its record")
    args = ap.parse_args(argv)

    if args.audit:
        for name in args.audit:
            print(json.dumps(audit(name)), flush=True)
        return 0
    if args.chip_runs:
        os.makedirs(args.out, exist_ok=True)
        runs = {}
        for name in CHIP_RUNS:
            rec = chip_run(name)
            runs[name] = {k: rec.get(k) for k in (
                "peak", "fits", "reserved_peak_bytes", "oom",
                "argument_bytes", "segment_peaks", "depth")}
            runs[name]["phase"] = CHIP_RUNS[name][0]
            print(f"[census] {name}: peak {rec['peak'] / 1e9:.2f} GB, "
                  f"fits {rec['fits']}", flush=True)
        with open(os.path.join(args.out, "chip_runs.json"), "w") as f:
            json.dump(runs, f, indent=1)
        return 0

    if args.list:
        for aid, sid in cells():
            print(f"{aid} {sid}")
        if args.include_lcc:
            print("paper-lcc default")
        return 0

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        todo = list(cells())
        if args.include_lcc:
            todo.append(("paper-lcc", "default"))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    results = []
    for aid, sid in todo:
        tag = _tag(aid, sid)
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            try:
                with open(path) as f:
                    res = json.load(f)
                if res.get("ok"):
                    print(f"[skip] {tag}")
                    results.append(res)
                    continue
            except (OSError, ValueError):  # malformed -> rerun
                pass
        print(f"[run ] {tag}", flush=True)
        res = run_cell(aid, sid)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = "OK" if res["ok"] else "FAIL " + res.get("error", "")[:200]
        print(f"[done] {tag}: {status} ({res['total_s']}s)", flush=True)
        results.append(res)
    if args.table:
        text = format_table(results)
        print(text)
        with open(os.path.join(args.out, "table.md"), "w") as f:
            f.write(text + "\n")
    return 0 if all(r.get("ok") for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
