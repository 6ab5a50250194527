"""The one-card census (``repro_torch.launch.{mesh,op_census,dryrun}``)
and the registry's ``list_archs`` / ``cells`` against the reference: the
same cells in the same order; each cell's parameter and batch bytes equal to
the reference's ``jax.eval_shape`` / ``input_specs``; the census's matmul
FLOPs equal to the reference's HLO census of the same smoke steps; the
depth extrapolation equal to a full trace; the kernel stand-ins called as
often as the card's wrappers launch; and ``paper-lcc``'s modeled
all-to-all bytes in closed form.

``dot_flops`` is compared with ``collective_census(compiled.as_text())``
of the reference's step jitted on one CPU device, whose dots stay ``dot``
instructions there (no custom-calls): the smoke steps' FLOPs agree to the
FLOP (tolerance 2%, relative)."""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import inputs as r_inputs
from repro.configs import registry as r_registry
from repro.launch.hlo_census import collective_census
from repro.models import transformer as r_tfm
from repro.train import train_loop as r_tl
from repro.train.optimizer import adamw as r_adamw
from repro_torch.configs import inputs as p_inputs
from repro_torch.configs import registry as p_registry
from repro_torch.launch import dryrun, op_census
from repro_torch.launch.mesh import HW

DOT_RTOL = 2e-2
GNN_MODULES = {"mace": "mace", "pna": "pna", "gin-tu": "gin",
               "gat-cora": "gat"}
TORCH_DTYPES = {np.dtype("int32"): torch.int32,
                np.dtype("float32"): torch.float32,
                np.dtype("bool"): torch.bool}


# ------------------------------------------------------------- registry
def test_list_archs_and_cells_equal_the_reference():
    assert p_registry.list_archs() == r_registry.list_archs()
    assert (p_registry.list_archs(assigned_only=True)
            == r_registry.list_archs(assigned_only=True))
    assert len(p_registry.list_archs()) == 11
    assert p_registry.cells() == r_registry.cells()
    assert len(p_registry.cells()) == 36
    assert (p_registry.cells(include_skipped=True)
            == r_registry.cells(include_skipped=True))
    skipped = sorted(set(p_registry.cells(True)) - set(p_registry.cells()))
    assert skipped == [(a, "long_500k") for a in (
        "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "qwen2.5-14b",
        "stablelm-1.6b")]
    for name in ("list_archs", "cells"):
        assert name in p_registry.__all__


def test_dryrun_list_prints_the_reference_cells(capsys):
    assert dryrun.main(["--list", "--include-lcc"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"{a} {s}" for a, s in r_registry.cells()] + [
        "paper-lcc default"]


# ------------------------------------------------- parameter and batch bytes
def _nbytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@functools.lru_cache(maxsize=None)
def _reference_param_bytes(arch_id: str, shape_id: str) -> int:
    arch = r_registry.get_arch(arch_id)
    cfg = r_inputs.input_specs(arch_id, shape_id)[0]
    if arch.family == "lm":
        init = r_tfm.init_params
    elif arch.family == "gnn":
        init = importlib.import_module(
            f"repro.models.gnn.{GNN_MODULES[arch_id]}").init_params
    else:
        from repro.models.recsys import din

        init = din.init_params
    return _nbytes(jax.eval_shape(functools.partial(init, cfg),
                                  jax.random.key(0)))


@pytest.mark.parametrize("arch_id,shape_id", r_registry.cells())
def test_parameter_and_batch_bytes_equal_the_reference(arch_id, shape_id):
    got = dryrun.cell_bytes(arch_id, shape_id)
    assert got["param_bytes"] == _reference_param_bytes(arch_id, shape_id)
    # unpadded: the reference's dryrun pads to a device count of the mesh
    want_batch = _nbytes(r_inputs.input_specs(arch_id, shape_id)[2])
    assert got["batch_bytes"] == want_batch
    spec = p_inputs.input_specs(arch_id, shape_id)[2]
    assert got["batch_bytes"] == sum(t.numel() * t.element_size()
                                     for t in spec.values())
    if shape_id.startswith("decode") or shape_id == "long_500k":
        cfg = p_inputs.input_specs(arch_id, shape_id)[0]
        assert got["cache_bytes"] > 0 and cfg.n_layers > 0


# ------------------------------------------------------ dot FLOPs vs HLO
def _reference_dot_flops(step, *args) -> float:
    text = jax.jit(step).lower(*args).compile().as_text()
    assert "custom-call" not in text  # the CPU backend kept its dots
    return collective_census(text)["dot_flops"]


def _specs_of(batch):
    return {k: (tuple(np.asarray(v).shape), TORCH_DTYPES[np.asarray(v).dtype])
            for k, v in batch.items()}


@pytest.mark.parametrize("arch_id,kind", [
    ("stablelm-1.6b", "lm_prefill"), ("stablelm-1.6b", "lm_train"),
    ("gemma2-27b", "lm_prefill"), ("gemma2-27b", "lm_train"),
    ("gin-tu", "gnn_train"), ("din", "recsys_serve")])
def test_dot_flops_equal_the_reference_hlo_census(arch_id, kind):
    """The smoke steps (LM training in 2 microbatches, remat on) through
    the reference's HLO census and through the port's op census."""
    r_cfg, batch = r_inputs.make_smoke_batch(arch_id, kind,
                                             np.random.default_rng(0))
    p_cfg = p_inputs.make_smoke_batch(arch_id, kind,
                                      np.random.default_rng(0))[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    family = r_registry.get_arch(arch_id).family
    if family == "lm":
        params = jax.eval_shape(functools.partial(r_tfm.init_params, r_cfg),
                                jax.random.key(0))
        b, s = batch["tokens"].shape
        if kind == "lm_train":
            opt = r_adamw(lr=3e-4)
            want = _reference_dot_flops(
                r_tl.make_lm_train_step(r_cfg, opt, n_microbatches=2),
                params, jax.eval_shape(opt.init, params), jb)
        else:
            want = _reference_dot_flops(
                r_tl.make_lm_prefill_step(r_cfg, max_len=s), params,
                jb["tokens"])
        build, step = dryrun._lm_setup(p_cfg, kind, b, s, b // 2)
    elif family == "gnn":
        mod = importlib.import_module(
            f"repro.models.gnn.{GNN_MODULES[arch_id]}")
        params = jax.eval_shape(functools.partial(mod.init_params, r_cfg),
                                jax.random.key(0))
        opt = r_adamw(lr=1e-3, weight_decay=0.0)
        want = _reference_dot_flops(
            r_tl.make_gnn_train_step(mod.apply, r_cfg, opt), params,
            jax.eval_shape(opt.init, params), jb)
        build, step = dryrun._gnn_setup(arch_id, p_cfg, _specs_of(batch))
    else:
        from repro.models.recsys import din

        params = jax.eval_shape(functools.partial(din.init_params, r_cfg),
                                jax.random.key(0))
        want = _reference_dot_flops(
            r_tl.make_recsys_serve_step(din.apply, r_cfg), params, jb)
        build, step = dryrun._recsys_setup(p_cfg, kind, _specs_of(batch))
    got = op_census.trace(build, step).dot_flops
    assert want > 0
    assert abs(got - want) <= DOT_RTOL * want, (got, want)


# ----------------------------------------------------- depth extrapolation
@pytest.mark.parametrize("arch_id,kind", [
    ("stablelm-1.6b", "lm_train"), ("moonshot-v1-16b-a3b", "lm_train"),
    ("stablelm-1.6b", "lm_prefill")])
def test_depth_extrapolation_equals_a_full_trace(arch_id, kind):
    """The smoke config at 6 layers: extrapolated from 1, 2 and 3 layers
    (``at_depth``) against a trace of all 6."""
    import dataclasses

    base = p_inputs.make_smoke_batch(arch_id, kind,
                                     np.random.default_rng(0))[0]
    assert len(base.pattern) == 1

    def at(n):
        cfg = dataclasses.replace(base, n_layers=n)
        build, step = dryrun._lm_setup(cfg, kind, 4, 32, 2)
        return dryrun._measure(build, step, {"kind": kind, "layers": n})

    got = dryrun.at_depth(at, 1, 6)
    full = at(6)
    assert got["depth"]["traced"] == [1, 2, 3]
    for key in ("param_bytes", "opt_bytes"):
        assert got[key] == full[key], key
    for key in ("flops", "dot_flops", "bytes_accessed"):
        assert got[key] == pytest.approx(full[key], rel=1e-9), key
    # live bytes are charged in blocks of 512 (the allocator's): a smoke
    # leaf of a few hundred bytes a layer rounds up unevenly with depth
    for key in ("argument_bytes", "peak_bytes", "step_peak_bytes",
                "output_bytes"):
        assert got[key] == pytest.approx(full[key], rel=2e-3), key
    assert got["segment_peaks"].keys() == full["segment_peaks"].keys()


def test_peak_follows_the_microbatch_size_not_their_number():
    """Microbatches run one after another: 4 microbatches of 2 peak as 2
    of 2, beside the larger batch tensors (what the census's cut search
    leans on); 2 of 4 peak higher."""
    cfg = p_inputs.make_smoke_batch("stablelm-1.6b", "lm_train",
                                    np.random.default_rng(0))[0]

    def peak(batch, micro):
        build, step = dryrun._lm_setup(cfg, "lm_train", batch, 32, micro)
        rec = dryrun._measure(build, step, {"kind": "lm_train"})
        return rec["step_peak_bytes"] - rec["batch_bytes"]

    two, four = peak(4, 2), peak(8, 2)
    # the larger batch's token arrays round up to other 512-byte blocks
    assert abs(four - two) <= 2 * 512
    assert peak(8, 4) > two


def test_depth_extrapolation_of_a_published_config_is_linear():
    """gemma2-27b x prefill_32k (period 2, local and global layers): the
    extrapolated parameter bytes are the config's own count."""
    rec = dryrun.measure_depth("gemma2-27b", "prefill_32k", batch=1,
                               seq=8192)
    cfg = p_registry.get_arch("gemma2-27b").config()
    assert rec["depth"] == {"traced": [2, 4, 6], "layers": 46}
    assert rec["param_bytes"] == 2 * cfg.param_count()
    # B8 once a layer at the flash cutoff
    assert rec["kernels"]["flash_attention"]["calls"] == 46


# --------------------------------------------------------- the stand-ins
def test_stand_ins_are_swapped_inside_only_and_charge_the_kernels():
    from repro_torch.kernels import ops

    real = (ops.flash_attention_gqa, ops.segment_sum_sorted,
            torch.nn.init.trunc_normal_)
    with op_census.StandIns() as st:
        assert ops.flash_attention_gqa is not real[0]
        assert ops.segment_sum_sorted is not real[1]
        v = torch.zeros((10, 4))
        out = ops.segment_sum_sorted(v, torch.zeros(10, dtype=torch.int32),
                                     num_segments=3)
        q = torch.zeros((1, 64, 2, 2, 16), dtype=torch.bfloat16)
        k = torch.zeros((1, 64, 2, 16), dtype=torch.bfloat16)
        y = ops.flash_attention_gqa(q, k, k, scale=0.25, causal=True,
                                    window=16)
    assert (ops.flash_attention_gqa, ops.segment_sum_sorted,
            torch.nn.init.trunc_normal_) == real
    assert out.shape == (3, 4) and out.dtype == torch.float32
    assert y.shape == q.shape and y.dtype == q.dtype
    b9 = st.charges["segment_sum_sorted"]
    assert (b9.calls, b9.flops, b9.bytes) == (1, 40.0,
                                              4 * 40 + 4 * 10 + 4 * 12)
    b8 = st.charges["flash_attention"]
    # 64 queries, causal, window 16: 16*17/2 + 48*16 pairs a head
    pairs = (16 * 17 // 2 + 48 * 16) * 2 * 2
    assert b8.calls == 1 and b8.flops == 4.0 * 16 * pairs
    assert b8.bytes == (2.0 * 64 * 2 * 2 * 16 + 2.0 * 64 * 2 * 16) * 2


@pytest.mark.parametrize("s,t,causal,window", [
    (64, 64, True, 0), (64, 64, True, 16), (70, 70, True, 64),
    (33, 33, False, 0), (8192, 8192, True, 4096)])
def test_attention_pairs_closed_form(s, t, causal, window):
    want = 0
    for i in range(s):
        hi = min(i + 1, t) if causal else t
        lo = max(i - window + 1, 0) if window > 0 else 0
        want += max(hi - lo, 0)
    assert op_census.attention_pairs(s, t, causal, window) == want


# ----------------------------------------------------------- paper-lcc
def test_paper_lcc_modeled_bytes_closed_form():
    rec = dryrun.run_cell("paper-lcc", "default")
    assert rec["ok"] and rec["p"] == 256 and rec["mesh"] == "h100x1"
    # n = 2^20 over 256 ranks: 4,096 rows each; 16 x 4,096 edge slots in 8
    # rounds; 8,192 / 8 / 255 -> 32 rows a (rank, rank) pair and round
    assert (rec["n_loc"], rec["e_max"], rec["s_max"]) == (4096, 65536, 32)
    wire = 8 * 256 * 255 * 32 * 512 * 4
    led = rec["collectives"]
    assert led["bytes_on_wire"] == led["bytes_on_wire_single"] == wire
    assert led["n_collectives"] == 8
    assert led["rows_shipped"] == 8 * 256 * 255 * 32
    t = rec["tensor_bytes"]
    # the ragged store: 16 ids a row, an int64 offset a row and the end
    assert t["row_ids"] == 256 * 4096 * 16 * 4
    assert t["row_off"] == (256 * 4097 + 1) * 8
    assert "rows_ext" not in t
    assert t["serve_idx"] == 256 * 8 * 256 * 32 * 4
    assert rec["memory"]["peak_bytes"] == sum(t.values())
    assert rec["fits"]


# --------------------------------------------------------------- HW
def test_hw_is_the_h100s_and_bounds_read_it():
    assert HW.PEAK_FLOPS_BF16 == 989e12 and HW.HBM_BW == 3.35e12
    assert HW.INT32_OPS == 67e12
    assert HW.SFU_OPS == 16 * 132 * 1.98e9
    assert HW.usable_bytes() == HW.HBM_BYTES - HW.RESERVE_BYTES
    assert "NVIDIA H100 80GB HBM3" in HW.CARD and "700" in HW.CARD
    r = dryrun.roofline(989e12, 3.35e12 / 2)
    assert r == {"compute_s": 1.0, "memory_s": 0.5, "bound_s": 1.0,
                 "bound_by": "compute"}


def test_allocator_model_splits_merges_and_runs_out():
    a = op_census.CachingAllocator(capacity=64 << 20)
    a.malloc(1, 30 << 20)  # a segment of its own size, 2 MB rounded
    a.malloc(2, 3 << 20)   # a 20 MB segment, split
    assert a.reserved == (30 << 20) + (20 << 20)
    a.malloc(3, 3 << 20)   # from the 20 MB segment's remainder
    assert a.reserved == (50 << 20)
    a.free(2)
    a.free(3)              # merged back into one free 20 MB block
    a.malloc(4, 20 << 20)  # fits that block exactly
    assert a.reserved == (50 << 20) and a.oom is None
    a.malloc(5, 16 << 20)  # 50 + 16 > 64: out of memory
    assert a.oom is not None and a.oom["request"] == 16 << 20
