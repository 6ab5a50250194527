"""The ``epoch`` mix driven through the harness on the CPU at small sizes (the
port's plain versions in place of its CUDA kernels): sound runs come out
correct; the control and each fault the cell can have come out not correct;
the command itself refuses to run without a card."""
import contextlib
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gpubench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"kron-s18.epoch": {"scale": 8}, "urand-s19.epoch": {"scale": 9}}


def small_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(ROOT, name)
    cfg = dict(cell.config, **SMALL[name])
    # a cache of 16 rows and 4 rounds keep rows to pull at this size
    cfg["assumed"] = dict(cfg["assumed"], cache_rows=16, rounds=4)
    cell.config = cfg
    cell.mix = dict(cell.mix, sampled_steps=2, trace_seconds=0.2)
    return cell


def run(cell, seed=2**31 + 5, seconds=0.2, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    cell = small_cell(name)
    res = run(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "setup_spans", "reference_s", "checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["t_wrong"]["value"] == 0
    assert res["checks"]["lcc_rel_err"]["value"] < 1e-6
    assert {"step_ms", "step_p95_ms", "setup_s"} <= set(res["metrics"])
    assert "peak_mem_gb" not in res["metrics"]  # no card, no device memory


def test_traced_run_reads_its_layers():
    res = run(small_cell("kron-s18.epoch"), trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert 0 < m["cache_hit_share"]["value"] < 1
    assert m["schedule_build_s"]["value"] > 0
    # no device, no device metrics: the readers return nothing, never 0
    for k in ("epoch_roofline", "epoch_land_roofline", "epoch_count_roofline",
              "device_idle_share"):
        assert k not in m
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def test_step_outputs_equal_reference():
    cell = small_cell("kron-s18.epoch")
    drv = harness.driver_of(cell.mix)
    state = drv.set_up(cell.config, cell.mix, 77, "cpu", harness.Spans())
    t, lcc = drv.step(state)
    ref_t, deg = drv.reference(state, "cpu")
    got = t.reshape(-1)[: state.n]
    np.testing.assert_array_equal(got, ref_t.numpy())
    assert int(ref_t.sum()) > 0


def test_control_is_not_correct():
    cell = small_cell("kron-s18.epoch")
    drv = harness.driver_of(cell.mix)
    state = drv.inputs_only(cell.config, 3, "cpu")
    checks, failed = drv.judge(state, [drv.control_output(state, "cpu")],
                               "cpu")
    assert failed == 1
    assert checks["t_wrong"]["value"] == 0
    assert checks["lcc_rel_err"]["value"] > checks["lcc_rel_err"]["limit"]


@contextlib.contextmanager
def fault(kind: str):
    """Break the timed path under the harness, in the port's own modules."""
    from repro_torch.core import async_engine as ae
    from repro_torch.kernels import epoch_count as ec

    saved = {"acc": ae._epoch_acc, "scores": ae._scores,
             "land": ec.epoch_land, "count": ec.epoch_count}
    if kind == "state_unchanged":  # S returned as it was made: all zero
        ae._epoch_acc = lambda prob, method: torch.zeros(
            prob.p * (prob.n_loc + 1), dtype=torch.int32)
    elif kind == "half_the_batch":  # odd rounds skipped, even ones doubled
        def count(prob, index, r, landing, acc, *, method):
            if r % 2:
                return acc
            part = saved["count"](prob, index, r, landing,
                                  torch.zeros_like(acc), method=method)
            return acc.add_(2 * part)
        ec.epoch_count = count
    elif kind == "no_exchange":  # the pulled rows never land
        def land(prob, index, r, landing):
            return landing.fill_(prob.sentinel)
        ec.epoch_land = land
    elif kind == "answer_altered":  # one vertex's count off by one
        def scores(prob, acc):
            t, lcc = saved["scores"](prob, acc)
            t = t.clone()
            t[0, 0] += 1
            return t, lcc
        ae._scores = scores
    try:
        yield
    finally:
        ae._epoch_acc, ae._scores = saved["acc"], saved["scores"]
        ec.epoch_land, ec.epoch_count = saved["land"], saved["count"]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_batch",
                                  "no_exchange", "answer_altered"])
def test_fault_is_not_correct(kind):
    cell = small_cell("kron-s18.epoch")
    with fault(kind):
        res = run(cell)
    assert not res["correct"]
    assert res["failed"] >= 1
    assert res["checks"]["t_wrong"]["value"] > 0


def test_command_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload",
         "kron-s18.epoch", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
