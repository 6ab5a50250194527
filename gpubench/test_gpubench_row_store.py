"""The readers of the program's row store and heavy-pair counts
(``row_store_gb``, ``heavy_slot_share``) on the CPU, and the kron scale-19
configuration: each reader returns the program's own count where the program
has it and a problem on the device, and nothing where it does not (as on a
program before the counts); the configuration loads as the harness finds it
and runs correct at a small scale, its traced line carrying both readings."""
import json
import time
import types

import pytest

from gpubench import harness
from gpubench.test_gpubench_epoch import ROOT, small_cell


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py")


@pytest.mark.parametrize("has_count", [True, False],
                         ids=["program", "no_count"])
@pytest.mark.parametrize("cell_name", ["kron-s18.epoch", "urand-s19.epoch"])
def test_row_store_gb_reads_the_programs_count(cell_name, has_count):
    cell = small_cell(cell_name)
    drv = harness.driver_of(cell.mix)
    state = drv.set_up(cell.config, cell.mix, 2**31 + 17, "cpu",
                       harness.Spans())
    dev = state.dev_prob
    want = (dev.row_ids.nbytes + dev.row_off.nbytes
            + dev.cache_rows.nbytes) / 1e9
    if not has_count:
        # a problem without the count, as the program before it
        state.dev_prob = types.SimpleNamespace(rows_ext=dev.rows_ext)
    got = reader("row_store_gb").read(types.SimpleNamespace(state=state))
    if has_count:
        assert got == want and got > 0
    else:
        assert got is None
    state.dev_prob = dev
    drv.release(state)
    assert reader("row_store_gb").read(
        types.SimpleNamespace(state=state)) is None


@pytest.mark.parametrize("has_count", [True, False],
                         ids=["program", "no_count"])
@pytest.mark.parametrize("cell_name", ["kron-s18.epoch", "urand-s19.epoch"])
def test_heavy_slot_share_reads_the_programs_count(monkeypatch, cell_name,
                                                   has_count):
    from repro_torch.kernels import epoch_count

    cell = small_cell(cell_name)
    drv = harness.driver_of(cell.mix)
    state = drv.set_up(cell.config, cell.mix, 2**31 + 19, "cpu",
                       harness.Spans())
    runs = epoch_count.count_runs(state.dev_prob)
    want = runs.heavy / runs.real
    if not has_count:
        monkeypatch.delattr(epoch_count, "heavy_slot_share")
    got = reader("heavy_slot_share").read(types.SimpleNamespace(state=state))
    if has_count:
        assert got == want and 0.0 <= got + runs.share <= 1.0
    else:
        assert got is None
    drv.release(state)
    assert reader("heavy_slot_share").read(
        types.SimpleNamespace(state=state)) is None


def test_kron_s19_configuration_loads():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (conf,) = [c for c in manifest["configs"] if c["name"] == "gap-kron-s19"]
    cell = harness.load_cell(ROOT, "kron-s19.epoch")
    cfg = cell.config
    assert cfg["name"] == conf["name"] == "gap-kron-s19"
    assert cfg["generator"] == "kron" and cfg["scale"] == 19
    assert (cfg["a"], cfg["b"], cfg["c"]) == (0.57, 0.19, 0.19)
    assert cfg["published"] == {"scale": 27, "edge_factor": 16}
    assert cfg["reduced"] == conf["reduced"] == ["scale"]
    assert cfg["edge_factor"] == cfg["published"]["edge_factor"]
    s18 = json.loads((ROOT / "gpubench/configs/gap-kron-s18.json")
                     .read_text())
    # the same deployment as kron-s18 but for the scale
    for key in ("deployment", "generator", "edge_factor", "a", "b", "c",
                "published", "guarantees", "limits"):
        assert cfg[key] == s18[key], key
    assert {k: v for k, v in cfg["assumed"].items() if k != "labels"} == {
        k: v for k, v in s18["assumed"].items() if k != "labels"}
    assert cell.mix["driver"] == "lcc_epoch" and cell.chips == 1
    assert {m["name"] for m in cell.per_layer} == {"row_store_gb",
                                                   "heavy_slot_share"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "step_ms"}


def test_kron_s19_cell_runs_correct_at_a_small_scale():
    """The cell through the harness at scale 9 on the CPU, traced: correct,
    and its line carries the two readings."""
    cell = harness.load_cell(ROOT, "kron-s19.epoch")
    cell.config = dict(cell.config, scale=9)
    cell.config["assumed"] = dict(cell.config["assumed"], cache_rows=16,
                                  rounds=4)
    cell.mix = dict(cell.mix, sampled_steps=2, trace_seconds=0.2)
    res = harness.run_cell(cell, 2**31 + 23, 0.2, True, "cpu",
                           time.perf_counter())
    assert res["correct"] and res["checks"]["t_wrong"]["value"] == 0
    m = res["metrics"]
    assert set(m) == {"row_store_gb", "heavy_slot_share"}
    assert m["row_store_gb"]["unit"] == "GB" and m["row_store_gb"]["value"] > 0
    assert 0.0 <= m["heavy_slot_share"]["value"] <= 1.0
