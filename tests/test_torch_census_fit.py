"""The census's fit verdicts and peaks against the card's record: every
configuration ``chip_smoke.py``'s phases run (``dryrun.CHIP_RUNS``), as the
phase holds it, traced on the host, against the ``max_memory_allocated``
the phase measured less the memory it held before the run (its base), on
an NVIDIA H100 80GB HBM3 at 700.00 W (``chip_smoke.py``'s phase
``census``). Each predicted peak is within ``RATIO_BAND`` of the card's,
each verdict the card's, and each kernel stand-in called as often as the
card's wrapper launched in the run.

The raw figures the phases print (``PERF.md`` §5) hold the base besides,
1.40-1.43 GB that earlier phases leave allocated: gemma2 60.6 GB, moonshot
62.41, phi3.5 at 24 layers 71.05, gin-tu 46.74, mace 3.19, the hub split /
unsplit 44.44 / 50.38, stablelm 62.60, moonshot at 1 layer 58.95, din
74.76. An earlier record of moonshot x train_4k at 2 layers running out
of memory came after earlier phases' allocations; run in phase ``census``
it peaked at 71.25 GB and fitted, as the census says. phi3.5 at
its 32 layers has not run on the card: 83.75 GB of bf16 weights, and the
census's peak 90.46 GB.
"""
import functools
import importlib.util
import os

import pytest

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW

ROOT = os.path.join(os.path.dirname(__file__), "..")
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
RATIO_BAND = 0.2
# run -> the card's peak less its base, bytes (None: not run on the card),
# and whether it fitted; chip_smoke.py phase census on the card above
CARD_RECORD = {
    "gemma2-27b serve 8192 x 1": (59_237_059_072, True),
    "moonshot-v1-16b-a3b serve 8192 x 1": (61_010_937_856, True),
    "phi3.5-moe-42b-a6.6b serve 8192 x 1, 24 layers": (69_654_683_648, True),
    "phi3.5-moe-42b-a6.6b serve 8192 x 1, 32 layers": (None, False),
    "gin-tu x ogb_products": (45_314_638_336, True),
    "gat-cora x full_graph_sm": (38_519_808, True),
    "mace x molecule": (1_758_971_904, True),
    "gat-cora x ogb_products, hub split, a tenth of the edges": (
        43_007_953_408, True),
    "gat-cora x ogb_products, unsplit, a tenth of the edges": (
        48_947_727_872, True),
    "stablelm-1.6b x train_4k, batch 4 in 2": (61_167_267_328, True),
    "moonshot-v1-16b-a3b x train_4k, batch 4 in 2, 1 layer": (
        57_518_448_128, True),
    "moonshot-v1-16b-a3b x train_4k, batch 4 in 2, 2 layers": (
        71_245_975_040, True),
    "din x train_batch": (73_331_169_792, True),
}
# the hub cells' names in chip_smoke.py's B9_PER_STEP
B9_CELLS = {
    "gin-tu x ogb_products": ("gin-tu", "ogb_products"),
    "gat-cora x full_graph_sm": ("gat-cora", "full_graph_sm"),
    "mace x molecule": ("mace", "molecule"),
    "gat-cora x ogb_products, hub split, a tenth of the edges": (
        "gat-cora", "ogb_products_hub"),
    "gat-cora x ogb_products, unsplit, a tenth of the edges": (
        "gat-cora", "ogb_products_cut"),
}


@functools.lru_cache(maxsize=None)
def census(name):
    return dryrun.chip_run(name)


@functools.lru_cache(maxsize=None)
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_record_is_every_run_of_the_census():
    assert sorted(CARD_RECORD) == sorted(dryrun.CHIP_RUNS)
    assert HW.CARD == CARD


@pytest.mark.parametrize("name", list(CARD_RECORD))
def test_fit_verdict_is_the_cards(name):
    assert census(name)["fits"] is CARD_RECORD[name][1]


@pytest.mark.parametrize("name", [n for n, (p, _) in CARD_RECORD.items()
                                  if p is not None])
def test_peak_within_the_band_of_the_cards(name):
    ratio = census(name)["peak"] / CARD_RECORD[name][0]
    assert 1 - RATIO_BAND <= ratio <= 1 + RATIO_BAND, ratio


@pytest.mark.parametrize("name", list(CARD_RECORD))
def test_stand_ins_called_as_often_as_the_card_launches(name):
    """B9 ``B9_PER_STEP`` times a step (the runs take two); B8 once a layer
    in an 8,192-token prefill and never in training (no backward)."""
    rec = census(name)
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    how = dryrun.CHIP_RUNS[name][2]
    if name in B9_CELLS:
        per_step = chip_smoke().B9_PER_STEP[B9_CELLS[name]]
        assert calls == {"segment_sum_sorted": 2 * per_step,
                         "flash_attention": 0}
    elif how == "serve":
        assert calls == {"flash_attention": rec["meta"]["layers"],
                         "segment_sum_sorted": 0}
    else:
        assert calls == {"flash_attention": 0, "segment_sum_sorted": 0}
