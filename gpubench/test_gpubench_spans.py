"""The readers of the program's own spans and counts (``engine_python_idle_ms``,
``engine_idle_share``, ``cached_slot_share``) on the CPU: the harness's trace
reduction names the engine's phases in its idle gaps, each reader returns a
finite value where the program gives it something to read and nothing where
it does not (as on a program without these spans), and the program's count of
cache-served slots equals the benchmark's own."""
import time
import types
from collections import namedtuple

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from gpubench import devtrace, harness
from gpubench.test_gpubench_epoch import small_cell

READERS = ("engine_python_idle_ms", "engine_idle_share", "cached_slot_share")
Interval = namedtuple("Interval", "start end")


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py")


def traced_epochs(cell_name="urand-s19.epoch", steps=2):
    """The harness's window around ``steps`` epochs of a small cell on the
    CPU, profiled as a traced run profiles it; returns (state, events)."""
    cell = small_cell(cell_name)
    drv = harness.driver_of(cell.mix)
    state = drv.set_up(cell.config, cell.mix, 2**31 + 9, "cpu",
                       harness.Spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            for _ in range(steps):
                with record_function(devtrace.STEP):
                    drv.step(state)
    return state, list(prof.events())


class DeviceOp:
    """A device activity as ``devtrace.reduce`` reads one."""

    is_user_annotation = False

    def __init__(self, start, end):
        self.name = "kernel"
        self.device_type = DeviceType.CUDA
        self.thread = -1
        self.time_range = Interval(start, end)


def with_device_under_operators(events):
    """The CPU profile with a device that runs exactly while the host is in
    a torch operator: its idle gaps then fall where the host ran Python."""
    ops = [DeviceOp(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
    return events + ops


def test_reduce_attributes_idle_to_the_engines_phases():
    state, events = traced_epochs()
    names = {e.name for e in events}
    assert {"lcc.epoch", "lcc.index", "lcc.round", "lcc.scores",
            "lcc.to_host"} <= names
    # no device: busy 0, the window is one gap
    bare = devtrace.reduce(events)
    assert bare.busy_s == 0 and bare.window_s > 0
    assert sum(bare.idle_by_host.values()) == pytest.approx(bare.window_s)
    t = devtrace.reduce(with_device_under_operators(events))
    assert 0 < t.busy_s < t.window_s
    engine = {n: s for n, s in t.idle_by_host.items()
              if n.startswith("lcc.")}
    assert "lcc.round" in engine and engine["lcc.round"] > 0
    assert not any(n.startswith("aten::") for n in t.idle_by_host)
    run = types.SimpleNamespace(trace=t, step_s=[0.1, 0.1], state=state)
    for name in READERS:
        value = reader(name).read(run)
        assert value is not None and np.isfinite(value) and value > 0, name
    assert reader("engine_python_idle_ms").read(run) == pytest.approx(
        1e3 * sum(engine.values()) / 2)


def synthetic_run(idle_by_host, busy_s=0.9, window_s=1.0, steps=4,
                  state=None):
    trace = devtrace.DeviceTrace(window_s=window_s, busy_s=busy_s,
                                 device_by_name={"kernel": busy_s},
                                 idle_by_host=idle_by_host)
    return harness.Run(cell=None, state=state, spans=harness.Spans(),
                       setup_s=1.0, step_s=[window_s / steps] * steps,
                       window_s=window_s, memory_peak_bytes=None,
                       device_kind="cpu", trace=trace)


COUNTS = {"local": 70, "cached": 6, "pulled": 24, "padded": 12}
PROGRAM = types.SimpleNamespace(
    host_prob=types.SimpleNamespace(slot_counts=lambda: dict(COUNTS)))
IDLE = {"lcc.round": 0.02, "lcc.index": 0.01, "cudaMemcpyAsync": 0.03,
        devtrace.STEP: 0.005, devtrace.WINDOW: 0.015}


@pytest.mark.parametrize("name,idle,state,want", [
    ("engine_python_idle_ms", IDLE, None, 1e3 * 0.03 / 4),
    ("engine_idle_share", IDLE, None, 0.06),
    ("cached_slot_share", {}, PROGRAM, 0.2),
    # a program without the spans or the count: nothing to read
    ("engine_python_idle_ms", {devtrace.STEP: 0.1, "aten::cat": 0.01},
     None, None),
    ("engine_idle_share", {devtrace.STEP: 0.1, "aten::cat": 0.01},
     None, None),
    ("cached_slot_share", {}, types.SimpleNamespace(
        host_prob=types.SimpleNamespace()), None),
    ("cached_slot_share", {}, types.SimpleNamespace(
        host_prob=types.SimpleNamespace(slot_counts=lambda: dict(
            COUNTS, cached=0, pulled=0))), None),
], ids=["python_idle", "idle_share", "slot_share", "python_idle_no_span",
        "idle_share_no_span", "slot_share_no_count", "slot_share_no_remote"])
def test_reader_on_a_synthetic_run(name, idle, state, want):
    got = reader(name).read(synthetic_run(idle, state=state))
    if want is None:
        assert got is None
    else:
        assert np.isfinite(got) and got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS[:2])
def test_engine_readers_need_a_device(name):
    """No device activity (a CPU run): the idle readers return nothing."""
    assert reader(name).read(synthetic_run(IDLE, busy_s=0.0)) is None
    assert reader(name).read(types.SimpleNamespace(trace=None,
                                                   step_s=[1.0])) is None


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 9100000011])
@pytest.mark.parametrize("cell_name", ["kron-s18.epoch", "urand-s19.epoch"])
def test_cached_slot_share_equals_cache_hit_share(cell_name, seed):
    cell = small_cell(cell_name)
    drv = harness.driver_of(cell.mix)
    state = drv.set_up(cell.config, cell.mix, seed, "cpu", harness.Spans())
    run = types.SimpleNamespace(state=state)
    ours = reader("cached_slot_share").read(run)
    theirs = reader("cache_hit_share").read(run)
    assert ours is not None and theirs is not None
    assert abs(ours - theirs) <= 1e-12
    c = state.host_prob.slot_counts()
    assert c["cached"] + c["pulled"] > 0


def test_traced_harness_run_reports_the_new_readers_on_a_device_only():
    """Through ``run_cell`` on the CPU: the program counts are read, the
    device-idle readers return nothing (no device), and nothing raises."""
    res = harness.run_cell(small_cell("kron-s18.epoch"), 2**31 + 5, 0.2,
                           True, "cpu", time.perf_counter())
    m = res["metrics"]
    assert m["cached_slot_share"]["value"] == pytest.approx(
        m["cache_hit_share"]["value"], abs=1e-12)
    assert "engine_python_idle_ms" not in m and "engine_idle_share" not in m
