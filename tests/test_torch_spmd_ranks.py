"""The port's SPMD data plane at p in {4, 8} on the CPU, against the
reference's loop mode (which needs no devices): serving and streaming,
1D and hub partitions, pipelined and not, with the device tier
replicated and per rank, for the reference tests' seeds. Answers, stream
state, every runtime ledger and pair counter field for field; the port's
measured traffic equal to its modeled serve matrix; every unit's B5 block
and B6 counts equal to the kernels' contract (``UnitRecorder``), split-hub
fragments included. The runners are ``tests/test_torch_spmd.py``'s."""
import pytest

from repro_torch.distributed import spmd_runtime as spmd
from test_torch_spmd import (
    UnitRecorder,
    ledger_dict,
    run_serving,
    run_streaming,
    serving_agrees,
    streaming_agrees,
)

CASES = [
    # (p, seed, hub, pipeline, device_slots, device_scope)
    (4, 0, False, False, 0, "replicated"),
    (8, 0, False, True, 0, "replicated"),
    (4, 1, False, True, 32, "replicated"),
    (4, 0, True, False, 0, "replicated"),
    (8, 1, True, True, 0, "replicated"),
    (8, 0, True, False, 32, "per_rank"),
]


def fragment_spy(monkeypatch):
    """Counts the hub-fragment keys (``n + 1 + v``) each unit makes
    resident — nonzero only when a split hub row was fetched."""
    seen = []
    ensure = spmd._ResidentShardBuffer.ensure

    def spy(buf, needed, unit, keep):
        seen.append(sum(key > buf.sentinel for d in needed for key in d))
        return ensure(buf, needed, unit, keep)

    monkeypatch.setattr(spmd._ResidentShardBuffer, "ensure", spy)
    return seen


def _id(case):
    p, seed, hub, pipe, slots, scope = case
    return (f"p{p}-seed{seed}-{'hub' if hub else '1d'}"
            f"{'-pipeline' if pipe else ''}"
            f"{f'-tier_{scope}' if slots else ''}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_serving_loop_vs_spmd(case, monkeypatch):
    p, seed, hub, pipeline, slots, scope = case
    want = run_serving("ref", "loop", p, seed, slots, device_scope=scope,
                       hub=hub)
    rec = UnitRecorder(monkeypatch, kernel=False)
    frags = fragment_spy(monkeypatch)
    got = run_serving("port", "spmd", p, seed, slots, pipeline=pipeline,
                      device_scope=scope, hub=hub)
    serving_agrees(got, want, latency=not pipeline)
    rec.check(got[0].store.n)
    assert rec.serve, "no unit shipped rows"
    # with the tier, the hub rows a rank reads are resident there: held,
    # never fetched, so no fragment ships
    assert (sum(frags) > 0) == (hub and not slots), frags


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_streaming_loop_vs_spmd(case, monkeypatch):
    p, seed, hub, pipeline, slots, scope = case
    want = run_streaming("ref", "loop", p, seed, slots, device_scope=scope,
                         hub=hub)
    rec = UnitRecorder(monkeypatch, kernel=True)
    frags = fragment_spy(monkeypatch)
    got = run_streaming("port", "spmd", p, seed, slots, pipeline=pipeline,
                        device_scope=scope, hub=hub)
    streaming_agrees(got, want)
    rec.check(got[0].n)
    assert rec.serve, "no unit shipped rows"
    assert (sum(frags) > 0) == (hub and not slots), frags


@pytest.mark.parametrize("p", [4, 8])
def test_pipelined_ledger_equals_unpipelined(p):
    """Pipelining changes when a unit is waited for, never what it ships:
    the port's ledgers, pipelined and not, field for field."""
    for run in (run_serving, run_streaming):
        a, _ = run("port", "spmd", p, 0)
        b, _ = run("port", "spmd", p, 0, pipeline=True)
        led_a = (a.engine if run is run_serving else a).spmd.ledger
        led_b = (b.engine if run is run_serving else b).spmd.ledger
        assert ledger_dict(led_a) == ledger_dict(led_b)
        assert led_a.n_collectives > 0 and led_a.total_rows > 0
