"""The port's ``CollectiveLedger`` against the reference's SPMD ledger at
p in {4, 8}: the reference runs its SPMD mode in a subprocess on 8 forced
host devices (JAX pins the device count at first init, and the rest of the
suite must see one device), pipelined and not, serving and streaming, 1D
and hub partitions, R-MAT S7; it prints each scenario's ledger. The port
runs the same scenarios here on the CPU; every counter must be equal (the
wall-clock fields excepted)."""
import json
import os
import subprocess
import sys

import pytest

from test_torch_spmd import ledger_dict, run_serving, run_streaming

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# (runner, p, seed, pipeline, hub)
SCENARIOS = [
    ("serving", 4, 0, False, False),
    ("serving", 8, 0, True, False),
    ("serving", 4, 1, False, True),
    ("streaming", 4, 0, False, False),
    ("streaming", 8, 0, True, False),
    ("streaming", 8, 1, True, True),
]

SCRIPT = r"""
from repro.distributed.spmd_runtime import ensure_host_devices
ensure_host_devices(8)  # before anything initializes jax
import json
import sys
sys.path.insert(0, {test_dir!r})
from test_torch_spmd import ledger_dict, run_serving, run_streaming

out = []
for name, p, seed, pipeline, hub in {scenarios!r}:
    run = run_serving if name == "serving" else run_streaming
    obj, _ = run("ref", "spmd", p, seed, pipeline=pipeline, hub=hub)
    led = (obj.engine if name == "serving" else obj).spmd.ledger
    out.append(ledger_dict(led))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_ledgers():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, os.path.dirname(__file__)])
    env.pop("XLA_FLAGS", None)
    script = SCRIPT.format(
        test_dir=os.path.dirname(os.path.abspath(__file__)),
        scenarios=SCENARIOS)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(SCENARIOS)), ids=[
    f"{n}-p{p}-seed{s}{'-pipeline' if pipe else ''}{'-hub' if hub else ''}"
    for n, p, s, pipe, hub in SCENARIOS])
def test_ledger_equals_reference_spmd(i, reference_ledgers):
    name, p, seed, pipeline, hub = SCENARIOS[i]
    run = run_serving if name == "serving" else run_streaming
    obj, _ = run("port", "spmd", p, seed, pipeline=pipeline, hub=hub)
    led = (obj.engine if name == "serving" else obj).spmd.ledger
    got = ledger_dict(led)
    assert got == reference_ledgers[i]
    assert got["n_collectives"] > 0 and got["rows_shipped"] > 0
