"""The port stands alone: importing ``repro_torch``, every submodule of it
and ``chip_smoke`` pulls in neither ``jax`` nor any module of the reference
package, and its entry points do not run on the CPU unless asked to."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

IMPORT_SCRIPT = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"imported": names, "bad": bad,
                  "torch": "torch" in sys.modules}))
"""


@pytest.fixture(scope="module")
def import_report():
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, ROOT])
    r = subprocess.run([sys.executable, "-c", IMPORT_SCRIPT],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_no_jax_and_no_reference_package(import_report):
    assert import_report["bad"] == []
    assert import_report["torch"]


@pytest.mark.parametrize("name", [
    "repro_torch.device",
    "repro_torch.core.async_engine", "repro_torch.core.cache",
    "repro_torch.core.csr", "repro_torch.core.intersect",
    "repro_torch.core.lcc", "repro_torch.core.partition",
    "repro_torch.core.rma", "repro_torch.core.triangles",
    "repro_torch.core.tric_baseline",
    "repro_torch.graphs.datasets", "repro_torch.graphs.rmat",
    "repro_torch.kernels._build", "repro_torch.kernels.bucketing",
    "repro_torch.kernels.delta_intersect",
    "repro_torch.kernels.intersect_count", "repro_torch.kernels.ops",
    "repro_torch.kernels.point_query", "repro_torch.kernels.ref",
    "repro_torch.launch.lcc_run",
    "repro_torch.obs.cachescope", "repro_torch.obs.metrics",
    "repro_torch.obs.trace",
])
def test_submodule_was_imported(import_report, name):
    assert name in import_report["imported"]


def test_port_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    hits = []
    for base, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        hits.append(path)
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        if pat.search(fh.read()):
            hits.append("chip_smoke.py")
    assert hits == []


def test_default_device_is_cuda_and_raises_without_a_card():
    import torch

    from repro_torch.core import async_engine, rma, tric_baseline
    from repro_torch.graphs.datasets import powerlaw_graph
    from repro_torch.kernels import delta_intersect, point_query
    from repro_torch.launch import lcc_run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    import numpy as np

    g = powerlaw_graph(40, 4, seed=0)
    prob = rma.build_sharded_problem(g, 2, n_rounds=2)
    rows = np.array([[1, 2, 9, 9], [3, 9, 9, 9]], np.int32)
    calls = [
        lambda: async_engine.lcc_pipelined(prob),
        lambda: async_engine.run_distributed_lcc(g, 2),
        lambda: tric_baseline.tric_lcc_torch(g, 2),
        lambda: delta_intersect.delta_intersect_counts(rows, rows, sentinel=9),
        lambda: point_query.batched_pair_counts([rows[0]], [rows[0]],
                                                sentinel=9, use_kernel=True),
        lambda: lcc_run.main(["--scale", "6", "--p", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the host path of the ragged-pair entry touches no device
    assert point_query.batched_pair_counts(
        [rows[0]], [rows[0]], sentinel=9).tolist() == [2]


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""  # no result line without a device
