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
import glob, importlib.util, os
for path in sorted(glob.glob(os.path.join("examples", "torch", "*.py"))):
    spec = importlib.util.spec_from_file_location(
        "example_" + os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path)
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
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_no_jax_and_no_reference_package(import_report):
    assert import_report["bad"] == []
    assert import_report["torch"]


@pytest.mark.parametrize("name", [
    "repro_torch.device",
    "repro_torch.device.resolve", "repro_torch.device.residency",
    "repro_torch.core.async_engine", "repro_torch.core.cache",
    "repro_torch.core.csr", "repro_torch.core.intersect",
    "repro_torch.core.lcc", "repro_torch.core.partition",
    "repro_torch.core.repartition", "repro_torch.core.rma",
    "repro_torch.core.runtime", "repro_torch.core.triangles",
    "repro_torch.core.tric_baseline",
    "repro_torch.graphs.datasets", "repro_torch.graphs.rmat",
    "repro_torch.kernels._build", "repro_torch.kernels.bitmap_popcount",
    "repro_torch.kernels.bucketing",
    "repro_torch.kernels.delta_intersect",
    "repro_torch.kernels.embedding_bag", "repro_torch.kernels.epoch_count",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.intersect_count", "repro_torch.kernels.ops",
    "repro_torch.kernels.point_query", "repro_torch.kernels.ref",
    "repro_torch.kernels.resident_intersect",
    "repro_torch.launch.lcc_run", "repro_torch.launch.serve",
    "repro_torch.launch.stream_run", "repro_torch.launch.resident_timing",
    "repro_torch.launch.query_serve",
    "repro_torch.obs.timing",
    "repro_torch.configs.registry", "repro_torch.configs.shapes",
    "repro_torch.configs.gemma2_27b", "repro_torch.configs.qwen25_14b",
    "repro_torch.configs.stablelm_1_6b", "repro_torch.configs.din",
    "repro_torch.configs.paper_lcc",
    "repro_torch.configs.moonshot_v1_16b_a3b",
    "repro_torch.configs.phi35_moe_42b_a6_6b",
    "repro_torch.data.recsys", "repro_torch.data.tokens",
    "repro_torch.graphs.sampler", "repro_torch.distributed.hub_gather",
    "repro_torch.models.common", "repro_torch.models.attention",
    "repro_torch.models.transformer", "repro_torch.models.moe",
    "repro_torch.models.recsys.embedding",
    "repro_torch.models.recsys.din", "repro_torch.train.train_loop",
    "repro_torch.kernels.segment_sum_sorted", "repro_torch.tree",
    "repro_torch.configs.inputs", "repro_torch.configs.gin_tu",
    "repro_torch.configs.gat_cora", "repro_torch.configs.pna",
    "repro_torch.models.gnn", "repro_torch.models.gnn.common",
    "repro_torch.models.gnn.gin", "repro_torch.models.gnn.gat",
    "repro_torch.models.gnn.pna", "repro_torch.models.gnn.so3",
    "repro_torch.models.gnn.mace", "repro_torch.configs.mace",
    "repro_torch.obs.validate", "repro_torch.train.optimizer",
    "repro_torch.train.checkpoint", "repro_torch.distributed",
    "repro_torch.distributed.fault_tolerance", "repro_torch.launch.train",
    "repro_torch.distributed.spmd_runtime", "repro_torch.kernels.spmd_plane",
    "repro_torch.obs.cachescope", "repro_torch.obs.metrics",
    "repro_torch.obs.trace",
    "repro_torch.streaming", "repro_torch.streaming.coherence",
    "repro_torch.streaming.incremental", "repro_torch.streaming.store",
    "repro_torch.streaming.updates",
    "repro_torch.serving", "repro_torch.serving.requests",
    "repro_torch.serving.metrics", "repro_torch.serving.provider",
    "repro_torch.serving.engine", "repro_torch.serving.scheduler",
    "repro_torch.serving.closed_loop", "repro_torch.serving.workload",
    "repro_torch.serving.service",
    "repro_torch.traffic", "repro_torch.traffic.arrivals",
    "repro_torch.traffic.loadgen", "repro_torch.traffic.slo",
    "repro_torch.traffic.tenancy", "repro_torch.traffic.scoring",
    "repro_torch.launch.mesh", "repro_torch.launch.op_census",
    "repro_torch.launch.dryrun",
    os.path.join("examples", "torch", "quickstart.py"),
    os.path.join("examples", "torch", "lcc_distributed.py"),
    os.path.join("examples", "torch", "serve_lm.py"),
    os.path.join("examples", "torch", "train_lm.py"),
    os.path.join("examples", "torch", "din_ctr.py"),
])
def test_submodule_was_imported(import_report, name):
    assert name in import_report["imported"]


def test_port_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    hits = []
    scanned = 0
    for top in (os.path.join(SRC, "repro_torch"),
                os.path.join(ROOT, "examples", "torch")):
        for base, _, files in os.walk(top):
            for f in files:
                if f.endswith(".py"):
                    scanned += 1
                    path = os.path.join(base, f)
                    with open(path) as fh:
                        if pat.search(fh.read()):
                            hits.append(path)
    assert scanned > 5
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        if pat.search(fh.read()):
            hits.append("chip_smoke.py")
    assert hits == []


def test_default_device_is_cuda_and_raises_without_a_card():
    import torch

    from repro_torch.core import async_engine, rma, tric_baseline
    from repro_torch.core.partition import partition_1d
    from repro_torch.core.runtime import ShardedRuntime
    from repro_torch.device import ResidencyManager
    from repro_torch.distributed.spmd_runtime import SpmdIntersectExecutor
    from repro_torch.graphs.datasets import powerlaw_graph
    from repro_torch.kernels import delta_intersect, ops, point_query
    from repro_torch.kernels.resident_intersect import (
        resident_intersect_counts,
    )
    from repro_torch.launch import (lcc_run, query_serve, resident_timing,
                                    serve, stream_run, train)
    from repro_torch.serving import LiveQueryService, QueryEngine
    from repro_torch.streaming import DynamicCSR, StreamingLCCEngine

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
        lambda: stream_run.main(["--scale", "6", "--batches", "2"]),
        lambda: serve.main(["--arch", "stablelm-1.6b", "--smoke"]),
        lambda: serve.main(["--arch", "din", "--smoke"]),
        lambda: train.main(["--arch", "gin-tu", "--steps", "1"]),
        lambda: resident_timing.main(["--scale", "6"]),
        lambda: query_serve.main(["--smoke"]),
        lambda: LiveQueryService(g, p=2),
        lambda: QueryEngine(DynamicCSR.from_csr(g)),
        lambda: StreamingLCCEngine(g),
        lambda: ResidencyManager(DynamicCSR.from_csr(g), slots=4),
        lambda: ShardedRuntime(DynamicCSR.from_csr(g), 2, device_slots=4),
        lambda: resident_intersect_counts(rows, np.array([0]),
                                          slots_b=np.array([1]), sentinel=9),
        lambda: ops.bitmap_intersect_count(rows, rows),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the SPMD plane runs where every other path runs: not here by default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        query_serve.main(["--smoke", "--spmd", "--ranks", "2"])
    for call in (
        lambda: stream_run.main(["--scale", "6", "--spmd", "--pipeline"]),
        lambda: SpmdIntersectExecutor(partition_1d(8, 2), 8),
        lambda: StreamingLCCEngine(g, execution="spmd",
                                   runtime=ShardedRuntime(None, 2, n=g.n)),
    ):
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
