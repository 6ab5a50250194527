"""The slice as a whole: the port's epoch engine (``device="cpu"``, plain
torch versions of the kernels) against the reference JAX engine.

p = 1 runs both engines in-process. p in {2, 4, 8} needs that many JAX
devices, which are pinned at first init, so one subprocess runs the
reference under ``--xla_force_host_platform_device_count=8`` and writes its
compiled problems and results to an ``.npz``; the parent carries each
problem over with ``ShardedLCCProblem.from_reference`` and runs the port on
it. Tolerances: ``t`` bit-for-bit (int32); ``lcc`` float32 vs the JAX
engine ``rtol=1e-6`` (same formula, same precision) and vs the float64
host oracle ``rtol=1e-5``.
"""
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from repro_torch.core import async_engine, rma, tric_baseline, triangles
from repro_torch.core.lcc import lcc_distributed
from repro_torch.graphs.datasets import powerlaw_graph
from repro_torch.launch import lcc_run

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
METHODS = ("bsearch", "pairwise", "hybrid")
PROBLEM_ARRAYS = ("rows_ext", "degrees", "edge_u", "edge_vc", "edge_mask",
                  "serve_idx", "cache_rows", "cache_ids")
PROBLEM_SCALARS = ("n", "p", "width", "n_loc", "e_max", "n_rounds", "s_max",
                   "n_rounds_requested", "dedup_rounds")


def same_engine_output(got, want):
    (t, lcc), (want_t, want_lcc) = got, want
    assert t.dtype == np.int32 and lcc.dtype == np.float32
    assert want_t.dtype == np.int32 and want_lcc.dtype == np.float32
    assert t.shape == want_t.shape and lcc.shape == want_lcc.shape
    assert np.array_equal(t, want_t)
    np.testing.assert_allclose(lcc, want_lcc, rtol=1e-6)


# --------------------------------------------------------------------------
# p = 1, in-process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cache_rows", [0, 16])
@pytest.mark.parametrize("method", METHODS)
def test_engine_p1_matches_jax_engine(method, cache_rows):
    from repro.core.async_engine import lcc_pipelined as ref_lcc_pipelined
    from repro.core.cache import build_static_degree_cache
    from repro.core.rma import build_sharded_problem
    from repro.graphs.datasets import powerlaw_graph as ref_powerlaw_graph

    g = ref_powerlaw_graph(80, 6, seed=0)
    c = build_static_degree_cache(g.degrees, cache_rows) if cache_rows else None
    ref_prob = build_sharded_problem(g, 1, n_rounds=2, cache=c)
    want = ref_lcc_pipelined(ref_prob, method=method)
    prob = rma.ShardedLCCProblem.from_reference(ref_prob)
    same_engine_output(
        async_engine.lcc_pipelined(prob, "cpu", method=method), want)
    # the moved problem is accepted as well, and gives the same bits
    same_engine_output(
        async_engine.lcc_pipelined(prob.to_device("cpu"), "cpu", method=method),
        want)


@pytest.mark.parametrize("method", METHODS)
def test_run_distributed_lcc_matches_host_oracle(method):
    g = powerlaw_graph(80, 6, seed=0)
    t, lcc = async_engine.run_distributed_lcc(
        g, 4, n_rounds=3, cache_rows=8, method=method, device="cpu")
    assert t.dtype == np.int64 and lcc.dtype == np.float64
    assert np.array_equal(t, triangles.triangles_per_vertex(g))
    np.testing.assert_allclose(lcc, triangles.lcc_scores(g), rtol=1e-5)
    t2, _ = lcc_distributed(g, 4, n_rounds=3, cache_rows=8, method=method,
                            device="cpu")
    assert np.array_equal(t2, t)


@pytest.mark.parametrize("method", METHODS)
def test_engine_slab_walk_is_invisible(monkeypatch, method):
    g = powerlaw_graph(120, 8, seed=1)
    prob = rma.build_sharded_problem(g, 4, n_rounds=2)
    whole = async_engine.lcc_pipelined(prob, "cpu", method=method)
    # 7 pair rows per slab: several ragged slabs per round
    monkeypatch.setattr(async_engine, "_PAIR_SLAB_BYTES", 7 * 4 * prob.width)
    same_engine_output(
        async_engine.lcc_pipelined(prob, "cpu", method=method), whole)


def test_engine_rejects_unknown_method_and_misplaced_problem():
    g = powerlaw_graph(40, 4, seed=0)
    prob = rma.build_sharded_problem(g, 2, n_rounds=2)
    with pytest.raises(ValueError, match="method"):
        async_engine.lcc_pipelined(prob, "cpu", method="merge")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        # a CPU-resident problem cannot be run "on cuda" here either
        async_engine.lcc_pipelined(prob.to_device("cpu"), "cuda")


# --------------------------------------------------------------------------
# p in {2, 4, 8}: the reference runs in one subprocess with 8 host devices
# --------------------------------------------------------------------------
MULTIDEV_SCRIPT = r"""
from repro.distributed.spmd_runtime import ensure_host_devices
ensure_host_devices(8)  # must precede jax init
import contextlib, io, sys
import numpy as np
from repro.graphs.datasets import powerlaw_graph
from repro.core.async_engine import lcc_pipelined
from repro.core.cache import build_static_degree_cache
from repro.core.rma import build_sharded_problem
from repro.core.tric_baseline import tric_lcc_jnp
from repro.launch import lcc_run

out = {}
csr = powerlaw_graph(160, 8, seed=0)
for p in (2, 4, 8):
    for cache_rows in (0, 16):
        cache = (build_static_degree_cache(csr.degrees, cache_rows)
                 if cache_rows else None)
        prob = build_sharded_problem(csr, p, n_rounds=3, cache=cache)
        key = f"p{p}_c{cache_rows}"
        for f in ("rows_ext", "degrees", "edge_u", "edge_vc", "edge_mask",
                  "serve_idx", "cache_rows", "cache_ids"):
            out[f"{key}_{f}"] = getattr(prob, f)
        for f in ("n", "p", "width", "n_loc", "e_max", "n_rounds", "s_max",
                  "n_rounds_requested", "dedup_rounds"):
            out[f"{key}_{f}"] = np.asarray(getattr(prob, f))
        for k, (u, v) in enumerate(prob.works):
            out[f"{key}_works_u{k}"] = u
            out[f"{key}_works_v{k}"] = v
        for method in ("bsearch", "pairwise", "hybrid"):
            t, lcc = lcc_pipelined(prob, method=method)
            out[f"{key}_{method}_t"] = t
            out[f"{key}_{method}_lcc"] = lcc
t, lcc = tric_lcc_jnp(csr, 4)
out["tric_t"], out["tric_lcc"] = t, lcc
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = lcc_run.main(["--scale", "8", "--p", "4", "--verify"])
out["lcc_run_rc"] = np.asarray(rc)
out["lcc_run_stdout"] = np.asarray(buf.getvalue())
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_engine") / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", MULTIDEV_SCRIPT, str(path)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def carried_problem(runs, key):
    p = int(runs[f"{key}_p"])
    obj = types.SimpleNamespace(
        **{f: runs[f"{key}_{f}"] for f in PROBLEM_ARRAYS},
        **{f: runs[f"{key}_{f}"].item() for f in PROBLEM_SCALARS},
        works=[(runs[f"{key}_works_u{k}"], runs[f"{key}_works_v{k}"])
               for k in range(p)],
        part=types.SimpleNamespace(n=int(runs[f"{key}_n"]), p=p),
    )
    return rma.ShardedLCCProblem.from_reference(obj)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("cache_rows", [0, 16])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_engine_multirank_matches_jax_engine(reference_runs, p, cache_rows,
                                             method):
    key = f"p{p}_c{cache_rows}"
    prob = carried_problem(reference_runs, key)
    # the carried problem equals the port's own build, field for field
    g = powerlaw_graph(160, 8, seed=0)
    from repro_torch.core.cache import build_static_degree_cache

    own = rma.build_sharded_problem(
        g, p, n_rounds=3,
        cache=build_static_degree_cache(g.degrees, cache_rows)
        if cache_rows else None)
    rma.assert_problems_equal(prob, own)
    assert np.array_equal(prob.serve_idx, own.serve_idx)
    got = async_engine.lcc_pipelined(prob, "cpu", method=method)
    want = (reference_runs[f"{key}_{method}_t"],
            reference_runs[f"{key}_{method}_lcc"])
    same_engine_output(got, want)
    # and the float64 host oracle
    t_glob = np.concatenate([got[0][k, : prob.part.hi(k) - prob.part.lo(k)]
                             for k in range(p)])
    lcc_glob = np.concatenate([got[1][k, : prob.part.hi(k) - prob.part.lo(k)]
                               for k in range(p)])
    assert np.array_equal(t_glob, triangles.triangles_per_vertex(g))
    np.testing.assert_allclose(lcc_glob, triangles.lcc_scores(g), rtol=1e-5)


def test_tric_baseline_exact(reference_runs):
    g = powerlaw_graph(160, 8, seed=0)
    t, lcc = tric_baseline.tric_lcc_torch(g, 4, device="cpu")
    same_engine_output((t, lcc),
                       (reference_runs["tric_t"], reference_runs["tric_lcc"]))
    part = rma.partition_1d(g.n, 4)
    t_glob = np.concatenate([t[k, : part.hi(k) - part.lo(k)] for k in range(4)])
    assert np.array_equal(t_glob, triangles.triangles_per_vertex(g))
    prob = tric_baseline.tric_problem(g, 4)
    assert prob.n_rounds == 1 and prob.cache_ids.size == 0


def test_lcc_run_matches_reference_launcher(reference_runs, capsys):
    rc = lcc_run.main(["--scale", "8", "--p", "4", "--device", "cpu",
                       "--verify"])
    out = capsys.readouterr().out
    assert rc == 0 and int(reference_runs["lcc_run_rc"]) == 0
    ref_out = str(reference_runs["lcc_run_stdout"])

    def facts(text):
        return (re.search(r"^graph .*$", text, re.M).group(0),
                re.search(r"triangles=(\d+)", text).group(1),
                re.search(r"comm_bytes=([\d,]+)", text).group(1),
                re.search(r"^CLaMPI-sim: .*$", text, re.M).group(0))

    assert facts(out) == facts(ref_out)
    assert "verified exact vs single-node reference" in out
    assert "verified exact vs single-node reference" in ref_out


def test_lcc_run_writes_trace_metrics_and_cache_sidecar(tmp_path, capsys):
    trace, metrics, side = (tmp_path / "t.json", tmp_path / "m.json",
                            tmp_path / "c.json")
    rc = lcc_run.main(["--scale", "7", "--p", "2", "--device", "cpu",
                       "--n-rounds", "2", "--trace", str(trace),
                       "--metrics", str(metrics), "--cache-trace", str(side)])
    assert rc == 0
    out = capsys.readouterr().out
    for path in (trace, metrics, side):
        assert path.stat().st_size > 0 and str(path) in out
    # the reference's validator accepts the port's artifacts
    from repro.obs import validate

    assert validate.main(["--trace", str(trace), "--metrics", str(metrics),
                          "--cachescope", str(side)]) == 0
