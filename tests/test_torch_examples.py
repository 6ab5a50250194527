"""The port's ``examples/torch/*.py`` on the CPU (``--device cpu``, each
script's own size flags where its defaults take longer than ~20 s here),
all started together as processes of their own: each returns 0 and prints
the reference's lines; ``quickstart``'s triangle counts and
``lcc_distributed``'s exactness lines and communication volumes equal the
reference scripts' (run beside them, in processes that set their own host
device count)."""
import os
import re
import shutil
import subprocess
import sys
import tempfile

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
LCC_FLAGS = ["--scale", "9", "--p", "4"]
PORT = {
    "quickstart": [],
    "lcc_distributed": LCC_FLAGS,
    "serve_lm": [],
    "train_lm": ["--steps", "20", "--seq", "64", "--fresh"],
    "din_ctr": [],
}
REFERENCE = {"quickstart": [], "lcc_distributed": LCC_FLAGS}
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def runs():
    # few threads a process: seven of them run at once
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    ckpt = tempfile.mkdtemp(prefix="examples_ckpt_")
    procs = {}
    for name, flags in PORT.items():
        argv = [sys.executable, os.path.join(ROOT, "examples", "torch",
                                             f"{name}.py"),
                "--device", "cpu", *flags]
        if name == "train_lm":
            argv += ["--ckpt-dir", ckpt]
        procs[("port", name)] = subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    for name, flags in REFERENCE.items():
        procs[("reference", name)] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
             *flags], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
            out[key] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


@pytest.mark.parametrize("name", list(PORT))
def test_example_returns_zero(runs, name):
    rc, stdout, stderr = runs[("port", name)]
    assert rc == 0, stderr[-3000:]
    assert stdout.strip()


@pytest.mark.parametrize("name", list(REFERENCE))
def test_reference_example_returns_zero(runs, name):
    rc, _, stderr = runs[("reference", name)]
    assert rc == 0, stderr[-3000:]


def _lines(runs, who, name):
    return runs[(who, name)][1].strip().splitlines()


def test_quickstart_counts_equal_the_reference(runs):
    port = _lines(runs, "port", "quickstart")
    ref = _lines(runs, "reference", "quickstart")
    # every line is the reference's: the toy graph, its triangles and LCC,
    # the R-MAT graph and its triangle total (here from the epoch engine),
    # the modeled RMA simulation
    assert port == ref
    assert "triangles: 3" in port
    assert any(re.fullmatch(r"total triangles: \d+", ln) for ln in port)


def test_lcc_distributed_exactness_and_volumes_equal_the_reference(runs):
    port = _lines(runs, "port", "lcc_distributed")
    ref = _lines(runs, "reference", "lcc_distributed")
    exact = [ln for ln in port if "exact:" in ln]
    assert exact == [ln for ln in ref if "exact:" in ln]
    assert len(exact) == 3 and all(ln.endswith("exact: YES") for ln in exact)
    vol = port[port.index("communication volume (bytes, all devices):"):]
    assert vol == ref[ref.index("communication volume (bytes, all "
                                "devices):"):]
    assert len(vol) == 4
    timed = [ln for ln in port if ln.endswith("ms/iter")]
    assert len(timed) == 3
    assert all(re.fullmatch(r"  .{28} +\d+\.\d ms/iter", ln) for ln in timed)
    assert port[0] == ref[0]  # the graph line


def test_serve_lm_prints_the_reference_lines(runs):
    out = _lines(runs, "port", "serve_lm")
    assert out[0] == "batch=4 prompt=24 generated=16"
    assert re.fullmatch(r"prefill: \d+\.\d ms \(\d+ tok/s\)", out[1])
    assert re.fullmatch(r"decode:  \d+\.\d ms/token \(\d+ tok/s\)", out[2])
    assert out[3] == "sample generations (token ids):"
    assert len(out) == 6 and all(ln.endswith("...") for ln in out[4:])


def test_train_lm_prints_the_reference_lines(runs):
    out = _lines(runs, "port", "train_lm")
    assert re.fullmatch(r"model: lm-12m, \d+\.\dM params", out[0])
    assert re.fullmatch(r"steps 0\.\.20: loss \d+\.\d+ -> \d+\.\d+", out[1])
    assert re.fullmatch(r"loss improved; straggler flags: \d+", out[2])


def test_din_ctr_prints_the_reference_lines(runs):
    out = _lines(runs, "port", "din_ctr")
    m = re.fullmatch(r"train BCE: (\d+\.\d+) -> (\d+\.\d+)", out[0])
    assert m and float(m.group(2)) < float(m.group(1))
    assert re.fullmatch(r"serve: mean p\(click\|pos\)=\d\.\d{3} "
                        r"p\(click\|neg\)=\d\.\d{3}", out[1])
    assert out[2].startswith("retrieval top-10 candidate ids: [")


@pytest.fixture(scope="module")
def default_device_runs():
    """Each script with no flags: ``--device`` defaults to cuda."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", "torch",
                                      f"{name}.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in PORT}
    out = {name: p.communicate(timeout=TIMEOUT_S)[1]
           for name, p in procs.items()}
    return {name: (procs[name].returncode, err) for name, err in out.items()}


@pytest.mark.parametrize("name", list(PORT))
def test_example_raises_without_the_card_by_default(default_device_runs,
                                                    name):
    """With no card the default device fails at once: ``resolve_device``
    raises (no quiet fall back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    rc, stderr = default_device_runs[name]
    assert rc != 0
    assert "CUDA is not available" in stderr
