"""``BENCHMARK.json`` against the contract it is written to, and every file it
names against the harness's layout."""
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "gpubench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def test_command_and_paths(manifest):
    cmd, paths = manifest["command"], manifest["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w:
            assert not w.startswith("/") and ".." not in w
            assert any(w.startswith(p + "/") for p in paths)
            assert (ROOT / w).is_file()


def test_names_units_and_keys(manifest):
    seen = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in {"lower",
                                                                 "higher"}
    names = [e["name"] for g in ("end_to_end", "per_layer")
             for e in manifest[g]]
    assert len(names) == len(set(names))


def test_setup_and_rooflines(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_file_exists(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in configs.values():
        assert c["file"].startswith("gpubench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        # reduced keys are the configuration's own and differ from the source
        for k in c["reduced"]:
            assert cfg[k] != cfg["published"][k]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert set(cfg["limits"]) == {"t_wrong", "lcc_rel_err"}
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    used = {w["config"] for w in manifest["workloads"]}
    assert used == set(configs)
    for w in manifest["workloads"]:
        mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
        assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
    for m in manifest["end_to_end"]:
        assert (HERE / "end_to_end" / f"{m['name']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (HERE / "layer_metrics" / f"{m['name']}.py").is_file()
    for f in HERE.rglob("*"):
        rel = str(f.relative_to(ROOT))
        if "__pycache__" not in rel:
            assert PATH.match(rel), rel


def test_cells(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in cells)


def _reports(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def test_moves_and_reporting(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = manifest["end_to_end"]
    for m in manifest["per_layer"]:
        mover = [e for e in e2e if e["name"] == m["moves"]]
        assert mover, m["name"]
        for cell in cells:
            if _reports(m, cell):
                assert _reports(mover[0], cell), (m["name"], cell)
        assert all(c in cells for c in m.get("workloads", cells))
    for cell in cells:
        mine = [e["name"] for e in e2e if _reports(e, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(m, cell) for m in manifest["per_layer"])
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
