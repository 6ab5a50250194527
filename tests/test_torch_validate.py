"""The port's validator (``repro_torch.obs.validate``) against the
reference's (``repro.obs.validate``): the same violation lists, printed
lines and ``main`` exit codes on the ``--trace`` / ``--metrics`` /
``--cache-trace`` artifacts of the port's launchers (``lcc_run``,
``stream_run`` on the loop and with ``--spmd --pipeline``, ``query_serve``
on the loop and with ``--spmd --pipeline``), run on the CPU at small scale,
and on corrupted copies of them."""
import contextlib
import copy
import io
import json

import pytest

from repro.obs import validate as ref_validate
from repro_torch.launch import lcc_run, query_serve, stream_run
from repro_torch.obs import validate

LAUNCHERS = {
    "lcc_run": (lcc_run, ["--scale", "7", "--p", "2", "--n-rounds", "2"]),
    "stream_run": (stream_run, ["--scale", "8", "--batches", "4",
                                "--device-tier", "--cache-rows", "64"]),
    "stream_run_spmd": (stream_run, ["--scale", "8", "--batches", "4",
                                     "--p", "4", "--spmd", "--pipeline"]),
    "query_serve": (query_serve, ["--smoke"]),
    "query_serve_spmd": (query_serve, ["--smoke", "--ranks", "4", "--spmd",
                                       "--pipeline"]),
}
KINDS = (("trace", "--trace", "validate_trace"),
         ("metrics", "--metrics", "validate_metrics"),
         ("cachescope", "--cachescope", "validate_cachescope"))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """launcher -> {kind: path} of its three artifacts, written on the CPU."""
    out = {}
    for name, (mod, argv) in LAUNCHERS.items():
        d = tmp_path_factory.mktemp(name)
        paths = {k: str(d / f"{k}.json") for k, _, _ in KINDS}
        with contextlib.redirect_stdout(io.StringIO()):
            rc = mod.main(argv + ["--device", "cpu",
                                  "--trace", paths["trace"],
                                  "--metrics", paths["metrics"],
                                  "--cache-trace", paths["cachescope"]])
        assert rc == 0, name
        out[name] = paths
    return out


def _main(mod, paths, capsys):
    argv = []
    for kind, flag, _ in KINDS:
        argv += [flag, paths[kind]]
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def _verdicts(mod, paths):
    out = {}
    for kind, _, fn in KINDS:
        with open(paths[kind]) as f:
            out[kind] = getattr(mod, fn)(json.load(f))
    return out


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_both_validators_accept_the_ports_artifacts(artifacts, launcher,
                                                    capsys):
    paths = artifacts[launcher]
    got, want = _verdicts(validate, paths), _verdicts(ref_validate, paths)
    assert got == want == {"trace": [], "metrics": [], "cachescope": []}
    rc, out = _main(validate, paths, capsys)
    ref_rc, ref_out = _main(ref_validate, paths, capsys)
    assert (rc, out) == (ref_rc, ref_out)
    assert rc == 0 and out.strip().endswith("[validate] OK")


def _x_without_dur(doc):
    ev = next(e for e in doc["traceEvents"] if e.get("ph") == "X")
    del ev["dur"]


def _crossing_spans(doc):
    doc["traceEvents"] += [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "pid": 99,
         "tid": 99},
        {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0, "pid": 99,
         "tid": 99}]


def _bump(name, **match):
    def corrupt(doc):
        row = next(r for r in doc["counters"] if r["name"] == name
                   and all(r[k] == v for k, v in match.items()))
        row["value"] += 1
    return corrupt


def _host_hits_off_by_one(doc):
    s = next(s for s in doc["streams"] if s["tier"] == "host_cache")
    s["live"]["hits"] += 1


def _schema(doc):
    doc["schema"] = "no.such.schema/v0"


# name -> (launcher, artifact kind, corruption, a violation it must raise)
CORRUPTIONS = {
    "x_event_without_dur": ("stream_run", "trace", _x_without_dur,
                            "bad dur None"),
    "crossing_spans": ("lcc_run", "trace", _crossing_spans,
                       "span 'b' [5.000, 15.000) overlaps 'a'"),
    "local_plus_remote_reads": ("query_serve", "metrics",
                                _bump("local_reads", tier="host", rank=0),
                                "rank 0: local_reads + remote_reads != "
                                "row_requests"),
    "rma_rows_measured": ("query_serve_spmd", "metrics",
                          _bump("rma_rows_measured", tier="wire"),
                          "rma_rows: measured"),
    "host_hits_off_by_one": ("query_serve_spmd", "cachescope",
                             _host_hits_off_by_one,
                             "replay does not reconcile (hits: live"),
    "unknown_metrics_schema": ("stream_run_spmd", "metrics", _schema,
                               "unknown snapshot schema"),
    "unknown_cachescope_schema": ("stream_run", "cachescope", _schema,
                                  "unknown cachescope schema"),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_both_validators_refuse_a_corrupted_artifact(artifacts, case,
                                                     tmp_path, capsys):
    launcher, kind, corrupt, message = CORRUPTIONS[case]
    paths = dict(artifacts[launcher])
    with open(paths[kind]) as f:
        doc = json.load(f)
    bad = copy.deepcopy(doc)
    corrupt(bad)
    paths[kind] = str(tmp_path / f"{kind}.json")
    with open(paths[kind], "w") as f:
        json.dump(bad, f)
    got, want = _verdicts(validate, paths), _verdicts(ref_validate, paths)
    assert got == want
    assert any(message in m for m in got[kind]), got[kind]
    assert all(not v for k, v in got.items() if k != kind)
    rc, out = _main(validate, paths, capsys)
    ref_rc, ref_out = _main(ref_validate, paths, capsys)
    assert (rc, out) == (ref_rc, ref_out)
    assert rc == 1 and out.strip().endswith("[validate] FAIL")


def test_main_refuses_an_empty_call_as_the_reference(capsys):
    for mod in (validate, ref_validate):
        with pytest.raises(SystemExit) as exc:
            mod.main([])
        assert exc.value.code == 2
        assert "nothing to validate" in capsys.readouterr().err
