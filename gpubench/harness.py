"""The general part of the benchmark: find a cell's files by the names in
``BENCHMARK.json``, set the cell up, run its measured window, read its
metrics, judge its outputs against the plain reference, print the line.

A cell's mix (``mixes/<traffic>.json``) names its driver (``drivers/<driver>.py``),
which provides::

    set_up(cfg, mix, seed, device, span) -> state   # the timed set-up
    step(state) -> output                           # one timed step
    release(state) -> None                          # free the program's state
    judge(state, outputs, device) -> (checks, n_failed)

``checks`` maps a short name to ``{"value": v, "limit": l}``; a run is correct
iff every ``value <= limit``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import random
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from . import devtrace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HERE = pathlib.Path(__file__).resolve().parent
NO_DEVICE_EXIT = 3


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]  # the configuration's file
    mix: Dict[str, Any]  # the traffic mix's file
    end_to_end: List[Dict[str, Any]]  # metric entries this cell reports
    per_layer: List[Dict[str, Any]]


def _reports(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: pathlib.Path, workload: str) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)],
    )


def load_module(path: pathlib.Path):
    """Import one file of the benchmark by its path (names may hold ``-``
    and ``.``)."""
    name = "gpubench._file_" + "".join(
        ch if ch.isalnum() else "_" for ch in str(path.relative_to(HERE)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver_of(mix: Dict[str, Any]):
    return load_module(HERE / "drivers" / f"{mix['driver']}.py")


class Spans:
    """Host-clock spans the harness puts around its calls into the program."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


@dataclasses.dataclass
class Run:
    """What the metric readers see of one run."""

    cell: Cell
    state: Any
    spans: Spans
    setup_s: float
    step_s: List[float]  # host time of every step of the window
    window_s: float
    memory_peak_bytes: Optional[int]
    device_kind: str
    trace: Optional[devtrace.DeviceTrace] = None

    def roofline_bytes(self, name: str) -> Optional[float]:
        """The least bytes of ``rooflines/<name>.py`` for this run's state."""
        return load_module(HERE / "rooflines" / f"{name}.py").least_bytes(
            self.state)

    def kernel_roofline(self, kernel: str, name: str) -> Optional[float]:
        """Percent of the roofline of the kernel ``kernel``:
        ``rooflines/<name>.py``'s bytes at the card's memory rate over the
        kernel's traced device time a step."""
        if self.trace is None or not self.step_s:
            return None
        dev_s = self.trace.device_seconds(kernel) / len(self.step_s)
        nbytes, rate = self.roofline_bytes(name), self.peak("hbm_bytes_per_s")
        if dev_s <= 0 or not nbytes or not rate:
            return None
        return 100.0 * nbytes / rate / dev_s

    def peak(self, key: str) -> Optional[float]:
        """The card's published ``key`` from ``peaks.json``, or None for a
        device it does not list."""
        peaks = json.loads((HERE / "peaks.json").read_text())["devices"]
        return peaks.get(self.device_kind, {}).get(key)


class Reservoir:
    """A uniform sample of at most ``k`` of a stream's items, drawn from the
    seed; the last item is always kept besides."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items: List[Any] = []
        self.seen = 0
        self.last: Any = None

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1
        self.last = item

    def sample(self) -> List[Any]:
        return self.items + ([self.last] if not any(
            i is self.last for i in self.items) else [])


def closed_loop(step: Callable, state, seconds: float, keep: Reservoir,
                annotate: Callable = contextlib.nullcontext):
    """Steps back to back until ``seconds`` have passed since the first began;
    returns (host seconds of each step, window seconds)."""
    times: List[float] = []
    t0 = end = time.perf_counter()
    while end - t0 < seconds:
        with annotate(devtrace.STEP):
            s = time.perf_counter()
            out = step(state)
            end = time.perf_counter()
        times.append(end - s)
        keep.offer(out)
    return times, end - t0


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that the
    run must not load, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _metrics(entries, folder: str, run: Run) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in entries:
        value = load_module(HERE / folder / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> Dict[str, Any]:
    """Set up, measure, read and judge one run; returns the result line's
    object (``checks`` last). ``t_start`` is when the run began: set-up is
    counted from it."""
    spans = Spans()
    spans.seconds["start_and_imports"] = time.perf_counter() - t_start
    import torch

    cuda = device.startswith("cuda")
    with spans("open_device"):
        if cuda:
            torch.cuda.init()
            torch.empty(1, device=device)
            torch.cuda.reset_peak_memory_stats(device)
    drv = driver_of(cell.mix)
    state = drv.set_up(cell.config, cell.mix, seed, device, spans)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    keep = Reservoir(int(cell.mix["sampled_steps"]), seed)
    dtrace = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        span = min(seconds, float(cell.mix["trace_seconds"]))
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW):
                times, window_s = closed_loop(drv.step, state, span, keep,
                                              record_function)
        dtrace = devtrace.reduce(prof.events())
    else:
        times, window_s = closed_loop(drv.step, state, seconds, keep)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    run = Run(cell=cell, state=state, spans=spans, setup_s=setup_s,
              step_s=times, window_s=window_s, memory_peak_bytes=peak,
              device_kind=kind, trace=dtrace)
    if trace:
        metrics = _metrics(cell.per_layer, "layer_metrics", run)
    else:
        metrics = _metrics(cell.end_to_end, "end_to_end", run)

    # the reference runs once the peak is read and the program's state freed
    drv.release(state)
    t_ref = time.perf_counter()
    checks, n_failed = drv.judge(state, keep.sample(), device)
    reference_s = time.perf_counter() - t_ref
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": peak if peak is not None else 0}
    if cuda:
        dev["power_limit"] = _power_limit()
    result: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(times), "failed": n_failed,
        "metrics": metrics, "device": dev,
    }
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = {
            "device_ops": devtrace.DeviceTrace.top(dtrace.device_by_name),
            "idle_gaps": devtrace.DeviceTrace.top(dtrace.idle_by_host)}
    result["setup_spans"] = spans.seconds
    result["reference_s"] = reference_s
    result["checks"] = checks
    return result


def check_lines(checks: Dict[str, Dict[str, Any]]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]


def main(root: pathlib.Path, workload: str, seed: int, seconds: float,
         trace: bool, t_start: float) -> int:
    cell = load_cell(root, workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return NO_DEVICE_EXIT
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return NO_DEVICE_EXIT
    result = run_cell(cell, seed, seconds, trace, "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for m in result["metrics"].values():
        if not math.isfinite(m["value"]):
            print(f"a metric is not finite: {result['metrics']}",
                  file=sys.stderr)
            return 5
    sys.stdout.flush()
    print("\n".join(check_lines(result["checks"])), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
