"""The control's readings, that the upper ends of ``correct``'s limits are set
from, on the card at the cell's own size.

    python3 gpubench/readings.py --workload <name> --seeds 11 12 13 ...

For each seed, in one process: the cell's inputs as the benchmark makes
them, then the control: the plain reference in the program's place with its
LCC computed in bfloat16, laid out as the program lays out its output and
judged by the benchmark's own comparison. Prints one JSON line a seed with
the numbers beside the configuration's limits. The program's readings (the
lower ends) are the ``checks`` of the benchmark's own runs. The benchmark's
runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    from run import import_paths

    import_paths()
    from gpubench import harness

    cell = harness.load_cell(ROOT, args.workload)
    drv = harness.driver_of(cell.mix)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctl = drv.inputs_only(cell.config, seed, args.device)
        checks, _ = drv.judge(ctl, [drv.control_output(ctl, args.device)],
                              args.device)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": checks,
            "control_correct": all(c["value"] <= c["limit"]
                                   for c in checks.values()),
            "seconds": time.perf_counter() - t0}), flush=True)
        del ctl
        gc.collect()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
