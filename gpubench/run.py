"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Needs as many CUDA devices as the cell asks
for: without them it exits with code 3 and prints no result. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit); the same checks are
the last lines of standard error.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def import_paths() -> None:
    """Make ``gpubench`` and the port (``src/``) importable, and the files of
    this folder importable only as ``gpubench.*``."""
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path
                   if p and str(pathlib.Path(p).resolve()) != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import_paths()
    # kernel caches at fixed paths inside the checkout (the port builds its
    # CUDA libraries into build/repro_torch/ by itself)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    from gpubench import harness

    return harness.main(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start)


if __name__ == "__main__":
    raise SystemExit(main())
