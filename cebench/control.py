"""The control of a cell's check: the reference computed one precision
below what the configuration states (float8 e4m3 for the bf16 model,
one TF32 pass for the f32 products), put in the program's place, and
judged by the same comparison a run makes, on the same sample. Each
driver's ``control(run)`` computes it.

    python3 cebench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed with each compared number beside the
cell's limit; every seed should come out not correct. The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cebench.lib.harness import Run, load_benchmark  # noqa: E402


def gaps(run: Run):
    """The control's numbers for ``run``'s cell, by its driver."""
    return importlib.import_module(f"cebench.drivers.{run.traffic['driver']}").control(run)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None, help="the window the run sizes its traffic by "
                   "(default: BENCHMARK.json's run_seconds)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    seconds = args.seconds or load_benchmark()["run_seconds"]
    for seed in args.seeds:
        run = Run(args.workload, seed, seconds, False, args.device)
        found = gaps(run)
        line = {name: {"value": v, "limit": run.limits[name]} for name, v in found.items()}
        line["failed_a_limit"] = any(not (v <= run.limits[name]) for name, v in found.items())
        print(json.dumps({"workload": args.workload, "seed": seed, "control": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
