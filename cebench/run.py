"""Run one cell of the benchmark of ``anncur_tpu_torch`` on one H100.

    python3 cebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell from its seed, warms it up, measures ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output (the numbers
compared, each beside its limit, also close standard error). Exits with
another code and prints no result without a card, or when JAX, Flax or
the JAX package were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# caches at fixed paths inside the checkout, so only a cell's first run
# there builds; the port's kernels build into anncur_tpu_torch/build/
CACHE = os.path.join(ROOT, ".cebench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from cebench.lib import harness

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cebench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    run = harness.Run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start=T_START)
    result = harness.execute(run)
    found = harness.forbidden_modules()
    if found:
        print(f"cebench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
