"""Kernel B of one checkout, timed at ``chip_smoke.py``'s shapes.

    python anncur_tpu_torch/cli/time_mips.py [--root DIR]

Imports ``anncur_tpu_torch`` from ``--root`` (default: this checkout), so
that another commit's kernel B (a ``git archive`` of it) runs on the same
card in the same call, and times ``mips_topk_fused`` with
``chip_smoke.py``'s ``time_mips`` (this checkout's: the same yardstick for
both) at its ``MIPS_SHAPES`` (exclusions where a shape has them) and at
q=32 k=500. A shape the checkout's
wrapper rejects is reported as such. Prints one JSON line per shape with
the card and the root. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(_HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=_HERE, help="checkout whose anncur_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_mips: needs a CUDA card")
    smoke = _chip_smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = [*smoke.MIPS_SHAPES, (32, 500, 10240, 10000, 500, 0)]
    for q, d, n, n_valid, k, n_ex in shapes:
        queries, items = smoke.mips_inputs(gen, dev, q, d, n, n_valid)
        # as chip_smoke.py: a growth round's exclusions are each query's best ids
        exclude = mips_topk(queries, items, n_ex, n_valid)[1] if n_ex else None
        rec = {"root": root, "card": card}
        try:
            rec.update(smoke.time_mips(mips_topk_fused, mips_topk, queries, items, k, n_valid, flush, exclude))
        except (ValueError, TypeError) as exc:  # a checkout that predates a shape's argument
            rec.update(shape=f"q={q} d={d} n={n} n_valid={n_valid} k={k} S={n_ex} f32", rejected=str(exc))
        print(json.dumps(rec), flush=True)
        del queries, items, exclude


if __name__ == "__main__":
    main()
