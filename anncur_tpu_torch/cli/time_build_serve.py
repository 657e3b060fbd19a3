"""Phases 3, 4 and 6 of one checkout's ``chip_smoke.py``: build pairs/s,
cost-600 q/s and adaptive (210 over 8) q/s.

    python anncur_tpu_torch/cli/time_build_serve.py [--root DIR]

Runs ``phase_build``, ``phase_serve`` and ``phase_adaptive`` of
``DIR/chip_smoke.py`` (phase 6 on phase 4's retriever; phase 5 is not
run, so its queries are other draws than a full run's) with
``DIR``'s ``anncur_tpu_torch`` (default: this checkout), so that another
commit (a ``git archive`` of it) runs on the same card in the same call;
run it for each root in turns (parent, change, change, parent). Prints
one JSON line with the root, the three rates and ``nvidia-smi``'s SM clock,
power draw, power limit and temperature after the run. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here, help="checkout whose chip_smoke.py and package run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_build_serve: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.ops import cuda_build

    cuda_build.build()
    dev = torch.device("cuda", 0)
    spec = BertSpec()
    ce = CrossEncoder(spec, cross_enc_type="default", compute_dtype=torch.bfloat16, device=dev, seed=0)
    rng = np.random.default_rng(0)
    build = chip_smoke.phase_build(ce, spec, dev, rng)
    serve = chip_smoke.phase_serve(ce, spec, dev, rng)
    adaptive = chip_smoke.phase_adaptive(serve["retriever"], serve["train"], spec, dev, rng)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "build_pairs_per_s": build["pairs_per_s"],
                      "cost600_qps": serve["qps"], "adaptive_qps": adaptive["qps"], "smi": smi}), flush=True)


if __name__ == "__main__":
    main()
