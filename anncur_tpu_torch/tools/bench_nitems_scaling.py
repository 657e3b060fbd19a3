"""Adaptive-engine n_items scaling profile.

Counterpart of ``tools/bench_nitems_scaling.py``. The JAX driver found,
on a TPU, that adaptive serving q/s stays flat from 10,000 to 104,520
items once the train matrix stays on the device (DESIGN §27-28 of that
package); this driver measures the same curve on the port: at each
``--n_items`` (ZeShEL-military's 104,520 entities is the largest world of
the reference, utils/zeshel_utils.py:6-42), the latency driver's
bert-base world (``_common.BASE_WORLD`` at that item count), the fixed
path at b=8 as the control, adaptive q/s at each of ``--batches`` (JAX:
b=1, b=8 and b=512), a rounds-attribution probe (the same budget in one
round at b=8: round 0's CE work does not depend on n_items, so the
difference is the per-round O(n_items) work) and, with
``--shortlist_also L``, the adaptive rows at b <= 8 again with rounds 2+
picking from a batch-shared L-item shortlist.

    python -m anncur_tpu_torch.tools.bench_nitems_scaling [--n_items 10000 30000 104520]
    python -m anncur_tpu_torch.tools.bench_nitems_scaling --cpu --n_items 600 1200 --batches 1 4 --reps 1

``--cpu`` is the tiny run: a tiny CE and world on the CPU. The JAX
driver's default budget is the headline matched budget of
benchmarks/adaptive_matched_recall.json, 210.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from anncur_tpu_torch.core.adaptive_fused import split_rounds
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device

HEADLINE_BUDGET = 210


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(_common.RESULTS_DIR, "nitems_scaling.json"))
    ap.add_argument("--n_items", type=int, nargs="+", default=[10000, 30000, 104520])
    ap.add_argument("--budget", type=int, default=HEADLINE_BUDGET)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 512], help="adaptive batches timed")
    ap.add_argument("--shortlist", type=int, default=0,
                    help="rounds 2+ pick candidates from a shared L-item shortlist instead of the full corpus "
                    "(applies to ALL adaptive rows)")
    ap.add_argument("--shortlist_also", type=int, default=2048,
                    help="additionally time the adaptive rows at b <= 8 with this shortlist at each scale "
                    "(0 disables)")
    ap.add_argument("--skip_b512", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="tiny run: a tiny CE and world on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    batches = [b for b in args.batches if not (args.skip_b512 and b == 512)]

    base = _common.TINY_WORLD if args.cpu else _common.BASE_WORLD
    encoder = _common.make_encoder(args.cpu, device)
    out = {"device": _common.card(device), "budget": args.budget, "rounds": args.rounds,
           "shortlist": args.shortlist, "world": {k: v for k, v in base.items() if k != "n_items"}, "scales": {}}
    for n_items in args.n_items:
        retriever, train_scores, rng = _common.build_retriever(encoder, **dict(base, n_items=n_items))
        train_dev = torch.as_tensor(train_scores, device=device)
        vocab, lm = encoder.spec.vocab_size, base["seq_len"]
        scale = {"padded_items": retriever._padded_n_items()}

        def timed(name, fn, b):
            t0 = time.perf_counter()
            fn()
            first_s = time.perf_counter() - t0
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            med = float(np.median(times))
            row = {"p50_ms": med * 1000.0, "qps": b / med, "first_s": first_s, "times_s": times}
            scale[name] = row
            print(json.dumps({f"n{n_items}.{name}": row}), flush=True)

        def ada(b, n_rounds, shortlist=args.shortlist):
            qt = rng.integers(1, vocab, size=(b, lm)).astype(np.int32)
            return lambda: retriever.query_tokens_adaptive_fused(
                qt, total_budget=args.budget, n_rounds=n_rounds, top_k=10, train_scores=train_dev, method="cur",
                shortlist=shortlist or None,
            )

        qt8 = rng.integers(1, vocab, size=(8, lm)).astype(np.int32)
        timed("fixed_b8", lambda: retriever.query_tokens_batch(qt8, top_k=10, top_k_retvr=100), 8)
        for b in batches:
            timed(f"adaptive_b{b}", ada(b, args.rounds), b)
            if b == 8:
                # the same CE budget in ONE round: no completion rounds, so
                # what remains is the n_items-independent CE scoring
                timed("adaptive_b8_r1", ada(8, 1), 8)
        sl = args.shortlist_also
        if sl and not args.shortlist:
            first, per, nr = split_rounds(args.budget, args.rounds)
            for b in (b for b in batches if b <= 8):
                # the retriever drops a shortlist that cannot hold the
                # batch's picks: such a row would time the full engine
                need = first + b * per + per * max(1, nr - 2)
                if sl < need or sl >= n_items:
                    print(f"# skip adaptive_b{b}_sl{sl}: guard (need {need}, n_items {n_items})", flush=True)
                    continue
                timed(f"adaptive_b{b}_sl{sl}", ada(b, args.rounds, sl), b)
        out["scales"][str(n_items)] = scale
        del retriever, train_dev
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
