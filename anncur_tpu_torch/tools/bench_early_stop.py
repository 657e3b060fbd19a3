"""Early-stop adaptive serving benchmark.

Counterpart of ``tools/bench_early_stop.py``. The early-stop engine
(``CurRetriever.query_tokens_adaptive_fused`` with ``escalate_budget``)
makes every query pay the base budget, and only queries whose top-k set
still changed in the last base round resume and spend the difference.
This driver measures, for the headline config of the committed
``benchmarks/adaptive_matched_recall.json`` (``b100r5_e210r8``), at
q = 512 over the serving world's 10,000 items (bert-base, bf16;
``_common.BASE_WORLD``, ``chip_smoke.py`` phase 4's):

1. q/s through the public serving call at the two extremes, forced by
   ``stability_overlap``: ``stable_all`` (0.0, no row escalates) and
   ``escalate_all`` (1.01, every row does), and ``natural`` (1.0);
2. the escalation's time per power-of-two bucket: the engine's own
   continuation (``adaptive_continue`` through the retriever's scorer and a
   CUR completer), on synthetic resume state;
3. per committed scenario, the q/s derived from its calibrated escalated
   share: phase 1's time plus the escalation time of its bucket at q.

JAX recorded compile seconds per bucket, since each bucket was a program
of its own. The port compiles nothing per bucket (eager PyTorch; the
kernels are built once per checkout), so each row records its first
call's seconds instead, and the output says so.

    python -m anncur_tpu_torch.tools.bench_early_stop [--q 512] [--reps 3]
    python -m anncur_tpu_torch.tools.bench_early_stop --cpu

``--cpu`` is a tiny run (a tiny CE, 1,000 items, q = 16) on the CPU, with
torch at one thread (a threaded batched solve of 158 rows or more hangs
there). Writes ``results/torch/early_stop_serving.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from anncur_tpu_torch.core.adaptive_fused import CurCompleter, _bucket_size, adaptive_continue
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device

AMR_PATH = os.path.join(_common.CHECKOUT, "benchmarks", "adaptive_matched_recall.json")
# the three forced regimes: (row, stability_overlap)
REGIMES = (("stable_all", 0.0), ("natural", 1.0), ("escalate_all", 1.01))
PER_BUCKET = "none: eager PyTorch, kernels built once per checkout; rows give their first call's seconds"


def headline_config(path=AMR_PATH):
    """(the artifact, its early-stop headline) of the committed sweep."""
    with open(path) as fin:
        amr = json.load(fin)
    return amr, amr["headline_early_stop"]


def timed(fn, reps, device):
    """(first call's seconds, each later call's seconds, the last result)."""
    t0 = time.perf_counter()
    out = fn()
    _common.sync(device)
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _common.sync(device)
        times.append(time.perf_counter() - t0)
    return first, times, out


def e2e_kwargs(es, train_dev, overlap):
    return dict(
        total_budget=es["base_budget"], n_rounds=es["base_rounds"], top_k=10, train_scores=train_dev, method="cur",
        escalate_budget=es["escalate_budget"], escalate_rounds=es["escalate_rounds"], stability_overlap=overlap,
        return_stats=True,
    )


def buckets_up_to(q):
    """The escalation's power-of-two buckets, 8 (``_bucket_size``'s floor)
    up to and including q."""
    out, b = [], 8
    while b < q:
        out.append(b)
        b *= 2
    return out + [q]


def bucket_rows(retriever, train_scores, qt, es, reps, rng, device):
    """The escalation's seconds per bucket: ``adaptive_continue`` from
    synthetic resume state (distinct valid ids, random scores; its cost
    depends on the shapes only) through the retriever's scorer."""
    n_items = retriever.item_tokens.shape[0]
    base, extra = es["base_budget"], es["escalate_budget"] - es["base_budget"]
    items = retriever._device_consts()[0]
    train_t = torch.zeros((retriever._padded_n_items(), train_scores.shape[0]), dtype=torch.float32, device=device)
    train_t[:n_items] = torch.as_tensor(train_scores, device=device).T
    completer = CurCompleter(train_t, 1e-6)
    q = qt.shape[0]
    st_ids = torch.as_tensor(np.stack([rng.choice(n_items, size=base, replace=False) for _ in range(q)]), device=device)
    st_vals = torch.as_tensor(rng.standard_normal((q, base)).astype(np.float32), device=device)
    qtoks = torch.as_tensor(qt, device=device)
    rows = {}
    for b_pad in buckets_up_to(q):
        scorer = retriever._adaptive_scorer(qtoks[:b_pad], items)
        first, times, _ = timed(lambda: adaptive_continue(
            scorer, completer, st_ids[:b_pad], st_vals[:b_pad], extra, es["escalate_rounds"], 10, n_items,
        ), reps, device)
        rows[str(b_pad)] = {"med_s": float(np.median(times)), "first_call_s": first, "times_s": times}
        print(json.dumps({f"phase2_b{b_pad}": rows[str(b_pad)]}), flush=True)
    return rows


def per_scenario(amr, es, q, t_phase1, buckets):
    """Each committed scenario's q/s at q, from its calibrated escalated
    share: phase 1's time plus its bucket's escalation time."""
    base, extra = es["base_budget"], es["escalate_budget"] - es["base_budget"]
    out = {}
    for scen, s in amr["scenarios"].items():
        cfg = s["early_stop"]["configs"][es["config"]]
        n_esc = int(round(cfg["frac_escalated"] * q))
        bucket = _bucket_size(n_esc, q) if n_esc else 0
        t = t_phase1 + (buckets[str(bucket)]["med_s"] if bucket else 0.0)
        out[scen] = {
            "calibrated_frac_escalated": cfg["frac_escalated"], "bucket_at_q": bucket, "derived_qps": q / t,
            "avg_budget_at_q": base + extra * bucket / q, "recall_vs_fixed600": cfg["recall"],
        }
        print(json.dumps({scen: out[scen]}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(_common.RESULTS_DIR, "early_stop_serving.json"))
    ap.add_argument("--q", type=int, default=None, help="queries per batch (512; 16 with --cpu)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--skip_buckets", action="store_true", help="only the three end-to-end rows")
    ap.add_argument("--cpu", action="store_true", help="tiny run on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)  # the threaded batched solve hangs at S >= ~158 on the CPU
    try:
        return run(args, device)
    finally:
        torch.set_num_threads(threads)


def run(args, device):
    amr, es = headline_config()
    world = dict(_common.TINY_WORLD, n_items=1000) if args.cpu else _common.BASE_WORLD
    q = args.q or (16 if args.cpu else 512)
    retriever, train_scores, rng = _common.build_retriever(_common.make_encoder(args.cpu, device), **world)
    train_dev = torch.as_tensor(train_scores, device=device)
    qt = rng.integers(1, retriever.encoder.spec.vocab_size, size=(q, world["seq_len"])).astype(np.int32)
    results = {
        "device": _common.card(device), "config": es["config"], "q": q, "n_items": world["n_items"],
        "world": world, "compile_per_bucket": PER_BUCKET, "e2e": {},
    }
    meds = {}
    for name, overlap in REGIMES:
        first, times, (_, _, stats) = timed(
            lambda: retriever.query_tokens_adaptive_fused(qt, **e2e_kwargs(es, train_dev, overlap)), args.reps, device)
        meds[name] = float(np.median(times))
        results["e2e"][name] = {
            "stability_overlap": overlap, "qps": q / meds[name], "med_s": meds[name], "first_call_s": first,
            "avg_budget": stats["avg_budget"], "frac_escalated": stats["frac_escalated"], "times_s": times,
        }
        print(json.dumps({name: results["e2e"][name]}), flush=True)
    if not args.skip_buckets:
        results["phase2_buckets"] = bucket_rows(retriever, train_scores, qt, es, args.reps, rng, device)
        results["per_scenario"] = per_scenario(amr, es, q, meds["stable_all"], results["phase2_buckets"])
    _common.write_json(args.out, results)
    return results


if __name__ == "__main__":
    main()
