"""Serving latency benchmark: per-dispatch p50/p95 for both query modes.

Counterpart of ``tools/bench_serving_latency.py``. The throughput cells
measure batched q/s; production serving also cares about the latency of a
single dispatch at small batch. This driver measures the wall clock of
each dispatch of the fixed-anchor path (cost = 500 anchors + 100 rerank
CE calls per query, the reference cost model at
run_retrieval_eval_wrt_exact_crossenc.py:480-481) and of the fused
adaptive engine (budget 150 over 5 rounds, the matched-recall config of
benchmarks/adaptive_matched_recall.json) by batch, on the bert-base CE in
bf16 over a 10,000-item corpus (``_common.BASE_WORLD``), then the time of
an /add of 16 items and of the first queries after it.

    python -m anncur_tpu_torch.tools.bench_serving_latency [--out results/torch/serving_latency.json]
    python -m anncur_tpu_torch.tools.bench_serving_latency --tiny --device cpu --reps 2   # tiny CPU run

Each mode and batch takes one untimed first dispatch, then ``--reps``
timed ones (each returns numpy, so the host waits for the card). The JAX
driver's "recompile" row (its compiled-program cache cleared after an
add) has no counterpart: the port compiles nothing per shape; an add only
restages the item constants on the device, which the first query after
it pays.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device

ADAPTIVE = dict(total_budget=150, n_rounds=5)


def time_dispatches(fn, reps: int):
    """Per-dispatch wall times in ms (``fn`` returns host numpy)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(_common.RESULTS_DIR, "serving_latency.json"))
    ap.add_argument("--reps", type=int, default=16)
    # fixed mode stops at 32 (throughput saturates there, bench.py line 2);
    # adaptive includes its 512 throughput batch
    ap.add_argument("--fixed_batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--ada_batches", type=int, nargs="+", default=[1, 8, 32, 512])
    ap.add_argument("--tiny", action="store_true", help="a tiny CE and world (CPU runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    world = _common.TINY_WORLD if args.tiny else _common.BASE_WORLD
    retriever, train_scores, rng = _common.build_retriever(_common.make_encoder(args.tiny, device), **world)
    vocab, lm = retriever.encoder.spec.vocab_size, world["seq_len"]
    # device-resident once, as a server keeps it
    train_dev = torch.as_tensor(train_scores, device=device)
    results = {}
    for mode in ("fixed", "adaptive"):
        for b in args.fixed_batches if mode == "fixed" else args.ada_batches:
            qt = rng.integers(1, vocab, size=(b, lm)).astype(np.int32)
            if mode == "fixed":
                fn = lambda: retriever.query_tokens_batch(qt, top_k=10, top_k_retvr=100)  # noqa: E731
            else:
                fn = lambda: retriever.query_tokens_adaptive_fused(  # noqa: E731
                    qt, top_k=10, train_scores=train_dev, method="cur", **ADAPTIVE)
            t0 = time.perf_counter()
            fn()  # first dispatch (discarded)
            first_s = time.perf_counter() - t0
            reps = args.reps if b <= 32 else max(4, args.reps // 3)
            times = time_dispatches(fn, reps)
            pct = _common.percentiles(times, (50, 95))
            entry = {"p50_ms": pct["p50"], "p95_ms": pct["p95"], "qps": b / (pct["p50"] / 1000.0),
                     "first_s": first_s, "reps": reps, "times_ms": times}
            results[f"{mode}_b{b}"] = entry
            print(json.dumps({f"{mode}_b{b}": entry}), flush=True)

    # time to the first query after a corpus edit: the /add itself (k_q CE
    # calls per new item and one matvec), then the first and second
    # single-query dispatches after it
    builder = ScoreMatrixBuilder(retriever.encoder, ment_block=32, ent_block=8, device=device)
    qt1 = rng.integers(1, vocab, size=(1, lm)).astype(np.int32)
    q1 = lambda: retriever.query_tokens_batch(qt1, top_k=10, top_k_retvr=100)  # noqa: E731
    q1()
    base_ms = float(np.percentile(time_dispatches(q1, 4), 50))
    new_toks = rng.integers(1, vocab, size=(16, lm)).astype(np.int32)
    pad_before = retriever._padded_n_items()
    t0 = time.perf_counter()
    retriever.add_items(new_toks, builder)
    _common.sync(device)
    add_ms = (time.perf_counter() - t0) * 1000.0
    if retriever._padded_n_items() != pad_before:
        raise RuntimeError("the add crossed an item padding block")
    within_ms, second_ms = time_dispatches(q1, 2)
    results["add_then_query"] = {
        "query_b1_baseline_ms": base_ms, "add_items_ms": add_ms, "n_added": 16,
        "add_then_query_ms": within_ms, "second_query_after_add_ms": second_ms,
    }
    print(json.dumps({"add_then_query": results["add_then_query"]}), flush=True)

    out = {
        "device": _common.card(device),
        "config": {
            "model": "tiny CE f32" if args.tiny else "bert-base CE bf16",
            **world,
            "fixed": f"{world['n_anchors']} anchors + 100 rerank CE calls/query",
            "adaptive": f"budget {ADAPTIVE['total_budget']} CE calls, {ADAPTIVE['n_rounds']} rounds",
        },
        "results": results,
    }
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
