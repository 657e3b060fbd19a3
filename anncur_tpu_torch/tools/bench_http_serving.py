"""HTTP serving throughput under concurrency: the coalescer, end to end.

Counterpart of ``tools/bench_http_serving.py``.
``bench_serving_latency`` measures the retriever's dispatches; this
driver measures the whole serving path: real sockets, the stdlib
ThreadingHTTPServer and the cross-request ``Coalescer`` of
``cli/serve.py``, under N concurrent single-query clients, the load that
dynamic batching exists for.

Flow: the latency driver's 10,000-item bert-base retriever
(``_common.BASE_WORLD``) is saved as a state file with its CE's weights,
``cli/serve.py`` serves it over HTTP in a thread of this process on
127.0.0.1 (adaptive, the matched-recall budget 150 over 5, ``--batch``
32), one query warms it, a sequential single client gives the baseline,
then ``--clients`` threads each POST ``--per_client`` single-query /query
requests. Reports q/s, per-request latency percentiles and the
coalescing factor (queries answered per device dispatch, from /healthz).

    python -m anncur_tpu_torch.tools.bench_http_serving [--out results/torch/http_serving.json]
    python -m anncur_tpu_torch.tools.bench_http_serving --tiny --device cpu --clients 4 --per_client 2
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device


def run_pass(base, queries, n_threads):
    """Fire len(queries) single-query requests from n_threads workers;
    return (wall_s, per-request latencies ms, errors)."""
    lat_ms, errs = [], []
    lock = threading.Lock()
    it = iter(queries)

    def worker():
        while True:
            with lock:
                q = next(it, None)
            if q is None:
                return
            t0 = time.perf_counter()
            try:
                code, out = _common.http_call(base, "/query", q)
                if code != 200 or not out["results"]:
                    raise RuntimeError(f"{code}: {out}")
            except Exception as e:  # noqa: BLE001 — reported by the caller
                with lock:
                    errs.append(repr(e))
                return
            with lock:
                lat_ms.append((time.perf_counter() - t0) * 1e3)

    ths = [threading.Thread(target=worker) for _ in range(n_threads)]
    t0 = time.perf_counter()
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=600)
    if any(t.is_alive() for t in ths):
        errs.append("a client hung")
    return time.perf_counter() - t0, lat_ms, errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(_common.RESULTS_DIR, "http_serving.json"))
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--per_client", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--coalesce_ms", type=float, default=25.0)
    ap.add_argument("--budget", type=int, default=150)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seq_baseline", type=int, default=12,
                    help="sequential single-client queries for the baseline pass")
    ap.add_argument("--tiny", action="store_true", help="a tiny CE and world (CPU runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    world = _common.TINY_WORLD if args.tiny else _common.BASE_WORLD
    encoder = _common.make_encoder(args.tiny, device)
    retriever, _, rng = _common.build_retriever(encoder, **world)
    with tempfile.TemporaryDirectory(prefix="bench_http_") as tmp:
        files = _common.served_files(retriever, tmp)
        del retriever  # the server loads its own copy from the files
        argv_srv = _common.serve_argv(files, encoder, device) + [
            "--mode", "adaptive", "--budget", str(args.budget), "--rounds", str(args.rounds), "--top_k", "10",
            "--batch", str(args.batch), "--coalesce_ms", str(args.coalesce_ms),
        ]
        del encoder
        srv = _common.Server(argv_srv)
        try:
            results = run_passes(srv.base, args, rng, world, device)
        finally:
            srv.close()
    _common.write_json(args.out, results)
    return results


def run_passes(base, args, rng, world, device):
    # make_test_vocab's only alphabetic entries are the 26 letters, so
    # random 4-10 letter words make WordPiece split each into a head and
    # '##' continuations: real per-character work for every request
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = ["".join(rng.choice(letters, int(n))) for n in rng.integers(4, 11, size=500)]
    qs = [
        {"mention": " ".join(rng.choice(words, 3)), "context_left": " ".join(rng.choice(words, 5)),
         "context_right": " ".join(rng.choice(words, 5))}
        for _ in range(max(args.clients * args.per_client, args.seq_baseline))
    ]
    t0 = time.perf_counter()
    _common.http_call(base, "/query", qs[0])  # warm: first dispatch
    warm_s = time.perf_counter() - t0
    print(json.dumps({"warm_s": warm_s}), flush=True)

    results = {"device": _common.card(device), "config": {
        "mode": "adaptive", "budget": args.budget, "rounds": args.rounds, "batch": args.batch,
        "coalesce_ms": args.coalesce_ms, "clients": args.clients, "per_client": args.per_client,
        "model": "tiny CE f32" if args.tiny else "bert-base CE bf16", "n_items": world["n_items"],
    }, "warm_s": warm_s}
    for name, queries, n_threads in (
        ("sequential_1_client", qs[: args.seq_baseline], 1),
        ("concurrent", qs[: args.clients * args.per_client], args.clients),
    ):
        d0 = _common.http_call(base, "/healthz")[1]
        wall, lat, errs = run_pass(base, queries, n_threads)
        d1 = _common.http_call(base, "/healthz")[1]
        if errs:
            raise RuntimeError(f"{name}: {errs[:3]}")
        dispatches = d1["dispatches"] - d0["dispatches"]
        pct = _common.percentiles(lat, (50, 95))
        entry = {
            "queries": len(queries), "wall_s": wall, "qps": len(queries) / wall,
            "latency_p50_ms": pct["p50"], "latency_p95_ms": pct["p95"],
            "device_dispatches": dispatches, "queries_per_dispatch": len(queries) / max(dispatches, 1),
        }
        results[name] = entry
        print(json.dumps({name: entry}), flush=True)
    return results


if __name__ == "__main__":
    main()
