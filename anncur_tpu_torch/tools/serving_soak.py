"""Sustained mixed-load soak of the HTTP serving front end.

Counterpart of ``tools/serving_soak.py``: N query clients plus a mutator
doing /add + /remove against ``cli/serve.py --http`` for ``--seconds``,
in fixed mode and in adaptive mode with per-query early-stop escalation,
asserting the serving contract under churn:

- no errors, no hung clients, every request answered;
- p50/p95/p99 latency per op recorded, p99 <= max(20 x p50, 2 s);
- stable ids: a query never returns an id whose /remove completed before
  the query started (ids removed mid-flight may appear in that one
  in-flight response);
- memory: the process's RSS, and on the card ``torch.cuda.
  memory_allocated()`` read while holding the server's device lock (no
  dispatch in flight), grow from the soak's midpoint by < 32 MB or < 25%;
- no kernel is rebuilt or reloaded during the soak (``ops/cuda_build.py``'s
  libraries and loaded handles are the same after it as after warm-up).
  This replaces the JAX driver's check that no program recompiles: the
  port compiles nothing per shape.

By default it serves bert-base on the card: the 10,000-item world of
``_common.BASE_WORLD`` (anchor queries and U kept, so /add works), fixed
at cost 600 and adaptive at 100 over 5 rounds escalating to 210 over 8
(bench.py lines 3-4's early stop). ``--tiny`` serves the JAX driver's
tiny world (24 entities, a one-layer CE, budget 8 over 3 escalating to
16 over 2) for CPU runs.

    python -m anncur_tpu_torch.tools.serving_soak [--seconds 60] [--clients 6]
    python -m anncur_tpu_torch.tools.serving_soak --tiny --device cpu --seconds 4
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device

SERVE_FLAGS = {
    ("base", "fixed"): ["--top_k", "10", "--top_k_retvr", "100", "--batch", "32"],
    ("base", "adaptive"): ["--top_k", "10", "--batch", "32", "--mode", "adaptive", "--budget", "100", "--rounds", "5",
                           "--escalate_budget", "210", "--escalate_rounds", "8"],
    ("tiny", "fixed"): ["--top_k", "3", "--top_k_retvr", "20", "--batch", "2"],
    ("tiny", "adaptive"): ["--top_k", "3", "--top_k_retvr", "20", "--batch", "2", "--mode", "adaptive", "--budget", "8",
                           "--rounds", "3", "--escalate_budget", "16", "--escalate_rounds", "2"],
}
# growth from the soak's midpoint to its end: below either bound
GROWTH_MB, GROWTH_FRAC = 32.0, 0.25


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return float("nan")


def _tiny_retriever(device):
    """The JAX driver's tiny world: 24 entities, 6 anchor queries, 5 anchor
    items, a one-layer f32 CE (weights from seed 4)."""
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.data.synthetic import make_tokenized_world
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder

    ment, ent, _, tok = make_tokenized_world(seed=21, n_ents=24, n_ments=12, max_ment_len=16, max_ent_len=16)
    spec = BertSpec.tiny(vocab_size=tok.vocab_size, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                          max_position_embeddings=512)
    ce = CrossEncoder(spec, compute_dtype=torch.float32, device=device, seed=4)
    builder = ScoreMatrixBuilder(ce, ment_block=2, ent_block=4, pair_pad_multiple=32, device=device)
    return CurRetriever.build(
        encoder=ce, tokenizer=tok, train_query_tokens=np.asarray(ment[:6]), item_tokens=np.asarray(ent),
        n_anchor_items=5, builder=builder, max_query_len=16,
    )


def build_server(tmp_dir, mode="fixed", tiny=False, device="cuda"):
    """A served world in this process: its state and CE files under
    ``tmp_dir``, ``cli/serve.py --http`` on 127.0.0.1 in a thread. Returns
    the running ``_common.Server``."""
    device = resolve_device(device)
    if tiny:
        retriever = _tiny_retriever(device)
    else:
        retriever = _common.build_retriever(_common.make_encoder(False, device), **_common.BASE_WORLD)[0]
    argv = _common.serve_argv(_common.served_files(retriever, tmp_dir), retriever.encoder, device)
    del retriever  # the server loads its own copy from the files
    return _common.Server(argv + SERVE_FLAGS[("tiny" if tiny else "base", mode)])


def _builds():
    """What ``ops/cuda_build.py`` has built and loaded: library files and
    loaded handles."""
    files = sorted(os.listdir(cuda_build.BUILD_DIR)) if os.path.isdir(cuda_build.BUILD_DIR) else []
    return files, {name: id(lib) for name, lib in cuda_build._LOADED.items()}


def _device_mb(server):
    """Device memory in use with no dispatch in flight (None off the card)."""
    dev = server.retriever.device
    if dev.type != "cuda":
        return None
    with server.device_lock:
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated(dev) / 2**20


def _check_growth(samples, what):
    """Growth from the soak's midpoint to its end (the first half of a short
    soak still absorbs first-use allocations after the warm-up's edits);
    raises past both bounds. Returns the relative growth."""
    if len(samples) < 2:
        return None
    base = samples[len(samples) // 2] if len(samples) >= 3 else samples[0]
    growth = (samples[-1] - base) / max(base, 1.0)
    if not (samples[-1] - base < GROWTH_MB or growth < GROWTH_FRAC):
        raise AssertionError(f"{what} grew {growth:.1%} ({base:.0f} -> {samples[-1]:.0f} MB) from the soak's midpoint")
    return growth


def run_soak(base: str, seconds: float, n_clients: int = 6, mutate: bool = True, server=None):
    """Drive the soak against ``base``; returns the result dict and raises
    AssertionError where the contract breaks. With ``server`` (the live
    server of this process) it also holds device memory and the kernel
    builds to the contract."""

    def call(path, payload=None, timeout=120):
        t0 = time.perf_counter()
        code, out = _common.http_call(base, path, payload, timeout)
        if code != 200:
            raise RuntimeError(f"{path} answered {code}: {out}")
        return out, time.perf_counter() - t0

    words = ["alpha beta", "gamma", "delta epsilon", "zeta", "castle dragon", "sword magic", "robot", "planet star"]
    lock = threading.Lock()
    removed_done = set()  # ids whose /remove COMPLETED
    errors = []
    lat = {"query": [], "add": [], "remove": []}
    counts = {"query": 0, "add": 0, "remove": 0}
    stop = threading.Event()

    def query_client(i):
        k = 0
        while not stop.is_set():
            k += 1
            with lock:
                removed_before = set(removed_done)
            try:
                out, dt = call("/query", {"queries": [{"mention": words[(i + k) % len(words)]}]})
                ids = [x for x, _ in out["results"][0]["results"]]
                bad = [x for x in ids if x in removed_before]
                with lock:
                    if bad:
                        errors.append(f"query returned removed ids {bad}")
                    lat["query"].append(dt)
                    counts["query"] += 1
            except Exception as e:  # noqa: BLE001 — the contract's own failure, reported below
                with lock:
                    errors.append(f"query[{i}]: {e!r}")
                return

    def mutator():
        live = []
        k = 0
        while not stop.is_set():
            k += 1
            try:
                if len(live) < 3:
                    out, dt = call("/add", {"items": [{"title": f"churn item {k}", "description": "soak entity"}]})
                    with lock:
                        lat["add"].append(dt)
                        counts["add"] += 1
                    live.extend(out["ids"])
                else:
                    victim = live.pop(0)
                    out, dt = call("/remove", {"ids": [victim]})
                    with lock:
                        lat["remove"].append(dt)
                        counts["remove"] += 1
                        removed_done.add(victim)
            except Exception as e:  # noqa: BLE001 — the contract's own failure, reported below
                with lock:
                    errors.append(f"mutator: {e!r}")
                return
            time.sleep(0.2)

    # warm-up outside the measured window: first dispatches and one
    # add/remove round trip, so every path the steady state takes has run
    t_warm = time.perf_counter()
    call("/query", {"queries": [{"mention": words[0]}]})
    if mutate:
        out, _ = call("/add", {"items": [{"title": "warmup item", "description": "soak entity"}]})
        call("/query", {"queries": [{"mention": words[1]}]})
        call("/remove", {"ids": out["ids"]})
        with lock:
            removed_done.update(out["ids"])
        call("/query", {"queries": [{"mention": words[2]}]})
    warmup_s = time.perf_counter() - t_warm
    builds_warm = _builds()

    threads = [threading.Thread(target=query_client, args=(i,)) for i in range(n_clients)]
    if mutate:
        threads.append(threading.Thread(target=mutator))
    rss0 = _rss_mb()
    rss, dev_mb = [], []
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    qtr = max(seconds / 4.0, 0.5)
    while time.perf_counter() - t_start < seconds:
        time.sleep(qtr)
        rss.append(_rss_mb())
        if server is not None:
            dev_mb.append(_device_mb(server))
    stop.set()
    for th in threads:
        th.join(timeout=300)
    hung = [th.name for th in threads if th.is_alive()]
    assert not hung, f"hung soak threads: {hung}"
    assert not errors, errors[:5]
    assert counts["query"] > 0 and (not mutate or counts["add"] > 0), counts

    res = {
        "seconds": time.perf_counter() - t_start,
        "warmup_s": warmup_s,
        "clients": n_clients,
        "mutate": mutate,
        "counts": counts,
        "latency_s": {op: _common.percentiles(xs) for op, xs in lat.items() if xs},
        "rss_mb": {"start": rss0, "samples": rss},
        "removed_total": len(removed_done),
    }
    res["rss_growth_frac_after_warm"] = _check_growth(rss, "RSS")
    if server is not None:
        builds_end = _builds()
        assert builds_end == builds_warm, f"kernels rebuilt or reloaded during the soak: {builds_warm} -> {builds_end}"
        res["kernel_builds"] = {"libraries": builds_end[0], "loaded": sorted(builds_end[1])}
        if dev_mb and dev_mb[0] is not None:
            res["device_mb"] = dev_mb
            res["device_growth_frac_after_warm"] = _check_growth(dev_mb, "device memory")
    # the steady tail within 20x the median
    q = res["latency_s"]["query"]
    assert q["p99"] <= max(20 * q["p50"], 2.0), q
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--no-mutate", action="store_true")
    ap.add_argument("--out", default=os.path.join(_common.RESULTS_DIR, "serving_soak.json"))
    ap.add_argument("--tiny", action="store_true", help="the JAX driver's tiny world (CPU runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": _common.card(device), "world": "tiny" if args.tiny else "bert-base, 10,000 items"}
    for mode in ("fixed", "adaptive"):
        with tempfile.TemporaryDirectory(prefix=f"serving_soak_{mode}_") as tmp:
            srv = build_server(tmp, mode=mode, tiny=args.tiny, device=device)
            try:
                res = run_soak(srv.base, args.seconds, args.clients, mutate=not args.no_mutate, server=srv.server)
            finally:
                srv.close()
        res["mode"] = mode
        res["serve_flags"] = SERVE_FLAGS[("tiny" if args.tiny else "base", mode)]
        out[mode] = res
        print(json.dumps({mode: res}), flush=True)
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
