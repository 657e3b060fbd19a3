"""Query-sharded serving across ranks: q/s against the rank count.

Counterpart of ``tools/multichip_scaling.py``, which ran the JAX
retriever's ``shard_map`` query path on 1, 2, 4 and 8 virtual CPU devices
(one subprocess per device count). Here each world size is a
``torch.distributed`` group of that many processes (gloo on the CPU, one
process per rank), every rank holding a ``CurRetriever`` over a 1-D mesh
of the group (``parallel/``): the query batch is sharded over the ranks,
the corpus and index replicated. At a constant total batch it measures
the fixed path's and the fused adaptive engine's total q/s, and their
overhead against one rank; ``--fixed-tpps`` repeats the fixed path with
``target_pairs_per_step`` capped (JAX's memory-capped sweep).

The ranks of one host share its cores, so the ideal total q/s is flat in
the rank count and any drop is the sharding's overhead (dispatch, the
gathers, replication), as in JAX's reading. On the card it runs at world
size 1 over NCCL only, since the host has one H100: no multi-device
speedup is measured there, and the output says so.

    python -m anncur_tpu_torch.tools.multichip_scaling
    python -m anncur_tpu_torch.tools.multichip_scaling --device cpu [--nproc 1 2 4 8] [--fixed-tpps 512]
    python -m anncur_tpu_torch.tools.multichip_scaling --device cpu --quick

It runs on the card (world size 1, NCCL) unless ``--device cpu`` asks
for gloo ranks on the CPU (1, 2, 4 and 8 unless ``--nproc`` says).

The world is JAX's: a seeded rank-50 train matrix over 10,000 items of
32 tokens, 500 anchor items, a tiny f32 CE (64 queries of 32 tokens,
top-100 rerank; adaptive 150 over 5 rounds); ``--quick`` is its quick
world (512 items, 16 queries). Writes
``results/torch/multichip_scaling[_quick].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

QUICK = dict(n_items=512, n_train=40, k_i=24, k_retvr=16, rank=8, n_q=16, lm=16, budget=24, n_rounds=3, iters=2,
             max_pos=64)
FULL = dict(n_items=10000, n_train=500, k_i=500, k_retvr=100, rank=50, n_q=64, lm=32, budget=150, n_rounds=5,
            iters=3, max_pos=512)
NO_SPEEDUP = ("one card on this host: world size 1 over NCCL only, so no multi-device speedup is measured; "
              "the row is the mesh path's cost on one rank")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_world(quick: bool, device, mesh=None, fixed_tpps: int = 0):
    """The seeded world (the same on every rank): (retriever over ``mesh``,
    the query tokens, the train matrix, the sizes)."""
    import torch

    from anncur_tpu_torch.core.cur import build_cur
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab

    w = QUICK if quick else FULL
    rng = np.random.default_rng(0)
    spec = BertSpec.tiny(vocab_size=512, max_position_embeddings=w["max_pos"])
    ce = CrossEncoder(spec, compute_dtype=torch.float32, device=device, seed=0)
    item_toks = rng.integers(1, spec.vocab_size, size=(w["n_items"], w["lm"])).astype(np.int32)
    train = (rng.standard_normal((w["n_train"], w["rank"])) @ rng.standard_normal((w["rank"], w["n_items"]))).astype(
        np.float32)
    anchors = np.asarray(sorted(rng.choice(w["n_items"], w["k_i"], replace=False)))
    index = build_cur(rows=train, cols=train[:, anchors], row_idxs=np.arange(w["n_train"]), col_idxs=anchors,
                      approx_preference="rows", validate=False, device=device)
    kw = {"target_pairs_per_step": fixed_tpps} if fixed_tpps else {}
    retriever = CurRetriever(encoder=ce, tokenizer=WordPieceTokenizer(make_test_vocab()), item_tokens=item_toks,
                             index=index, anchor_item_ids=anchors, max_query_len=w["lm"], device=device, mesh=mesh,
                             **kw)
    qtoks = rng.integers(1, spec.vocab_size, size=(w["n_q"], w["lm"])).astype(np.int32)
    return retriever, qtoks, train, w


def fixed(retriever, qtoks, train, w):
    """The fixed path's answers on the world: {fixed_scores, fixed_ids}."""
    s, i = retriever.query_tokens_batch(qtoks, top_k=10, top_k_retvr=w["k_retvr"])
    return {"fixed_scores": s.tolist(), "fixed_ids": i.tolist()}


def adaptive(retriever, qtoks, train, w):
    """The adaptive engine's answers: {adaptive_scores, adaptive_ids}."""
    import torch

    s, i = retriever.query_tokens_adaptive_fused(
        qtoks, total_budget=w["budget"], n_rounds=w["n_rounds"], top_k=10,
        train_scores=torch.as_tensor(train, device=retriever.device))
    return {"adaptive_scores": s.tolist(), "adaptive_ids": i.tolist()}


def worker(quick: bool, fixed_tpps: int, device: str, out_dir: str) -> None:
    """One rank: the world over a mesh of every rank, the timed calls;
    rank 0 writes its row and the answers of the last calls."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from anncur_tpu_torch.parallel.mesh import make_mesh
    from anncur_tpu_torch.parallel.multihost import init_distributed

    dev = init_distributed(device)
    n = dist.get_world_size()
    world = build_world(quick, dev, make_mesh((n,), ("data",), dev), fixed_tpps)
    row = {"n_ranks": n, "n_q": world[3]["n_q"], "backend": dist.get_backend()}
    answers = {}
    for name, call in (("fixed", fixed),) if fixed_tpps else (("fixed", fixed), ("adaptive", adaptive)):
        call(*world)  # warm-up: handles and kernel loads
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(world[3]["iters"]):
            got = call(*world)
        dist.barrier()
        row[f"{name}_q_per_s_total"] = world[3]["iters"] * world[3]["n_q"] / (time.perf_counter() - t0)
        answers.update(got)
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as fout:
            json.dump({"row": row, "answers": answers}, fout)
    dist.destroy_process_group()


def launch(n: int, quick: bool, fixed_tpps: int, device: str, timeout: float) -> dict:
    """Run ``n`` ranks to the end (one process each, a free local port);
    rank 0's row and answers. Raises when a rank fails or outlives
    ``timeout`` (every rank is then killed)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = []
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank if device == "cuda" else 0),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
            cmd = [sys.executable, "-m", "anncur_tpu_torch.tools.multichip_scaling", "--worker", "--device", device,
                   "--fixed-tpps", str(fixed_tpps), "--worker_out", out_dir] + (["--quick"] if quick else [])
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + timeout
        failed = []
        try:
            for rank, p in enumerate(procs):
                try:
                    log, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    failed.append(f"rank {rank} of {n} timed out after {timeout} s")
                    break
                if p.returncode != 0:
                    failed.append(f"rank {rank} of {n} exited {p.returncode}:\n{log[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError("\n".join(failed))
        with open(os.path.join(out_dir, "rank0.json")) as fin:
            return json.load(fin)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="JAX's quick world")
    ap.add_argument("--nproc", type=int, nargs="+", default=None, help="world sizes (1 2 4 8; 1 with --device cuda)")
    ap.add_argument("--fixed-tpps", type=int, default=0,
                    help="only the fixed path with target_pairs_per_step capped to this, merged into --out")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds for each world size")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--worker_out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.quick, args.fixed_tpps, args.device, args.worker_out)
        return None
    from anncur_tpu_torch.tools import _common

    out_path = args.out or os.path.join(
        _common.RESULTS_DIR, "multichip_scaling_quick.json" if args.quick else "multichip_scaling.json")
    sizes = args.nproc or ([1] if args.device == "cuda" else [1, 2, 4, 8])
    if args.device == "cuda" and sizes != [1]:
        raise SystemExit("the card's host has one H100: --device cuda runs at --nproc 1 only")
    runs = {}
    for n in sizes:
        runs[n] = launch(n, args.quick, args.fixed_tpps, args.device, args.timeout)
        print(json.dumps(runs[n]["row"]), flush=True)
    rows = {str(n): r["row"] for n, r in runs.items()}
    base = runs[sizes[0]]["row"]

    def overhead(key):
        return {str(n): 1.0 - r["row"][key] / base[key] for n, r in runs.items()}

    if args.fixed_tpps:
        with open(out_path) as fin:
            out = json.load(fin)
        key = f"fixed_tpps{args.fixed_tpps}_q_per_s_total"
        for n, r in runs.items():
            out["rows"].setdefault(str(n), {})[key] = r["row"]["fixed_q_per_s_total"]
        out[f"fixed_tpps{args.fixed_tpps}_overhead_vs_1rank"] = overhead("fixed_q_per_s_total")
    else:
        out = {
            "host": (NO_SPEEDUP if args.device == "cuda" else
                     "one host's CPU cores shared by every rank (gloo): the ideal total q/s is flat in the rank "
                     "count, and any drop is the sharding's overhead"),
            "device": _common.card(args.device), "quick": bool(args.quick), "rows": rows,
            "fixed_overhead_vs_1rank": overhead("fixed_q_per_s_total"),
            "adaptive_overhead_vs_1rank": overhead("adaptive_q_per_s_total"),
            "answers": {str(n): r["answers"] for n, r in runs.items()},
        }
    if args.device == "cuda":
        print(NO_SPEEDUP, flush=True)
    _common.write_json(out_path, out)
    return out


if __name__ == "__main__":
    main()
