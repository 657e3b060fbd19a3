"""Where the time goes on the card: device time by kernel for one
bert-base CE forward of a build step and for one cost-600 query batch.

    python -m anncur_tpu_torch.cli.profile_ce [--pairs 2048] [--queries 32]

Random weights from seed 0, bf16, 256-token pairs, the shapes of
``chip_smoke.py``. Each section runs once to warm up, then once under
``torch.profiler`` (CPU + CUDA activities). It prints one JSON line per
section: the wall time (host clock around work that ends in a
synchronize), the summed device time of its kernels, the device's idle
share of the wall time, and the device time by group (kernel A, kernel
B, matmuls, everything else) and of the ten costliest kernels.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _group(name: str) -> str:
    if "attention_fwd_kernel" in name:
        return "kernel_A_attention"
    if name.startswith("mips_") or "mips_split_topk" in name or "mips_merge" in name:
        return "kernel_B_mips_topk"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(fn, label: str) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()  # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        # device-side entries only: kernels and memsets/copies
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    busy_ms = sum(kernels.values()) / 1e3
    groups = {}
    for name, us in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "section": label,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
        "groups_ms": groups,
        "top_kernels_ms": [[name[:120], us / 1e3] for name, us in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2048, help="pairs in the profiled CE forward")
    ap.add_argument("--queries", type=int, default=32, help="queries in the profiled batch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ce: needs a CUDA card")

    from anncur_tpu_torch.core.cur import build_cur
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.indexer.score_matrix import build_pairs
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab

    dev = torch.device("cuda", 0)
    spec = BertSpec()
    ce = CrossEncoder(spec, compute_dtype=torch.bfloat16, device=dev, seed=0)
    rng = np.random.default_rng(0)
    lm = le = 128
    n_m = 32
    n_e = max(1, args.pairs // n_m)
    ment = torch.as_tensor(rng.integers(1, spec.vocab_size, size=(n_m, lm)), dtype=torch.int32, device=dev)
    ent = torch.as_tensor(rng.integers(1, spec.vocab_size, size=(n_e, le)), dtype=torch.int32, device=dev)
    pairs = build_pairs(ment, ent, lm + le)
    out = [profile(lambda: ce.score(pairs, first_segment_end=lm), f"ce_forward_{pairs.shape[0]}_pairs")]

    n_items, n_train, k_i = 10000, 500, 500
    item_toks = rng.integers(1, spec.vocab_size, size=(n_items, le)).astype(np.int32)
    train = (rng.standard_normal((n_train, 16)) @ rng.standard_normal((16, n_items))).astype(np.float32)
    anchors = np.asarray(sorted(rng.choice(n_items, k_i, replace=False)))
    index = build_cur(
        rows=train, cols=train[:, anchors], row_idxs=np.arange(n_train), col_idxs=anchors,
        approx_preference="rows", validate=False, device=dev,
    )
    retriever = CurRetriever(
        encoder=ce, tokenizer=WordPieceTokenizer(make_test_vocab()), item_tokens=item_toks,
        index=index, anchor_item_ids=anchors, max_query_len=lm, device=dev,
    )
    qtoks = rng.integers(1, spec.vocab_size, size=(args.queries, lm)).astype(np.int32)
    out.append(
        profile(
            lambda: retriever.query_tokens_batch(qtoks, top_k=10, top_k_retvr=100),
            f"query_batch_{args.queries}_cost600",
        )
    )
    card = torch.cuda.get_device_name(0)
    for rec in out:
        rec["device"] = card
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
