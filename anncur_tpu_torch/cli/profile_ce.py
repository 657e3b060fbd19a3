"""Where the time goes on the card: device time by kernel for one
bert-base CE forward of a build step, for one cost-600 query batch, for
one adaptive query batch (budget 210 over 8 rounds, CUR and AXN), for one
retrieve-and-rerank batch (a bert-base bi-encoder embeds the mentions and
the corpus, DenseIndex retrieves the top 64, the CE reranks them), for
one cross-encoder train step and for one bi-encoder train step.

    python -m anncur_tpu_torch.cli.profile_ce [--pairs 2048] [--queries 32] [--adaptive_queries 128]

Random weights from seed 0, bf16, the shapes of ``chip_smoke.py``:
256-token pairs for the forward and the query batch; for the train step
the Trainer at ``configs/el_zeshel_cross_enc.json``'s widths with random
negatives, 4 micro-batches of one mention x 64 pairs of 255 tokens,
attention dropout 0 and hidden dropout 0.1; for the bi-encoder step the
Trainer at ``configs/el_zeshel_bi_enc.json``'s widths (separate
cls_w_lin towers, 16 mentions in 4 micro-batches) with 63 random
negatives a mention, the shapes of ``chip_smoke.py`` phase 9's hard-negative
steps (3 tower forwards a micro-batch: 4 mentions, 4 positives, 252
negatives). Each section runs once to
warm up, then once under ``torch.profiler`` (CPU + CUDA activities). It
prints one JSON line per section: the wall time (host clock around work
that ends in a synchronize), the summed device time of its kernels, the
device's idle share of the wall time, and the device time by group
(kernels A, B, C, D, matmuls, everything else) and of the ten costliest
kernels. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def _group(name: str) -> str:
    if "attention_fwd_" in name:
        return "kernel_A_attention"
    if "attention_bwd_dkv_" in name:
        return "kernel_C_attention_bwd_dkv"
    if "attention_bwd_dq_" in name:
        return "kernel_D_attention_bwd_dq"
    if "mips_" in name:  # score, select and sort kernels
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


def train_step_section(dev, rng) -> dict:
    """One Trainer step at phase 5 of ``chip_smoke.py``'s shapes."""
    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.train.data import EntLinkDataset
    from anncur_tpu_torch.train.trainer import Trainer

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cfg = Config.from_json(os.path.join(repo, "configs", "el_zeshel_cross_enc.json"))
    spec = BertSpec(attention_dropout=0.0, hidden_dropout=0.1)
    with tempfile.TemporaryDirectory() as res_dir:
        cfg.update_from_dict({"neg_strategy": "random", "train_batch_size": 4, "base_res_dir": res_dir, "seed": 0})
        n_ments, n_ents = 8, 1000
        data = EntLinkDataset(
            rng.integers(1, spec.vocab_size, size=(n_ments, cfg.max_input_len)).astype(np.int32),
            rng.integers(1, spec.vocab_size, size=(n_ents, cfg.max_label_len)).astype(np.int32),
            rng.integers(0, n_ents, size=n_ments),
        )
        ce = CrossEncoder(spec, cfg.cross_enc_type, cfg.pooling_type, torch.bfloat16, device=dev, seed=0)
        trainer = Trainer(cfg, ce, total_steps=100)
        state = trainer.init_state()
        negs = trainer._epoch_negatives(data, state, 0)
        batches = [trainer._shard_batch(b) for b in trainer._make_batches(data, negs, cfg.train_batch_size, 0)]
        steps = iter(batches)
        pairs = cfg.train_batch_size * (1 + cfg.num_negs)
        return profile(lambda: trainer.train_step(state, next(steps)), f"train_step_{pairs}_pairs")


def bienc_train_step_section(dev, rng) -> dict:
    """One bi-encoder Trainer step with 63 negatives a mention."""
    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.train.data import EntLinkDataset
    from anncur_tpu_torch.train.trainer import Trainer

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cfg = Config.from_json(os.path.join(repo, "configs", "el_zeshel_bi_enc.json"))
    spec = BertSpec(attention_dropout=0.0, hidden_dropout=0.1)
    with tempfile.TemporaryDirectory() as res_dir:
        cfg.update_from_dict({"neg_strategy": "random", "base_res_dir": res_dir, "seed": 0})
        n_ments, n_ents = 2 * cfg.train_batch_size, 1000
        data = EntLinkDataset(
            rng.integers(1, spec.vocab_size, size=(n_ments, cfg.max_input_len)).astype(np.int32),
            rng.integers(1, spec.vocab_size, size=(n_ents, cfg.max_label_len)).astype(np.int32),
            rng.integers(0, n_ents, size=n_ments),
        )
        bienc = BiEncoder(spec, cfg.pooling_type, cfg.bi_enc_type, cfg.embed_dim, cfg.add_linear_layer,
                          torch.bfloat16, device=dev, seed=0)
        trainer = Trainer(cfg, bienc, total_steps=100)
        state = trainer.init_state()
        negs = trainer._epoch_negatives(data, state, 0)
        batches = [trainer._shard_batch(b) for b in trainer._make_batches(data, negs, cfg.train_batch_size, 0)]
        steps = iter(batches)
        return profile(lambda: trainer.train_step(state, next(steps)),
                       f"bienc_train_step_{cfg.train_batch_size}_mentions_{cfg.num_negs}_negs")


def rerank_section(dev, ce, item_toks, rng, n_ments) -> dict:
    """One retrieve-and-rerank eval at chip_smoke.py's phase 7 widths: a
    bert-base separate cls_w_lin bi-encoder (seed 1, bf16), ``n_ments``
    128-token mentions over the 10,000 items, top 64, the CE reranking."""
    from anncur_tpu_torch.evalx.retrieve_rerank import run_retrieve_rerank_eval
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.biencoder import BiEncoder

    spec = BertSpec()
    bienc = BiEncoder(spec, "cls_w_lin", "separate", 768, compute_dtype=torch.bfloat16, device=dev, seed=1)
    ments = rng.integers(1, spec.vocab_size, size=(n_ments, item_toks.shape[1])).astype(np.int32)
    gt = rng.integers(0, item_toks.shape[0], size=n_ments)
    return profile(lambda: run_retrieve_rerank_eval(bienc, ce, ments, item_toks, gt, top_k=64, batch_size=64),
                   f"retrieve_rerank_{n_ments}_mentions_{item_toks.shape[0]}_entities_top64")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2048, help="pairs in the profiled CE forward")
    ap.add_argument("--queries", type=int, default=32, help="queries in the profiled batch")
    ap.add_argument("--adaptive_queries", type=int, default=128, help="queries in the profiled adaptive batch")
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
    # the headline adaptive configuration (bench.py line 3), the train
    # matrix on the device as chip_smoke.py's phase 6 passes it
    aq = rng.integers(1, spec.vocab_size, size=(args.adaptive_queries, lm)).astype(np.int32)
    train_dev = torch.as_tensor(train, device=dev)
    out.append(
        profile(
            lambda: retriever.query_tokens_adaptive_fused(aq, total_budget=210, n_rounds=8, top_k=10, train_scores=train_dev),
            f"adaptive_batch_{args.adaptive_queries}_b210r8",
        )
    )
    out.append(
        profile(
            lambda: retriever.query_tokens_adaptive_fused(aq, total_budget=210, n_rounds=8, top_k=10, train_scores=train_dev,
                                                          method="axn"),
            f"axn_adaptive_batch_{args.adaptive_queries}_b210r8",
        )
    )
    out.append(rerank_section(dev, ce, item_toks, rng, 256))
    del retriever, ce
    torch.cuda.empty_cache()
    out.append(train_step_section(dev, rng))
    torch.cuda.empty_cache()
    out.append(bienc_train_step_section(dev, rng))
    card = torch.cuda.get_device_name(0)
    for rec in out:
        rec["device"] = card
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
