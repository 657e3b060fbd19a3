"""Smoke run of the PyTorch + CUDA port (``anncur_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--decoder-only]

Phases, in order (``--decoder-only``: 1, 15 and the kernels line of 15's
kernels); any failure exits non-zero before the result line:

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and every kernel built from ``anncur_tpu_torch/csrc``
   (one ``nvcc`` per source, started together);
2. each hand-written kernel against its plain PyTorch version on the card
   at the main path's shapes, with its time, the plain version's, a
   PyTorch library call's (a yardstick the port never calls) and the
   least time the card could take (``bound_ms``): kernel A (attention
   forward, with its row log-sum-exp; timed at the build's full layer,
   its CLS-only final layer, the train layer and the towers' layers, its
   device kernels named under ``torch.profiler``: the Hopper body at hd
   64, g > 16), kernels D and C
   (attention backward, dQ with D = rowsum(dO * O), then dK/dV; checked
   also for D's delta, same bits twice and a part-padding query tile;
   timed, D first, at 64 pairs of random key lengths and at the train
   step's own inputs, 63 and 1 pairs with every key valid, beside the
   port's whole backward and SDPA's; one whole backward at 63 pairs under
   ``torch.profiler`` must be exactly D then C on the card) and kernel B
   (MIPS top-k: score GEMM, by FFMA or, for more than 32 queries over
   16-byte f32 rows, in three TF32 passes on the tensor cores, + cluster
   radix select; each timing gives the score stage and the select apart
   from the profiler's device kernels, and its f32 bound is that of an
   f32-accurate product on the tensor cores, the FFMA figure beside it;
   timed at a cost-600
   batch, q=32 over 10,000 items, at one text, q=1, at an eval batch
   of 256 over ZeShEL-military's 104,520 entities, and at an adaptive
   growth round, 512 queries picking 26 past 184 excluded ids each, and
   checked once more at k=500), and kernel B at the bi-encoder's width
   d=768 over f32 rows and, through its int8 entry, over int8 rows with
   per-row scales (a search batch q=32 over 10,000 entities, k=64; one
   text and an eval batch of 256 over 104,520 entities, k=100) and at the
   hard-negative mine, 1,024 x 10,000, k=64, where its top-k scores are
   held against f64 products within 4x the plain f32 matmul's error. Head
   dims above 256 (kernels A, C and D's wide route): ``attention`` and
   its autograd against the plain versions at hd 272, 384, 512 and 768,
   bf16 and f32, at b=64 g=s=255 nh=4 (one launch each of A, C and D and
   none of the plain attention per call; A's lse against logsumexp; A, C
   and D's Hopper bodies there, named under ``torch.profiler``), each
   kernel timed there beside its bound, the plain version and SDPA (C and
   D also as the whole backward); then at hd 272 one key or query tile
   past what A's, C's or D's Hopper body stores in shared memory (bf16 s
   1473 for A, g 641 and s 1281, f32 g 257 and s 513 for A and D), checked
   the same way with A, C or D on its slice body. For every bf16
   instantiation of kernels A, C and D (every head dim that is a multiple
   of 16 up to 256, the wide route's slice body, the Hopper body at hd 64
   and the wide Hopper body): its HMMA count in the SASS, HGMMA for the
   Hopper bodies (it fails on none, and on an hd-64 Hopper body that
   spills; the f32 wide Hopper bodies too) and ptxas' registers and
   spills; the f32 wide forward and backward against an f64 autograd,
   within 4x the plain f32 version's error; for kernel B's kernels, f32
   and int8, registers and spills; the encoder layer's epilogue kernels
   (``bias_residual_layernorm``, ``bias_gelu``, ``bias_add3``) at the build
   cell's rows (2,048 pairs of 256 tokens: 524,288 x 768, and x 3,072 for
   the GELU) against their plain compositions (within one bf16 ulp and at
   least 99% the same bits; ``bias_add3`` bit for bit), each timed beside
   its byte bound and the plain composition, registers and spills;
3. build: a bert-base cross-encoder (random weights from seed 0, bf16)
   scores a 32 x 2048 matrix of 256-token pairs with ScoreMatrixBuilder;
4. serve: CurRetriever.query_tokens_batch answers 32 token queries over
   10,000 items at cost 600 (500 anchors + top-100 rerank, top-10);
5. train: the Trainer takes 1 warm-up and 5 timed steps of bert-base
   cross-encoder training at the widths of
   ``configs/el_zeshel_cross_enc.json`` (4 micro-batches of one mention x
   64 pairs of 255 tokens per step), then one micro-batch's loss and
   gradient norm are held against the plain attention's;
6. adaptive serve: on phase 4's retriever and train matrix (on the
   device), CurRetriever.query_tokens_adaptive_fused answers 128 token
   queries at budget 210 over 8 rounds, top-10 (one warm call, then the
   median of 3), and the early-stop worst case (base 100 over 5 rounds,
   every query escalating to 210 over 8 more); it checks 210 distinct
   scored ids per query, the returned scores against the plain-attention
   CE, kernel B's launches per batch, one growth round's pick against the
   plain version, and, on the committed trained-CE matrices with no CE,
   the adaptive oracle's recall against the fixed-anchor path's at cost
   600;
7. retrieve and rerank: a bert-base bi-encoder (``configs/
   el_zeshel_bi_enc.json``: separate towers, cls_w_lin, 768; random
   weights from seed 1, bf16) embeds phase 4's 10,000 entities and 384
   mentions of 128 tokens, ``DenseIndex`` retrieves each mention's top 64
   (kernel B) and phase 4's CE reranks them (``run_retrieve_rerank_eval``,
   one small warm call, then one timed call), and the same embeddings are
   searched in an int8 index; it checks the index's ids against the plain
   MIPS, the rerank scores against the pair scorer's on the same pairs,
   and the int8 index's top-64 overlap with the f32 one;
8. AXN and host ADACUR on phase 4's retriever: phase 6's adaptive batch
   and early-stop worst case with ``method='axn'`` (full rank, so kernel B
   scores 501-wide rows; the early stop timed in one call after a warm
   one), one growth round's pick against the plain
   version, the AXN oracle recall on the trained-CE matrices at 210 over
   5 rounds (the JAX sweep's ranks), and ``query_tokens_adaptive`` (the
   host round loop) on 8 queries at 100 over 3 rounds;
9. bi-encoder training: the Trainer takes 1 warm and 5 timed steps at
   ``configs/el_zeshel_bi_enc.json``'s widths (bert-base, separate towers,
   cls_w_lin, 128-token texts, bf16, all_encoder_layers, 16 mentions in 4
   micro-batches; attention dropout 0, hidden 0.1; random tokens) with (a)
   in-batch negatives, (b) 63 hard negatives mined once over 1,024
   mentions and 10,000 entities (the towers embed through kernel A, kernel
   B mines) and (c) distillation from the top 64 of
   ``benchmarks/trained_ce_matrix.npz``; it checks finite losses, the
   moved and frozen leaves, the attention kernels' launches (12 layers x 2
   or 3 tower forwards x 4 micro-batches x 5 steps), one micro-batch's loss
   and gradient norm against the plain attention, and the mined ids
   against the plain MIPS;
10. the paper's evals: ``run_transductive_eval`` (cur, cur_oracle) and
   ``run_inductive_eval`` (cur) on both committed trained-CE matrices,
   held against the port on the CPU, and ``build_ent_to_ent_scores`` for
   1,000 random-token entities against 32 k-means++ anchors of phase 9's
   towers (phase 4's CE, kernel A), a slice against the plain attention;
11. the command-line pipeline over ZeShEL-format files, each CLI through
   its ``main(argv)`` on the card at bert-base width: a synthetic world
   (10,000 entities of ~120 words, 400 mentions with ~60 words of context
   on each side, words of the bert-base-uncased-shaped vocabulary),
   ``tokenize_entities`` (and the native tokenizer, ids equal to the
   Python WordPiece's), ``build_score_matrix`` as two chunk jobs of 8
   anchor mentions + ``combine_chunks`` (against one in-process build
   and the plain attention), a retriever state file over that matrix,
   ``serve`` from a JSONL file at cost 600 and adaptively at 210 over 8
   (each row against the in-process retriever), ``serve --http`` with 32
   concurrent clients (coalesced dispatches, answers against the file
   mode's), sequential latency, /add and /remove, ``eval_retrieve_rerank``
   (128 mentions, top 64), ``compute_tfidf_hard_negs`` (kernel B at d =
   the fitted vocabulary, against the plain MIPS and timed),
   ``eval_retrieval`` at one of phase 10's grid points (the same recall)
   and ``train`` (two bi-encoder steps at configs/el_zeshel_bi_enc.json's
   widths, kernels A, C and D); launches are counted around the CLIs'
   calls only;
12. the analysis CLIs and the serving drivers, each through its
   ``main(argv)`` on the card at bert-base width: ``compute_bienc_scores``
   (256 of phase 11's mentions x its 10,000 entities; a sample against
   embeddings made with the plain attention), ``build_ent2ent`` (1,000 x 32
   k-means++ anchors of those embeddings; a slice against the plain
   attention), ``rank_probe`` on the trained-CE matrices, ``launch_jobs
   --backend local`` (two eval_retrieval jobs at phase 10's grid point,
   their recall equal to phase 10's, then skipped as done),
   ``bench_serving_latency``, ``bench_http_serving`` (16 clients x 2) and
   ``serving_soak`` (fixed and adaptive with escalation, ~6 s each, 6
   clients and a mutator, its contract asserted), and ZeShEL-military:
   ``military_scale`` (kernel B at 13,063 x 104,520 x 768, k=64, against
   matmul + topk and its scores against f64 products; one bert-base build
   row over 104,520 entities; fixed cost 600 at q=32 and adaptive 210 over
   8 at q=128 and q=512 over 104,520 items, held to phase 6's checks),
   kernel B timed at its MIPS shape, and
   ``bench_nitems_scaling`` at q=128 over 10,000 and 104,520 items;
   one JSON line per driver, with the card;
13. the parallel layer at world size 1, on a 1-rank NCCL group started on
   an in-process store and destroyed at the end of the phase, reusing
   phases 3-7's CE, retriever and state, each path against the one-device
   call it replaces: the Trainer over ``default_mesh()`` and over a (1, 1)
   data x model mesh with the towers tensor-parallel (2 steps each from
   phase 5's starting state; losses and gradient norm to phase 5's
   tolerances; A, C, D launches), the entity-sharded build and
   ``build_multihost`` of 4 x 2048 of phase 3's pairs, ``mips_topk_sharded``
   at ZeShEL-military's MIPS shape and ``DenseIndex(mesh=)`` on phase 7's
   embeddings (both timed beside the one-device calls),
   ``CurRetriever(mesh=)`` at cost 600 on phase 4's 32 queries and at 210
   over 8 on phase 6's 128 (phases 4 and 6's checks, q/s beside theirs),
   and ``python -m anncur_tpu_torch.parallel.dryrun --nproc 1 --device
   cuda``; one JSON line per check, with the card;
14. the last tools/ drivers and the examples (``phase_tools``), each
   through its ``main(argv)`` at full widths and cut counts, its answers
   checked: ``bench_early_stop`` at q=128 (the regimes' budgets, the
   scores against the plain-attention CE), ``measure_packing`` at 16 x
   2,048 pairs per regime (bucketed equal to padded), ``quickstart`` on
   the card (recall, also on the CPU with the card's weights; A, C, D and
   B launched), ``yugioh_scale_eval`` on the full 3,374 x 10,031 matrix
   over a 2 x 2 grid (a point against the CPU),
   ``multichip_scaling`` at world size 1 over NCCL (against the world
   served unsharded), and ``adaptive_matched_recall --tiny`` and
   ``make_trained_ce_matrix --quick`` on the card (the matched budgets
   against the committed JAX artifact, the training from one start
   against the CPU's); one JSON line per driver, with the card;
15. the decoder CE (DeepSeek-V2-Lite, ``models/deepseek_v2.py``) at the
   index-build cell's shapes: ``moe_permute`` and ``moe_combine`` at
   131,072 tokens x top 6 of 64 experts x 2,048 (a seeded router) against
   their plain versions bit for bit (``moe_combine`` the same bits on three
   runs), timed beside their byte bounds and the plain versions, registers
   and spills; kernel A's causal body (hd 192, v 128 zero-padded; b=512
   g=s=256 nh=16, one pad key a pair) and the final layer's g=1 launch
   against the plain attention (32 pairs), timed beside the bound and SDPA
   with an explicit mask, its HMMA count, registers and spills; the
   RMSNorm kernel (``ops/rms_norm.py``) at 131,072 x 2,048 and at
   kv_norm's 131,072 x 512 read out of 576-wide rows against its plain
   composition (each element bit-equal or within one bf16 ulp), timed
   beside its byte bound, the plain composition and
   ``torch.nn.functional.rms_norm``, registers and spills;
   then one forward of 512 pairs (random weights on the card, seed 5) with
   its launches counted (26 causal + 1 final kernel A, 26 of each dispatch
   kernel, 82 RMSNorm, nothing else), three timed, peak memory, and the
   gap to the f32 reference (``models/deepseek_v2_reference.py``) at 32
   pairs with the tokens each expert layer routes apart from it;
16. the ``kernels`` line: each kernel's launches on phases 3-15 (counts set
   to 0 just before each phase, CLI, driver or path call and read just
   after), error and times; kernel B's f32 entry once per score route
   (``mips_topk_fused``: every launch, its FFMA shapes; ``mips_topk_fused_tc``:
   the launches whose score stage ran on the tensor cores, its shapes);
   kernel A's entry holds phase 15's causal record;
17. the last line, ``{"ok": true, "device": {...}}``.

Needs a CUDA card and the CUDA toolkit; imports nothing of JAX.
"""

import contextlib
import functools
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# peaks of one H100 SXM (NVIDIA data sheet, dense): bytes/s of HBM3 and
# op/s of the types the kernels take
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# an f32-accurate product on the tensor cores: three TF32 passes (kernel B's
# score stage; the reference's precision="highest" on the TPU's matrix unit)
TF32_PASSES = 3
# tolerances of kernel vs plain version
ATTN_ATOL = 2e-2  # bf16 output: 8-bit mantissa, f32 sums in other orders
MIPS_RTOL = 1e-4  # kernel B vs cuBLAS f32: one dot of 500 terms, other order
# kernel B's top-k scores against their f64 products, max error over max
# |f64|: at most this many times the plain f32 matmul's at the same entries
MIPS_F64_RATIO = 4.0
MIPS_TIE_GAP = 1e-5  # ids compared where neighbours differ by more (x max|s|)
CE_ATOL = 2e-2  # bf16 CE scores, kernel A vs plain attention, 12 layers
# bf16 bi-encoder embeddings, kernel A vs plain attention, row-wise relative
# L2 distance: at most this many times SDPA's own distance from plain on the
# same inputs (12 random bf16 layers amplify any change of summation order)
EMBED_VS_SDPA = 2.0
GRAD_RTOL = 2e-2  # kernels C/D grads vs plain autograd, x the plain grad's max (bf16 out)
LSE_RTOL = 1e-5  # kernel A's f32 log-sum-exp vs torch.logsumexp, sums in another order
TRAIN_LOSS_ATOL = 2e-2  # bf16 CE loss through 12 layers, kernels vs plain attention
TRAIN_GNORM_RTOL = 2e-2  # global gradient norm, the same
# bi-encoder training (phase 9): its logits are dot products of two
# 768-wide bf16-computed embeddings (|s| ~ 1e2), so rounding moves its loss
# in proportion to the loss (TRAIN_LOSS_ATOL relative beyond 1) and its
# gradient as much as any bf16 attention does: the kernels' gradient is held
# within this many times SDPA's distance from the plain attention's (SDPA
# itself misses TRAIN_GNORM_RTOL there, 3.7% at in-batch, PERF.md)
BIENC_VS_SDPA = 2.0
# ~10 ms of device clock that the card spins before each timed call
SLEEP_CYCLES = 20_000_000
# gradients that are 0 in exact arithmetic (a shift under a softmax), so
# a step may leave them, and their parameters, unchanged
ZERO_GRAD_LEAVES = ("attn/k_bias", "score_linear/bias")
# bf16 instantiations of each of kernels A, C and D: 16 head dims x 2
# tilings, the wide route's slice body (head dims above 256, a runtime
# count), the Hopper body (wgmma, hd = 64, g > 16) and the wide route's
# Hopper body (wgmma + TMA, head dims above 256; its f32 instantiation, on
# the tensor cores in three TF32 passes, is held apart)
BF16_INSTANTIATIONS = 35
DELTA_RTOL = 1e-6  # kernel D's D = rowsum(dO * O) vs the plain reduction, x max|D| (f32 sums in another order)
# head dims above 256 (the wide route; 272 also pads nothing, 300-style
# widths pad to these), held in bf16 and f32 at the train layer's b=64
# g=s=255 with nh=4
WIDE_HEAD_DIMS = (272, 384, 512, 768)
WIDE_SHAPE = (64, 255, 255, 4)
# f32 kernel vs plain: sums of up to 768 products in another order
ATTN_F32_ATOL = 1e-4  # forward, absolute
GRAD_F32_RTOL = 1e-4  # gradients, x the plain gradient's max
# the f32 wide backward (three TF32 passes) against the autograd in f64, max
# error over max |f64| of each gradient: at most this many times the plain
# f32 autograd's (cuBLAS, no TF32), as kernel B's MIPS_F64_RATIO
WIDE_F64_RATIO = 4.0


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps, flush):
    """Median device ms of ``fn`` over ``reps`` calls, CUDA events around
    each call. ``flush`` (512 MB) is rewritten before each call: every
    call finds the 50 MB L2 cache cold, as the main path does. Then the
    card spins for ~10 ms (``torch.cuda._sleep``) while the host enqueues
    the call, so a call of several launches (an autograd backward, a
    matmul and a top-k) runs back to back and the events time the
    device's work, not the host's pace between its launches; the median
    drops a call that a stall of the shared host still reached."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# --------------------------------------------------------------------- #
# phase 2: kernels vs plain versions
# --------------------------------------------------------------------- #


def attention_inputs(gen, b, g, s, nh, hd, dev, all_valid=False, dtype=torch.bfloat16):
    """(q, k, v) in ``dtype`` (bf16), the key mask and each pair's key
    count: random lengths, or every key valid (``all_valid``: random token
    ids pad nothing, as in the train steps)."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    k, v = rnd(b, s, nh, hd), rnd(b, s, nh, hd)
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    if all_valid:
        lengths = torch.full_like(lengths, s)
    key_valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    return rnd(b, g, nh, hd), k, v, key_valid, lengths


# the bi-encoder towers' training shapes (phase 9: 128-token texts, random
# tokens, every key valid): a micro-batch's 4 mentions or positives, its
# 4 x 63 hard negatives, its 4 x 64 distillation labels; the full layer
# (g=128) and the CLS-only last layer (g=1)
TOWER_SHAPES = tuple((b, g, 128) for b in (4, 252, 256) for g in (128, 1))


def check_attention(dev, flush):
    from anncur_tpu_torch.ops.attention import attention, attention_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    nh, hd = 12, 64
    max_err, timed = 0.0, []
    # (b, g, s, timed reps): the CE's full layer, final 1-row and 3-row
    # slices at 64 pairs; the bi-encoder towers' full layer and CLS-only
    # last layer (phase 7: 64 texts of 128 tokens); then, timed, the
    # build's full layer (2048 pairs per CE forward), its CLS-only final
    # layer and the train layer
    cases = [(64, 256, 256, 0, False), (64, 1, 256, 0, False), (64, 3, 256, 0, False), (64, 128, 128, 0, False),
             (64, 1, 128, 0, False), (2048, 256, 256, 10, False), (2048, 1, 256, 20, False), (64, 255, 255, 50, False)]
    cases += [(b, g, s, 30, True) for b, g, s in TOWER_SHAPES]
    for b, g, s, reps, all_valid in cases:
        q, k, v, key_valid, lengths = attention_inputs(gen, b, g, s, nh, hd, dev, all_valid)
        got = attention(q, k, v, key_valid).float()
        want = attention_plain(q, k, v, key_valid).float()
        # real query rows: all of a 1- or 3-row slice, rows < length of a full layer
        rows = torch.arange(g, device=dev)[None, :] < (lengths[:, None] if g == s else g)
        err = float((got - want).abs().amax(dim=(2, 3))[rows.expand(b, g)].max())
        del got, want
        log(f"  kernel A b={b} g={g} s={s}: max |kernel - plain| = {err:.3e} (tol {ATTN_ATOL})")
        if not err <= ATTN_ATOL:
            fail(f"attention at b={b} g={g} s={s} disagrees with its plain version: {err}")
        max_err = max(max_err, err)
        if reps:
            timed.append(time_attention(q, k, v, key_valid, lengths, reps, flush, all_valid))
            ran = list(timed[-1]["device_kernels"])
            if (g > 16) != any("attention_fwd_wgmma_kernel" in name for name in ran):
                fail(f"kernel A at b={b} g={g} s={s} ran {ran}: the Hopper body is the one for hd 64, g > 16")
    main_shape = timed[0]
    return {
        "name": "attention_fwd",
        "route": "cuda",
        "source": "anncur_tpu_torch/csrc/attention.cu",
        "replaces": "anncur_tpu/models/bert.py:278",
        "max_abs_err": max_err,
        **{key: main_shape[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "shapes": timed,
        "instantiations": instantiations("attention", "attention_fwd_bf16_kernel", "warps", BF16_INSTANTIATIONS,
                                         "attention_fwd_wgmma_kernel", "attention_fwd_wide_wgmma_kernel"),
        "wgmma_warnings": wgmma_warnings("attention"),
    }


def time_attention(q, k, v, key_valid, lengths, reps, flush, all_valid=False):
    """Kernel A, its plain version and SDPA (masked) on one input, with
    the bound of what these inputs need: q and out whole, k and v at valid
    keys only, the mask; QK^T and PV over valid keys (multiply-add = 2 ops)."""
    from anncur_tpu_torch.ops.attention import attention, attention_plain

    b, g, nh, hd = q.shape
    s = k.shape[1]
    mask = key_valid[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(lambda: attention(q, k, v, key_valid), reps, flush)
    plain_ms = time_ms(lambda: attention_plain(q, k, v, key_valid), max(3, reps // 4), flush)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps, flush
    )
    n_keys = int(lengths.sum())
    row_bytes = nh * hd * q.element_size()
    nbytes = 2 * q.numel() * q.element_size() + 2 * n_keys * row_bytes + key_valid.numel()
    ops = 4 * nh * g * n_keys * hd
    rec = {
        "shape": f"b={b} g={g} s={s} nh={nh} hd={hd} bf16, " + ("every key valid" if all_valid else "random key lengths"),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bound(nbytes, ops, "bf16"),
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / PEAK_OPS["bf16"] * 1e3,
    }
    rec["x_bound"] = ms / rec["bound_ms"]
    rec["device_kernels"] = device_kernels(lambda: attention(q, k, v, key_valid))
    log(f"  kernel A {rec['shape']}: {ms:.4f} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
        f"bytes {rec['bytes_ms']:.4f}, ops {rec['ops_ms']:.4f}), {rec['x_bound']:.2f}x bound; "
        f"plain {plain_ms:.4f} ms; SDPA {library_ms:.4f} ms ({ms / library_ms:.2f}x SDPA); "
        f"device kernels {list(rec['device_kernels'])}")
    return rec


def profiled_kernels(fn):
    """The device kernels (profiler events) of ``fn()`` under
    ``torch.profiler``, in order of start. A short spin kernel opens the
    session and is left out. Late in a long run the profiler loses kernel
    records on the H100 (a session listed one whole backward as kernel C
    alone, or none of kernel B's two kernels), so callers take several
    sessions and use the records each holds."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name),
                  key=lambda e: e.time_range.start)


def device_kernels(fn, flush=None, calls=1, sessions=12):
    """The device kernels of ``fn`` under torch.profiler (``flush``
    rewritten before each call, as ``time_ms`` does): each kernel's name
    (cut at its argument list) and its median device ms per call over the
    sessions that recorded it; sessions go on, up to ``sessions``, until
    every kernel seen has ``calls`` records."""
    fn()
    torch.cuda.synchronize()
    found = {}
    for _ in range(sessions):
        if flush is not None:
            flush.zero_()
        torch.cuda.synchronize()
        ms = {}
        for e in profiled_kernels(fn):
            if not e.name.startswith("void at::native::"):
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                ms[name] = ms.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        for name, t in ms.items():
            found.setdefault(name, []).append(t)
        if found and min(len(v) for v in found.values()) >= calls:
            break
    return {name: statistics.median(v) for name, v in sorted(found.items())}


@functools.lru_cache(maxsize=None)
def _sass(source):
    """``cuobjdump -sass`` of the built library of ``csrc/<source>.cu``, or
    None where the toolkit has no cuobjdump."""
    from anncur_tpu_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", cuda_build.library_path(source)],
                          capture_output=True, text=True, timeout=300, check=True).stdout


def ptxas_report(source):
    """Registers and spilled bytes of every entry function in the build's
    ``ptxas -v`` report of ``csrc/<source>.cu``, by mangled name."""
    from anncur_tpu_torch.ops import cuda_build

    found, fn = {}, None
    with open(cuda_build.library_path(source) + ".log") as fin:
        for line in fin:
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if entry:
                fn = found.setdefault(entry.group(1), {})
            elif fn is not None and spills:
                fn.setdefault("spill_stores", int(spills.group(1)))
                fn.setdefault("spill_loads", int(spills.group(2)))
            elif fn is not None and regs:
                fn.setdefault("registers", int(regs.group(1)))
    return found


def wgmma_warnings(source):
    """ptxas' warnings that it serialised the wgmma of a kernel (C7510 and
    up: divergent code in the warpgroup, accumulators touched between
    products) in the build of ``csrc/<source>.cu``; logged when any."""
    from anncur_tpu_torch.ops import cuda_build

    with open(cuda_build.library_path(source) + ".log") as fin:
        found = [line.strip() for line in fin if re.search(r"\(C75\d\d\)", line)]
    if found:
        log(f"  ptxas serialised wgmma in {source}: {found}")
    return found


HOPPER_LABEL = "hd=64 g>16 (wgmma)"
WIDE_HOPPER_LABEL = "hd>256 (wide route, wgmma)"
TF32_LABEL = "f32 hd>256 (wide route, wgmma in three TF32 passes)"


def instantiations(source, kernel, param, expected, hopper=None, wide_hopper=None):
    """Each instantiation (head dim, ``param``) of the bf16 body ``kernel``
    in the built library of ``csrc/<source>.cu``, its wide route's slice
    body (``kernel`` with ``_wide`` before ``_kernel``: head dims above
    256), its Hopper body ``hopper`` where it has one and its wide route's
    Hopper body ``wide_hopper`` where it has one (bf16, and f32 apart): its
    tensor-core instructions as ``cuobjdump -sass`` lists them (HMMA for
    mma.sync, HGMMA for wgmma: neither name contains the other), and its
    registers and spilled bytes from the build's ``ptxas -v`` report. Fails
    unless there are ``expected`` bf16 instantiations, each mma.sync body
    with HMMA, the Hopper bodies with HGMMA (the f32 wide one too) and the
    hd-64 Hopper body with no spilled byte."""
    pattern = re.compile(kernel + r"ILi(\d+)ELi(\d+)E")
    wide = kernel.replace("_kernel", "_wide_kernel")
    on_wgmma = (HOPPER_LABEL, WIDE_HOPPER_LABEL, TF32_LABEL)

    def label(name):
        found = pattern.search(name)
        if found:
            return f"hd={found.group(1)} {param}={found.group(2)}"
        if wide_hopper and wide_hopper + "I13__nv_bfloat16E" in name:
            return WIDE_HOPPER_LABEL
        if wide_hopper and wide_hopper + "IfE" in name:
            return TF32_LABEL
        if hopper and hopper in name:
            return HOPPER_LABEL
        return "hd>256 (wide route)" if wide in name else None

    found = {label(name): dict(rec) for name, rec in ptxas_report(source).items() if label(name)}
    sass = _sass(source)
    if sass is None:
        log(f"  {kernel}: cuobjdump not found, HMMA and HGMMA counts not measured")
    else:
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = label(line)
                if fn:
                    found.setdefault(fn, {}).update(hmma=0, hgmma=0)
            elif fn and "HGMMA" in line:
                found[fn]["hgmma"] += 1
            elif fn and "HMMA" in line:
                found[fn]["hmma"] += 1
    log(f"  {kernel} by instantiation (HMMA and HGMMA in SASS, ptxas registers and spill bytes): {found}")

    def on_tensor_cores(name, rec):
        return rec.get("hgmma") if name in on_wgmma else rec.get("hmma")

    n_bf16 = len(found) - (TF32_LABEL in found)
    if (n_bf16 != expected or (wide_hopper and TF32_LABEL not in found)
            or (sass is not None and not all(on_tensor_cores(n, r) for n, r in found.items()))):
        fail(f"{kernel} is not on the tensor cores in every one of its {expected} instantiations: {found}")
    if hopper and (found.get(HOPPER_LABEL, {}).get("spill_stores", 1) or found[HOPPER_LABEL].get("spill_loads", 1)):
        fail(f"{hopper} spills registers (ptxas): {found.get(HOPPER_LABEL)}")
    return found


def time_grad_ms(out, inputs, dout, reps, flush):
    """Device ms of the backward alone of ``out`` (a graph built once)."""
    return time_ms(lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True), reps, flush)


def bwd_inputs(gen, b, g, s, nh, hd, dev, all_valid):
    """(q, k, v, key_valid, lengths, rows, dout) for the backward: random
    key lengths, or every key valid (``all_valid``: the train step's
    random token ids pad nothing); ``rows`` are the rows that reach a loss
    (those below a pair's length in a full layer, all of a 1-row slice),
    and dO is 0 at the others, as in the CE."""
    q, k, v, key_valid, lengths = attention_inputs(gen, b, g, s, nh, hd, dev, all_valid)
    rows = (torch.arange(g, device=dev)[None, :] < (lengths[:, None] if g == s else g)).expand(b, g)
    dout = (torch.randn(q.shape, generator=gen, device=dev) * rows[:, :, None, None]).to(q.dtype)
    return q, k, v, key_valid, lengths, rows, dout


def run_bwd(q, k, v, key_valid, dout, out, lse):
    """Kernel D (dQ and D = rowsum(dO * O)), then kernel C (dK, dV), as the
    autograd runs them: (dq, dk, dv, delta)."""
    from anncur_tpu_torch.ops.attention import attention_bwd_dkv, attention_bwd_dq

    dq, delta = attention_bwd_dq(q, k, v, key_valid, dout, out, lse)
    return (dq, *attention_bwd_dkv(q, k, v, key_valid, dout, lse, delta), delta)


def check_bwd_case(case, errs, what):
    """Kernels D and C (and kernel A's lse) against the plain autograd on
    one input, at the rows that reach a loss and the valid keys; masked
    keys must get exactly zero dK and dV; D's delta against the plain
    rowsum(dO * O); a second launch must give the same bits. Raises
    ``errs`` to the errors."""
    from anncur_tpu_torch.ops.attention import attention_bwd_plain, attention_delta_plain, attention_fwd

    q, k, v, key_valid, _, rows, dout = case
    hd = q.shape[-1]
    out, lse = attention_fwd(q, k, v, key_valid, with_lse=True)
    dq, dk, dv, delta = got = run_bwd(q, k, v, key_valid, dout, out, lse)
    again = run_bwd(q, k, v, key_valid, dout, out, lse)
    want = attention_bwd_plain(q, k, v, key_valid, dout)
    want_delta = attention_delta_plain(dout, out)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
    want_lse = torch.logsumexp(scores + torch.where(key_valid, 0.0, -1e9)[:, None, None, :], dim=-1)
    torch.cuda.synchronize()
    lse_err = float(((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).transpose(1, 2)[rows].max())
    for name, res, ref, sel in (("dq", dq, want[0], rows), ("dkv", dk, want[1], key_valid), ("dkv", dv, want[2], key_valid)):
        err = float((res.float() - ref.float()).abs().amax(dim=(2, 3))[sel].max() / ref.float().abs().max())
        errs[name] = max(errs[name], err)
    zero = bool((dk[~key_valid] == 0).all() and (dv[~key_valid] == 0).all())
    delta_err = float((delta - want_delta).abs().max() / want_delta.abs().max())
    errs["delta"] = max(errs["delta"], delta_err)
    differ = [name for name, a, b in zip(("dq", "dk", "dv", "delta"), got, again) if not torch.equal(a, b)]
    same = not differ
    log(f"  kernels C/D {what}: max |kernel - plain| / max|plain| dQ {errs['dq']:.3e}, dK/dV {errs['dkv']:.3e} (tol {GRAD_RTOL}); masked keys zero: {zero}; D's delta rel err {delta_err:.2e} (tol {DELTA_RTOL}); same bits twice: {same}; lse rel err {lse_err:.2e}")
    if not (errs["dq"] <= GRAD_RTOL and errs["dkv"] <= GRAD_RTOL and zero and delta_err <= DELTA_RTOL and same):
        fail(f"attention backward kernels disagree with the plain autograd at {what}: {errs}, masked keys zero {zero}, "
             f"outputs that differ between two launches {differ}")
    if not lse_err <= LSE_RTOL:
        fail(f"kernel A's lse disagrees with logsumexp at {what}: {lse_err}")
    errs["lse"] = max(errs["lse"], lse_err)


def time_bwd_case(case, what, flush):
    """Kernels D and C on one input, in that order, each beside its bound,
    with the port's whole attention backward (autograd through kernel A's
    graph: D, which also writes D = rowsum(dO * O), then C), the plain
    autograd and SDPA's backward (masked where a key is masked) beside
    both."""
    from anncur_tpu_torch.ops.attention import attention, attention_bwd_dkv, attention_bwd_dq, attention_fwd, attention_plain

    q, k, v, key_valid, lengths, _, dout = case
    b, g, nh, hd = q.shape
    out, lse = attention_fwd(q, k, v, key_valid, with_lse=True)
    dq_ms = time_ms(lambda: attention_bwd_dq(q, k, v, key_valid, dout, out, lse), 20, flush)
    _, delta = attention_bwd_dq(q, k, v, key_valid, dout, out, lse)
    dkv_ms = time_ms(lambda: attention_bwd_dkv(q, k, v, key_valid, dout, lse, delta), 20, flush)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    whole_ms = time_grad_ms(attention(*leaves, key_valid), leaves, dout, 20, flush)
    plain_ms = time_grad_ms(attention_plain(*leaves, key_valid), leaves, dout, 5, flush)
    lib_leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    mask = None if bool(key_valid.all()) else key_valid[:, None, None, :]
    lib_out = torch.nn.functional.scaled_dot_product_attention(*lib_leaves, attn_mask=mask)
    library_ms = time_grad_ms(lib_out, lib_leaves, dout.transpose(1, 2), 20, flush)
    # what these inputs need: q, dO (all rows), k and v at valid keys, lse
    # and D read (D writes D, C reads it); C writes dK, dV at valid keys, D
    # reads O and writes dQ. Operations over the valid keys: C does 4
    # products (S, dP, dV, dK), D 3 (S, dP, dQ)
    n_keys = int(lengths.sum())
    row_bytes = nh * hd * q.element_size()
    common = 2 * q.numel() * q.element_size() + 2 * n_keys * row_bytes + 2 * lse.numel() * 4 + key_valid.numel()
    pair_ops = 2 * nh * g * n_keys * hd  # one product of (g x valid keys x hd)
    both = {"shape": what, "plain_ms": plain_ms, "library_ms": library_ms, "whole_backward_ms": whole_ms}
    recs = (
        {"ms": dkv_ms, **bound(common + 2 * n_keys * row_bytes, 4 * pair_ops, "bf16"), **both},
        {"ms": dq_ms, **bound(common + 2 * q.numel() * q.element_size(), 3 * pair_ops, "bf16"), **both},
    )
    for rec in recs:
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    log(f"  kernels D/C {what}: D {dq_ms:.4f} ms (bound {recs[1]['bound_ms']:.4f}, {recs[1]['bound_by']}, "
        f"{recs[1]['x_bound']:.2f}x), C {dkv_ms:.4f} ms (bound {recs[0]['bound_ms']:.4f}, {recs[0]['bound_by']}, "
        f"{recs[0]['x_bound']:.2f}x), C + D {dkv_ms + dq_ms:.4f} ms; whole backward {whole_ms:.4f} ms; "
        f"SDPA backward {library_ms:.4f} ms (whole / SDPA {whole_ms / library_ms:.2f}x); plain {plain_ms:.4f} ms")
    return recs


def profile_bwd(case, what, tries=10):
    """One whole backward through the autograd under ``torch.profiler``:
    its device work must be exactly kernel D, then kernel C (no torch
    reduction, copy or cast beside them). A session that records any other
    kernel fails at once; one that lost a record of the two is taken again
    (``profiled_kernels``), up to ``tries`` sessions. Returns the kernels'
    names and device microseconds in order."""
    from anncur_tpu_torch.ops.attention import attention

    q, k, v, key_valid, _, _, dout = case
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves, key_valid)
    torch.autograd.grad(out, leaves, dout, retain_graph=True)  # warm
    torch.cuda.synchronize()
    for _ in range(tries):
        seen = [(e.name, float(e.time_range.end - e.time_range.start))
                for e in profiled_kernels(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))]
        log(f"  profiler, one whole backward at {what}: {len(seen)} device kernels "
            f"{[(n[:90], round(t, 2)) for n, t in seen]}")
        if not all("attention_bwd_dq" in n or "attention_bwd_dkv" in n for n, _ in seen):
            break  # other device work: fails at once
        if len(seen) == 2 and "attention_bwd_dq" in seen[0][0] and "attention_bwd_dkv" in seen[1][0]:
            return [{"name": n, "us": t} for n, t in seen]
    fail(f"the whole backward at {what} is not exactly kernel D then kernel C: {seen}")


def check_attention_bwd(dev, flush):
    """Kernels C and D (and kernel A's lse) against the plain autograd at
    the training shape, 64 pairs of 255 tokens of random key lengths (full
    layer and CLS-only final layer), then timed there and at the CE train
    step's own inputs (the 63 negative pairs and the 1 positive pair of a
    micro-batch, every key valid) and at the bi-encoder towers' training
    shapes (TOWER_SHAPES, every key valid; the g=1 last layer too, and g=2,
    the input tower's tag rows under spl_tkns, checked)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    s, nh, hd = 255, 12, 64
    errs = {"dkv": 0.0, "dq": 0.0, "lse": 0.0, "delta": 0.0}
    check_bwd_case(bwd_inputs(gen, 64, 1, s, nh, hd, dev, False), errs, f"b=64 g=1 s={s}")
    check_bwd_case(bwd_inputs(gen, 64, 2, 128, nh, hd, dev, True), errs, "b=64 g=2 s=128, every key valid")
    # the Hopper bodies at a g that is no multiple of 64 (a part-padding last query tile)
    check_bwd_case(bwd_inputs(gen, 64, 100, s, nh, hd, dev, False), errs, f"b=64 g=100 s={s}")
    timed, profiled = [], None
    for b, g, s_, all_valid in ((64, s, s, False), (63, s, s, True), (1, s, s, True)) + tuple(
            (b, g, s_, True) for b, g, s_ in TOWER_SHAPES):
        what = f"b={b} g={g} s={s_} nh={nh} hd={hd} bf16, " + ("every key valid" if all_valid else "random key lengths")
        case = bwd_inputs(gen, b, g, s_, nh, hd, dev, all_valid)
        check_bwd_case(case, errs, what)
        timed.append(time_bwd_case(case, what, flush))
        if b == 63:
            profiled = profile_bwd(case, what)
    common = {"route": "cuda", "source": "anncur_tpu_torch/csrc/attention_bwd.cu"}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "whole_backward_ms", "shape")
    kernels = []
    for i, (name, replaces, kernel, param, hopper) in enumerate((
        ("attention_bwd_dkv", "jax/experimental/pallas/ops/tpu/flash_attention.py:1121", "attention_bwd_dkv_bf16_kernel",
         "query_tile", "attention_bwd_dkv_wgmma_kernel"),
        ("attention_bwd_dq", "jax/experimental/pallas/ops/tpu/flash_attention.py:1456", "attention_bwd_dq_bf16_kernel",
         "warps", "attention_bwd_dq_wgmma_kernel"),
    )):
        shapes = [recs[i] for recs in timed]
        kernels.append({
            "name": name, "replaces": replaces, **common,
            "max_abs_err": errs["dkv" if i == 0 else "dq"],
            **{key: shapes[0][key] for key in keys}, "shapes": shapes,
            "instantiations": instantiations("attention_bwd", kernel, param, BF16_INSTANTIATIONS, hopper,
                                             kernel.replace("_bf16_kernel", "_wide_wgmma_kernel")),
        })
    kernels[1]["delta_rel_err"] = errs["delta"]
    kernels[1]["whole_backward_profile"] = profiled
    kernels[0]["wgmma_warnings"] = wgmma_warnings("attention_bwd")
    return errs["lse"], kernels


# the wide route past the s (kernels A and D) or g (kernel C) whose stored
# tiles fit in a block's shared memory: A's P (bf16 s 1472, f32 448;
# attention.cu's launch_wide), C's P^T and dS^T (g 640, 256) and D's dS (s
# 1280, 512; attention_bwd.cu's launch_wide), at hd 272, b=8, nh=4 with
# random key lengths: (dtype, g, s, A's body, D's body, C's body), "wgmma"
# the Hopper body and "slices" the slice body that recomputes the scores
# for each output slice; each slice body runs at least once
WIDE_PAST_LIMIT = (
    (torch.bfloat16, 641, 641, "wgmma", "wgmma", "slices"), (torch.bfloat16, 100, 1281, "wgmma", "slices", "wgmma"),
    (torch.bfloat16, 100, 1473, "slices", "slices", "wgmma"),
    (torch.float32, 257, 257, "wgmma", "wgmma", "slices"), (torch.float32, 100, 513, "slices", "slices", "wgmma"),
)


def check_attention_wide(dev, flush):
    """Head dims above 256 (the wide route of kernels A, C and D): at each
    of WIDE_HEAD_DIMS, in bf16 and f32, at WIDE_SHAPE with random key
    lengths, ``attention`` and its autograd (``AttentionFunction``: A with
    the lse, then C and D) and A's lse against the plain versions
    (``wide_case``), A, C and D on their Hopper bodies (``wide_bodies``),
    the f32 forward and backward against f64; then A, C and D timed, each
    beside its bound, the plain version and SDPA. Then the shapes of
    WIDE_PAST_LIMIT, where A, C or D takes its slice body, checked the same
    way. Returns one record per (hd, dtype) with the errors and times of
    the three kernels, and one per shape past the limit."""
    b, g, s, nh = WIDE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(12)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for hd in WIDE_HEAD_DIMS:
            q, k, v, key_valid, lengths = attention_inputs(gen, b, g, s, nh, hd, dev, dtype=dtype)
            rows = (torch.arange(g, device=dev)[None, :] < lengths[:, None]).expand(b, g)
            dout = (torch.randn(q.shape, generator=gen, device=dev) * rows[:, :, None, None]).to(dtype)
            what = f"hd={hd} {name} b={b} g=s={s} nh={nh}"
            fwd_err, lse_err, errs, got = wide_case(q, k, v, key_valid, rows, dout, what)
            f64 = wide_f64_accuracy(q, k, v, key_valid, dout, got, what) if dtype == torch.float32 else None
            del got
            bodies = wide_bodies(q, k, v, key_valid, dout, ("wgmma",) * 3, what)
            rec = {"hd": hd, "dtype": name, "fwd_err": fwd_err, "lse_rel_err": lse_err, "grad_rel_err": errs,
                   "f64": f64, **time_wide(q, k, v, key_valid, lengths, dout, what, flush)}
            rec["A"]["body"], rec["D"]["body"], rec["C"]["body"] = bodies
            recs.append(rec)
    past, b, hd = [], 8, 272
    for dtype, g, s, *expect in WIDE_PAST_LIMIT:
        q, k, v, key_valid, lengths = attention_inputs(gen, b, g, s, nh, hd, dev, dtype=dtype)
        rows = (torch.arange(g, device=dev)[None, :] < lengths[:, None]).expand(b, g) if g == s else \
            torch.ones(b, g, dtype=torch.bool, device=dev)
        dout = (torch.randn(q.shape, generator=gen, device=dev) * rows[:, :, None, None]).to(dtype)
        what = f"hd={hd} {'bf16' if dtype == torch.bfloat16 else 'f32'} b={b} g={g} s={s} nh={nh}, past the staging limit"
        fwd_err, lse_err, errs, _ = wide_case(q, k, v, key_valid, rows, dout, what)
        bodies = wide_bodies(q, k, v, key_valid, dout, expect, what)
        past.append({"shape": what, "fwd_err": fwd_err, "lse_rel_err": lse_err, "grad_rel_err": errs,
                     **{f"{key}_body": body for key, body in zip("ADC", bodies)}})
    return recs, past


def wide_case(q, k, v, key_valid, rows, dout, what):
    """``attention`` and its autograd at one wide input against the plain
    attention and its autograd at the real ``rows`` and valid keys (bf16
    ATTN_ATOL and GRAD_RTOL, f32 ATTN_F32_ATOL and GRAD_F32_RTOL), masked
    keys' dK and dV exactly zero; launch counts set to 0 just before: the
    call launches A, C and D once each and the plain attention never. Then
    A's lse at the real rows against logsumexp (LSE_RTOL, taken without the
    -1e9 in a pair with no valid key). Returns the forward's error, the
    lse's, the gradients' errors (x the plain gradient's max) and the
    gradients."""
    from anncur_tpu_torch.ops import attention as attn_mod
    from anncur_tpu_torch.ops.attention import attention, attention_bwd_plain, attention_fwd, attention_plain

    fwd_tol, grad_tol = (ATTN_ATOL, GRAD_RTOL) if q.dtype == torch.bfloat16 else (ATTN_F32_ATOL, GRAD_F32_RTOL)
    plain_calls = []

    def counted_plain(*a, **k):
        plain_calls.append(1)
        return attention_plain(*a, **k)

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    reset_counts()
    attn_mod.attention_plain = counted_plain
    try:
        out = attention(*leaves, key_valid)
        got = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
    finally:
        attn_mod.attention_plain = attention_plain
    counts = read_counts()
    want_out = attention_plain(q, k, v, key_valid)
    want = attention_bwd_plain(q, k, v, key_valid, dout)
    fwd_err = float((out.detach().float() - want_out.float()).abs().amax(dim=(2, 3))[rows].max())
    errs = {}
    for key, a, w, sel in (("dq", got[0], want[0], rows), ("dk", got[1], want[1], key_valid),
                           ("dv", got[2], want[2], key_valid)):
        errs[key] = float((a.float() - w.float()).abs().amax(dim=(2, 3))[sel].max() / w.float().abs().max())
    zero = bool((got[1][~key_valid] == 0).all() and (got[2][~key_valid] == 0).all())
    launched = (counts["attention_fwd"], counts["attention_bwd_dkv"], counts["attention_bwd_dq"])
    lse = attention_fwd(q, k, v, key_valid, with_lse=True)[1]
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    shift = torch.where(key_valid.any(dim=1), 0.0, -1e9)[:, None, None, None]
    want_lse = torch.logsumexp(scores + torch.where(key_valid, 0.0, -1e9)[:, None, None, :] - shift, dim=-1)
    lse_err = float(((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).transpose(1, 2)[rows].max())
    del scores, want_lse
    log(f"  wide route {what}: forward max |kernel - plain| {fwd_err:.3e} (tol {fwd_tol}); lse rel err {lse_err:.2e} "
        f"(tol {LSE_RTOL}); dQ/dK/dV {errs['dq']:.3e}/{errs['dk']:.3e}/{errs['dv']:.3e} x max (tol {grad_tol}); "
        f"masked keys zero: {zero}; launches A/C/D {launched}, plain attention {len(plain_calls)}")
    if not (fwd_err <= fwd_tol and lse_err <= LSE_RTOL and max(errs.values()) <= grad_tol and zero):
        fail(f"the wide route disagrees with the plain attention at {what}: forward {fwd_err}, lse {lse_err}, {errs}, "
             f"masked keys zero {zero}")
    if launched != (1, 1, 1) or plain_calls:
        fail(f"at {what} the call launched A/C/D {launched} times and the plain attention {len(plain_calls)}")
    return fwd_err, lse_err, errs, got


def wide_bodies(q, k, v, key_valid, dout, expect, what, tries=10):
    """The device kernels of the wide forward (kernel A) and backward
    (kernel D, then C, as ``run_bwd`` launches them) under
    ``torch.profiler``: fails unless they are exactly the bodies ``expect``
    names, A's, D's, then C's ("wgmma": the Hopper body; "slices": the
    slice body). Each session runs the forward, or the backward, twice,
    since the profiler loses records late in a long run (often the first
    kernel after the spin): it must record A's body (the backward: D's
    directly followed by C's), and is taken again otherwise, up to
    ``tries`` (``profiled_kernels``); one that records another body fails
    at once. Returns A's, D's and C's kernel names."""
    from anncur_tpu_torch.ops.attention import attention_fwd

    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    want = [f"attention_{kern}_wide_wgmma_kernel" if body == "wgmma" else f"attention_{kern}_{dt}_wide_kernel"
            for kern, body in zip(("fwd", "bwd_dq", "bwd_dkv"), expect)]
    out, lse = attention_fwd(q, k, v, key_valid, with_lse=True)

    def fwd():
        return attention_fwd(q, k, v, key_valid, with_lse=True)

    def bwd():
        return run_bwd(q, k, v, key_valid, dout, out, lse)

    found = []
    for fn, names, tag in ((fwd, want[:1], "attention_fwd"), (bwd, want[1:], "attention_bwd")):
        fn()
        torch.cuda.synchronize()
        seen, run = [], None
        for _ in range(tries):
            seen = [e.name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                    for e in profiled_kernels(lambda: (fn(), fn())) if tag in e.name]
            if not all(any(w in n for w in names) for n in seen):
                break  # another body: fails at once
            run = next((list(group) for group in zip(*(seen[i:] for i in range(len(names))))
                        if all(w in n for w, n in zip(names, group))), None)
            if run:
                break
        if not run:
            fail(f"the wide {'forward' if fn is fwd else 'backward'} at {what} did not run exactly {names}, "
                 f"in that order: {seen}")
        found += run
    log(f"  wide route {what}: the forward ran {found[0]}, the backward {found[1:]}")
    return found


def wide_f64_accuracy(q, k, v, key_valid, dout, got, what):
    """The f32 wide forward (kernel A's O and lse) and backward (``got``:
    dQ, dK, dV through kernels D and C) against the plain attention and its
    autograd in f64: max |error| over max |f64| of each, beside the plain
    f32 version's (cuBLAS, no TF32; the lse a logsumexp of its f32 scores);
    fails past WIDE_F64_RATIO times the plain error."""
    from anncur_tpu_torch.ops.attention import attention_bwd_plain, attention_fwd, attention_plain
    from anncur_tpu_torch.utils.device import true_f32

    out, lse = attention_fwd(q, k, v, key_valid, with_lse=True)
    bias = torch.where(key_valid, 0.0, -1e9)[:, None, None, :]
    with true_f32():
        plain = attention_bwd_plain(q, k, v, key_valid, dout)
        plain_out = attention_plain(q, k, v, key_valid)
        plain_lse = torch.logsumexp(torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(q.shape[-1]) + bias, dim=-1)
    with torch.enable_grad():
        leaves = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
        scores = torch.einsum("bqnd,bknd->bnqk", leaves[0], leaves[1]) / math.sqrt(q.shape[-1]) + bias.double()
        exact_out = torch.einsum("bnqk,bknd->bqnd", torch.softmax(scores, dim=-1), leaves[2])
        exact = torch.autograd.grad(exact_out, leaves, dout.double())
    exact_lse = torch.logsumexp(scores.detach(), dim=-1)
    rec = {}
    for name, a, p, e in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *got), (plain_out, plain_lse, *plain),
                             (exact_out.detach(), exact_lse, *exact)):
        scale = float(e.abs().max())
        rec[name] = {"kernel": float((a.double() - e).abs().max()) / scale,
                     "plain_f32": float((p.double() - e).abs().max()) / scale}
        rec[name]["ratio"] = rec[name]["kernel"] / rec[name]["plain_f32"]
    del plain, exact, leaves, scores, exact_out, exact_lse
    log(f"  wide route {what} against f64 (x max |f64|): " + ", ".join(
        f"{n} {r['kernel']:.3e} (plain f32 {r['plain_f32']:.3e}, ratio {r['ratio']:.2f})" for n, r in rec.items())
        + f" (limit {WIDE_F64_RATIO})")
    if not max(r["ratio"] for r in rec.values()) <= WIDE_F64_RATIO:
        fail(f"the f32 wide route at {what} is not f32-accurate: {rec}")
    return rec


def time_wide(q, k, v, key_valid, lengths, dout, what, flush):
    """Kernels A, D and C at one wide input, each beside its bound (bytes:
    each input read once at valid keys, each output written once;
    operations: its products over the valid keys at the dtype's peak; in
    f32 as three TF32 passes on the tensor cores, the FFMA bound beside
    it), the port's whole backward (D then C through the autograd), the
    plain version's and SDPA's forward and whole backward."""
    from anncur_tpu_torch.ops.attention import attention, attention_bwd_dkv, attention_bwd_dq, attention_fwd, attention_plain

    b, g, nh, hd = q.shape
    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    reps = 10
    with torch.no_grad():
        a_ms = time_ms(lambda: attention(q, k, v, key_valid), reps, flush)
        plain_ms = time_ms(lambda: attention_plain(q, k, v, key_valid), 3, flush)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=key_valid[:, None, None, :]), reps, flush)
        out, lse = attention_fwd(q, k, v, key_valid, with_lse=True)
        d_ms = time_ms(lambda: attention_bwd_dq(q, k, v, key_valid, dout, out, lse), reps, flush)
        _, delta = attention_bwd_dq(q, k, v, key_valid, dout, out, lse)
        c_ms = time_ms(lambda: attention_bwd_dkv(q, k, v, key_valid, dout, lse, delta), reps, flush)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    whole_ms = time_grad_ms(attention(*leaves, key_valid), leaves, dout, reps, flush)
    plain_bwd_ms = time_grad_ms(attention_plain(*leaves, key_valid), leaves, dout, 3, flush)
    lib_leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(*lib_leaves, attn_mask=key_valid[:, None, None, :])
    sdpa_bwd_ms = time_grad_ms(lib_out, lib_leaves, dout.transpose(1, 2), reps, flush)
    n_keys = int(lengths.sum())
    es = q.element_size()
    row_bytes = nh * hd * es
    qo = q.numel() * es  # q, or out, or dO, or dQ
    kv_valid = n_keys * row_bytes  # k or v (or dK, dV) at the valid keys
    pair_ops = 2 * nh * g * n_keys * hd  # one product of (g x valid keys x hd)
    stats = 2 * b * nh * g * 4  # lse and D

    def kernel_bound(nbytes, ops):
        if dt == "bf16":
            return bound(nbytes, ops, dt)
        return {**bound(nbytes, TF32_PASSES * ops, "tf32"), "ffma_bound_ms": bound(nbytes, ops, "f32")["bound_ms"]}

    recs = {
        "A": {"ms": a_ms, **kernel_bound(2 * qo + 2 * kv_valid + key_valid.numel(), 2 * pair_ops),
              "plain_ms": plain_ms, "library_ms": sdpa_ms},
        "C": {"ms": c_ms, **kernel_bound(2 * qo + 4 * kv_valid + stats + key_valid.numel(), 4 * pair_ops),
              "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms, "whole_backward_ms": whole_ms},
        "D": {"ms": d_ms, **kernel_bound(4 * qo + 2 * kv_valid + stats + key_valid.numel(), 3 * pair_ops),
              "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms, "whole_backward_ms": whole_ms},
    }
    for rec in recs.values():
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    log(f"  wide route {what}: A {a_ms:.4f} ms (bound {recs['A']['bound_ms']:.4f}, {recs['A']['bound_by']}; plain "
        f"{plain_ms:.4f}, SDPA {sdpa_ms:.4f}); C {c_ms:.4f} (bound {recs['C']['bound_ms']:.4f}), D {d_ms:.4f} "
        f"(bound {recs['D']['bound_ms']:.4f}); whole backward {whole_ms:.4f}, plain {plain_bwd_ms:.4f}, SDPA {sdpa_bwd_ms:.4f}")
    return recs


# kernel B's timed shapes (q, d, n, n_valid, k, S excluded ids per row): a
# cost-600 serve batch (phase 4's), one text (CurRetriever.query), an eval
# batch at ZeShEL-military's entity count (anncur_tpu/ops/mips_pallas.py:
# 25-30), and the last growth round of 210 over 8 at the bench's adaptive
# batch of 512 (phase 6's widths: weights over 500 train rows)
MIPS_SHAPES = (
    (32, 500, 10240, 10000, 100, 0), (1, 500, 10240, 10000, 100, 0), (256, 500, 104520, 104520, 100, 0),
    (512, 500, 10240, 10000, 26, 184),
)
MIPS_KERNELS = ("mips_score_tc_kernel", "mips_score_kernel", "mips_select_kernel", "mips_sort_chunk_kernel",
                "mips_sort_step_kernel")


def mips_inputs(gen, dev, q, d, n, n_valid):
    queries = torch.randn(q, d, generator=gen, device=dev)
    items = torch.randn(n, d, generator=gen, device=dev)
    # ties: each query's best item duplicated at another valid position,
    # and query 0's best copied into the padding (must never be selected)
    best = (queries @ items[:n_valid].T).argmax(dim=1)
    dup_at = torch.randperm(n_valid, generator=gen, device=dev)[:q]
    items[dup_at] = items[best]
    if n_valid < n:
        items[n_valid + (n - n_valid) // 2] = items[best[0]]
    return queries, items.contiguous()


def check_mips(queries, items, k, n_valid, what, exclude=None, int8=False):
    """Kernel B (its int8 entry when ``int8``, ``items`` then quantised)
    against its plain version on one input."""
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused, mips_topk_int8_fused
    from anncur_tpu_torch.ops.quantized import mips_topk_int8_plain

    fused, plain = (mips_topk_int8_fused, mips_topk_int8_plain) if int8 else (mips_topk_fused, mips_topk)
    s_k, i_k = fused(queries, items, k, n_valid, exclude)
    s_p, i_p = plain(queries, items, k, n_valid, exclude)
    torch.cuda.synchronize()
    if exclude is not None and bool((i_k[:, :, None] == exclude[:, None, :]).any()):
        fail(f"{what}: kernel B selected an excluded id")
    scale = float(s_p.abs().max())
    err = float((s_k - s_p).abs().max())
    if not err <= MIPS_RTOL * scale:
        fail(f"{what}: kernel B scores differ from plain by {err} (scale {scale})")
    if int(i_k.max()) >= n_valid or int(i_k.min()) < 0:
        fail(f"{what}: kernel B selected a column >= n_valid or < 0")
    # ids where the plain score stands apart from both neighbours
    gap = -(s_p[:, 1:] - s_p[:, :-1])
    sep = torch.ones_like(s_p, dtype=torch.bool)
    sep[:, :-1] &= gap > MIPS_TIE_GAP * scale
    sep[:, 1:] &= gap > MIPS_TIE_GAP * scale
    if not torch.equal(i_k[sep], i_p[sep]):
        fail(f"{what}: kernel B ids differ from plain at separated scores")
    # ties (exactly equal kernel scores) go to the smaller id
    tied = s_k[:, 1:] == s_k[:, :-1]
    if not bool((i_k[:, 1:] > i_k[:, :-1])[tied].all()):
        fail(f"{what}: kernel B broke a tie towards the larger id")
    if not bool((s_k[:, 1:] <= s_k[:, :-1]).all()):
        fail(f"{what}: kernel B scores not descending")
    log(
        f"  {what}: max |kernel - plain| = {err:.3e} (scale {scale:.1f}), "
        f"{int(sep.sum())}/{sep.numel()} ids compared, {int(tied.sum())} ties in order"
    )
    return err


def time_mips(fused, plain, queries, items, k, n_valid, flush, exclude=None):
    """Kernel B (``fused``), its plain version and ``torch.topk(queries @
    items.T, k)`` (with exclusions, ``scatter_`` of -inf between the two;
    for int8 items, ``QuantizedItems``, the dequantising cast, the matmul
    and the scale before the top-k) on one input, with the bound of what
    the call needs: the queries, the n_valid real item rows (and scales)
    and the exclusion lists read, the outputs written; f32 rows: 2 q n_valid
    d operations as an f32-accurate product on the tensor cores (three TF32
    passes), the FFMA figure beside it; int8 rows: at the FFMA rate. The
    score stage and the select (and sorts) apart: their device kernels under
    torch.profiler, median of 3 calls, L2 flushed before each."""
    q, d = queries.shape
    n_ex = 0 if exclude is None else exclude.shape[1]
    int8 = hasattr(items, "scales")
    ms = time_ms(lambda: fused(queries, items, k, n_valid, exclude), 30, flush)
    plain_ms = time_ms(lambda: plain(queries, items, k, n_valid, exclude), 5 if q * n_valid > 1e7 else 20, flush)
    if int8:
        values, scales = items.values[:n_valid], items.scales[:n_valid, 0]
        library = lambda: torch.topk((queries @ values.float().T) * scales, k)  # noqa: E731
        item_bytes = n_valid * (d + 4)
    elif exclude is None:
        library = lambda: torch.topk(queries @ items[:n_valid].T, k)  # noqa: E731
        item_bytes = 4 * n_valid * d
    else:
        library = lambda: torch.topk((queries @ items[:n_valid].T).scatter_(1, exclude, -torch.inf), k)  # noqa: E731
        item_bytes = 4 * n_valid * d
    library_ms = time_ms(library, 30, flush)
    nbytes = 4 * q * d + item_bytes + 8 * q * n_ex + q * k * (4 + 8)
    ops = 2 * q * n_valid * d
    tc_before = getattr(fused, "tc_launches", 0)
    kernels = device_kernels(lambda: fused(queries, items, k, n_valid, exclude), flush, calls=3)
    on_tc = getattr(fused, "tc_launches", 0) > tc_before  # the wrapper's count: a checkout without the route has none
    score = [t for name, t in kernels.items() if "mips_score" in name]
    select = [t for name, t in kernels.items() if "mips_score" not in name]
    # the profiler's records of both stages, or None (not measured)
    score_ms = sum(score) if score and select else None
    select_ms = sum(select) if score and select else None
    rec = {"shape": f"q={q} d={d} n={items.shape[0]} n_valid={n_valid} k={k} S={n_ex} {'int8' if int8 else 'f32'}",
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           **(bound(nbytes, ops, "f32") if int8 else bound(nbytes, TF32_PASSES * ops, "tf32")),
           "ffma_bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["f32"]) * 1e3,
           "score_route": "tensor cores (3xTF32)" if on_tc else "FFMA",
           "score_ms": score_ms, "select_ms": select_ms, "device_kernels": kernels}
    rec["x_bound"] = ms / rec["bound_ms"]
    lib_name = ("dequantise + matmul x scale + topk" if int8 else
                "matmul + topk" if exclude is None else "matmul + scatter_ + topk")
    split = "not measured" if score_ms is None else f"{score_ms:.4f}, select {select_ms:.4f}"
    log(f"  kernel B {rec['shape']}: {ms:.4f} ms (score on {rec['score_route']}: {split}); bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; FFMA {rec['ffma_bound_ms']:.4f}), "
        f"{rec['x_bound']:.2f}x bound; plain {plain_ms:.4f} ms; {lib_name} {library_ms:.4f} ms "
        f"({ms / library_ms:.2f}x library)")
    return rec


def f64_accuracy(queries, items, k, what, chunk=1024):
    """Kernel B's top-k scores against the f64 products at their ids, max
    |error| / max |f64|, beside the plain f32 matmul's (cuBLAS, no TF32) at
    the same entries; fails past MIPS_F64_RATIO times the plain error."""
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused
    from anncur_tpu_torch.utils.device import true_f32

    s_k, i_k = mips_topk_fused(queries, items, k)
    err_k = err_p = scale = 0.0
    with true_f32():
        for q0 in range(0, queries.shape[0], chunk):
            qs, ids = queries[q0:q0 + chunk], i_k[q0:q0 + chunk]
            exact = torch.einsum("qd,qkd->qk", qs.double(), items[ids].double())
            plain = torch.gather(qs @ items.T, 1, ids)
            scale = max(scale, float(exact.abs().max()))
            err_k = max(err_k, float((s_k[q0:q0 + chunk].double() - exact).abs().max()))
            err_p = max(err_p, float((plain.double() - exact).abs().max()))
            del exact, plain
    rec = {"kernel_rel_err_f64": err_k / scale, "plain_f32_rel_err_f64": err_p / scale}
    rec["ratio"] = err_k / err_p if err_p else (0.0 if err_k == 0 else math.inf)
    log(f"  {what} against f64: kernel B {rec['kernel_rel_err_f64']:.3e}, plain f32 matmul "
        f"{rec['plain_f32_rel_err_f64']:.3e} (x max |f64|), ratio {rec['ratio']:.2f} (limit {MIPS_F64_RATIO})")
    if not rec["ratio"] <= MIPS_F64_RATIO:
        fail(f"{what}: kernel B is not f32-accurate: {rec}")
    return rec


def mips_ptxas():
    """Registers and spills of each of kernel B's kernels (the score GEMM
    by tiling: VEC, item type, BM x BN, TM x TN, BK, stages)."""
    tiling = re.compile(r"ScoreTileILb(\d)ELb(\d)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")
    out = {}
    for name, rec in ptxas_report("mips_topk").items():
        kernel = next((kern for kern in MIPS_KERNELS if kern in name), None)
        found = tiling.search(name)
        if kernel and found:
            vec, i8, bm, bn, tm, tn, bk, st = found.groups()
            kernel += f" {'16B' if vec == '1' else '4B'} {'int8' if i8 == '1' else 'f32'} {bm}x{bn} {tm}x{tn} bk{bk} s{st}"
        if kernel:
            out[kernel] = rec
    log(f"  kernel B's kernels (ptxas registers and spill bytes): {out}")
    if not all(any(name.startswith(kern) for name in out) for kern in MIPS_KERNELS):
        fail(f"kernel B's build lacks one of {MIPS_KERNELS}: {sorted(out)}")
    if sum(" int8 " in name for name in out) != 6:
        fail(f"kernel B's build lacks its six int8 score GEMMs: {sorted(out)}")
    tc = out["mips_score_tc_kernel"]
    if tc.get("spill_stores", 1) or tc.get("spill_loads", 1):
        fail(f"kernel B's tensor-core score kernel spills registers (ptxas): {tc}")
    return out


def check_mips_kernel(dev, flush):
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused

    gen = torch.Generator(device=dev).manual_seed(2)
    err, timed = 0.0, []
    for q, d, n, n_valid, k, n_ex in MIPS_SHAPES:
        queries, items = mips_inputs(gen, dev, q, d, n, n_valid)
        # a growth round's exclusions: the ids the query scored, here its
        # best ones, so the pick must reach past them
        exclude = mips_topk(queries, items, n_ex, n_valid)[1] if n_ex else None
        what = f"kernel B q={q} d={d} n={n} k={k} S={n_ex}"
        err = max(err, check_mips(queries, items, k, n_valid, what, exclude))
        if q == 32:  # the transductive eval's top_k_retvr, past the old k <= 256 cap
            err = max(err, check_mips(queries, items, 500, n_valid, f"kernel B q={q} d={d} n={n} k=500"))
        timed.append(time_mips(mips_topk_fused, mips_topk, queries, items, k, n_valid, flush, exclude))
        del queries, items, exclude
    f32_768, err_768, int8_entry = check_mips_768(dev, flush)
    timed += f32_768
    err = max(err, err_768)
    ptxas = mips_ptxas()
    int8_entry["ptxas"] = {name: rec for name, rec in ptxas.items() if " int8 " in name}
    f32 = {"max_abs_err": err, "shapes": timed, "ptxas": {name: rec for name, rec in ptxas.items() if " int8 " not in name},
           "wgmma_warnings": wgmma_warnings("mips_topk")}
    return f32, int8_entry


# the kernels line's f32 entries of kernel B, one per score route: name,
# the route's word in time_mips's "score_route", the shape its numbers
# come from (the first of the route's timed shapes that starts so)
MIPS_ROUTES = (("mips_topk_fused", "FFMA", "q=32 d=500"), ("mips_topk_fused_tc", "tensor cores", "q=1024 d=768"))


def mips_route_entries(f32):
    """Kernel B's f32 entries of the kernels line from ``check_mips_kernel``'s
    record, with every timed shape (phase 2's and later phases') on the
    entry of the score route it took."""
    entries = []
    for name, route, main in MIPS_ROUTES:
        shapes = [r for r in f32["shapes"] if r["score_route"].startswith(route)]
        head = next(r for r in shapes if r["shape"].startswith(main))
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "anncur_tpu_torch/csrc/mips_topk.cu",
            "replaces": "anncur_tpu/ops/mips_pallas.py:116",  # _mips_kernel
            "also_replaces": "anncur_tpu/ops/mips_pallas.py:149",  # _maxmask_kernel
            "score_route": route,
            "kernels": list(MIPS_KERNELS),
            "max_abs_err": f32["max_abs_err"],
            **{key: head[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "score_ms",
                                          "select_ms", "ffma_bound_ms")},
            "shapes": shapes,
            **{key: f32[key] for key in ("ptxas", "wgmma_warnings")},
        })
    return entries


# kernel B at the bi-encoder's width (phase 7), over f32 rows and int8 rows:
# (q, d, n, k): the retrieve-and-rerank search batch, one text, and an eval
# batch of 256 over ZeShEL-military's entity count
MIPS_768_SHAPES = ((32, 768, 10000, 64), (1, 768, 104520, 100), (256, 768, 104520, 100))
# the bi-encoder's hard-negative mine (phase 9): every mention against every
# entity, num_negs + 1 = 64 (f32 rows)
MINE_SHAPE = (1024, 768, 10000, 64)


def check_mips_768(dev, flush):
    """Kernel B and its int8 entry at MIPS_768_SHAPES: each against its
    plain version and timed. The int8 rows are the f32 rows quantised
    (``quantize_items``). Returns (the f32 timings, the f32 error, the int8
    entry's kernels-line record without launches)."""
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused, mips_topk_int8_fused
    from anncur_tpu_torch.ops.quantized import mips_topk_int8_plain, quantize_items

    gen = torch.Generator(device=dev).manual_seed(4)
    f32_err = i8_err = 0.0
    f32_recs, i8_recs = [], []
    for q, d, n, k in MIPS_768_SHAPES:
        queries, items = mips_inputs(gen, dev, q, d, n, n)
        f32_err = max(f32_err, check_mips(queries, items, k, n, f"kernel B q={q} d={d} n={n} k={k} f32"))
        f32_recs.append(time_mips(mips_topk_fused, mips_topk, queries, items, k, n, flush))
        qitems = quantize_items(items)
        del items
        i8_err = max(i8_err, check_mips(queries, qitems, k, n, f"kernel B q={q} d={d} n={n} k={k} int8", int8=True))
        i8_recs.append(time_mips(mips_topk_int8_fused, mips_topk_int8_plain, queries, qitems, k, n, flush))
        del queries, qitems
    q, d, n, k = MINE_SHAPE
    queries, items = mips_inputs(gen, dev, q, d, n, n)
    f32_err = max(f32_err, check_mips(queries, items, k, n, f"kernel B q={q} d={d} n={n} k={k} f32 (the mine)"))
    f32_recs.append(time_mips(mips_topk_fused, mips_topk, queries, items, k, n, flush))
    f32_recs[-1]["f64"] = f64_accuracy(queries, items, k, f"kernel B q={q} d={d} n={n} k={k} (the mine)")
    del queries, items
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    return f32_recs, f32_err, {
        "name": "mips_topk_int8_fused",
        "route": "cuda",
        "source": "anncur_tpu_torch/csrc/mips_topk.cu",
        "replaces": "anncur_tpu/ops/mips_pallas.py:116",  # _mips_kernel, whose score GEMM it instantiates for int8
        "also_replaces": "anncur_tpu/ops/quantized.py:54",  # mips_topk_int8, an XLA scan in the JAX package
        "kernels": list(MIPS_KERNELS),
        "max_abs_err": i8_err,
        **{key: i8_recs[0][key] for key in keys},
        "shapes": i8_recs,
    }


# the encoder epilogue at the build cell's rows (2,048 pairs of 256 tokens)
# and bert-base's hidden and MLP widths
EPILOGUE_SHAPE = (2048 * 256, 768, 3072)
# least share of the LayerNorm's and the GELU's elements with the plain
# composition's bits (the rest within one bf16 ulp: f32 sums in another
# order, the math library's last bits)
EPILOGUE_BIT_EQUAL = 0.99
EPILOGUE_KERNELS = ("bias_residual_layernorm_kernel", "bias_gelu_kernel", "bias_add3_kernel")


def epilogue_ulps(got, want, terms=None, chunk_rows=1 << 16):
    """(largest |got - want| in bf16 ulps of the element's magnitude, share
    of elements with the same bits), over chunks of rows. The magnitude is
    the larger of the two values, or of ``terms`` (per column) where the
    output is a sum that cancels (the LayerNorm's y = g·z + shift: |shift|)."""
    width = got.shape[-1]
    got, want = got.reshape(-1, width), want.reshape(-1, width)
    floor = torch.full((width,), 2.0 ** -126, device=got.device) if terms is None else terms.abs().float()
    worst, same = 0.0, 0
    for i in range(0, got.shape[0], chunk_rows):
        a, b = got[i:i + chunk_rows].float(), want[i:i + chunk_rows].float()
        mag = torch.maximum(torch.maximum(a.abs(), b.abs()), floor).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        worst = max(worst, float(((a - b).abs() / ulp).max()))
        same += int((a == b).sum())
    return worst, same / got.numel()


def check_encoder_epilogue(dev, flush):
    """The epilogue kernels at ``EPILOGUE_SHAPE`` against their plain
    compositions, then timed beside their byte bounds (activations read
    once and written once, the f32 vectors once) and the plain
    compositions they replace in ``models/bert.py``. One kernels-line
    entry each."""
    from anncur_tpu_torch.ops import encoder_epilogue as ee

    rows, h, inter = EPILOGUE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(20)

    def act(width, std=1.0):
        return (torch.randn(rows, width, generator=gen, device=dev) * std).to(torch.bfloat16)

    def vec(width, std, mean=0.0):
        return torch.randn(width, generator=gen, device=dev) * std + mean

    ptxas = ptxas_report("encoder_epilogue")
    log(f"  epilogue kernels (ptxas registers and spill bytes): {ptxas}")
    if not all(any(kern in name for name in ptxas) for kern in EPILOGUE_KERNELS):
        fail(f"the epilogue's build lacks one of {EPILOGUE_KERNELS}: {sorted(ptxas)}")
    if any(rec.get("spill_stores", 1) or rec.get("spill_loads", 1) for rec in ptxas.values()):
        fail(f"an epilogue kernel spills registers (ptxas): {ptxas}")
    entries = []
    mm, res = act(h), act(h, 2.0)
    args = (mm, vec(h, 0.5), res, vec(h, 0.1, 1.0), vec(h, 0.1), 1e-12)
    entries.append(time_epilogue(ee.bias_residual_layernorm, ee.bias_residual_layernorm_plain, args,
                                 3 * mm.numel() * 2 + 3 * h * 4, f"rows={rows} h={h} bf16", flush, ptxas))
    del mm, res, args
    mm = act(inter, 2.0)
    args = (mm, vec(inter, 0.5), True)
    entries.append(time_epilogue(ee.bias_gelu, ee.bias_gelu_plain, args, 2 * mm.numel() * 2 + inter * 4,
                                 f"rows={rows} width={inter} bf16, tanh", flush, ptxas))
    del mm, args
    args = (act(h), act(h), act(h), vec(h, 0.5), vec(h, 0.5), vec(h, 0.5))
    entries.append(time_epilogue(ee.bias_add3, ee.bias_add3_plain, args, 3 * (2 * rows * h * 2 + h * 4),
                                 f"q, k, v rows={rows} h={h} bf16, in place", flush, ptxas))
    return entries


def time_epilogue(fn, plain, args, nbytes, shape, flush, ptxas):
    """One epilogue kernel against its plain composition on ``args`` (on
    copies, in place), then both timed."""
    name = fn.__name__
    if name == "bias_add3":
        got = fn(*(t.clone() for t in args[:3]), *args[3:])
        want = plain(*(t.clone() for t in args[:3]), *args[3:])
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        worst, share = (0.0, 1.0) if same else (float("inf"), 0.0)
        del got, want
        if not same:
            fail("bias_add3 differs from the plain adds")
    else:
        terms = args[4] if name == "bias_residual_layernorm" else None  # the shift
        worst, share = epilogue_ulps(fn(*args), plain(*args), terms)
        if worst > 1.0 or share < EPILOGUE_BIT_EQUAL:
            fail(f"{name} differs from its plain composition: {worst} ulps at most, {share:.4%} the same bits")
    torch.cuda.empty_cache()
    ms = time_ms(lambda: fn(*args), 20, flush)
    plain_ms = time_ms(lambda: plain(*args), 10, flush)
    rec = {
        "name": name, "route": "cuda", "source": "anncur_tpu_torch/csrc/encoder_epilogue.cu",
        "replaces": None, "replaces_plain": f"anncur_tpu_torch/ops/encoder_epilogue.py::{name}_plain",
        "shape": shape, "ms": ms, "plain_ms": plain_ms, **bound(nbytes, 0, "bf16"),
        "max_ulps": worst, "bit_equal_share": share,
        "ptxas": {k: v for k, v in ptxas.items() if f"{name}_kernel" in k},
    }
    rec["x_bound"] = ms / rec["bound_ms"]
    log(f"  {name} {shape}: {ms:.4f} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
        f"{100 / rec['x_bound']:.1f}% of it; plain {plain_ms:.4f} ms ({plain_ms / ms:.2f}x); "
        f"{worst:.2f} ulps at most, {share:.4%} the same bits")
    return rec


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --------------------------------------------------------------------- #
# phases 3-4: the port's main path
# --------------------------------------------------------------------- #


def _wrappers():
    from anncur_tpu_torch.ops.attention import attention, attention_bwd_dkv, attention_bwd_dq
    from anncur_tpu_torch.ops.encoder_epilogue import bias_add3, bias_gelu, bias_residual_layernorm
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused, mips_topk_int8_fused
    from anncur_tpu_torch.ops.moe import moe_combine, moe_permute
    from anncur_tpu_torch.ops.rms_norm import rms_norm

    return {"attention_fwd": attention, "attention_bwd_dkv": attention_bwd_dkv,
            "attention_bwd_dq": attention_bwd_dq, "mips_topk_fused": mips_topk_fused,
            "mips_topk_int8_fused": mips_topk_int8_fused, "bias_residual_layernorm": bias_residual_layernorm,
            "bias_gelu": bias_gelu, "bias_add3": bias_add3, "moe_permute": moe_permute, "moe_combine": moe_combine,
            "rms_norm": rms_norm}


def _counters():
    """Each launch count by its name in the kernels line: (wrapper,
    attribute). Kernel B's wrapper also counts its launches whose score
    stage ran on the tensor cores."""
    counters = {name: (fn, "launches") for name, fn in _wrappers().items()}
    counters["mips_topk_fused_tc"] = (counters["mips_topk_fused"][0], "tc_launches")
    return counters


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


class StepRecorder:
    """One phase's steps: each timed, its kernel launches added to the
    phase's ``totals``, one JSON line per step with the card. ``rec`` is
    the phase's record (``seconds`` and ``lines`` by step); ``key`` names
    the step in its line."""

    def __init__(self, smi=None, key="driver"):
        self.smi, self.key = smi, key
        self.totals = {name: 0 for name in _counters()}
        self.rec = {"seconds": {}, "lines": {}}

    def counted(self, fn):
        """``fn()``, the card synchronised after it, its launches added to
        the phase's; (what it returned, its launches)."""
        reset_counts()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        counts = read_counts()
        for name, n in counts.items():
            self.totals[name] += n
        return out, counts

    def run(self, step, fn, argv):
        """One driver's ``fn(argv)``, timed, its launches counted; a step
        run twice adds its seconds. (what it returned, seconds, launches)."""
        t0 = time.perf_counter()
        out, counts = self.counted(lambda: fn(argv))
        dt = time.perf_counter() - t0
        self.rec["seconds"][step] = self.rec["seconds"].get(step, 0.0) + dt
        return out, dt, counts

    def line(self, step, t0=None, **numbers):
        """Log the step's JSON line; ``t0`` times the step from there."""
        if t0 is not None:
            self.rec["seconds"][step] = time.perf_counter() - t0
        entry = {self.key: step, "card": self.smi, "seconds": self.rec["seconds"][step], **numbers}
        self.rec["lines"][step] = entry
        log(json.dumps(entry))


def rescore_with_plain_attention(ce, pairs, lm):
    """CE scores of ``pairs`` with the plain attention in every layer."""
    from anncur_tpu_torch.models import bert
    from anncur_tpu_torch.ops.attention import attention, attention_plain

    bert.attention = attention_plain
    try:
        return ce.score(pairs, first_segment_end=lm)
    finally:
        bert.attention = attention


def phase_build(ce, spec, dev, rng):
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder, build_pairs, padded_pair_len

    lm = le = 128  # ZeShEL max mention/entity lengths -> 256-token pairs
    n_ments, n_ents = 32, 2048
    ment = rng.integers(1, spec.vocab_size, size=(n_ments, lm)).astype(np.int32)
    ent = rng.integers(1, spec.vocab_size, size=(n_ents, le)).astype(np.int32)
    builder = ScoreMatrixBuilder(ce, ment_block=32, ent_block=64, max_pairs_per_program=32768, device=dev)
    builder(ment, ent[:64])  # warm-up: cuBLAS handles, kernel loads
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    scores = builder(ment, ent)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    pairs_per_s = n_ments * n_ents / dt
    log(f"  build {n_ments}x{n_ents} pairs of 256 tokens: {dt:.3f} s, {pairs_per_s:.1f} pairs/s; launches {counts}")
    if scores.shape != (n_ments, n_ents) or not np.isfinite(scores).all():
        fail("score matrix has the wrong shape or non-finite values")
    if counts["attention_fwd"] == 0:
        fail("the build never launched kernel A")

    # a 2 x 64 sub-block again, with the plain attention, on the card
    sub = 64
    pairs = build_pairs(
        torch.as_tensor(ment[:2], device=dev), torch.as_tensor(ent[:sub], device=dev),
        padded_pair_len(lm, le, builder.pair_pad_multiple, spec.max_position_embeddings),
    )
    plain = rescore_with_plain_attention(ce, pairs, lm).reshape(2, sub).cpu().numpy()
    err = float(np.abs(plain - scores[:2, :sub]).max())
    log(f"  build sub-block 2x{sub} vs plain attention: max |diff| = {err:.3e} (tol {CE_ATOL}), score range [{scores.min():.4f}, {scores.max():.4f}]")
    if not err <= CE_ATOL:
        fail(f"score matrix disagrees with the plain-attention CE: {err}")
    return {"pairs_per_s": pairs_per_s, "seconds": dt, "launches": counts, "plain_attention_err": err,
            "ment": ment, "ent": ent, "scores": scores}


def phase_serve(ce, spec, dev, rng):
    from anncur_tpu_torch.core.cur import build_cur
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.indexer.score_matrix import padded_pair_len
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab
    lm = le = 128
    n_items, n_train, k_i, k_retvr, top_k, n_q = 10000, 500, 500, 100, 10, 32
    item_toks = rng.integers(1, spec.vocab_size, size=(n_items, le)).astype(np.int32)
    train = (rng.standard_normal((n_train, 16)) @ rng.standard_normal((16, n_items))).astype(np.float32)
    anchors = np.asarray(sorted(rng.choice(n_items, k_i, replace=False)))
    index = build_cur(
        rows=train, cols=train[:, anchors], row_idxs=np.arange(n_train), col_idxs=anchors,
        approx_preference="rows", validate=False, device=dev,
    )
    retriever = CurRetriever(
        encoder=ce, tokenizer=WordPieceTokenizer(make_test_vocab()), item_tokens=item_toks,
        index=index, anchor_item_ids=anchors, max_query_len=lm, target_pairs_per_step=4096, device=dev,
    )
    qtoks = rng.integers(1, spec.vocab_size, size=(n_q, lm)).astype(np.int32)
    retriever.query_tokens_batch(qtoks, top_k=top_k, top_k_retvr=k_retvr)  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    scores, ids = retriever.query_tokens_batch(qtoks, top_k=top_k, top_k_retvr=k_retvr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    qps = n_q / dt
    ce_pairs_per_s = n_q * (k_i + k_retvr) / dt
    log(f"  serve {n_q} queries at cost {k_i + k_retvr}: {dt:.3f} s, {qps:.2f} q/s, {ce_pairs_per_s:.1f} CE pairs/s; launches {counts}")
    if scores.shape != (n_q, top_k) or ids.shape != (n_q, top_k) or not np.isfinite(scores).all():
        fail("query result has the wrong shape or non-finite scores")
    if not (np.diff(scores, axis=1) <= 0).all() or ids.min() < 0 or ids.max() >= n_items:
        fail("query result is not sorted or holds ids out of range")
    if any(len(set(row)) != top_k for row in ids.tolist()):
        fail("query result repeats an id within a row")
    if counts["attention_fwd"] == 0 or counts["mips_topk_fused"] != 1:
        fail(f"the query batch did not run kernel A and kernel B once: {counts}")

    # kernel B vs the plain MIPS on this batch's anchor scores
    items, _, latent = retriever._device_consts()
    anchor_scores = retriever._anchor_scores(torch.as_tensor(qtoks, device=dev), retriever._stage_batch(k_i))
    mips_err = check_mips(anchor_scores, latent, k_retvr, n_items, "kernel B on the query's anchor scores")
    # the reranked scores are the CE's scores of the returned items
    pairs = torch.cat(
        [torch.as_tensor(qtoks[:2], device=dev)[:, None, :].expand(2, top_k, lm),
         items[torch.as_tensor(ids[:2], device=dev)][:, :, 1:]], dim=-1,
    ).reshape(2 * top_k, lm + le - 1)
    pair_len = padded_pair_len(lm, le, retriever.pair_pad_multiple, spec.max_position_embeddings)
    pairs = torch.nn.functional.pad(pairs, (0, pair_len - (lm + le - 1)))
    direct = ce.score(pairs, first_segment_end=lm).reshape(2, top_k).cpu().numpy()
    rerank_err = float(np.abs(direct - scores[:2]).max())
    log(f"  reranked scores vs direct CE scores: max |diff| = {rerank_err:.3e} (tol {CE_ATOL})")
    if not rerank_err <= CE_ATOL:
        fail(f"reranked scores differ from the CE's: {rerank_err}")
    res = retriever.query("alpha beta", context_left="gamma delta", top_k=3, top_k_retvr=k_retvr)
    if len(res) != 3 or not all(0 <= i < n_items and math.isfinite(s) for i, s in res):
        fail(f"text query returned {res}")
    log(f"  text query -> {res}")
    return {"qps": qps, "ce_pairs_per_s": ce_pairs_per_s, "seconds": dt, "launches": counts, "mips_err": mips_err,
            "retriever": retriever, "train": train, "answer": (qtoks, scores, ids)}


def leaf_check(state, before, frozen, what):
    """Fails unless every trainable leaf moved (but those whose gradient is
    0 in exact arithmetic) and no frozen one did; (leaves changed, leaves)."""
    changed = {n: not torch.equal(p, before[n]) for n, p in state.params.items()}
    stuck = [n for n, c in changed.items() if n not in frozen and not c and not n.endswith(ZERO_GRAD_LEAVES)]
    moved_frozen = [n for n in frozen if changed[n]]
    if stuck or moved_frozen or not frozen:
        fail(f"{what}: trainable leaves unchanged {stuck}, frozen leaves changed {moved_frozen}, frozen {sorted(frozen)}")
    return sum(changed.values()), len(changed)


def phase_train(dev, rng):
    """Cross-encoder training through the Trainer at the widths of
    configs/el_zeshel_cross_enc.json: bert-base, default head with
    cls_w_lin, bf16, loss ce, all_encoder_layers, lr 1e-5, max_grad_norm
    1, 128-token mentions and entities, 63 random negatives; attention
    dropout 0 (the configuration that reaches the attention backward
    kernels), hidden dropout 0.1; 4 micro-batches of one mention per step."""
    import tempfile

    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.models import bert
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.ops.attention import attention, attention_plain
    from anncur_tpu_torch.train.data import EntLinkDataset
    from anncur_tpu_torch.train.trainer import Trainer

    cfg = Config.from_json(os.path.join(ROOT, "configs", "el_zeshel_cross_enc.json"))
    spec = BertSpec(attention_dropout=0.0, hidden_dropout=0.1)
    warm, timed = 1, 5
    with tempfile.TemporaryDirectory() as res_dir:
        # random negatives (ZeShEL and a bi-encoder are not in the repo);
        # 4 mentions per batch, one per micro-batch
        cfg.update_from_dict({"neg_strategy": "random", "train_batch_size": 4, "base_res_dir": res_dir, "seed": 0})
        lm, le = cfg.max_input_len, cfg.max_label_len
        n_ments, n_ents = cfg.train_batch_size * (warm + timed), 1000
        data = EntLinkDataset(
            rng.integers(1, spec.vocab_size, size=(n_ments, lm)).astype(np.int32),
            rng.integers(1, spec.vocab_size, size=(n_ents, le)).astype(np.int32),
            rng.integers(0, n_ents, size=n_ments),
        )
        ce = CrossEncoder(spec, cfg.cross_enc_type, cfg.pooling_type, torch.bfloat16, device=dev, seed=0)
        trainer = Trainer(cfg, ce, total_steps=100)
        state = trainer.init_state()
        negs = trainer._epoch_negatives(data, state, 0)
        raw = list(trainer._make_batches(data, negs, cfg.train_batch_size, 0))
        batches = [trainer._shard_batch(b) for b in raw]
        pairs_per_step = cfg.train_batch_size * (1 + cfg.num_negs)
        trainer.train_step(state, batches[0])  # warm-up: cuBLAS handles, kernel loads
        torch.cuda.synchronize()
        before = {n: p.detach().clone() for n, p in state.params.items()}
        frozen = trainer._tx.frozen

        reset_counts()
        losses, step_s = [], []
        for batch in batches[warm: warm + timed]:
            t0 = time.perf_counter()
            metrics = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        counts = read_counts()
    secs = sum(step_s)
    pairs_per_s = pairs_per_step * timed / secs
    log(f"  train {timed} steps of {pairs_per_step} pairs of {lm + le - 1} tokens: {secs:.3f} s "
        f"({', '.join(f'{t:.3f}' for t in step_s)} s/step), {pairs_per_s:.1f} pairs/s; losses {losses}; launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    n_changed, n_leaves = leaf_check(state, before, frozen, "CE")
    log(f"  {n_changed}/{n_leaves} parameter leaves changed; {len(frozen)} frozen (the embeddings)")
    per_micro = 2 * spec.num_layers  # positive and negative CE forwards, every layer
    want = per_micro * cfg.grad_acc_steps * timed
    if any(counts[k] != want for k in ("attention_fwd", "attention_bwd_dkv", "attention_bwd_dq")):
        fail(f"training launched the attention kernels {counts}, not {want} times each")

    # one micro-batch again, kernels vs plain attention, same dropout masks
    mb = {k: v[0] for k, v in batches[0].items()}

    def loss_and_norm():
        for p in state.params.values():
            p.grad = None
        loss, _ = trainer._loss_fn(mb, torch.Generator().manual_seed(7))
        loss.backward()
        grads = [p.grad.float() for p in state.params.values() if p.grad is not None]
        return float(loss.detach()), math.sqrt(sum(float((g * g).sum()) for g in grads))

    loss_k, norm_k = loss_and_norm()
    bert.attention = attention_plain
    try:
        loss_p, norm_p = loss_and_norm()
    finally:
        bert.attention = attention
    for p in state.params.values():
        p.grad = None
    log(f"  micro-batch loss {loss_k:.5f} vs plain attention {loss_p:.5f} (tol {TRAIN_LOSS_ATOL}); "
        f"grad norm {norm_k:.5f} vs {norm_p:.5f} (rtol {TRAIN_GNORM_RTOL})")
    if not (abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL and abs(norm_k - norm_p) <= TRAIN_GNORM_RTOL * norm_p):
        fail("training through the kernels disagrees with the plain attention")
    return {"pairs_per_s": pairs_per_s, "step_s": step_s, "losses": losses, "launches": counts,
            "loss_vs_plain": [loss_k, loss_p], "grad_norm_vs_plain": [norm_k, norm_p],
            "start": (ce, cfg, raw[:2])}


ADAPTIVE_QUERIES = 128  # cut this, never the widths, if the run nears its limit
ADAPTIVE = dict(total_budget=210, n_rounds=8)  # bench.py line 3
EARLY_STOP = dict(total_budget=100, n_rounds=5, escalate_budget=210, escalate_rounds=8,
                  stability_overlap=1.01)  # bench.py line 4's worst case: every query escalates
TRAINED_CE = ("trained_ce_matrix.npz", "trained_ce_matrix_hard.npz")


def timed_calls(fn, n):
    """Seconds of each of ``n`` calls of ``fn``, each ending in a synchronize."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def oracle_recalls(dev):
    """The adaptive engine at 210 over 8 rounds and the fixed-anchor path at
    500 anchors + 100 reranked, recall@10 on the committed trained-CE
    matrices (eval rows scored by the CE itself: no CE runs here), the
    mean over seeds 0-2 as benchmarks/adaptive_matched_recall.json takes it."""
    from anncur_tpu_torch.core.adaptive_fused import adaptive_recall_oracle, fixed_anchor_recall

    out = {}
    for name in TRAINED_CE:
        d = np.load(os.path.join(ROOT, "benchmarks", name))
        scores = np.asarray(d["scores"], np.float32)
        n_train, n_q = int(d["n_train"]), int(d["n_q"])
        full, train = scores[n_train:n_train + n_q], scores[:n_train]
        adaptive = float(np.mean([adaptive_recall_oracle(full, train, 210, 8, seed=s, device=dev) for s in (0, 1, 2)]))
        fixed = float(np.mean([fixed_anchor_recall(full, train, 500, 100, 10, seed=s, device=dev) for s in (0, 1, 2)]))
        log(f"  {name} ({n_q} queries x {full.shape[1]} items): adaptive 210 over 8 recall@10 {adaptive:.4f}, "
            f"fixed-anchor at cost 600 {fixed:.4f}")
        if not adaptive >= fixed:
            fail(f"adaptive recall {adaptive} below the fixed-anchor recall {fixed} on {name}")
        out[name] = {"adaptive_210r8": adaptive, "fixed_600": fixed}
    return out


def recording_scorers(owner, seen):
    """Replaces ``owner._adaptive_scorer`` (a retriever, or the class) by one
    that appends, for each scorer the engine makes, a list of every
    (ids, exact scores) it is called with to ``seen``. Undo with
    ``del owner._adaptive_scorer`` (an instance) or by restoring the
    returned original (the class)."""
    make_scorer = owner._adaptive_scorer

    def recording(*a):
        score_fn = make_scorer(*a)
        calls = []
        seen.append(calls)

        def fn(ids):
            out = score_fn(ids)
            calls.append((ids, out))
            return out

        return fn

    owner._adaptive_scorer = recording
    return make_scorer


def check_scored(calls, scores, ids, budget, n_items, n_q, top_k):
    """Fails unless each query scored exactly ``budget`` distinct real items
    in the engine's CE ``calls`` and the answer is the top-k of their exact
    scores. Returns (scored ids, their exact scores)."""
    scored = torch.cat([i for i, _ in calls], dim=1)[:n_q]
    vals = torch.cat([v for _, v in calls], dim=1)[:n_q].float()
    distinct = [len(set(row)) for row in scored.tolist()]
    log(f"  {len(calls)} CE stages of widths {[i.shape[1] for i, _ in calls]}; scored ids per query "
        f"{scored.shape[1]}, distinct {min(distinct)}-{max(distinct)}, max id {int(scored.max())}")
    if scored.shape[1] != budget or min(distinct) != budget or int(scored.max()) >= n_items:
        fail(f"the adaptive engine did not score exactly {budget} distinct real items per query")
    if scores.shape != (n_q, top_k) or not np.isfinite(scores).all() or not (np.diff(scores, axis=1) <= 0).all():
        fail("adaptive result has the wrong shape, non-finite or unsorted scores")
    # the answer is the top-10 of the exact scores of everything scored
    want_s, order = torch.sort(vals, dim=1, descending=True, stable=True)
    if not (np.array_equal(want_s[:, :top_k].cpu().numpy(), scores)
            and np.array_equal(torch.gather(scored, 1, order[:, :top_k]).cpu().numpy(), ids)):
        fail(f"the adaptive answer is not the top-{top_k} of the exact scores it paid for")
    return scored, vals


def recorded_adaptive_call(retriever, call, kw, n_q, top_k):
    """One ``call(kw)`` of query_tokens_adaptive_fused, recording every CE
    call the engine makes: fails unless each query scored exactly the
    budget's distinct real items and the answer is the top-k of their exact
    scores. Returns (scores, ids, scored ids, their exact scores)."""
    seen = []
    recording_scorers(retriever, seen)
    try:
        scores, ids, _ = call(kw)
    finally:
        del retriever._adaptive_scorer  # the class's method again
    torch.cuda.synchronize()
    scored, vals = check_scored(seen[0], scores, ids, kw["total_budget"], retriever.item_tokens.shape[0], n_q, top_k)
    return scores, ids, scored, vals


def scores_vs_plain(retriever, qtoks, ids, scores, what, n=2):
    """The returned scores of the first ``n`` queries against the
    plain-attention CE's scores of the returned ids; returns the error."""
    from anncur_tpu_torch.indexer.score_matrix import padded_pair_len

    dev, lm, top_k = retriever.device, qtoks.shape[1], ids.shape[1]
    items = retriever._device_consts()[0]
    pos = torch.as_tensor(np.searchsorted(retriever.item_ids, ids[:n]), device=dev)  # stable ids -> rows
    pairs = torch.cat(
        [torch.as_tensor(qtoks[:n], device=dev)[:, None, :].expand(n, top_k, lm), items[pos][:, :, 1:]], dim=-1,
    ).reshape(n * top_k, lm + items.shape[1] - 1)
    pair_len = padded_pair_len(lm, items.shape[1], retriever.pair_pad_multiple,
                               retriever.encoder.spec.max_position_embeddings)
    pairs = torch.nn.functional.pad(pairs, (0, pair_len - pairs.shape[1]))
    plain = rescore_with_plain_attention(retriever.encoder, pairs, lm).reshape(n, top_k).float().cpu().numpy()
    err = float(np.abs(plain - scores[:n]).max())
    log(f"  {what} scores vs the plain-attention CE: max |diff| = {err:.3e} (tol {CE_ATOL})")
    if not err <= CE_ATOL:
        fail(f"{what} scores differ from the plain-attention CE's: {err}")
    return err


def growth_round_vs_plain(retriever, train_dev, scored, vals, budget, n_rounds, what):
    """The last growth round's pick (``budget - per`` ids scored) of these
    queries through kernel B against the plain version; returns the error."""
    from anncur_tpu_torch.core.adaptive_fused import ridge_weights, split_rounds

    n_items = retriever.item_tokens.shape[0]
    per = split_rounds(budget, n_rounds)[1]
    n_s = budget - per
    train_t = torch.zeros((retriever._padded_n_items(), train_dev.shape[0]), device=retriever.device)
    train_t[:n_items] = train_dev.T
    w = ridge_weights(train_t, scored[:, :n_s], vals[:, :n_s])
    return check_mips(w, train_t, per, n_items, f"kernel B on a growth round of {what} (q={scored.shape[0]}, "
                      f"S={n_s}, k={per})", exclude=scored[:, :n_s])


def phase_adaptive(retriever, train, spec, dev, rng):
    from anncur_tpu_torch.core.adaptive_fused import split_rounds

    lm = retriever.max_query_len
    top_k, n_q = 10, ADAPTIVE_QUERIES
    qtoks = rng.integers(1, spec.vocab_size, size=(n_q, lm)).astype(np.int32)
    train_dev = torch.as_tensor(train, device=dev)  # device-resident, as a server keeps it

    def call(kw):
        return retriever.query_tokens_adaptive_fused(qtoks, top_k=top_k, train_scores=train_dev, return_stats=True, **kw)

    scores, ids, scored, vals = recorded_adaptive_call(retriever, call, ADAPTIVE, n_q, top_k)

    reset_counts()
    base_s = timed_calls(lambda: call(ADAPTIVE), 3)
    base_counts = read_counts()
    reset_counts()
    call(EARLY_STOP)  # warm
    reset_counts()
    es_s = timed_calls(lambda: call(EARLY_STOP), 3)
    es_counts = read_counts()
    _, _, es_stats = call(EARLY_STOP)
    torch.cuda.synchronize()
    rounds = split_rounds(ADAPTIVE["total_budget"], ADAPTIVE["n_rounds"])[2]
    base_dt, es_dt = statistics.median(base_s), statistics.median(es_s)
    qps = n_q / base_dt
    es_qps = n_q / es_dt
    log(f"  adaptive {n_q} queries at 210 over 8 rounds: {', '.join(f'{t:.3f}' for t in base_s)} s by call, "
        f"median {base_dt:.3f} s, {qps:.2f} q/s, {n_q * 210 / base_dt:.1f} CE pairs/s; launches of 3 calls {base_counts}")
    log(f"  early-stop worst case (b100r5_e210r8, every query escalating): {', '.join(f'{t:.3f}' for t in es_s)} s, "
        f"median {es_dt:.3f} s, {es_qps:.2f} q/s; avg_budget {es_stats['avg_budget']}, frac_escalated "
        f"{es_stats['frac_escalated']}; launches of 3 calls {es_counts}")
    if base_counts["mips_topk_fused"] != 3 * (rounds - 1) or base_counts["attention_fwd"] == 0:
        fail(f"an adaptive batch did not launch kernel B once per growth round ({rounds - 1}): {base_counts}")
    es_rounds = (split_rounds(100, 5)[2] - 1) + 8  # base growth rounds, then every escalation round
    if es_counts["mips_topk_fused"] != 3 * es_rounds or es_counts["attention_fwd"] == 0:
        fail(f"an early-stop batch did not launch kernel B {es_rounds} times: {es_counts}")
    if es_stats["avg_budget"] != 210.0 or es_stats["frac_escalated"] != 1.0:
        fail(f"the early-stop worst case did not escalate every query: {es_stats}")

    ce_err = scores_vs_plain(retriever, qtoks, ids, scores, "adaptive top-10")
    # the last growth round's pick (S = 184 scored) through kernel B vs plain
    mips_err = growth_round_vs_plain(retriever, train_dev, scored, vals, ADAPTIVE["total_budget"],
                                     ADAPTIVE["n_rounds"], "210 over 8")
    recalls = oracle_recalls(dev)
    counts = {name: base_counts[name] + es_counts[name] for name in base_counts}
    return {"qps": qps, "ce_pairs_per_s": n_q * 210 / base_dt, "seconds": base_s, "early_stop_qps": es_qps,
            "early_stop_seconds": es_s, "early_stop_avg_budget": es_stats["avg_budget"], "launches": counts,
            "launches_base_calls": base_counts, "launches_early_stop_calls": es_counts, "mips_err": mips_err,
            "ce_err": ce_err, "recall": recalls, "qtoks": qtoks, "train_dev": train_dev, "answer": (scores, ids)}


RERANK_MENTIONS = 384  # cut this, never the widths, if the run nears its limit
RERANK = dict(top_k=64, batch_size=64)  # tools/scale_drive_tpu.py's config #4


def phase_retrieve_rerank(retriever, spec, dev, rng):
    """The bi-encoder retrieve-and-rerank baseline on phase 4's corpus and CE."""
    import tempfile

    from anncur_tpu_torch.core.metrics import topk_overlap_frac
    from anncur_tpu_torch.evalx.retrieve_rerank import embed_tokenized, run_retrieve_rerank_eval
    from anncur_tpu_torch.indexer.score_matrix import make_pair_scorer
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.ops.dense_index import DenseIndex
    from anncur_tpu_torch.ops.quantized import quantize_items

    with open(os.path.join(ROOT, "configs", "el_zeshel_bi_enc.json")) as fin:
        cfg = json.load(fin)
    bienc = BiEncoder(spec, cfg["pooling_type"], cfg["bi_enc_type"], cfg["embed_dim"], cfg["add_linear_layer"],
                      torch.bfloat16, device=dev, seed=1)
    ce, ents = retriever.encoder, retriever.item_tokens
    n_m, n_e, k = RERANK_MENTIONS, ents.shape[0], RERANK["top_k"]
    ments = rng.integers(1, spec.vocab_size, size=(n_m, cfg["max_input_len"])).astype(np.int32)
    gt = rng.integers(0, n_e, size=n_m)
    run_retrieve_rerank_eval(bienc, ce, ments[:64], ents[:512], gt[:64] % 512, **RERANK)  # warm
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as res_dir:
        reset_counts()
        t0 = time.perf_counter()
        res = run_retrieve_rerank_eval(bienc, ce, ments, ents, gt, res_dir=res_dir, **RERANK)
        dt = time.perf_counter() - t0
        # the same embeddings, searched in an int8 index as well
        label_emb = embed_tokenized(bienc, ents, RERANK["batch_size"], "label")
        ment_emb = embed_tokenized(bienc, ments, RERANK["batch_size"], "input")
        _, q_ids = DenseIndex(label_emb, quantize=True, device=dev).search(ment_emb, k)
        torch.cuda.synchronize()
        counts = read_counts()
        with open(os.path.join(res_dir, "bienc_topk_preds.txt")) as fin:
            bi = json.load(fin)
        with open(os.path.join(res_dir, "crossenc_topk_preds_w_bienc_retrvr.txt")) as fin:
            reranked = np.asarray(json.load(fin)["scores"], np.float32)
    bi_ids = np.asarray(bi["indices"])
    sec = res["seconds"]
    mps = n_m / dt
    embed_sps = (n_e + n_m) / (sec["embed_entities"] + sec["embed_mentions"])
    rerank_pps = n_m * k / sec["rerank"]
    log(f"  retrieve-and-rerank {n_m} mentions over {n_e} entities, top {k}: {dt:.3f} s, {mps:.2f} mentions/s; "
        f"embed {embed_sps:.1f} seqs/s ({sec['embed_entities']:.3f} + {sec['embed_mentions']:.3f} s); search "
        f"{sec['search'] * 1e3:.3f} ms (host clock, copies included); rerank {rerank_pps:.1f} CE pairs/s "
        f"({sec['rerank']:.3f} s); metrics {res['bienc']} / {res['crossenc']}; launches {counts}")
    if bi_ids.shape != (n_m, k) or reranked.shape != (n_m, k) or not np.isfinite(reranked).all():
        fail("retrieve-and-rerank returned the wrong shapes or non-finite scores")
    if counts["attention_fwd"] == 0 or counts["mips_topk_fused"] != 1 or counts["mips_topk_int8_fused"] != 1:
        fail(f"retrieve-and-rerank did not run kernel A, kernel B once and its int8 entry once: {counts}")

    # the index's ids against the plain MIPS on the same embeddings, f32
    # and int8 (the int8 index's own quantisation)
    ment_t, label_t = torch.as_tensor(ment_emb, device=dev), torch.as_tensor(label_emb, device=dev)
    mips_err = check_mips(ment_t, label_t, k, n_e, f"kernel B on the bi-encoder's embeddings (q={n_m} d=768 n={n_e})")
    int8_err = check_mips(ment_t, quantize_items(label_t), k, n_e,
                          f"kernel B's int8 entry on the bi-encoder's embeddings (q={n_m} d=768 n={n_e})", int8=True)
    # the towers on the card (kernel A at b=64 s=128, the CLS-only last
    # layer) against the same towers with the plain attention in every layer
    embed_err = towers_vs_plain_attention(bienc, ments[:RERANK["batch_size"]], ents[:RERANK["batch_size"]])
    again = DenseIndex(label_emb, device=dev).search(ment_emb, k)[1]
    if not np.array_equal(again, bi_ids):
        fail("the eval's retrieval differs from a search of the same embeddings")
    overlap = float(topk_overlap_frac(q_ids, bi_ids).mean())
    log(f"  int8 index top-{k} overlap with the f32 index: {overlap:.4f} (> 0.9)")
    if not overlap > 0.9:
        fail(f"the int8 index's top-{k} overlaps the f32 index's by {overlap}")
    # the rerank scores are the pair scorer's on the same pairs: its first
    # batch (64 mentions x 64 candidates) again, one code path, the same bits
    bm = 4096 // k
    score_pairs = make_pair_scorer(ce, ments.shape[1], ents.shape[1], 128)
    items = retriever._device_consts()[0]
    direct = score_pairs(torch.as_tensor(ments[:bm], device=dev), items[torch.as_tensor(bi_ids[:bm], device=dev)])
    if not np.array_equal(direct.float().cpu().numpy(), reranked[:bm]):
        fail("the rerank scores differ from the pair scorer's on the same pairs")
    log(f"  rerank scores of the first {bm} mentions equal the pair scorer's bit for bit")
    return {"mentions_per_s": mps, "seconds": dt, "stage_seconds": sec, "embed_seqs_per_s": embed_sps,
            "search_ms": sec["search"] * 1e3, "rerank_pairs_per_s": rerank_pps, "launches": counts,
            "mips_err": mips_err, "int8_err": int8_err, "embed_err": embed_err, "int8_overlap": overlap,
            "metrics": {"bienc": res["bienc"], "crossenc": res["crossenc"]}, "embeds": (ment_emb, label_emb)}


def towers_vs_plain_attention(bienc, ments, ents, got=None):
    """max over rows of ||kernel - plain|| / ||plain|| of the input tower's
    embeddings of ``ments`` and the label tower's of ``ents`` (``got``: the
    kernel's embeddings, already made by a caller), the plain ones with the
    plain attention in every layer; the towers with SDPA in every layer set
    the yardstick (EMBED_VS_SDPA)."""
    from anncur_tpu_torch.models import bert
    from anncur_tpu_torch.ops.attention import attention, attention_plain

    dev = bienc.device
    ments, ents = torch.as_tensor(ments, device=dev), torch.as_tensor(ents, device=dev)

    def embeds(attn):
        bert.attention = attn
        try:
            return bienc.encode_input(ments).float(), bienc.encode_label(ents).float()
        finally:
            bert.attention = attention

    def dist(got, want):
        return max(float(((g - w).norm(dim=1) / w.norm(dim=1)).max()) for g, w in zip(got, want))

    plain = embeds(attention_plain)
    got = embeds(attention) if got is None else [torch.as_tensor(g, device=dev).float() for g in got]
    err, sdpa_err = dist(got, plain), dist(embeds(sdpa_attention), plain)
    log(f"  bi-encoder embeddings of {ments.shape[0]} mentions and entities vs plain attention, max row "
        f"||diff|| / ||plain||: kernel A {err:.3e}, SDPA {sdpa_err:.3e} (tol {EMBED_VS_SDPA} x SDPA's)")
    if not err <= EMBED_VS_SDPA * sdpa_err:
        fail(f"the bi-encoder's embeddings differ from the plain-attention towers' by {err}, SDPA's by {sdpa_err}")
    return err


def sdpa_attention(q, k, v, key_valid):
    """``ops/attention.py::attention``'s contract on SDPA: (b, g, nh, hd)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=key_valid[:, None, None, :]
    )
    return out.transpose(1, 2)


AXN = dict(ADAPTIVE, method="axn")  # default rank: every train row (500), so kernel B scores 501-wide rows
AXN_EARLY_STOP = dict(EARLY_STOP, method="axn")
AXN_ORACLE_RANKS = {"trained_ce_matrix.npz": 30, "trained_ce_matrix_hard.npz": 500}  # the JAX sweep's axn_r5
HOST_ADAPTIVE = dict(total_budget=100, n_rounds=3)
HOST_QUERIES = 8


def phase_axn(retriever, qtoks, train_dev, dev):
    """AXN serving and host ADACUR on phase 4's retriever, phase 6's queries."""
    from anncur_tpu_torch.core import retriever as retriever_mod
    from anncur_tpu_torch.core.adaptive_fused import adaptive_recall_oracle, axn_item_side, axn_query_side, split_rounds
    from anncur_tpu_torch.core.axn import fit_item_embeddings_cached

    n_items = retriever.item_tokens.shape[0]
    top_k, n_q = 10, qtoks.shape[0]

    def call(kw):
        return retriever.query_tokens_adaptive_fused(qtoks, top_k=top_k, train_scores=train_dev, return_stats=True, **kw)

    t0 = time.perf_counter()
    _, _, scored, vals = recorded_adaptive_call(retriever, call, AXN, n_q, top_k)  # warm: fits the embeddings
    log(f"  warm AXN call (the f64 SVD fit of the 500 x {n_items} train matrix included): {time.perf_counter() - t0:.3f} s")
    reset_counts()
    base_s = timed_calls(lambda: call(AXN), 3)
    base_counts = read_counts()
    # one warm early-stop call (its first run pays ~1 s of first use on the
    # card), then one timed
    call(AXN_EARLY_STOP)
    reset_counts()
    t0 = time.perf_counter()
    _, _, es_stats = call(AXN_EARLY_STOP)
    torch.cuda.synchronize()
    es_dt = time.perf_counter() - t0
    es_counts = read_counts()
    rounds = split_rounds(AXN["total_budget"], AXN["n_rounds"])[2]
    base_dt = statistics.median(base_s)
    qps, es_qps = n_q / base_dt, n_q / es_dt
    log(f"  AXN {n_q} queries at 210 over 8 rounds: {', '.join(f'{t:.3f}' for t in base_s)} s by call, median "
        f"{base_dt:.3f} s, {qps:.2f} q/s; launches of 3 calls {base_counts}")
    log(f"  AXN early-stop worst case, one call: {es_dt:.3f} s, {es_qps:.2f} q/s; avg_budget {es_stats['avg_budget']}, "
        f"frac_escalated {es_stats['frac_escalated']}; launches {es_counts}")
    if base_counts["mips_topk_fused"] != 3 * (rounds - 1) or base_counts["attention_fwd"] == 0:
        fail(f"an AXN batch did not launch kernel B once per growth round ({rounds - 1}): {base_counts}")
    es_rounds = (split_rounds(100, 5)[2] - 1) + 8
    if es_counts["mips_topk_fused"] != es_rounds or es_stats["avg_budget"] != 210.0 or es_stats["frac_escalated"] != 1.0:
        fail(f"the AXN early-stop worst case did not escalate every query through kernel B: {es_counts} {es_stats}")

    # host ADACUR: each query's own 100 scored ids, recorded from the loop
    captured, calls = [], []
    host_loop, host_scorer = retriever_mod.adaptive_cur_query, retriever_mod.crossenc_rerank_scores

    def loop(*args, **kw):
        out = host_loop(*args, **kw)
        captured.append(out)
        return out

    def scorer(*args, **kw):
        out = host_scorer(*args, **kw)
        calls.append((np.asarray(args[3][0]).copy(), out))
        return out

    retriever_mod.adaptive_cur_query, retriever_mod.crossenc_rerank_scores = loop, scorer
    try:
        reset_counts()
        t0 = time.perf_counter()
        h_scores, h_ids = retriever.query_tokens_adaptive(qtoks[:HOST_QUERIES], top_k=top_k, **HOST_ADAPTIVE)
        host_dt = time.perf_counter() - t0
        host_counts = read_counts()
    finally:
        retriever_mod.adaptive_cur_query, retriever_mod.crossenc_rerank_scores = host_loop, host_scorer
    h_scored = np.asarray(captured[0][2])
    first, per, _ = split_rounds(HOST_ADAPTIVE["total_budget"], HOST_ADAPTIVE["n_rounds"])
    # each query's value of each id: from the call of the round that picked it
    bounds = [0, first] + [first + per * r for r in range(1, len(calls))]
    h_vals = np.empty(h_scored.shape, np.float32)
    for r, (ids_r, out_r) in enumerate(calls):
        pos = {int(j): c for c, j in enumerate(ids_r)}
        for i in range(h_scored.shape[0]):
            h_vals[i, bounds[r]:bounds[r + 1]] = [out_r[i, pos[int(j)]] for j in h_scored[i, bounds[r]:bounds[r + 1]]]
    order = np.argsort(-h_vals, axis=1, kind="stable")[:, :top_k]
    distinct = [len(set(row)) for row in h_scored.tolist()]
    log(f"  host ADACUR {HOST_QUERIES} queries at 100 over 3 rounds: {host_dt:.3f} s, {HOST_QUERIES / host_dt:.2f} q/s; "
        f"{len(calls)} union scorings of {[len(c[0]) for c in calls]} items; scored ids per query {h_scored.shape[1]}, "
        f"distinct {min(distinct)}-{max(distinct)}; launches {host_counts}")
    if h_scored.shape != (HOST_QUERIES, HOST_ADAPTIVE["total_budget"]) or min(distinct) != HOST_ADAPTIVE["total_budget"]:
        fail("host ADACUR did not score exactly 100 distinct items per query")
    if not (np.array_equal(np.take_along_axis(h_scored, order, 1), h_ids)
            and np.array_equal(np.take_along_axis(h_vals, order, 1), h_scores)):
        fail("the host ADACUR answer is not the top-10 of the exact scores it paid for")

    # the last AXN growth round's pick (S = 184 scored) through kernel B vs plain
    index = fit_item_embeddings_cached(train_dev, min(train_dev.shape), device=dev)  # the served calls' fit
    n_s = AXN["total_budget"] - split_rounds(AXN["total_budget"], AXN["n_rounds"])[1]
    w = axn_query_side(index.item_embeds, index.mean, scored[:, :n_s], vals[:, :n_s])
    items = axn_item_side(index, retriever._padded_n_items())
    mips_err = check_mips(w, items, AXN["total_budget"] - n_s, n_items,
                          f"kernel B on an AXN growth round (q={n_q}, d={items.shape[1]}, S={n_s})", exclude=scored[:, :n_s])
    recalls = {}
    for name, rank in AXN_ORACLE_RANKS.items():
        d = np.load(os.path.join(ROOT, "benchmarks", name))
        scores = np.asarray(d["scores"], np.float32)
        n_train, n_qo = int(d["n_train"]), int(d["n_q"])
        full, train = scores[n_train:n_train + n_qo], scores[:n_train]
        rec = float(np.mean([adaptive_recall_oracle(full, train, 210, 5, seed=s, method="axn", axn_rank=rank, device=dev)
                             for s in (0, 1, 2)]))
        log(f"  {name}: AXN (rank {rank}) 210 over 5 rounds recall@10 {rec:.4f}")
        if not 0.5 < rec <= 1.0:
            fail(f"AXN oracle recall {rec} on {name} has collapsed")
        recalls[name] = {"axn_210r5": rec, "axn_rank": rank}
    counts = {name: base_counts[name] + es_counts[name] + host_counts[name] for name in base_counts}
    return {"qps": qps, "seconds": base_s, "early_stop_qps": es_qps, "early_stop_seconds": es_dt,
            "host_qps": HOST_QUERIES / host_dt, "host_seconds": host_dt, "launches": counts,
            "launches_base_calls": base_counts, "launches_early_stop_calls": es_counts, "launches_host": host_counts,
            "mips_err": mips_err, "recall": recalls}


# --------------------------------------------------------------------- #
# phase 9: bi-encoder training
# --------------------------------------------------------------------- #

BIENC_MENTIONS, BIENC_ENTITIES = 1024, 10000  # (b)'s mine; cut these, never the widths
BIENC_STRATEGIES = (  # (strategy, config, tower forwards per micro-batch)
    ("in_batch", "el_zeshel_bi_enc.json", 2),
    ("bienc_hard_negs", "el_zeshel_bi_enc.json", 3),
    ("top_ce_match", os.path.join("ce_distill", "zeshel_bi_enc_distill.json"), 2),
)


def bienc_micro_vs_plain(trainer, state, batch):
    """One micro-batch's loss and gradient through the kernels, with the
    plain attention in every layer and with SDPA in every layer, the same
    dropout masks. Returns the three losses, the three gradient norms and
    the distances of the kernels' and SDPA's gradients from the plain one."""
    from anncur_tpu_torch.models import bert
    from anncur_tpu_torch.ops.attention import attention, attention_plain

    mb = {k: v[0] for k, v in batch.items()}

    def loss_and_grads(attn):
        bert.attention = attn
        try:
            for p in state.params.values():
                p.grad = None
            loss, _ = trainer._loss_fn(mb, torch.Generator().manual_seed(7))
            loss.backward()
        finally:
            bert.attention = attention
        grads = {n: p.grad.float() for n, p in state.params.items() if p.grad is not None}
        for p in state.params.values():
            p.grad = None
        return float(loss.detach()), grads

    def norm(g):
        return math.sqrt(sum(float((t * t).sum()) for t in g.values()))

    def dist(g, ref):
        return math.sqrt(sum(float(((g[n] - t) ** 2).sum()) for n, t in ref.items()))

    loss_p, g_p = loss_and_grads(attention_plain)
    loss_k, g_k = loss_and_grads(attention)
    out = {"loss": [loss_k, loss_p], "grad_norm": [norm(g_k), norm(g_p)], "grad_dist": dist(g_k, g_p)}
    del g_k
    loss_s, g_s = loss_and_grads(sdpa_attention)
    out.update(sdpa_loss=loss_s, sdpa_grad_norm=norm(g_s), sdpa_grad_dist=dist(g_s, g_p))
    return out


def check_mined_ids(trainer, data, negs, dev):
    """The mined negatives against the plain MIPS's top 64 on the same
    embeddings (the towers in eval mode again), id by id where the plain
    score differs from both neighbours by more than MIPS_TIE_GAP of the
    largest (as check_mips); no gold id among them."""
    from anncur_tpu_torch.ops.mips import mips_topk

    inp, lab = trainer._embed(data)
    k = trainer.config.num_negs + 1
    s_p, i_p = (t.cpu().numpy() for t in mips_topk(torch.as_tensor(inp, device=dev), torch.as_tensor(lab, device=dev), k))
    gap = -np.diff(s_p, axis=1) > MIPS_TIE_GAP * np.abs(s_p).max()
    sep = np.ones(s_p.shape, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    compared = 0
    for row, (ids, ok, gold) in enumerate(zip(i_p, sep, data.gt_labels)):
        keep = ids != gold
        want, want_ok = ids[keep][:k - 1], ok[keep][:k - 1]
        if not np.array_equal(negs[row][want_ok], want[want_ok]):
            fail(f"the mined negatives of mention {row} differ from the plain MIPS's at separated scores")
        compared += int(want_ok.sum())
    if (negs == data.gt_labels[:, None]).any():
        fail("a gold id is among the mined negatives")
    log(f"  mined ids equal the plain MIPS's at {compared}/{negs.size} separated places; no gold id among them")
    return compared


def phase_bienc_train(dev, rng):
    """Bi-encoder training through the Trainer at configs/el_zeshel_bi_enc.json's
    widths (bert-base, separate towers, cls_w_lin, 128-token mentions and
    entities, bf16, all_encoder_layers, lr 1e-5, 16 mentions a step in 4
    micro-batches), attention dropout 0 and hidden dropout 0.1, random
    tokens: (a) in-batch negatives, (b) 63 hard negatives mined once over
    1,024 mentions and 10,000 entities (kernel B), (c) distillation from the
    committed trained-CE matrix's top 64 (``ce_distill``'s
    distill_n_labels). 1 warm and 5 timed steps each."""
    import tempfile

    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.train.data import EntLinkDataset
    from anncur_tpu_torch.train.trainer import Trainer

    spec = BertSpec(attention_dropout=0.0, hidden_dropout=0.1)
    warm, timed = 1, 5
    teacher = np.asarray(np.load(os.path.join(ROOT, "benchmarks", TRAINED_CE[0]))["scores"], np.float32)
    out, launches, kept = {}, None, None
    for strategy, cfg_file, fwd_per_micro in BIENC_STRATEGIES:
        cfg = Config.from_json(os.path.join(ROOT, "configs", cfg_file))
        lm, le = cfg.max_input_len, cfg.max_label_len
        distill = strategy == "top_ce_match"
        n_m, n_e = (teacher.shape if distill else (BIENC_MENTIONS, BIENC_ENTITIES))
        data = EntLinkDataset(
            rng.integers(1, spec.vocab_size, size=(n_m, lm)).astype(np.int32),
            rng.integers(1, spec.vocab_size, size=(n_e, le)).astype(np.int32),
            rng.integers(0, n_e, size=n_m), score_matrix=teacher if distill else None,
        )
        with tempfile.TemporaryDirectory() as res_dir:
            cfg.update_from_dict({"neg_strategy": strategy, "base_res_dir": res_dir, "seed": 0})
            bienc = BiEncoder(spec, cfg.pooling_type, cfg.bi_enc_type, cfg.embed_dim, cfg.add_linear_layer,
                              torch.bfloat16, device=dev, seed=0)
            trainer = Trainer(cfg, bienc, total_steps=100)
            state = trainer.init_state()
            rec = {}
            reset_counts()
            t0 = time.perf_counter()
            negs = trainer._epoch_negatives(data, state, 0)
            torch.cuda.synchronize()
            mine_s = time.perf_counter() - t0
            mine_counts = read_counts()
            if strategy == "bienc_hard_negs":
                t0 = time.perf_counter()
                trainer._embed(data)
                embed_s = time.perf_counter() - t0
                rec.update(mine_s=mine_s, mine_embed_s=embed_s, mine_launches=mine_counts)
                log(f"  ({strategy}) mine: {mine_s:.3f} s ({data.n_ments} mentions x {data.n_ents} entities; the "
                    f"embedding alone {embed_s:.3f} s, {(data.n_ments + data.n_ents) * cfg.embed_dim * 4 / 1e6:.1f} MB "
                    f"of embeddings through the host); launches {mine_counts}")
                if mine_counts["mips_topk_fused"] != 1 or mine_counts["attention_fwd"] == 0:
                    fail(f"the hard-negative mine did not embed through kernel A and mine through kernel B once: {mine_counts}")
                rec["mine_ids_compared"] = check_mined_ids(trainer, data, negs, dev)
            batches = [trainer._shard_batch(b)
                       for b in itertools.islice(trainer._make_batches(data, negs, cfg.train_batch_size, 0), warm + timed)]
            if len(batches) != warm + timed:
                fail(f"bi-encoder ({strategy}): {len(batches)} batches, not {warm + timed}")
            trainer.train_step(state, batches[0])  # warm-up: cuBLAS handles
            torch.cuda.synchronize()
            before = {n: p.detach().clone() for n, p in state.params.items()}
            reset_counts()
            losses, step_s = [], []
            for batch in batches[warm:]:
                t0 = time.perf_counter()
                metrics = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
            counts = read_counts()
            if not all(math.isfinite(x) for x in losses):
                fail(f"bi-encoder ({strategy}): non-finite loss {losses}")
            n_frozen = len(trainer._tx.frozen)
            n_changed, n_leaves = leaf_check(state, before, trainer._tx.frozen, f"bi-encoder ({strategy})")
            want = spec.num_layers * fwd_per_micro * cfg.grad_acc_steps * timed
            if any(counts[k] != want for k in ("attention_fwd", "attention_bwd_dkv", "attention_bwd_dq")):
                fail(f"bi-encoder ({strategy}) launched the attention kernels {counts}, not {want} times each")
            cmp = bienc_micro_vs_plain(trainer, state, batches[0])
            (loss_k, loss_p), (norm_k, norm_p) = cmp["loss"], cmp["grad_norm"]
            log(f"  ({strategy}) micro-batch vs plain attention: loss {loss_k:.5f} vs {loss_p:.5f} (SDPA {cmp['sdpa_loss']:.5f}; "
                f"tol {TRAIN_LOSS_ATOL} x max(1, |loss|)); grad norm {norm_k:.5f} vs {norm_p:.5f} (SDPA "
                f"{cmp['sdpa_grad_norm']:.5f}); ||g - g_plain||: kernels {cmp['grad_dist']:.5f}, SDPA "
                f"{cmp['sdpa_grad_dist']:.5f} (tol {BIENC_VS_SDPA} x SDPA's)")
            if not (abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL * max(1.0, abs(loss_p))
                    and cmp["grad_dist"] <= BIENC_VS_SDPA * cmp["sdpa_grad_dist"]):
                fail(f"bi-encoder ({strategy}) training through the kernels disagrees with the plain attention")
            if strategy == "in_batch":
                kept = bienc  # phase 10 clusters entities with its towers
            else:
                del bienc
            del trainer, state, before, batches
        secs = sum(step_s)
        n_seqs = cfg.train_batch_size * ((2 if strategy == "in_batch" else 2 + cfg.num_negs) if not distill
                                         else 1 + cfg.distill_n_labels)
        rec.update({
            "step_ms": 1e3 * secs / timed, "step_s": step_s, "mentions_per_s": cfg.train_batch_size * timed / secs,
            "seqs_per_s": n_seqs * timed / secs, "losses": losses, "launches": counts,
            "vs_plain": cmp,
        })
        log(f"  ({strategy}) {timed} steps of {cfg.train_batch_size} mentions ({n_seqs} tower sequences of 128 "
            f"tokens): {', '.join(f'{t:.3f}' for t in step_s)} s/step; step_ms {rec['step_ms']:.1f}, mentions_per_s "
            f"{rec['mentions_per_s']:.2f}, seqs_per_s {rec['seqs_per_s']:.1f}; losses {losses}; {n_changed}/{n_leaves} "
            f"leaves changed, {n_frozen} frozen (both towers' embeddings); launches {counts}")
        out[strategy] = rec
        launches = dict(counts) if launches is None else {k: launches[k] + counts[k] for k in counts}
        launches = {k: launches[k] + mine_counts[k] for k in launches}
        torch.cuda.empty_cache()
    return {"strategies": out, "launches": launches, "bienc": kept}


# --------------------------------------------------------------------- #
# phase 10: the paper's evals
# --------------------------------------------------------------------- #

TRANSDUCTIVE = dict(methods=("cur", "cur_oracle"), n_seeds=3, n_ment_anchors_vals=[100],
                    n_ent_anchors_vals=[100, 200, 500], top_k_vals=[1, 10, 100], top_k_retvr_vals=[100, 500])
E2E_ENTITIES, E2E_ANCHORS = 1000, 32  # cut these, never the widths
EVAL_RECALL_ATOL, EVAL_FROB_ATOL = 0.005, 2e-3  # tests/test_torch_evalx.py (PARITY.md)


def results_close(got, want, n_rows, k=1, path=""):
    """The first path where two result dicts differ beyond the test
    tolerances, or None: relative Frobenius error 2e-3; overlap metrics
    0.005 (PARITY.md's, one item in 200 rankings), or what one reordered
    item in one of the ``n_rows`` rankings of the smallest split moves the
    statistic where that is more: the mean 1/(k n), the std 1/(k sqrt(n)),
    the median 1/k (fractions; counts k times that). The card and the CPU
    round the projection differently, which may swap two items at the
    retrieval boundary. ``k``: the top-k where the path does not name it."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return f"{path}: keys differ"
        for key in want:
            bad = results_close(got[key], want[key], n_rows, k, f"{path}/{key}")
            if bad:
                return bad
        return None
    if path.endswith("approx_error"):
        return None  # its relative form is held
    if path.endswith("approx_error_relative"):
        return None if abs(got - want) <= EVAL_FROB_ATOL else f"{path}: {got} vs {want}"
    if "exact_vs_reranked" in path:
        named = re.search(r"top_k=(\d+)", path)
        k = int(named.group(1)) if named else k
        one_item = {"mean": 1.0 / (k * n_rows), "std": 1.0 / (k * math.sqrt(n_rows)), "p50": 1.0 / k}
        tol = max(EVAL_RECALL_ATOL, one_item[path.rsplit("_", 1)[1]]) * (1 if "frac" in path else k)
        return None if abs(got - want) <= tol else f"{path}: {got} vs {want}"
    return None if got == want else f"{path}: {got} vs {want}"


def phase_evals(retriever, bienc, spec, dev, rng):
    """run_transductive_eval (cur, cur_oracle) and run_inductive_eval (cur)
    on both committed trained-CE matrices, on the card and held against the
    port on the CPU; then the fixed-anchor-entity producer: 1,000
    random-token entities clustered by phase 9's towers (k-means++, 32
    anchors) and scored against the anchors by phase 4's CE (32,000 pairs,
    kernel A), a slice rescored with the plain attention."""
    import tempfile

    from anncur_tpu_torch.evalx.inductive import run_inductive_eval
    from anncur_tpu_torch.evalx.retrieve_rerank import embed_tokenized
    from anncur_tpu_torch.evalx.transductive import run_approx_eval_w_seed, run_transductive_eval
    from anncur_tpu_torch.indexer.ent2ent import build_ent_to_ent_scores, kmeanspp_anchor_ids
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder, build_pairs, padded_pair_len

    out = {}
    reset_counts()
    with tempfile.TemporaryDirectory() as res_dir:
        for name in TRAINED_CE:
            d = np.load(os.path.join(ROOT, "benchmarks", name))
            scores = np.asarray(d["scores"], np.float32)
            n_train, n_q = int(d["n_train"]), int(d["n_q"])
            t0 = time.perf_counter()
            trans = run_transductive_eval(scores, os.path.join(res_dir, name, "t"), device=dev, **TRANSDUCTIVE)
            trans_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ind = run_inductive_eval(scores[n_train:n_train + n_q], scores[:n_train], os.path.join(res_dir, name, "i"),
                                     device=dev)
            ind_s = time.perf_counter() - t0
            # the card against the CPU: the inductive dict whole; grid points
            # of the transductive sweep (one seed each, the CPU's sort of
            # 628 x 10,000 rows takes a second a point)
            ind_cpu = run_inductive_eval(scores[n_train:n_train + n_q], scores[:n_train],
                                         os.path.join(res_dir, name, "ic"), device="cpu")
            bad = results_close(ind, ind_cpu, n_q)
            for method in TRANSDUCTIVE["methods"]:
                for n_e in (100, 500):
                    pt = [run_approx_eval_w_seed(method, scores, 100, n_e, 10, 500, 0, device=x) for x in (dev, "cpu")]
                    bad = bad or results_close(*pt, 100, 10, f"{method}/anc_n_e={n_e}")
            if bad:
                fail(f"{name}: the card's eval differs from the CPU's at {bad}")
            rec = {"transductive_s": trans_s, "inductive_s": ind_s}
            for method in TRANSDUCTIVE["methods"]:
                for kr in (100, 500):
                    for n_e in TRANSDUCTIVE["n_ent_anchors_vals"]:
                        cell = trans[method]["top_k=10"][f"k_retvr={kr}"][f"anc_n_m=100~anc_n_e={n_e}"]["all"]
                        rec[f"{method}_r@10_kr{kr}_ne{n_e}"] = cell["exact_vs_reranked_approx_retvr~common_frac_mean"]
            for kr in (100, 500):
                for n_e in (100, 500):
                    cell = ind["top_k=10"][f"k_retvr={kr}"][f"anc_n_e={n_e}"]
                    rec[f"inductive_cur_r@10_kr{kr}_ne{n_e}"] = cell["exact_vs_reranked_approx_retvr~common_frac_mean"]
            bad_vals = [k for k, v in rec.items() if "r@10" in k and not 0.0 <= v <= 1.0]
            if bad_vals:
                fail(f"{name}: recall out of [0, 1] at {bad_vals}")
            log(f"  {name}: transductive (cur, cur_oracle; 100 mention anchors; 100/200/500 entity anchors; "
                f"top-k 1/10/100; k_retvr 100/500; 3 seeds) {trans_s:.2f} s; inductive cur ({n_train} train, {n_q} "
                f"test rows, the default grids) {ind_s:.2f} s; equal to the CPU's within the test tolerances")
            log(f"  {name} recall@10: " + ", ".join(f"{k} {v:.4f}" for k, v in rec.items() if "r@10" in k))
            out[name] = rec

    # the fixed-anchor-entity producer
    ce, lm = retriever.encoder, retriever.max_query_len
    ents = rng.integers(1, spec.vocab_size, size=(E2E_ENTITIES, lm)).astype(np.int32)
    anchors = kmeanspp_anchor_ids(embed_tokenized(bienc, ents, 64, "label"), E2E_ANCHORS, seed=0)
    builder = ScoreMatrixBuilder(ce, ment_block=32, ent_block=32, max_pairs_per_program=32768, device=dev)
    t0 = time.perf_counter()
    e2e = build_ent_to_ent_scores(builder, ents, anchors)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = read_counts()
    pairs = build_pairs(torch.as_tensor(ents[:2], device=dev), torch.as_tensor(ents[anchors], device=dev),
                        padded_pair_len(lm, lm, builder.pair_pad_multiple, spec.max_position_embeddings))
    plain = rescore_with_plain_attention(ce, pairs, lm).reshape(2, E2E_ANCHORS).float().cpu().numpy()
    err = float(np.abs(plain - e2e[:2]).max())
    log(f"  ent2ent {E2E_ENTITIES} x {E2E_ANCHORS} k-means++ anchors ({E2E_ENTITIES * E2E_ANCHORS} CE pairs): "
        f"{e2e_s:.3f} s, {E2E_ENTITIES * E2E_ANCHORS / e2e_s:.1f} pairs/s; 2 rows vs plain attention max |diff| "
        f"{err:.3e} (tol {CE_ATOL}); launches {counts}")
    if e2e.shape != (E2E_ENTITIES, E2E_ANCHORS) or not np.isfinite(e2e).all() or not err <= CE_ATOL:
        fail("the entity-to-entity scores have the wrong shape, non-finite values or differ from plain attention")
    if counts["attention_fwd"] == 0:
        fail("the paper's evals never launched kernel A")
    return {"matrices": out, "e2e_s": e2e_s, "e2e_pairs_per_s": E2E_ENTITIES * E2E_ANCHORS / e2e_s,
            "e2e_plain_err": err, "launches": counts}


# --------------------------------------------------------------------- #
# phase 11: the command-line pipeline over ZeShEL-format files
# --------------------------------------------------------------------- #

# the synthetic world (ZeShEL's on-disk formats, the bert-base-uncased
# vocabulary layout): cut these, never the widths, if the run nears its limit
CLI = dict(n_ents=10000, n_ments=400, desc_words=(100, 141), ctx_words=(50, 71), title_words=2,
           chunk=8, n_anchor_items=500, queries=128, http_clients=32, http_per_client=4, http_sequential=16,
           added=16, rerank_mentions=128, tfidf_negs=63)
CLI_FIXED = ["--top_k", "10", "--top_k_retvr", "100"]  # cost 600 with 500 anchors
CLI_ADAPTIVE = ["--mode", "adaptive", "--budget", "210", "--rounds", "8", "--top_k", "10"]
# phase 10's grid point that step 9 repeats through the CLI
CLI_EVAL_POINT = dict(method="cur", n_seeds=3, n_ment_anchors=100, n_ent_anchors=500, top_k=10, top_k_retvr=500)


def make_cli_world(root, rng, vocab):
    """ZeShEL-format files of CLI's sizes, words drawn from the vocabulary's
    whole words: every mention's gold title in its text, its context on
    both sides. Returns (files, mentions, entities)."""
    from anncur_tpu_torch.data.synthetic import write_world_files

    words = np.asarray([t for t in vocab if t.isascii() and t.isalpha() and len(t) > 1])

    def text(lo_hi):
        return " ".join(rng.choice(words, size=int(rng.integers(*lo_hi))))

    entities = [(" ".join(rng.choice(words, size=CLI["title_words"])), text(CLI["desc_words"]))
                for _ in range(CLI["n_ents"])]
    mentions = []
    for i in range(CLI["n_ments"]):
        label = int(rng.integers(0, CLI["n_ents"]))
        mentions.append({"mention": entities[label][0], "mention_id": f"m{i}", "context_left": text(CLI["ctx_words"]),
                         "context_right": text(CLI["ctx_words"]), "context_doc_id": f"d{i}", "type": "synth",
                         "label_id": label})
    return write_world_files(root, mentions, entities, world="synthcity"), mentions, entities


class CallTimer:
    """Wraps ``owner.name`` for the span of a ``with``: the seconds of each
    call (with ``sync``, the card synchronised after it) and, with
    ``keep``, the calls' arguments, results and kernel launches, so a CLI's
    own work can be timed and checked and its inputs reused without
    changing what it runs."""

    def __init__(self, owner, name, keep=False, sync=True):
        self.owner, self.name, self.keep, self.sync = owner, name, keep, sync
        self.seconds, self.calls, self.launches = 0.0, [], []

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)
        orig = self.orig

        @functools.wraps(orig)
        def timed(*a, **k):
            before = read_counts() if self.keep else None
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if self.sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            if self.keep:
                self.calls.append((a, k, out))
                self.launches.append({name: n - before[name] for name, n in read_counts().items()})
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def read_jsonl(path):
    with open(path) as fin:
        return [json.loads(line) for line in fin]


def rows_close(got, want, what):
    """Result rows of the same queries: scores within CE_ATOL; ids equal
    where the reference's neighbours differ by more than twice the largest
    score difference seen (random weights put most neighbours within
    CE_ATOL of each other, and a row's scores moved by at most that much
    keep the order of scores further apart). Returns (max |diff|, ids
    compared, ids in all, rows equal in ids and scores)."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows against {len(want)}")
    rows = []
    for g, w in zip(got, want):
        gi, gs = np.asarray([r[0] for r in g]), np.asarray([r[1] for r in g], np.float64)
        wi, ws = np.asarray([r[0] for r in w]), np.asarray([r[1] for r in w], np.float64)
        if gi.shape != wi.shape or not np.isfinite(gs).all():
            fail(f"{what}: a row has the wrong length or non-finite scores")
        rows.append((gi, gs, wi, ws))
    err = max(float(np.abs(gs - ws).max()) for _, gs, _, ws in rows)
    if not err <= CE_ATOL:
        fail(f"{what}: scores differ by {err} (tol {CE_ATOL})")
    compared = total = same = 0
    for gi, gs, wi, ws in rows:
        gap = -np.diff(ws) > 2 * err
        sep = np.ones(ws.shape, bool)
        sep[:-1] &= gap
        sep[1:] &= gap
        if not np.array_equal(gi[sep], wi[sep]):
            fail(f"{what}: ids differ at separated scores: {gi.tolist()} vs {wi.tolist()}")
        compared, total = compared + int(sep.sum()), total + sep.size
        same += int(np.array_equal(gi, wi) and np.array_equal(gs, ws))
    return err, compared, total, same


def http_call(base, path, payload=None, raw=None):
    import urllib.error
    import urllib.request

    data = raw if raw is not None else None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_cli(dev, rng, root, trained_ce_recall, device_args=(), arch=None):
    """Every CLI of the pipeline through its ``main(argv)``: tokenize (and
    the native tokenizer), build in two chunk jobs + combine, a retriever
    state file, serve from a file (fixed, adaptive) and over HTTP,
    retrieve-and-rerank, the TF-IDF mine (kernel B at d = the vocabulary),
    the transductive eval at one of phase 10's grid points, and two
    training steps. Each step timed on the host clock and held against an
    in-process call or the plain version on the same inputs. Launches are
    counted around the CLIs' calls only. Its files are written under
    ``root``; ``rec["shared"]`` names those phase 12 reads again.
    ``device_args`` and ``arch`` (the architecture flags' values; none on
    the card: bert-base) let a CPU rehearsal run it at a tiny size."""
    import glob

    import anncur_tpu_torch.cli.compute_tfidf_hard_negs as cli_tfidf
    import anncur_tpu_torch.train.negatives as negatives
    import anncur_tpu_torch.cli.eval_retrieve_rerank as cli_rr
    from anncur_tpu_torch.cli import (
        build_score_matrix,
        combine_chunks,
        eval_retrieval,
        serve,
        tokenize_entities,
        train as cli_train,
    )
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.indexer.score_matrix import (
        ScoreMatrixBuilder,
        build_pairs,
        load_score_matrix,
        padded_pair_len,
        save_score_matrix,
    )
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.models.native_tokenizer import NativeWordPieceTokenizer
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_realistic_vocab
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.train.checkpoint import save_pytree

    device_args, arch = list(device_args), dict(arch or {})
    arch_args = [x for key, val in arch.items() for x in (f"--{key}", str(val))]
    steps = StepRecorder()
    totals, rec = steps.totals, steps.rec

    def run(step, fn, argv, tensors=True):
        """One CLI call through ``steps``: (seconds, its launches).
        ``tensors``: the CLI takes ``--device``."""
        return steps.run(step, fn, argv + (device_args if tensors else []))[1:]

    vocab = make_realistic_vocab()
    tokenizer = WordPieceTokenizer(vocab)
    vocab_file = os.path.join(root, "vocab.txt")
    tokenizer.save_vocab(vocab_file)
    t0 = time.perf_counter()
    files, mentions, entities = make_cli_world(root, rng, vocab)
    spec = BertSpec(vocab_size=tokenizer.vocab_size, **arch)  # the CLIs' flags name BertSpec's fields
    ce = CrossEncoder(spec, compute_dtype=torch.bfloat16, device=dev, seed=0)
    ce_ckpt = os.path.join(root, "ce.pkl")
    save_pytree(ce_ckpt, {"params": ce.params_tree()})
    bienc_ckpt = os.path.join(root, "bienc.pkl")
    save_pytree(bienc_ckpt, {"params": BiEncoder(spec, embed_dim=spec.hidden_size, device="cpu", seed=1).params_tree()})
    log(f"  world: {len(entities)} entities, {len(mentions)} mentions, vocabulary {tokenizer.vocab_size}; "
        f"CE (seed 0) and bi-encoder (seed 1) checkpoints written in {time.perf_counter() - t0:.1f} s")
    common = ["--vocab_file", vocab_file] + arch_args

    # 1. tokenize, then the native tokenizer on the texts the CLI encoded
    # (each title and description, whole: its calls are recorded)
    ents_npy = os.path.join(root, "ents.npy")
    with CallTimer(WordPieceTokenizer, "encode", keep=True, sync=False) as enc:
        dt, _ = run("tokenize", tokenize_entities.main,
                    ["--ent_file", files["ent_file"], "--vocab_file", vocab_file, "--out_file", ents_npy],
                    tensors=False)
    ent_toks = np.load(ents_npy)
    native = NativeWordPieceTokenizer(vocab)
    if not native.native_available:
        fail("the native tokenizer is not available")
    texts, py_ids = [a[1] for a, _, _ in enc.calls], [out for _, _, out in enc.calls]
    py_s = enc.seconds
    t0 = time.perf_counter()
    nat_ids = [native.encode(x) for x in texts]
    nat_s = time.perf_counter() - t0
    if len(texts) != 2 * len(entities) or nat_ids != py_ids:
        fail("the native tokenizer's ids differ from the Python WordPiece's")
    del enc
    fill = float((ent_toks > 0).sum(1).mean())
    rec["tokenize"] = {"entities_per_s": len(entities) / dt, "python_texts_per_s": len(texts) / py_s,
                       "native_texts_per_s": len(texts) / nat_s, "native_speedup": py_s / nat_s,
                       "entity_tokens_mean": fill}
    log(f"  1. tokenize_entities {len(entities)} entities: {dt:.2f} s ({len(entities) / dt:.0f}/s), "
        f"{fill:.1f} of {ent_toks.shape[1]} tokens filled; WordPiece on its {len(texts)} texts (titles and "
        f"descriptions): Python {len(texts) / py_s:.0f} texts/s, native {len(texts) / nat_s:.0f} texts/s "
        f"({py_s / nat_s:.1f}x), ids equal on every text")

    # 2. build: two chunk jobs, combined; against one in-process call
    base = ["--ment_file", files["ment_file"], "--ent_file", files["ent_file"], "--ent_tokens_file", ents_npy,
            "--ckpt_path", ce_ckpt, "--res_dir", os.path.join(root, "scores")] + common
    c = CLI["chunk"]
    for start in (0, c):
        run("build", build_score_matrix.main, base + ["--n_ment_start", str(start), "--n_ment", str(c)])
    parts = sorted(glob.glob(os.path.join(root, "scores", "*.pkl")))
    full_pkl = os.path.join(root, "full.pkl")
    run("combine", combine_chunks.main, ["--chunks", *parts, "--out", full_pkl], tensors=False)
    full = load_score_matrix(full_pkl)
    scores, ment_toks = full["ment_to_ent_scores"], full["mention_tokens_list"]
    n_pairs = scores.size
    build_s = rec["seconds"]["build"]
    if scores.shape != (2 * c, len(entities)) or not np.isfinite(scores).all():
        fail(f"the combined matrix has shape {scores.shape} or non-finite values")
    builder = ScoreMatrixBuilder(ce, device=dev)
    t0 = time.perf_counter()
    inproc = builder(ment_toks, ent_toks)
    inproc_s = time.perf_counter() - t0
    build_err = float(np.abs(inproc - scores).max())
    sub = 256
    pairs = build_pairs(torch.as_tensor(ment_toks[:c], device=dev), torch.as_tensor(ent_toks[:sub], device=dev),
                        padded_pair_len(ment_toks.shape[1], ent_toks.shape[1], 128, spec.max_position_embeddings))
    plain = rescore_with_plain_attention(ce, pairs, ment_toks.shape[1]).reshape(c, sub).float().cpu().numpy()
    plain_err = float(np.abs(plain - scores[:c, :sub]).max())
    log(f"  2. build_score_matrix 2 chunk jobs of {c} x {len(entities)} + combine_chunks: {build_s:.2f} s, "
        f"{n_pairs / build_s:.1f} pairs/s; one in-process call of the builder at the CLI's blocks "
        f"{n_pairs / inproc_s:.1f} pairs/s, max |diff| {build_err:.3e}; {c} x {sub} vs plain attention "
        f"{plain_err:.3e} (tol {CE_ATOL})")
    if not (build_err <= CE_ATOL and plain_err <= CE_ATOL):
        fail("the CLI's score matrix differs from the in-process builder's or the plain attention's")
    rec["build"] = {"pairs_per_s": n_pairs / build_s, "in_process_pairs_per_s": n_pairs / inproc_s,
                    "vs_in_process": build_err, "vs_plain": plain_err}

    # 3. a retriever state file over the CLI's matrix
    t0 = time.perf_counter()
    retriever = CurRetriever.build(ce, tokenizer, ment_toks, ent_toks, n_anchor_items=CLI["n_anchor_items"],
                                   builder=builder, train_scores=scores, device=dev)
    state = os.path.join(root, "state.pkl")
    retriever.save(state)
    log(f"  3. CurRetriever.build ({CLI['n_anchor_items']} anchors over the {2 * c}-row matrix) + save: "
        f"{time.perf_counter() - t0:.2f} s")

    # 4. serve from a file, fixed: 128 queries at cost 600
    queries = [{k: m[k] for k in ("mention", "context_left", "context_right")}
               for m in mentions[2 * c:2 * c + CLI["queries"]]]
    qfile = os.path.join(root, "queries.jsonl")
    with open(qfile, "w") as fout:
        fout.writelines(json.dumps(q) + "\n" for q in queries)
    qtoks = np.asarray([retriever.tokenize_query(q["mention"], q["context_left"], q["context_right"])
                        for q in queries], np.int32)
    serve_base = ["--index", state, "--crossenc_ckpt", ce_ckpt, "--queries", qfile] + common
    fixed_out = os.path.join(root, "fixed.jsonl")
    with CallTimer(CurRetriever, "query_tokens_batch") as timer:
        dt, _ = run("serve_fixed", serve.main, serve_base + ["--out", fixed_out, "--batch", "32"] + CLI_FIXED)
    fixed_rows = [r["results"] for r in read_jsonl(fixed_out)]
    s_ref, i_ref = retriever.query_tokens_batch(qtoks, top_k=10, top_k_retvr=100)
    ref_rows = [list(zip(i.tolist(), s.tolist())) for i, s in zip(i_ref, s_ref)]
    err, n_cmp, n_all, n_same = rows_close(fixed_rows, ref_rows, "serve --mode fixed vs query_tokens_batch")
    rec["serve_fixed"] = {"qps": len(queries) / timer.seconds, "qps_with_start": len(queries) / dt, "err": err}
    log(f"  4. serve fixed, {len(queries)} queries from JSONL at cost {CLI['n_anchor_items'] + 100}, --batch 32: "
        f"{len(queries) / timer.seconds:.2f} q/s in its query calls ({timer.seconds:.2f} s), "
        f"{len(queries) / dt:.2f} q/s over the whole CLI ({dt:.2f} s, start-up included); vs query_tokens_batch "
        f"max |diff| {err:.3e}, {n_cmp}/{n_all} ids compared, {n_same}/{len(queries)} rows identical")

    # 5. serve from a file, adaptive: 210 over 8, one batch of 128
    ada_out = os.path.join(root, "adaptive.jsonl")
    with CallTimer(CurRetriever, "query_tokens_adaptive_fused") as timer:
        dt, _ = run("serve_adaptive", serve.main,
                    serve_base + ["--out", ada_out, "--batch", str(len(queries))] + CLI_ADAPTIVE)
    s_ref, i_ref = retriever.query_tokens_adaptive_fused(qtoks, total_budget=210, n_rounds=8, top_k=10, seed=0)
    err, n_cmp, n_all, n_same = rows_close([r["results"] for r in read_jsonl(ada_out)],
                                   [list(zip(i.tolist(), s.tolist())) for i, s in zip(i_ref, s_ref)],
                                   "serve --mode adaptive vs query_tokens_adaptive_fused")
    rec["serve_adaptive"] = {"qps": len(queries) / timer.seconds, "qps_with_start": len(queries) / dt, "err": err}
    log(f"  5. serve adaptive 210 over 8, {len(queries)} queries in one batch: {len(queries) / timer.seconds:.2f} q/s "
        f"in its query call, {len(queries) / dt:.2f} q/s over the whole CLI; vs query_tokens_adaptive_fused "
        f"max |diff| {err:.3e}, {n_cmp}/{n_all} ids compared, {n_same}/{len(queries)} rows identical")

    # 6. serve over HTTP, coalescing 32 concurrent clients
    http_base = ["--index", state, "--crossenc_ckpt", ce_ckpt] + common
    rec["http"] = http_step(run, serve, http_base, queries, fixed_rows, retriever, mentions)

    # 7. retrieve and rerank: 128 mentions, top 64
    with CallTimer(cli_rr, "run_retrieve_rerank_eval") as timer:
        dt, _ = run("retrieve_rerank", cli_rr.main,
                    ["--ment_file", files["ment_file"], "--ent_file", files["ent_file"], "--ent_tokens_file",
                     ents_npy, "--bienc_ckpt", bienc_ckpt, "--crossenc_ckpt", ce_ckpt, "--n_ment",
                     str(CLI["rerank_mentions"]), "--top_k", "64", "--batch_size", "64",
                     "--res_dir", os.path.join(root, "rr")] + common)
    with open(os.path.join(root, "rr", "res.json")) as fin:
        rr = json.load(fin)
    if rr["n_ments"] != CLI["rerank_mentions"] or rr["top_k"] != 64:
        fail(f"eval_retrieve_rerank wrote {rr}")
    rec["retrieve_rerank"] = {"mentions_per_s": CLI["rerank_mentions"] / timer.seconds,
                              "metrics": {"bienc": rr["bienc"], "crossenc": rr["crossenc"]}}
    log(f"  7. eval_retrieve_rerank {CLI['rerank_mentions']} mentions over {len(entities)} entities, top 64: "
        f"{CLI['rerank_mentions'] / timer.seconds:.2f} mentions/s in the eval ({timer.seconds:.2f} s; the "
        f"entities' embedding inside), {dt:.2f} s the whole CLI; metrics {rr['bienc']} / {rr['crossenc']}")

    # 8. the TF-IDF mine: kernel B at d = the fitted vocabulary
    negs_json = os.path.join(root, "negs.json")
    with CallTimer(negatives, "mips_topk_fused", keep=True) as mine:
        dt, _ = run("tfidf_negs", cli_tfidf.main,
                    ["--ment_file", files["ment_file"], "--ent_file", files["ent_file"], "--out_file", negs_json,
                     "--num_negs", str(CLI["tfidf_negs"])])
    (q_emb, i_emb, k), _, _ = mine.calls[0]
    rec["tfidf"] = tfidf_step(q_emb, i_emb, k, negs_json, mentions, dt, mips_topk)
    del q_emb, i_emb, mine

    # 9. the transductive eval at one of phase 10's grid points
    npz = np.load(os.path.join(ROOT, "benchmarks", "trained_ce_matrix.npz"))
    tce = np.asarray(npz["scores"], np.float32)
    tce_pkl = os.path.join(root, "trained_ce.pkl")
    save_score_matrix(tce_pkl, tce, np.zeros((tce.shape[0], 1), np.int32), np.arange(tce.shape[1]))
    p = CLI_EVAL_POINT
    dt, _ = run("eval_retrieval", eval_retrieval.main,
                ["--mode", "transductive", "--score_matrix", tce_pkl, "--res_dir", os.path.join(root, "trans"),
                 "--methods", p["method"], "--n_seeds", str(p["n_seeds"]), "--n_ment_anchors_vals",
                 str(p["n_ment_anchors"]), "--n_ent_anchors_vals", str(p["n_ent_anchors"]), "--top_k_vals",
                 str(p["top_k"]), "--top_k_retvr_vals", str(p["top_k_retvr"])])
    with open(os.path.join(root, "trans", "retrieval_wrt_exact_crossenc.json")) as fin:
        cell = json.load(fin)[p["method"]][f"top_k={p['top_k']}"][f"k_retvr={p['top_k_retvr']}"]
    recall = cell[f"anc_n_m={p['n_ment_anchors']}~anc_n_e={p['n_ent_anchors']}"]["all"][
        "exact_vs_reranked_approx_retvr~common_frac_mean"]
    log(f"  9. eval_retrieval transductive on trained_ce_matrix.npz at cur, 100 x 500 anchors, k_retvr 500, "
        f"3 seeds: recall@10 {recall:.4f} (phase 10: {trained_ce_recall}) in {dt:.2f} s")
    if trained_ce_recall is not None and abs(recall - trained_ce_recall) > 1e-9:
        fail(f"the CLI's transductive recall@10 {recall} differs from phase 10's {trained_ce_recall}")
    rec["eval_recall@10"] = recall

    # 10. two bi-encoder training steps at configs/el_zeshel_bi_enc.json's widths
    rec["train"] = train_step(run, cli_train, files, ents_npy, vocab_file, root)
    for name in ("attention_fwd", "mips_topk_fused"):
        if totals[name] == 0:
            fail(f"phase 11 never launched {name}")
    if rec["train"]["launches"]["attention_bwd_dkv"] == 0 or rec["train"]["launches"]["attention_bwd_dq"] == 0:
        fail("the train CLI never launched kernels C and D")
    rec["launches"] = totals
    rec["shared"] = dict(files=files, vocab_file=vocab_file, ce_ckpt=ce_ckpt, bienc_ckpt=bienc_ckpt, ents_npy=ents_npy,
                         tce_pkl=tce_pkl, common=common, device_args=device_args)
    log(f"  phase 11 launches (the CLIs' calls only): {totals}")
    return rec


def http_step(run, serve, serve_base, queries, fixed_rows, retriever, mentions):
    """``serve --http 127.0.0.1:0`` in a thread: 32 clients x 4 single-query
    requests (each answer against step 4's row), 16 sequential requests
    (latency), /add of 16 items and /remove of them, a malformed body."""
    import threading

    argv = serve_base + ["--http", "127.0.0.1:0", "--batch", "32", "--coalesce_ms", "5"] + CLI_FIXED
    serve._serve_http.last_server = None
    result = {}

    def serve_thread():
        """Keeps what ``run`` returned, or what it raised, for the main thread."""
        try:
            result["run"] = run("serve_http", serve.main, argv)
        except BaseException as e:  # noqa: BLE001 — re-raised through fail() by the main thread
            result["error"] = e

    thread = threading.Thread(target=serve_thread, daemon=True)
    thread.start()
    deadline = time.time() + 300
    while serve._serve_http.last_server is None and time.time() < deadline and thread.is_alive():
        time.sleep(0.05)
    server = serve._serve_http.last_server
    if server is None:
        fail(f"the HTTP server did not come up: {result.get('error')!r}")
    base = "http://127.0.0.1:%d" % server.server_address[1]
    out = {}
    try:
        code, warm = http_call(base, "/query", queries[0])
        if code != 200:
            fail(f"HTTP warm query answered {code}: {warm}")
        n_clients, per = CLI["http_clients"], CLI["http_per_client"]
        answers, errors, lock = {}, [], threading.Lock()
        barrier = threading.Barrier(n_clients)

        def client(c):
            try:
                barrier.wait(timeout=60)
                for j in range(per):
                    i = (c * per + j) % len(queries)
                    code, got = http_call(base, "/query", queries[i])
                    if code != 200:
                        raise RuntimeError(f"{code}: {got}")
                    with lock:
                        answers[c * per + j] = (i, got["results"][0]["results"])
            except Exception as e:  # noqa: BLE001 — reported by the main thread
                with lock:
                    errors.append(repr(e))

        clients = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
        t0 = time.perf_counter()
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        dt = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in clients) or len(answers) != n_clients * per:
            fail(f"HTTP clients failed: {errors[:3]}, {len(answers)} answers")
        err, n_cmp, n_all, n_same = rows_close([a for _, a in answers.values()],
                                               [fixed_rows[i] for i, _ in answers.values()],
                                               "HTTP answers vs the file mode's rows")
        code, health = http_call(base, "/healthz")
        if not (code == 200 and health["dispatches"] < health["queries_answered"]):
            fail(f"HTTP did not coalesce: {health}")
        out.update(qps=n_clients * per / dt, err=err, dispatches=health["dispatches"],
                   queries_answered=health["queries_answered"])
        log(f"  6. serve --http, {n_clients} clients x {per} single-query requests, --batch 32 --coalesce_ms 5: "
            f"{n_clients * per / dt:.2f} q/s ({dt:.2f} s); dispatches {health['dispatches']} for "
            f"{health['queries_answered']} queries; vs the file mode's rows max |diff| {err:.3e}, {n_cmp}/{n_all} "
            f"ids compared, {n_same}/{len(answers)} rows identical")
        lat = []
        for i in range(CLI["http_sequential"]):
            t0 = time.perf_counter()
            code, _ = http_call(base, "/query", queries[i])
            lat.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                fail(f"HTTP sequential query answered {code}")
        out.update(p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)))
        log(f"     {len(lat)} sequential single-query requests: p50 {out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms")
        n0 = health["n_items"]
        items = [{"title": f"added {i}", "description": mentions[-1 - i]["context_left"]} for i in range(CLI["added"])]
        t0 = time.perf_counter()
        code, added = http_call(base, "/add", {"items": items})
        add_s = time.perf_counter() - t0
        n_added = http_call(base, "/healthz")[1]["n_items"]
        code_r, removed = http_call(base, "/remove", {"ids": added.get("ids", [])})
        n_back = http_call(base, "/healthz")[1]["n_items"]
        log(f"     /add {len(items)} items ({len(retriever.train_query_tokens)} CE calls each): {add_s:.3f} s, n_items "
            f"{n0} -> {n_added}; /remove -> {removed}, n_items {n_back}")
        if code != 200 or n_added != n0 + len(items) or code_r != 200 or removed.get("removed") != len(items) or n_back != n0:
            fail(f"/add or /remove went wrong: {added}, {removed}, {n0} -> {n_added} -> {n_back}")
        out["add_s"] = add_s
        code, bad = http_call(base, "/query", raw=b"{not json")
        if code != 400:
            fail(f"a malformed body answered {code}, not 400")
    finally:
        server.shutdown()
        thread.join(timeout=60)
        serve._serve_http.last_server = None
    if thread.is_alive():
        fail("the HTTP server did not stop")
    if "error" in result:
        fail(f"serve --http raised: {result['error']!r}")
    if "run" not in result:
        fail("serve --http returned no launch counts")
    return out


def tfidf_step(q_emb, i_emb, k, negs_json, mentions, dt, mips_topk):
    """The CLI's negatives against the plain MIPS on the card on the same
    rows; kernel B timed at this shape beside its bound. The rows are
    sparse, so the bound counts what this data needs: the dense rows read
    once, and 2 operations per product of two non-zeros (the dense GEMM's
    bound is kept beside it)."""
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused

    q, d = q_emb.shape
    n = i_emb.shape[0]
    with open(negs_json) as fin:
        negs = json.load(fin)
    s_p, i_p = (t.cpu().numpy() for t in mips_topk(q_emb, i_emb, k))
    gap = -np.diff(s_p, axis=1) > MIPS_TIE_GAP * np.abs(s_p).max()
    sep = np.ones(s_p.shape, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    compared = 0
    for r, m in enumerate(mentions):
        keep = i_p[r] != m["label_id"]
        want, ok = i_p[r][keep][:k - 1], sep[r][keep][:k - 1]
        got = np.asarray(negs["indices"][r])
        if got.shape != want.shape or m["label_id"] in got or not np.array_equal(got[ok], want[ok]):
            fail(f"TF-IDF negatives of mention {r} differ from the plain MIPS's")
        compared += int(ok.sum())
    err = check_mips(q_emb, i_emb, k, n, f"kernel B at the TF-IDF width (q={q} d={d} n={n} k={k})")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=q_emb.device)
    timed = time_mips(mips_topk_fused, mips_topk, q_emb, i_emb, k, n, flush)
    del flush
    nnz_ops = 2 * float((q_emb != 0).sum(0).double() @ (i_emb != 0).sum(0).double())
    timed.update(dense_bound_ms=timed["bound_ms"], dense_bound_by=timed["bound_by"], nnz_ops=nnz_ops,
                 density_items=float((i_emb != 0).float().mean()),
                 **bound(4 * (q + n) * d + q * k * 12, TF32_PASSES * nnz_ops, "tf32"))
    timed["x_bound"] = timed["ms"] / timed["bound_ms"]
    log(f"  8. compute_tfidf_hard_negs {q} mentions x {n} entities, {k - 1} negatives: {dt:.2f} s; d = {d} "
        f"(d % 4 = {d % 4}); {compared} ids equal the plain MIPS's at separated places; kernel B {timed['ms']:.4f} ms, "
        f"bound {timed['bound_ms']:.4f} ms counting the non-zero products ({timed['bound_by']}; "
        f"{timed['x_bound']:.1f}x), {timed['dense_bound_ms']:.4f} ms for the dense GEMM; matmul + topk "
        f"{timed['library_ms']:.4f} ms")
    return {"seconds": dt, "d": d, "kernel": timed, "mips_err": err, "ids_compared": compared}


def train_step(run, cli_train, files, ents_npy, vocab_file, root):
    """Two bi-encoder steps through the train CLI at configs/el_zeshel_bi_enc.json's
    widths, over the world's files: in-batch negatives, attention dropout
    0 (so the attention runs kernels A, C and D), one epoch."""
    from anncur_tpu_torch.train.checkpoint import load_pytree

    res_root = os.path.join(root, "train")
    argv = ["--config", os.path.join(ROOT, "configs", "el_zeshel_bi_enc.json"),
            "--trn_files", json.dumps({"synthcity": [files["ment_file"], files["ent_file"], ents_npy]}),
            "--dev_files", "{}", "--bert_args", json.dumps({"vocab_file": vocab_file, "attention_probs_dropout_prob": 0.0}),
            "--base_res_dir", res_root, "--fast_dev_run", "2", "--num_epochs", "1", "--print_interval", "1",
            "--save_code", "False"]
    dt, launches = run("train", cli_train.main, argv)
    (metrics,) = glob_one(res_root, "metrics.jsonl")
    with open(metrics) as fin:
        losses = [r["train_loss"] for r in map(json.loads, fin) if "train_loss" in r]
    (ckpt,) = glob_one(res_root, "eoe-*")
    tree, _ = load_pytree(ckpt)
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses) or tree["step"] != 2:
        fail(f"the train CLI's losses {losses} or checkpoint step {tree.get('step')} are wrong")
    if set(tree["params"]) != {"input_bert", "label_bert"}:
        fail(f"the train CLI's checkpoint holds {sorted(tree['params'])}")
    log(f"  10. train (bi-encoder, configs/el_zeshel_bi_enc.json, in-batch, fast_dev_run 2): {dt:.2f} s the whole "
        f"CLI; losses {[round(x, 4) for x in losses]}; checkpoint {os.path.basename(ckpt)} read back; launches {launches}")
    return {"seconds": dt, "losses": losses, "launches": launches}


def glob_one(root, pattern):
    import glob

    return glob.glob(os.path.join(root, "**", pattern), recursive=True)


# --------------------------------------------------------------------- #
# phase 12: the analysis CLIs and the serving drivers
# --------------------------------------------------------------------- #

# cut these, never the widths, if the run nears its limit
DRIVERS = dict(bienc_mentions=256, e2e_entities=E2E_ENTITIES, e2e_anchors=E2E_ANCHORS, latency_reps=2,
               http_clients=16, http_per_client=2, http_sequential=8, soak_s=6.0, soak_clients=6)
# ZeShEL-military: kernel B at (13,063 x 104,520 x 768, k=64); one mention
# row of the bert-base build over the 104,520 entities in ~2,048-pair
# forwards; fixed cost 600 at q=32, adaptive 210 over 8 at q=128 and q=512
# (the driver's defaults but the build's rows)
MILITARY = ["--build_ments", "1"]
NITEMS = ["--n_items", "10000", "104520", "--batches", "128", "--rounds", "8",
          "--reps", "1", "--shortlist_also", "0"]


def phase_drivers(dev, root, shared, recalls, smi, rehearsal=False):
    """The analysis CLIs and the serving drivers, each through its
    ``main(argv)`` at bert-base width with random weights, over phase 11's
    files (``shared``, under ``root``): (a) ``compute_bienc_scores`` (400
    mentions x 10,000 entities), ``build_ent2ent`` (1,000 x 32 k-means++
    anchors of those embeddings), ``rank_probe`` on the trained-CE matrices,
    ``launch_jobs --backend local`` (two eval_retrieval jobs at phase 10's
    grid point, then the same launch skipping both); (b)
    ``bench_serving_latency``, ``bench_http_serving`` and ``serving_soak``
    (each over its own 10,000-item bert-base world); (c) ZeShEL-military:
    ``military_scale`` (kernel B at 13,063 x 104,520 x 768, one build row,
    serving over 104,520 items, held to phase 6's checks) and
    ``bench_nitems_scaling`` at 10,000 and 104,520 items. One JSON
    line per driver, with the card; launches counted around the drivers'
    calls only. ``recalls``: phase 10's results on trained_ce_matrix.npz
    (None skips the comparison). ``rehearsal``: the drivers' tiny CPU
    sizes."""
    import pickle

    import anncur_tpu_torch.cli.build_ent2ent as cli_e2e
    import anncur_tpu_torch.cli.compute_bienc_scores as cli_bienc
    from anncur_tpu_torch.cli import launch_jobs, rank_probe
    from anncur_tpu_torch.core.adaptive_fused import split_rounds
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.data import load_entities, load_mentions, tokenize_mentions
    from anncur_tpu_torch.indexer.ent2ent import kmeanspp_anchor_ids, load_ent_to_ent_pickle
    from anncur_tpu_torch.indexer.score_matrix import build_pairs, padded_pair_len, save_score_matrix
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused
    from anncur_tpu_torch.tools import (
        bench_http_serving,
        bench_nitems_scaling,
        bench_serving_latency,
        military_scale,
        serving_soak,
    )
    from anncur_tpu_torch.utils.device import true_f32

    root = os.path.join(root, "drivers")
    os.makedirs(root)
    common, device_args = shared["common"], shared["device_args"]
    tiny = ["--tiny", "--device", "cpu"] if rehearsal else []
    steps = StepRecorder(smi)
    run, line, totals, rec = steps.run, steps.line, steps.totals, steps.rec

    # (a) the analysis CLIs
    tokenizer = WordPieceTokenizer.from_vocab_file(shared["vocab_file"])
    kb2local, entities = load_entities(shared["files"]["ent_file"])
    mentions = load_mentions(shared["files"]["ment_file"], kb2local)[:DRIVERS["bienc_mentions"]]
    ent_toks = np.load(shared["ents_npy"])
    ment_toks = tokenize_mentions(mentions, tokenizer, 128)
    ments_pkl, bienc_out = os.path.join(root, "mentions.pkl"), os.path.join(root, "bienc_scores.pkl")
    save_score_matrix(ments_pkl, np.zeros((len(mentions), 1), np.float32), ment_toks, np.arange(len(entities)))
    with CallTimer(cli_bienc, "embed_tokenized", keep=True) as emb:
        _, dt, counts = run("compute_bienc_scores", cli_bienc.main,
                            ["--score_matrix", ments_pkl, "--ent_tokens_file", shared["ents_npy"], "--bienc_ckpt",
                             shared["bienc_ckpt"], "--out_file", bienc_out] + common + device_args)
    with open(bienc_out, "rb") as fin:
        bienc_scores = pickle.load(fin)["scores"]
    bienc = emb.calls[0][0][0]
    m_emb, e_emb = emb.calls[0][2], emb.calls[1][2]
    del emb
    if bienc_scores.shape != (len(mentions), len(entities)) or not np.isfinite(bienc_scores).all():
        fail(f"compute_bienc_scores wrote shape {bienc_scores.shape} or non-finite scores")
    with true_f32():
        product = (torch.as_tensor(m_emb, device=dev) @ torch.as_tensor(e_emb, device=dev).T).cpu().numpy()
    prod_err = float(np.abs(product - bienc_scores).max())
    if not prod_err <= MIPS_RTOL * float(np.abs(product).max()):
        fail(f"compute_bienc_scores' matrix is not the product of its towers' embeddings: {prod_err}")
    emb_err = towers_vs_plain_attention(bienc, ment_toks[:64], ent_toks[:64], got=(m_emb[:64], e_emb[:64]))
    del bienc
    line("compute_bienc_scores", mentions=len(mentions), entities=len(entities),
         seqs_per_s=(len(mentions) + len(entities)) / dt, embed_rel_err_vs_plain=emb_err, launches=counts)

    n_e2e, n_anc = min(DRIVERS["e2e_entities"], len(entities)), DRIVERS["e2e_anchors"]
    e2e_toks, e2e_emb, e2e_out = (os.path.join(root, f) for f in ("e2e_ents.npy", "e2e_embeds.npy", "e2e.pkl"))
    np.save(e2e_toks, ent_toks[:n_e2e])
    np.save(e2e_emb, e_emb[:n_e2e])
    with CallTimer(cli_e2e, "build_ent_to_ent_scores", keep=True) as e2e_call:
        _, dt, counts = run("build_ent2ent", cli_e2e.main,
                            ["--ent_tokens_file", e2e_toks, "--crossenc_ckpt", shared["ce_ckpt"], "--ent_embeds_file",
                             e2e_emb, "--n_anchors", str(n_anc), "--ment_block", "32", "--ent_block", "32",
                             "--out_file", e2e_out] + common + device_args)
    builder = e2e_call.calls[0][0][0]
    del e2e_call
    e2e, anchors = load_ent_to_ent_pickle(e2e_out)
    if not np.array_equal(anchors, kmeanspp_anchor_ids(e_emb[:n_e2e].astype(np.float32), n_anc, 0)):
        fail("build_ent2ent's anchors are not the k-means++ anchors of its embeddings")
    lm = ent_toks.shape[1]
    pairs = build_pairs(torch.as_tensor(ent_toks[:2], device=dev), torch.as_tensor(ent_toks[anchors], device=dev),
                        padded_pair_len(lm, lm, builder.pair_pad_multiple, builder.encoder.spec.max_position_embeddings))
    plain = rescore_with_plain_attention(builder.encoder, pairs, lm).reshape(2, n_anc).float().cpu().numpy()
    del builder
    e2e_err = float(np.abs(plain - e2e[:2]).max())
    if e2e.shape != (n_e2e, n_anc) or not np.isfinite(e2e).all() or not e2e_err <= CE_ATOL:
        fail(f"build_ent2ent's scores have shape {e2e.shape}, non-finite values or differ from plain attention "
             f"by {e2e_err} (tol {CE_ATOL})")
    line("build_ent2ent", entities=n_e2e, anchors=n_anc, pairs_per_s=n_e2e * n_anc / dt,
         two_rows_vs_plain_attention=e2e_err, launches=counts)
    del m_emb, e_emb

    hard = np.load(os.path.join(ROOT, "benchmarks", TRAINED_CE[1]))
    hard_pkl, ranks_json = os.path.join(root, "trained_ce_hard.pkl"), os.path.join(root, "ranks.json")
    save_score_matrix(hard_pkl, np.asarray(hard["scores"], np.float32), np.zeros((hard["scores"].shape[0], 1), np.int32),
                      np.arange(hard["scores"].shape[1]))
    reports, dt, _ = run("rank_probe", rank_probe.main,
                         ["--score_matrices", shared["tce_pkl"], hard_pkl, "--out", ranks_json])
    for path, rep in reports.items():
        if not 1 <= rep["rank_99pct_energy"] <= rep["rank"] <= min(rep["shape"]):
            fail(f"rank_probe's report of {path} is inconsistent: {rep}")
    line("rank_probe", **{name: {k: reports[p][k] for k in ("shape", "rank", "rank_99pct_energy", "rank_999pct_energy")}
                          for name, p in zip(TRAINED_CE, (shared["tce_pkl"], hard_pkl))})

    p = CLI_EVAL_POINT
    methods = ("cur", "cur_oracle")
    argv = ["--kind", "eval", "--mode", "transductive", "--grid", json.dumps({"method": list(methods)}),
            "--score_matrix_template", shared["tce_pkl"], "--res_dir_template", os.path.join(root, "launch"),
            "--extra_args", f"--n_seeds {p['n_seeds']} --n_ment_anchors_vals {p['n_ment_anchors']} --n_ent_anchors_vals "
            f"{p['n_ent_anchors']} --top_k_vals {p['top_k']} --top_k_retvr_vals {p['top_k_retvr']}",
            "--backend", "local"] + device_args
    launched, dt, _ = run("launch_jobs", launch_jobs.main, argv)
    got = {}
    for job in launched:
        with open(job["probe"]) as fin:
            cell = json.load(fin)[job["overrides"]["method"]][f"top_k={p['top_k']}"][f"k_retvr={p['top_k_retvr']}"]
        got[job["overrides"]["method"]] = cell[f"anc_n_m={p['n_ment_anchors']}~anc_n_e={p['n_ent_anchors']}"]["all"][
            "exact_vs_reranked_approx_retvr~common_frac_mean"]
    if set(got) != set(methods):
        fail(f"launch_jobs ran {sorted(got)}, not {methods}")
    for method in methods:
        want = None if recalls is None else recalls[f"{method}_r@10_kr{p['top_k_retvr']}_ne{p['n_ent_anchors']}"]
        if want is not None and abs(got[method] - want) > 1e-9:
            fail(f"launch_jobs' {method} recall@10 {got[method]} differs from phase 10's {want}")
    again, _, _ = run("launch_jobs_again", launch_jobs.main, argv)
    if again:
        fail(f"a second launch_jobs ran {len(again)} done jobs again")
    line("launch_jobs", jobs=len(launched), recall_at_10=got, phase_10=None if recalls is None else {
        m: recalls[f"{m}_r@10_kr{p['top_k_retvr']}_ne{p['n_ent_anchors']}"] for m in methods}, skipped_after=len(methods))

    # (b) the serving drivers, each over its own bert-base world
    lat, _, counts = run("bench_serving_latency", bench_serving_latency.main,
                         ["--reps", str(DRIVERS["latency_reps"]), "--fixed_batches", "1", "8", "32", "--ada_batches",
                          "1", "8", "32", "--out", os.path.join(root, "latency.json")] + tiny)
    rows = lat["results"]
    if counts["attention_fwd"] == 0 or (counts["mips_topk_fused"] == 0 and not rehearsal):
        fail(f"bench_serving_latency did not run kernels A and B: {counts}")
    line("bench_serving_latency", **{name: {k: row[k] for k in ("p50_ms", "p95_ms", "qps")} for name, row in rows.items()
                                     if name != "add_then_query"}, add_then_query=rows["add_then_query"],
         launches=counts)

    http, _, counts = run("bench_http_serving", bench_http_serving.main,
                          ["--clients", str(DRIVERS["http_clients"]), "--per_client", str(DRIVERS["http_per_client"]),
                           "--seq_baseline", str(DRIVERS["http_sequential"]), "--out",
                           os.path.join(root, "http.json")] + tiny)
    conc = http["concurrent"]
    if not conc["device_dispatches"] < conc["queries"]:
        fail(f"bench_http_serving's clients were not coalesced: {conc}")
    line("bench_http_serving", sequential=http["sequential_1_client"], concurrent=conc, launches=counts)

    soak, _, counts = run("serving_soak", serving_soak.main,
                          ["--seconds", str(DRIVERS["soak_s"]), "--clients", str(DRIVERS["soak_clients"]), "--out",
                           os.path.join(root, "soak.json")] + tiny)
    for mode in ("fixed", "adaptive"):
        if not rehearsal and "device_growth_frac_after_warm" not in soak[mode]:
            fail(f"serving_soak ({mode}) did not read the card's memory")
    line("serving_soak", **{mode: {k: soak[mode].get(k) for k in (
        "seconds", "counts", "latency_s", "rss_growth_frac_after_warm", "device_mb", "device_growth_frac_after_warm",
        "kernel_builds")} for mode in ("fixed", "adaptive")}, launches=counts)

    # (c) ZeShEL-military: the drive, its adaptive calls recorded
    military = ["--quick", "--device", "cpu"] if rehearsal else MILITARY
    seen = []
    scorer = recording_scorers(CurRetriever, seen)
    try:
        with CallTimer(CurRetriever, "query_tokens_adaptive_fused", keep=True) as ada, \
                CallTimer(CurRetriever, "query_tokens_batch", keep=True) as fixed:
            mil, _, counts = run("military_scale", military_scale.main,
                                 military + ["--stages", "mips", "offline_build", "serving", "serving_batch", "--out",
                                             os.path.join(root, "military.json")])
    finally:
        CurRetriever._adaptive_scorer = scorer
    if len(ada.calls) != 3 or len(seen) != 3 or len(fixed.calls) != 2:
        fail(f"military_scale made {len(ada.calls)} adaptive and {len(fixed.calls)} fixed calls, not 3 and 2")
    first = []
    for (a, k, (scores, ids)), calls, launches in zip(ada.calls, seen, ada.launches):
        n_items, rounds = a[0].item_tokens.shape[0], split_rounds(k["total_budget"], k["n_rounds"])[2]
        log(f"  military adaptive call, {a[1].shape[0]} queries over {n_items} items at {k['total_budget']} over "
            f"{k['n_rounds']}: kernel B launched {launches['mips_topk_fused']} times")
        scored, vals = check_scored(calls, scores, ids, k["total_budget"], n_items, a[1].shape[0], k["top_k"])
        if not rehearsal and launches["mips_topk_fused"] != rounds - 1:
            fail(f"a military adaptive batch launched kernel B {launches['mips_topk_fused']} times, not {rounds - 1}")
        first = first or [a, k, scores, ids, scored, vals]
    a, k, scores, ids, scored, vals = first
    mil_ce_err = scores_vs_plain(a[0], a[1], ids, scores, "military adaptive top-10")
    mil_err = growth_round_vs_plain(a[0], k["train_scores"], scored, vals, k["total_budget"], k["n_rounds"],
                                    "ZeShEL-military")
    for (a, k, (scores, ids)), launches in zip(fixed.calls, fixed.launches):
        if not rehearsal and launches["mips_topk_fused"] != 1:
            fail(f"a military fixed batch launched kernel B {launches['mips_topk_fused']} times")
        if scores.shape != (a[1].shape[0], 10) or not (np.diff(scores, axis=1) <= 0).all() or ids.max() >= n_items:
            fail("a military fixed answer has the wrong shape, unsorted scores or ids out of range")
    mil_ce_err = max(mil_ce_err, scores_vs_plain(a[0], a[1], ids, scores, "military fixed top-10"))
    del ada, fixed, seen, calls, first, scored, vals, a, k
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    stages = mil["stages"]
    line("military_scale", mips=stages["mips"], offline_build=stages["offline_build"], serving=stages["serving"],
         serving_batch=stages["serving_batch"], scores_vs_plain_attention=mil_ce_err, launches=counts)

    # kernel B at the military MIPS shape, beside its bound and the library
    q, n, d, kk = military_scale.mips_shape(rehearsal)
    queries, items = military_scale.mips_inputs(q, n, d, dev)
    mil_err = max(mil_err, check_mips(queries[:256], items, kk, n, f"kernel B at ZeShEL-military (256 of {q} "
                                                                      f"queries, d={d}, n={n}, k={kk})"))
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    rec["military_mips"] = time_mips(mips_topk_fused, mips_topk, queries, items, kk, n, flush)
    del flush
    rec["military_mips"]["f64"] = f64_accuracy(queries, items, kk, f"kernel B at ZeShEL-military ({q} x {n} x {d})")
    del queries, items
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    nitems = ["--cpu", "--n_items", "600", "1200", "--batches", "8", "--budget", "60", "--rounds", "3", "--reps", "1",
              "--shortlist_also", "0"] if rehearsal else NITEMS
    scaling, _, counts = run("bench_nitems_scaling", bench_nitems_scaling.main,
                             nitems + ["--out", os.path.join(root, "nitems.json")])
    line("bench_nitems_scaling", budget=scaling["budget"], rounds=scaling["rounds"], scales={
        n: {row: v["qps"] for row, v in scale.items() if row != "padded_items"} for n, scale in scaling["scales"].items()},
        launches=counts)

    for name in ("attention_fwd", "mips_topk_fused"):
        if totals[name] == 0:
            fail(f"phase 12 never launched {name}")
    rec.update(launches=totals, mips_err=mil_err)
    log(f"  phase 12 launches (the drivers' calls only): {totals}")
    return rec


# --------------------------------------------------------------------- #

# --------------------------------------------------------------------- #
# phase 13: the parallel layer at world size 1
# --------------------------------------------------------------------- #


def same_answer(got, want, what, atol=CE_ATOL):
    """Scores within ``atol`` and ids equal wherever the reference's
    neighbours differ by more than ``MIPS_TIE_GAP`` of its scale; returns
    the largest score difference."""
    (s, i), (s_ref, i_ref) = ((np.asarray(a), np.asarray(b)) for a, b in (got, want))
    if s.shape != s_ref.shape or i.shape != i_ref.shape:
        fail(f"{what}: shapes {s.shape} vs {s_ref.shape}")
    err = float(np.abs(s - s_ref).max())
    gap = -np.diff(s_ref, axis=1) > MIPS_TIE_GAP * float(np.abs(s_ref).max())
    sep = np.ones(s_ref.shape, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    if not err <= atol or not np.array_equal(i[sep], i_ref[sep]):
        fail(f"{what}: scores differ by {err} (tol {atol}) or ids differ at separated scores")
    return err


def phase_parallel(dev, smi, build, serve, train, adaptive, embeds, retriever, train_mat, rehearsal=False):
    """The parallel layer on a 1-rank NCCL group (``mesh_session``: started
    on an in-process store, destroyed at the end), each path against the
    one-device call it replaces, on phases 3-7's state: (a) the Trainer over
    ``default_mesh()`` and over a (1, 1) data x model mesh with the towers
    tensor-parallel, 2 steps each from phase 5's starting state; (b) the
    entity-sharded build and ``build_multihost`` of 4 x 2048 of phase 3's
    pairs; (c) ``mips_topk_sharded`` at ZeShEL-military's MIPS shape and
    ``DenseIndex(mesh=)`` on phase 7's embeddings, both timed beside the
    one-device calls; (d) ``CurRetriever(mesh=)`` at cost 600 on phase 4's
    queries and at 210 over 8 on phase 6's, held to those phases' checks;
    (e) ``parallel/dryrun.py --nproc 1 --device cuda`` in its own process.
    One JSON line per check, with the card. Launches are counted around the
    main-path calls of (a)-(d) only. ``rehearsal``: a CPU run at tiny
    shapes (gloo, the quick MIPS shape, no launch checks, the dry run on
    the CPU)."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
    from anncur_tpu_torch.ops.dense_index import DenseIndex
    from anncur_tpu_torch.ops.mips import mips_topk_sharded, topk_of_shards
    from anncur_tpu_torch.ops.mips_kernel import fused_mips_topk, mips_topk_fused
    from anncur_tpu_torch.parallel.mesh import make_mesh, mesh_session
    from anncur_tpu_torch.tools import military_scale
    from anncur_tpu_torch.train.trainer import Trainer

    steps = StepRecorder(smi, key="phase13")
    line, totals, rec = steps.line, steps.totals, steps.rec

    def counted(fn):
        return steps.counted(fn)[0]

    with mesh_session(dev) as mesh, tempfile.TemporaryDirectory() as tmp:
        if (dist.get_backend() != ("gloo" if rehearsal else "nccl") or mesh.shape != {"data": 1}
                or mesh.device != torch.device(dev)):
            fail(f"the world-size-1 group is not NCCL on {dev}: {dist.get_backend()} {mesh.shape} {mesh.device}")

        # (a) training: phase 5's CE, config and first two batches
        t0 = time.perf_counter()
        ce, cfg, raw = train["start"]
        cfg.update_from_dict({"base_res_dir": tmp})
        mesh_tp = make_mesh((1, 1), ("data", "model"), dev)

        def two_steps(m, tp_axis):
            trainer = Trainer(cfg, ce, mesh=m, total_steps=100, tp_axis=tp_axis)
            state = trainer.init_state()
            batches = [trainer._shard_batch(b) for b in raw]
            reset_counts()
            losses = [float(trainer.train_step(state, b)["loss"]) for b in batches]
            torch.cuda.synchronize()
            launched = read_counts()
            # one micro-batch's loss and gradient norm at the state reached
            mb = {k: v[0] for k, v in batches[0].items()}
            for p in state.params.values():
                p.grad = None
            loss, _ = trainer._loss_fn(mb, torch.Generator().manual_seed(7), group=trainer._data_group)
            loss.backward()
            norm = math.sqrt(sum(float((p.grad.float() ** 2).sum()) for p in state.params.values() if p.grad is not None))
            for p in state.params.values():
                p.grad = None
            return losses, float(loss.detach()), norm, launched

        ref = two_steps(None, None)
        for name, m, tp_axis in (("dp", mesh, None), ("dp_tp", mesh_tp, "model")):
            losses, loss, norm, launched = two_steps(m, tp_axis)
            for k, n_ in launched.items():
                totals[k] += n_
            d_loss = max(abs(a - b) for a, b in zip(losses + [loss], ref[0] + [ref[1]]))
            if not (d_loss <= TRAIN_LOSS_ATOL and abs(norm - ref[2]) <= TRAIN_GNORM_RTOL * ref[2]):
                fail(f"training over the {name} mesh: losses {losses}, {loss} vs {ref[0]}, {ref[1]}; "
                     f"grad norm {norm} vs {ref[2]}")
            want = 2 * 2 * ce.spec.num_layers * cfg.grad_acc_steps  # 2 steps x (pos, neg) forwards x layers x micro
            if not rehearsal and any(launched[k] != want for k in ("attention_fwd", "attention_bwd_dkv", "attention_bwd_dq")):
                fail(f"training over the {name} mesh launched the attention kernels {launched}, not {want} times")
            line(f"train_{name}", t0, mesh=m.shape, tp_axis=tp_axis, losses=losses, one_device_losses=ref[0],
                 micro_loss=[loss, ref[1]], grad_norm=[norm, ref[2]], launches=launched)
            t0 = time.perf_counter()
        del ce, raw
        torch.cuda.empty_cache()

        # (b) the entity-sharded build and build_multihost, 4 x 2048 pairs
        t0 = time.perf_counter()
        ment, ent = build["ment"][:4], build["ent"]
        # 4 x 512 pairs per forward, as phase 3's 32 x 64
        builder = ScoreMatrixBuilder(retriever.encoder, ment_block=4, ent_block=512, device=dev, mesh=mesh)
        sharded = counted(lambda: builder(ment, ent))
        dt = time.perf_counter() - t0
        local = ScoreMatrixBuilder(retriever.encoder, ment_block=4, ent_block=512, device=dev)
        multihost = counted(lambda: local.build_multihost(ment, ent, os.path.join(tmp, "mh"), chunk_rows=4))
        errs = [float(np.abs(m - build["scores"][:4]).max()) for m in (sharded, multihost)]
        if not max(errs) <= CE_ATOL:
            fail(f"the sharded build or build_multihost differs from phase 3's rows by {errs}")
        line("build", t0, pairs=4 * ent.shape[0], pairs_per_s=4 * ent.shape[0] / dt,
             phase3_pairs_per_s=build["pairs_per_s"], max_abs_err=errs[0], multihost_max_abs_err=errs[1])

        # (c) sharded MIPS at ZeShEL-military's shape, DenseIndex(mesh=) at phase 7's
        t0 = time.perf_counter()
        flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
        q, n, d, kk = military_scale.mips_shape(rehearsal)
        queries, items = military_scale.mips_inputs(q, n, d, dev)
        got = counted(lambda: mips_topk_sharded(queries, items, kk, mesh))
        want = fused_mips_topk(queries, items, kk)
        err = same_answer([t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want],
                          "mips_topk_sharded at ZeShEL-military", atol=MIPS_RTOL * float(want[0].abs().max()))
        sharded_ms = time_ms(lambda: mips_topk_sharded(queries, items, kk, mesh), 10, flush)
        fused_ms = time_ms(lambda: fused_mips_topk(queries, items, kk), 10, flush)
        library_ms = time_ms(lambda: torch.topk(queries @ items.T, kk), 3, flush)  # matmul + topk
        del queries, items, got, want
        line("mips_sharded", t0, shape=f"q={q} d={d} n={n} k={kk}", max_abs_err=err, ms=sharded_ms,
             one_device_ms=fused_ms, library_ms=library_ms)
        t0 = time.perf_counter()
        ment_emb, label_emb = embeds
        index = DenseIndex(label_emb, mesh=mesh, device=dev)
        got = counted(lambda: index.search(ment_emb, RERANK["top_k"]))
        one = DenseIndex(label_emb, device=dev)
        err = same_answer(got, one.search(ment_emb, RERANK["top_k"]), "DenseIndex(mesh=)",
                          atol=MIPS_RTOL * float(np.abs(got[0]).max()))
        q_dev = torch.as_tensor(ment_emb, device=dev)
        sharded_ms = time_ms(lambda: topk_of_shards(q_dev, index.embeds, RERANK["top_k"], mesh, "data", 0, index.n), 30, flush)
        fused_ms = time_ms(lambda: mips_topk_fused(q_dev, one.embeds, RERANK["top_k"]), 30, flush)
        library_ms = time_ms(lambda: torch.topk(q_dev @ one.embeds[:one.n].T, RERANK["top_k"]), 30, flush)
        # the bound of the search: queries and items read once, k scores and ids written, the product in
        # three TF32 passes (kernel B's route for f32 items in chunks of more than 32 queries)
        nq, d_emb = q_dev.shape
        dense_bound = bound(4 * (nq + one.n) * d_emb + 12 * nq * RERANK["top_k"],
                            TF32_PASSES * 2 * nq * one.n * d_emb, "tf32")
        del flush, index, one, q_dev
        torch.cuda.empty_cache()
        line("dense_index", t0, shape=f"q={ment_emb.shape[0]} d={ment_emb.shape[1]} n={label_emb.shape[0]} "
             f"k={RERANK['top_k']}", max_abs_err=err, ms=sharded_ms, one_device_ms=fused_ms, library_ms=library_ms,
             **dense_bound)

        # (d) query-sharded serving over phase 4's 10,000 items
        t0 = time.perf_counter()
        sharded_r = dataclasses.replace(retriever, mesh=mesh)
        qtoks, scores4, ids4 = serve["answer"]
        sharded_r.query_tokens_batch(qtoks, top_k=10, top_k_retvr=100)  # warm
        torch.cuda.synchronize()
        t1, before = time.perf_counter(), dict(totals)
        fixed = counted(lambda: sharded_r.query_tokens_batch(qtoks, top_k=10, top_k_retvr=100))
        dt = time.perf_counter() - t1
        launched = {k: totals[k] - before[k] for k in totals}
        if not rehearsal and (launched["attention_fwd"] == 0 or launched["mips_topk_fused"] != 1):
            fail(f"the sharded query batch did not run kernel A and kernel B once: {launched}")
        err = same_answer(fixed, (scores4, ids4), "CurRetriever(mesh=) at cost 600")
        line("serve_fixed", t0, queries=len(qtoks), qps=len(qtoks) / dt, phase4_qps=serve["qps"], max_abs_err=err,
             launches=launched)

        t0 = time.perf_counter()
        qtoks6 = adaptive["qtoks"]
        train_dev = torch.as_tensor(train_mat, device=dev)

        def call(kw):
            return sharded_r.query_tokens_adaptive_fused(qtoks6, top_k=10, train_scores=train_dev, return_stats=True,
                                                         **kw)

        before = dict(totals)
        s6, i6, _, _ = counted(lambda: recorded_adaptive_call(sharded_r, call, ADAPTIVE, len(qtoks6), 10))
        launched = {k: totals[k] - before[k] for k in totals}
        rounds = ADAPTIVE["n_rounds"]
        if not rehearsal and (launched["mips_topk_fused"] != rounds - 1 or launched["attention_fwd"] == 0):
            fail(f"the sharded adaptive batch did not launch kernel B once per growth round: {launched}")
        secs = timed_calls(lambda: call(ADAPTIVE), 2)
        err = same_answer((s6, i6), adaptive["answer"], "CurRetriever(mesh=) adaptive 210 over 8")
        ce_err = scores_vs_plain(sharded_r, qtoks6, i6, s6, "sharded adaptive top-10")
        line("serve_adaptive", t0, queries=len(qtoks6), qps=len(qtoks6) / statistics.median(secs),
             phase6_qps=adaptive["qps"], max_abs_err=err, scores_vs_plain_attention=ce_err, launches=launched)
        del sharded_r, train_dev

    if dist.is_initialized():
        fail("the world-size-1 group outlived phase 13")

    # (e) the dry run in its own process: 1 rank over NCCL
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "anncur_tpu_torch.parallel.dryrun", "--nproc", "1", "--device",
                          "cpu" if rehearsal else "cuda", "--timeout", "300"], cwd=ROOT, capture_output=True, text=True,
                         timeout=400)
    summary = next((json.loads(x)["dryrun"] for x in out.stdout.splitlines() if x.startswith('{"dryrun"')), None)
    if out.returncode != 0 or summary is None:
        fail(f"parallel/dryrun.py --nproc 1 --device cuda failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    line("dryrun", t0, **{k: v for k, v in summary["ranks"][0].items() if k != "seconds"})
    rec["launches"] = totals
    return rec


# --------------------------------------------------------------------- #
# phase 14: the last tools/ drivers and the examples
# --------------------------------------------------------------------- #

@contextlib.contextmanager
def keep_all_head_masks():
    """The 'default' CE head's keep-0.9 training dropout keeps every unit
    (its 1/0.9 scale kept), so that a trainer run twice from one start,
    with the spec's own rates at 0, computes one deterministic function;
    the CPU at one thread, whose reductions keep their order then."""
    import anncur_tpu_torch.models.crossencoder as tce

    orig, threads = tce.dropout, torch.get_num_threads()
    tce.dropout = lambda x, seed, rate: x if seed is None else x / (1.0 - rate)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        tce.dropout = orig
        torch.set_num_threads(threads)


# cut these, never the widths, if the run nears its limit
TOOLS = dict(early_stop_q=128, packing_ments=16, yugioh_grid=(100, 500), yugioh_cpu_point=(100, 100))
QUICKSTART_RECALL = 0.95  # JAX's quickstart reaches 1.000 on the CPU (tests/test_torch_examples.py)
# make_trained_ce_matrix's quick training from one start, card against CPU:
# steps, loss tolerance (on the CPU against JAX the first 15 sit within 4e-7)
TCE_SAME_START = (12, 1e-5)
RECALL_ATOL = 0.005  # PARITY.md: one reordered item in 200 rankings


def phase_tools(dev, root, smi, rehearsal=False):
    """The last five drivers and the two examples, each through its
    ``main(argv)``, their answers checked: (a) ``bench_early_stop`` at
    q=128, 1 rep, no bucket sweep (each regime's budget and escalated
    share as its stability overlap forces them, the last call's top-10
    scores against the plain-attention CE); (b) ``measure_packing`` at 16 x
    2,048 pairs per regime (bucketed scores equal to padded within
    CE_ATOL); (c) ``quickstart`` on the card (recall against the exact CE
    ranking, kernels A, C, D and B launched); (d) ``yugioh_scale_eval`` on
    the full 3,374 x 10,031 matrix over a 2 x 2 grid (one point against
    the port's evaluator on the CPU, the oracle above CUR); (e)
    ``multichip_scaling`` at world size 1 over NCCL (its answers against
    the same world served in this process without a mesh); (f)
    ``adaptive_matched_recall --tiny`` and ``make_trained_ce_matrix
    --quick`` on the card (matched budgets equal to the committed JAX
    artifact's; the matrix's layout, and its training from one start on
    the card against the CPU's, TCE_SAME_START). The quickstart's stages
    4-6 run again on the CPU with the CE the card trained (the recall
    within one item of the card's). One JSON line per driver, with the
    card; launches counted around the drivers' calls only. ``rehearsal``:
    the drivers' CPU sizes."""
    import tempfile

    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.evalx.transductive import run_approx_eval_w_seed
    from anncur_tpu_torch.examples import quickstart, yugioh_scale_eval
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.parallel.dryrun import _same_topk
    from anncur_tpu_torch.tools import (
        adaptive_matched_recall,
        bench_early_stop,
        make_trained_ce_matrix,
        measure_packing,
        multichip_scaling,
    )
    from anncur_tpu_torch.train.data import EntLinkDataset

    root = os.path.join(root, "tools")
    os.makedirs(root)
    steps = StepRecorder(smi)
    run, line, totals, rec = steps.run, steps.line, steps.totals, steps.rec

    def launched(counts, names, what):
        if not rehearsal and any(counts[n] == 0 for n in names):
            fail(f"{what} did not launch {names}: {counts}")

    # (a) the early-stop benchmark at a cut batch
    with CallTimer(CurRetriever, "query_tokens_adaptive_fused", keep=True) as calls:
        es, _, counts = run("bench_early_stop", bench_early_stop.main,
                         ["--q", "8" if rehearsal else str(TOOLS["early_stop_q"]), "--reps", "1", "--skip_buckets",
                          "--out", os.path.join(root, "early_stop.json")] + (["--cpu"] if rehearsal else []))
    _, cfg = bench_early_stop.headline_config()
    rows = es["e2e"]
    want = {"stable_all": (cfg["base_budget"], 0.0), "escalate_all": (cfg["escalate_budget"], 1.0)}
    for name, (budget, frac) in want.items():
        if (rows[name]["avg_budget"], rows[name]["frac_escalated"]) != (budget, frac):
            fail(f"bench_early_stop's {name} row spent {rows[name]['avg_budget']} at {rows[name]['frac_escalated']} "
                 f"escalated, not {budget} at {frac}")
    if not cfg["base_budget"] <= rows["natural"]["avg_budget"] <= cfg["escalate_budget"]:
        fail(f"bench_early_stop's natural row spent {rows['natural']['avg_budget']}")
    (retriever, qt), _, (scores, ids, _) = calls.calls[-1]
    es_err = scores_vs_plain(retriever, qt, ids, scores, "bench_early_stop's escalate_all call")
    del calls, retriever
    launched(counts, ("attention_fwd", "mips_topk_fused"), "bench_early_stop")
    line("bench_early_stop", config=es["config"], q=es["q"], compile_per_bucket=es["compile_per_bucket"],
         e2e={n: {k: r[k] for k in ("qps", "med_s", "first_call_s", "avg_budget", "frac_escalated")}
              for n, r in rows.items()}, scores_vs_plain=es_err, launches=counts)

    # (b) entity-length bucketing of the build
    pack, _, counts = run("measure_packing", measure_packing.main,
                       (["--quick"] if rehearsal else ["--n_ments", str(TOOLS["packing_ments"])])
                       + ["--out", os.path.join(root, "packing.json")])
    for regime, r in pack["regimes"].items():
        if not r["max_abs_err"] <= CE_ATOL or sum(r["bucket_sizes"].values()) != pack["shape"]["n_ents"]:
            fail(f"measure_packing's {regime} regime: bucketed scores differ from padded by {r['max_abs_err']} "
                 f"(tol {CE_ATOL}) or its buckets hold {r['bucket_sizes']}")
    ratios = [pack["regimes"][r]["padding_ratio"] for r in measure_packing.REGIMES]
    if not ratios[0] == 0.0 < ratios[1] < ratios[2]:
        fail(f"measure_packing's padding ratios {ratios} are not the regimes'")
    launched(counts, ("attention_fwd",), "measure_packing")
    line("measure_packing", shape=pack["shape"], dtype=pack["dtype"], regimes=pack["regimes"], launches=counts)

    # (c) the quickstart on the card
    with CallTimer(quickstart, "train_cross_encoder", keep=True) as trained, \
            CallTimer(quickstart, "index_and_query", keep=True) as indexed:
        qs, _, counts = run("quickstart", quickstart.main, ["--device", "cpu" if rehearsal else str(dev)])
    if not qs["recall"] >= QUICKSTART_RECALL or len(qs["text_query"]) != 3:
        fail(f"the quickstart's recall {qs['recall']} is below {QUICKSTART_RECALL} or its text query gave "
             f"{qs['text_query']}")
    launched(counts, ("attention_fwd", "attention_bwd_dkv", "attention_bwd_dq", "mips_topk_fused"), "the quickstart")
    # stages 4-6 again on the CPU with the CE the card trained: a recall
    # that follows the weights is the training's, not the scoring's
    ce = trained.calls[-1][2][0]
    (_, tokenizer, ment_toks, ent_toks, _), _, (_, idx, exact_top, _) = indexed.calls[-1]
    del trained, indexed
    cpu_ce = CrossEncoder(ce.spec, compute_dtype=torch.float32, device="cpu").load_params_(ce.params_tree())
    _, cpu_idx, cpu_top, cpu_recall = quickstart.index_and_query(cpu_ce, tokenizer, ment_toks, ent_toks, "cpu")
    if not abs(cpu_recall - qs["recall"]) <= 1 / idx.size:
        fail(f"the card's quickstart CE gives recall {qs['recall']} on the card but {cpu_recall} on the CPU")
    line("quickstart", recall=qs["recall"], cpu_recall_with_card_weights=cpu_recall,
         same_exact_top5_on_cpu=bool(np.array_equal(exact_top, cpu_top)),
         same_retrieved_on_cpu=bool(np.array_equal(idx, cpu_idx)), departs_from_reference=qs["departs_from_reference"],
         bienc_steps=qs["bienc_steps"], ce_steps=qs["ce_steps"], cost_per_query=qs["cost_per_query"],
         text_query=qs["text_query"], launches=counts)

    # (d) BASELINE config #1's matrix over a 2 x 2 grid
    grid = [20, 40] if rehearsal else list(TOOLS["yugioh_grid"])
    point = (20, 20) if rehearsal else TOOLS["yugioh_cpu_point"]
    yg_dir = os.path.join(root, "yugioh")
    if rehearsal:
        sizes = (yugioh_scale_eval.N_MENTS, yugioh_scale_eval.N_ENTS, yugioh_scale_eval.RANK)
        yugioh_scale_eval.N_MENTS, yugioh_scale_eval.N_ENTS, yugioh_scale_eval.RANK = 200, 600, 10
    try:
        yg, _, counts = run("yugioh_scale_eval", yugioh_scale_eval.main,
                         [yg_dir, "--device", "cpu" if rehearsal else str(dev), "--grid", *map(str, grid),
                          "--oracle_point", *map(str, grid[-1:] * 2)])
        mat = yugioh_scale_eval.make_matrix(yugioh_scale_eval.N_MENTS, yugioh_scale_eval.N_ENTS, yugioh_scale_eval.RANK)
    finally:
        if rehearsal:
            yugioh_scale_eval.N_MENTS, yugioh_scale_eval.N_ENTS, yugioh_scale_eval.RANK = sizes
    with open(os.path.join(yg_dir, "retrieval_wrt_exact_crossenc.json")) as fin:
        cell = json.load(fin)["cur"]["top_k=10"]["k_retvr=500"][f"anc_n_m={point[0]}~anc_n_e={point[1]}"]
    cpu = run_approx_eval_w_seed("cur", mat, *point, 10, 500, seed=0, device="cpu")
    del mat
    yg_err = max(abs(cell[split][yugioh_scale_eval.RECALL] - cpu[split][yugioh_scale_eval.RECALL])
                 for split in ("anchor", "non_anchor", "all"))
    op = yg["oracle_point"]
    if yg["n_points"] != len(grid) ** 2 or not yg_err <= RECALL_ATOL or not (
            op["cur_oracle_recall"] >= op["cur_recall"] - RECALL_ATOL):
        fail(f"yugioh_scale_eval: {yg['n_points']} points, the card vs the CPU at {point} {yg_err} (tol {RECALL_ATOL}), "
             f"oracle {op['cur_oracle_recall']} vs cur {op['cur_recall']}")
    line("yugioh_scale_eval", shape=yg["shape"], grid=grid, sweep_s=yg["sweep_s"], s_per_point=yg["s_per_point"],
         points=yg["points"], oracle_point=op, cpu_point=list(point), recall_vs_cpu=yg_err, heat_map=yg["heat_map"],
         launches=counts)

    # (e) query-sharded serving at world size 1, against this process unsharded
    mc, _, _ = run("multichip_scaling", multichip_scaling.main,
                (["--quick", "--device", "cpu"] if rehearsal else ["--device", "cuda"])
                + ["--nproc", "1", "--timeout", "600", "--out", os.path.join(root, "multichip.json")])
    world = multichip_scaling.build_world(rehearsal, "cpu" if rehearsal else dev)
    reset_counts()
    alone = {**multichip_scaling.fixed(*world), **multichip_scaling.adaptive(*world)}
    counts = read_counts()
    del world
    got = mc["answers"]["1"]
    mc_err = max(_same_topk(got[f"{p}_scores"], got[f"{p}_ids"], alone[f"{p}_scores"], alone[f"{p}_ids"],
                            f"multichip_scaling's {p} answers") for p in ("fixed", "adaptive"))
    launched(counts, ("attention_fwd", "mips_topk_fused"), "the unsharded multichip_scaling world")
    line("multichip_scaling", host=mc["host"], rows=mc["rows"], answers_vs_unsharded=mc_err, launches_unsharded=counts)

    # (f) the two tools sized for the CPU, on the card at their tiny sizes
    tool_dev = "cpu" if rehearsal else str(dev)
    amr, _, _ = run("adaptive_matched_recall", adaptive_matched_recall.main,
                    ["--tiny", "--device", tool_dev, "--out", os.path.join(root, "amr.json")])
    with open(os.path.join(ROOT, "benchmarks", "adaptive_matched_recall_quick.json")) as fin:
        jax_amr = json.load(fin)
    budgets = {f"{n}/{v}": (r["matched_budget"], jax_amr["scenarios"][n][v]["matched_budget"])
               for n, scen in amr["scenarios"].items() for v, r in scen.items() if v != "early_stop"
               and isinstance(r, dict) and "matched_budget" in r}
    if any(a != b for a, b in budgets.values()) or amr["headline_matched_budget"] != jax_amr["headline_matched_budget"]:
        fail(f"adaptive_matched_recall's matched budgets differ from the committed JAX sweep's: {budgets}")
    line("adaptive_matched_recall", device=amr["device"], headline_matched_budget=amr["headline_matched_budget"],
         headline_early_stop=amr["headline_early_stop"], matched_budgets_vs_jax=budgets)

    tce_path = os.path.join(root, "tce_quick.npz")
    meta, _, counts = run("make_trained_ce_matrix", make_trained_ce_matrix.main,
                          ["--quick", "--device", tool_dev, "--out", tce_path])
    if not (np.isfinite(meta["final_loss"]) and meta["train_steps"] == 30
            and np.load(tce_path)["scores"].shape == (76, 400)):
        fail(f"make_trained_ce_matrix --quick: {meta}")
    launched(counts, ("attention_fwd",), "make_trained_ce_matrix")
    # its training from one start on the card and on the CPU, before the
    # two f32 trajectories part (tests/test_torch_tools.py holds it to JAX's)
    ment, ent, gt, tok, hard_negs = make_trained_ce_matrix.make_shared_world(np.random.default_rng(0), 400, 276,
                                                                             n_rare=120)
    train_slice = slice(76, 276)
    data = EntLinkDataset(ment[train_slice], ent, gt[train_slice])
    spec = make_trained_ce_matrix.ce_spec(tok.vocab_size, True, hidden_dropout=0.0, attention_dropout=0.0)
    losses = {}
    with keep_all_head_masks(), tempfile.TemporaryDirectory() as tmp:
        for d in (tool_dev, "cpu"):
            cfg = Config(**make_trained_ce_matrix.train_kwargs(True), base_res_dir=tmp)
            negs = make_trained_ce_matrix.train_negatives(data, gt, train_slice, hard_negs, cfg.num_negs, d)
            ce = CrossEncoder(spec, compute_dtype=torch.float32, device=d)
            _, losses[d] = make_trained_ce_matrix.train_ce(ce, cfg, data, negs, TCE_SAME_START[0])
    tce_err = max(abs(a - b) for a, b in zip(losses[tool_dev], losses["cpu"]))
    if not tce_err <= TCE_SAME_START[1]:
        fail(f"make_trained_ce_matrix's training from one start: card {losses[tool_dev]} vs CPU {losses['cpu']}")
    line("make_trained_ce_matrix", **{k: meta[k] for k in ("device", "world", "train_steps", "final_loss", "s2_over_s1",
                                                         "rank_97pct_energy", "gold_in_top64_frac")},
         same_start_steps=TCE_SAME_START[0], same_start_loss_vs_cpu=tce_err, launches=counts)
    rec["launches"] = totals
    return rec


# --------------------------------------------------------------------- #
# phase 15: the decoder cross-encoder (DeepSeek-V2-Lite)
# --------------------------------------------------------------------- #

# the index-build cell's forward: 512 pairs of 256 tokens (131,072 tokens),
# 16 heads, qk head dim 192 (v 128), 64 experts of which 6 a token, hidden
# 2,048; 26 expert layers, so 26 causal kernel A launches + the final
# layer's one, 26 of each dispatch kernel, and 82 RMSNorms (attn_norm,
# kv_norm over the latent's 512 of 576 columns, mlp_norm; the final norm)
# a forward
DSV2_PAIRS, DSV2_SEQ, DSV2_HEADS, DSV2_HIDDEN, DSV2_EXPERTS, DSV2_TOP_K = 512, 256, 16, 2048, 64, 6
DSV2_TOKENS = DSV2_PAIRS * DSV2_SEQ
DSV2_LATENT, DSV2_CKV = 512, 576
DSV2_PLAIN_PAIRS = 32  # the plain attention's f32 scores of 512 pairs would take 8.6 GB
DSV2_LAUNCHES = {"attention_fwd": 27, "moe_permute": 26, "moe_combine": 26, "rms_norm": 82}
# the published keys the f32 reference reads (models/deepseek_v2_reference.py)
DSV2_CONFIG = {
    "hidden_size": 2048, "num_hidden_layers": 27, "num_attention_heads": 16, "kv_lora_rank": 512,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "rope_scaling": {"factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                                         "original_max_position_embeddings": 4096, "beta_fast": 32, "beta_slow": 1},
    "n_routed_experts": 64, "num_experts_per_tok": 6, "first_k_dense_replace": 1, "routed_scaling_factor": 1,
}


def check_dispatch(dev, flush):
    """``moe_permute`` and ``moe_combine`` at the cell's forward (a seeded
    router over 131,072 tokens) against their plain versions bit for bit,
    ``moe_combine`` the same bits on three runs; timed beside their byte
    bounds (each row read once and written once, the int32 rows and f32
    weights once) and the plain versions. One kernels-line entry each."""
    from anncur_tpu_torch.ops import moe

    ptxas = ptxas_report("moe_dispatch")
    log(f"  dispatch kernels (ptxas registers and spill bytes): {ptxas}")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(DSV2_TOKENS, DSV2_HIDDEN, generator=gen, device=dev).to(torch.bfloat16)
    gate = torch.randn(DSV2_EXPERTS, DSV2_HIDDEN, generator=gen, device=dev) * 0.05
    ids, weights = moe.route(x, gate, DSV2_TOP_K)
    dest = moe.sort_rows(ids, DSV2_EXPERTS).dest
    shape = f"tokens={DSV2_TOKENS} k={DSV2_TOP_K} of {DSV2_EXPERTS} h={DSV2_HIDDEN} bf16"
    entries = []

    def entry(fn, plain, args, nbytes, checks):
        ms = time_ms(lambda: fn(*args), 20, flush)
        plain_ms = time_ms(lambda: plain(*args), 5, flush)
        rec = {"name": fn.__name__, "route": "cuda", "source": "anncur_tpu_torch/csrc/moe_dispatch.cu",
               "replaces": None, "replaces_plain": f"anncur_tpu_torch/ops/moe.py::{fn.__name__}_plain",
               "shape": shape, "ms": ms, "plain_ms": plain_ms, **bound(nbytes, 0, "bf16"), **checks,
               "ptxas": {k: v for k, v in ptxas.items() if fn.__name__ in k}}
        rec["x_bound"] = ms / rec["bound_ms"]
        log(f"  {fn.__name__} {shape}: {ms:.4f} ms; bound {rec['bound_ms']:.4f} ms, {100 / rec['x_bound']:.1f}% of "
            f"it; plain {plain_ms:.4f} ms; {checks}")
        entries.append(rec)

    xs = moe.moe_permute(x, dest)
    if not torch.equal(xs, moe.moe_permute_plain(x, dest)):
        fail("moe_permute differs from its plain version")
    row = DSV2_HIDDEN * 2
    entry(moe.moe_permute, moe.moe_permute_plain, (x, dest),
          DSV2_TOKENS * row * (1 + DSV2_TOP_K) + 4 * DSV2_TOKENS * DSV2_TOP_K, {"bit_equal": True})
    del xs
    y = torch.randn(dest.numel(), DSV2_HIDDEN, generator=gen, device=dev).to(torch.bfloat16)
    shared, resid = (torch.randn(DSV2_TOKENS, DSV2_HIDDEN, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2))
    args = (y, dest, weights, shared, resid)
    runs = [moe.moe_combine(*args) for _ in range(3)]
    if not all(torch.equal(r, runs[0]) for r in runs):
        fail("moe_combine gives other bits on another run")
    if not torch.equal(runs[0], moe.moe_combine_plain(*args)):
        fail("moe_combine differs from its plain version")
    del runs
    torch.cuda.empty_cache()
    entry(moe.moe_combine, moe.moe_combine_plain, args,
          DSV2_TOKENS * row * (DSV2_TOP_K + 3) + 8 * DSV2_TOKENS * DSV2_TOP_K,
          {"bit_equal": True, "same_bits_every_run": True})
    del x, y, shared, resid, args
    torch.cuda.empty_cache()
    return entries


def check_causal(dev, flush):
    """Kernel A's causal body at the cell's full layers (b=512 g=s=256
    nh=16, q and k 192 wide, v 128 zero-padded to 192, 255 valid keys a
    pair) and the final layer's g=1 launch at the last valid position,
    against the plain attention (32 pairs) within ``ATTN_ATOL``; timed
    beside the byte bound, the plain attention and SDPA with an explicit
    causal and padding mask. The causal body's HMMA count, registers and
    spills. Kernel A's entry in the kernels line takes the record."""
    from anncur_tpu_torch.models.deepseek_v2 import DeepseekV2Spec
    from anncur_tpu_torch.ops.attention import attention, attention_plain

    found = {name: rec for name, rec in ptxas_report("attention").items() if "causal" in name}
    sass, fn = _sass("attention"), None
    for line in (sass or "").splitlines():
        if "Function :" in line:
            fn = next((name for name in found if name in line), None)
        elif fn and "HMMA" in line:
            found[fn]["hmma"] = found[fn].get("hmma", 0) + 1
    log(f"  causal kernel A (HMMA in SASS, ptxas registers and spill bytes): {found}")
    if len(found) != 1 or any(rec.get("spill_stores", 1) or rec.get("spill_loads", 1) for rec in found.values()) \
            or (sass is not None and not all(rec.get("hmma") for rec in found.values())):
        fail(f"kernel A's causal body is not one instantiation on the tensor cores with no spill: {found}")
    gen = torch.Generator(device=dev).manual_seed(2)
    scale = DeepseekV2Spec().softmax_scale
    b, s, nh = DSV2_PAIRS, DSV2_SEQ, DSV2_HEADS
    q, k = (torch.randn(b, s, nh, 192, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    v = torch.randn(b, s, nh, 128, generator=gen, device=dev).to(torch.bfloat16)
    valid = torch.ones(b, s, dtype=torch.bool, device=dev)
    valid[:, s - 1] = False
    sub = slice(0, DSV2_PLAIN_PAIRS)
    out = attention(q, k, v, valid, causal=True, scale=scale)
    want = attention_plain(q[sub], k[sub], v[sub], valid[sub], causal=True, scale=scale)
    err = float((out[sub].float() - want.float()).abs().max())
    last = torch.full((b,), s - 2, device=dev)
    q1 = q[torch.arange(b, device=dev), last][:, None].contiguous()
    err1 = float((attention(q1, k, v, valid, scale=scale).float()
                  - attention_plain(q1, k, v, valid, scale=scale).float()).abs().max())
    if not (err <= ATTN_ATOL and err1 <= ATTN_ATOL):
        fail(f"kernel A causal at hd 192 vs plain: {err} (g=s), {err1} (g=1)")
    del out, want
    n_valid = int(valid.sum())
    row = nh * 192 * 2
    # q and out whole, k and v at the valid keys (v at the padded 192, as
    # the kernel reads it); QKᵀ and PV over the visible pairs
    nbytes = 2 * b * s * row + 2 * n_valid * row + b * s
    ops = 4 * nh * 192 * b * (s - 1) * s / 2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(s, device=dev)
    allowed = (pos[None, :] <= pos[:, None])[None, None] & valid[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec = {"shape": f"b={b} g=s={s} nh={nh} hd=192 (v 128) bf16", "err": err,
           "ms": time_ms(lambda: attention(q, k, v, valid, causal=True, scale=scale), 10, flush),
           **bound(nbytes, ops, "bf16"),
           "plain_ms_scaled": time_ms(lambda: attention_plain(q[sub], k[sub], v[sub], valid[sub], causal=True,
                                                               scale=scale), 3, flush) * b / DSV2_PLAIN_PAIRS,
           "sdpa_explicit_mask_ms": time_ms(lambda: sdpa(qt, kt, vt, attn_mask=allowed, scale=scale), 10, flush)}
    rec1 = {"shape": f"b={b} g=1 s={s} nh={nh} hd=192 (v 128) bf16", "err": err1,
            "ms": time_ms(lambda: attention(q1, k, v, valid, scale=scale), 20, flush),
            **bound(2 * b * row + 2 * n_valid * row + b * s, 4 * nh * 192 * n_valid, "bf16"),
            "sdpa_explicit_mask_ms": time_ms(lambda: sdpa(q1.transpose(1, 2), kt, vt,
                                                          attn_mask=valid[:, None, None, :], scale=scale), 20, flush)}
    for r in (rec, rec1):
        log(f"  kernel A causal {r['shape']}: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"SDPA {r['sdpa_explicit_mask_ms']:.4f} ms; error vs plain {r['err']:.4f}")
    del q, k, v, qt, kt, vt, q1, allowed
    torch.cuda.empty_cache()
    return {"full_layer": rec, "final_layer": rec1, "ptxas": found}


def check_rms_norm(dev, flush):
    """The RMSNorm kernel at the cell's forward: 131,072 rows of 2,048
    (attn_norm and mlp_norm) and of 512 read in place out of 576-wide rows
    (kv_norm), weights around 1, against the plain composition (each
    element bit-equal or within one bf16 ulp); timed beside the byte bound
    (each row read once and written once, the weight once) and the plain
    composition, and beside ``torch.nn.functional.rms_norm`` (one fused
    library call that does not round before the weight multiply; it copies
    the strided view). One kernels-line entry, the strided shape under
    ``kv_norm``."""
    from anncur_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain, within_one_ulp

    ptxas = {k: v for k, v in ptxas_report("rms_norm").items() if "rms_norm_kernel" in k}
    log(f"  RMSNorm kernel (ptxas registers and spill bytes): {ptxas}")
    if not ptxas or any(rec.get("spill_stores", 1) or rec.get("spill_loads", 1) for rec in ptxas.values()):
        fail(f"the RMSNorm kernel is missing or spills registers (ptxas): {ptxas}")
    gen = torch.Generator(device=dev).manual_seed(3)
    eps = 1e-6
    recs = []
    for width, row in ((DSV2_HIDDEN, DSV2_HIDDEN), (DSV2_LATENT, DSV2_CKV)):
        x = torch.randn(DSV2_TOKENS, row, generator=gen, device=dev).to(torch.bfloat16)[:, :width]
        w = (1.0 + 0.3 * torch.randn(width, generator=gen, device=dev)).to(torch.bfloat16)
        within, same = within_one_ulp(rms_norm(x, w, eps), x, w, eps)
        if not within:
            fail(f"rms_norm at {DSV2_TOKENS} x {width} (rows {row} wide) is beyond one bf16 ulp of the plain "
                 f"composition: {same:.4%} the same bits")
        torch.cuda.empty_cache()
        ms = time_ms(lambda: rms_norm(x, w, eps), 20, flush)
        plain_ms = time_ms(lambda: rms_norm_plain(x, w, eps), 10, flush)
        library_ms = time_ms(lambda: torch.nn.functional.rms_norm(x, (width,), w, eps), 20, flush)
        rows = f" of {row}-wide rows" if row != width else ""
        rec = {"shape": f"rows={DSV2_TOKENS} width={width}{rows} bf16",
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               **bound(2 * x.numel() * 2 + width * 2, 0, "bf16"), "within_one_ulp": within, "bit_equal_share": same}
        rec["x_bound"] = ms / rec["bound_ms"]
        log(f"  rms_norm {rec['shape']}: {ms:.4f} ms; bound {rec['bound_ms']:.4f} ms, {100 / rec['x_bound']:.1f}% "
            f"of it; plain {plain_ms:.4f} ms ({plain_ms / ms:.2f}x); F.rms_norm {library_ms:.4f} ms "
            f"({ms / library_ms:.2f}x library); {same:.4%} the same bits")
        recs.append(rec)
        del x, w
        torch.cuda.empty_cache()
    return {"name": "rms_norm", "route": "cuda", "source": "anncur_tpu_torch/csrc/rms_norm.cu", "replaces": None,
            "replaces_plain": "anncur_tpu_torch/ops/rms_norm.py::rms_norm_plain", **recs[0], "kv_norm": recs[1],
            "ptxas": ptxas}


def routing_flips(ce, ids):
    """(tokens whose set of experts differs between the bf16 forward and the
    f32 reference, per expert layer, at the valid positions (the final
    layer: the last one a pair); the reference's scores)."""
    from anncur_tpu_torch.models import deepseek_v2 as dsv2
    from anncur_tpu_torch.models import deepseek_v2_reference as ref

    got, want = [], []
    route, moe = dsv2.route, ref.moe
    top_k = DSV2_CONFIG["num_experts_per_tok"]

    def recording_route(x, gate, k, scale=1.0):
        out = route(x, gate, k, scale)
        got.append(out[0])
        return out

    def recording_moe(x, lw, cfg):
        probs = torch.softmax(x @ lw["router"].T, dim=-1)
        want.append(torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k])
        return moe(x, lw, cfg)

    dsv2.route, ref.moe = recording_route, recording_moe
    try:
        ce.score(ids, DSV2_SEQ // 2)
        w = ce.weights
        scores = ref.forward_scores(DSV2_CONFIG, ids, w["embed"].float(),
                                    lambda i: {k: v.float() for k, v in w["layers"][i].items()},
                                    w["final_norm"].float(), w["score"].float())
    finally:
        dsv2.route, ref.moe = route, moe
    b, s = ids.shape
    valid = (ids != 0).reshape(-1)
    last = (torch.arange(s, device=ids.device) * (ids != 0)).argmax(-1)
    flips = []
    for li, (g, r) in enumerate(zip(got, want)):
        if li == len(got) - 1:
            r = r.view(b, s, -1)[torch.arange(b, device=ids.device), last]
        else:
            g, r = g[valid], r[valid]
        flips.append(int((g.sort(-1).values != r.sort(-1).values).any(-1).sum()))
    return flips, scores


def phase_decoder(dev, flush):
    """Phase 15: the dispatch kernels, causal kernel A and the RMSNorm
    kernel at the cell's shapes, then DeepSeek-V2-Lite as the CE (weights
    drawn on the card at ``INIT_STD``, seed 5) on 512 pairs of 8 mentions x
    64 entities of 128 + 128 tokens (a BOS, random words, an entity's EOS):
    one counted forward, whose launches must be ``DSV2_LAUNCHES``, then
    three timed; peak memory; the scores' spread over pairs; the gap to the
    f32 reference at 32 pairs and the tokens each expert layer routes apart
    from it."""
    from anncur_tpu_torch.indexer.score_matrix import build_pairs
    from anncur_tpu_torch.models.deepseek_v2 import DeepseekV2CrossEncoder, DeepseekV2Spec

    dispatch = check_dispatch(dev, flush)
    causal = check_causal(dev, flush)
    norm = check_rms_norm(dev, flush)
    t0 = time.perf_counter()
    ce = DeepseekV2CrossEncoder(DeepseekV2Spec(), dev, seed=5)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(6)
    half = DSV2_SEQ // 2
    ments = torch.randint(1, 100000, (8, half), generator=gen, device=dev, dtype=torch.int32)
    ents = torch.randint(1, 100000, (DSV2_PAIRS // 8, half), generator=gen, device=dev, dtype=torch.int32)
    ments[:, 0] = ents[:, 0] = 100000
    ents[:, -1] = 100001
    pairs = build_pairs(ments, ents, DSV2_SEQ)
    ce.score(pairs, half)  # warm: the kernels' first launches, the rope tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    ce.score(pairs, half)
    torch.cuda.synchronize()
    counts = read_counts()
    wrong = {name: counts[name] for name, n in DSV2_LAUNCHES.items() if counts[name] != n}
    if wrong or any(n for name, n in counts.items() if name not in DSV2_LAUNCHES):
        fail(f"a DeepSeek-V2-Lite forward launched {counts}, want {DSV2_LAUNCHES} and nothing else")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        scores = ce.score(pairs, half)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    flips, want = routing_flips(ce, pairs[:DSV2_PLAIN_PAIRS])
    w = ce.weights
    rec = {"init_s": init_s, "forward_s": statistics.median(times),
           "pairs_per_s": DSV2_PAIRS / statistics.median(times), "peak_gb": peak / 1e9,
           "weights_gb": sum(t.numel() * t.element_size() for t in [w["embed"], w["final_norm"], w["score"]]
                             + [t for lw in w["layers"] for t in lw.values()]) / 1e9,
           "score_std_over_pairs": float(scores.std()),
           "gap_vs_f32_reference": float((scores[:DSV2_PLAIN_PAIRS] - want).abs().max()),
           "tokens_routed_apart_per_expert_layer": flips, "launches_one_forward": counts}
    log(json.dumps({"decoder_forward": f"DeepSeek-V2-Lite bf16, {DSV2_PAIRS} pairs x {DSV2_SEQ} tokens", **rec}))
    del ce, w, scores, pairs
    torch.cuda.empty_cache()
    return {**rec, "dispatch": dispatch, "causal": causal, "rms_norm": norm, "launches": counts}


def run_phase_decoder(dev, t_start):
    """Phase 15 with its own flush buffer, timed; adds ``summary`` (the
    forward's numbers) and ``kernels`` (the phase's kernels-line entries:
    the dispatch kernels, the RMSNorm kernel, and kernel A's causal record
    with this phase's launches of it)."""
    log(f"[{time.perf_counter() - t_start:.0f} s] phase 15: the decoder CE (DeepSeek-V2-Lite, bf16, random weights "
        f"from seed 5; {DSV2_PAIRS} pairs of {DSV2_SEQ} tokens a forward)")
    t0 = time.perf_counter()
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    rec = phase_decoder(dev, flush)
    del flush
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    rec["summary"] = {k: v for k, v in rec.items() if k not in ("dispatch", "causal", "rms_norm", "launches")}
    for kern in (*rec["dispatch"], rec["rms_norm"]):
        kern["launches"] = rec["launches"][kern["name"]]
    rec["kernels"] = [{"name": "attention_fwd (causal, hd 192)", **rec["causal"],
                       "launches": rec["launches"]["attention_fwd"]}, *rec["dispatch"], rec["rms_norm"]]
    return rec



def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Smoke run of the port on one GPU (the module's docstring).")
    p.add_argument("--decoder-only", action="store_true",
                   help="phase 1, phase 15 (the decoder CE) and its kernels line alone")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, ROOT)
    import tempfile

    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    build_s = cuda_build.build()
    log(f"kernels built from {os.path.relpath(cuda_build.CSRC_DIR, ROOT)} in {build_s:.1f} s")
    if args.decoder_only:
        decoder = run_phase_decoder(dev, t_start)
        log(json.dumps({"summary": {"decoder": decoder["summary"], "card": smi,
                                    "seconds": time.perf_counter() - t_start}}))
        log(json.dumps({"kernels": decoder["kernels"]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 2: kernels vs plain versions")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    fwd = check_attention(dev, flush)
    lse_err, bwd = check_attention_bwd(dev, flush)
    fwd["lse_rel_err"] = lse_err
    wide, wide_past = check_attention_wide(dev, flush)
    for kern, key, err in ((fwd, "A", "fwd_err"), (bwd[0], "C", "dk"), (bwd[1], "D", "dq")):
        kern["wide_head_dims"] = [
            {"hd": r["hd"], "dtype": r["dtype"], "err": r[err] if err == "fwd_err" else r["grad_rel_err"][err],
             **({"lse_rel_err": r["lse_rel_err"]} if key == "A" else {}), **r[key]} for r in wide]
        kern["wide_past_staging_limit"] = [
            {"shape": r["shape"], "body": r[f"{key}_body"],
             **({"fwd_err": r["fwd_err"], "lse_rel_err": r["lse_rel_err"]} if key == "A" else {"grad_rel_err": r["grad_rel_err"]})}
            for r in wide_past]
    mips_f32, mips_int8 = check_mips_kernel(dev, flush)
    epilogue = check_encoder_epilogue(dev, flush)
    del flush
    torch.cuda.empty_cache()

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 3: build (bert-base CE, bf16, random weights from seed 0)")
    spec = BertSpec()
    t0 = time.perf_counter()
    ce = CrossEncoder(spec, cross_enc_type="default", compute_dtype=torch.bfloat16, device=dev, seed=0)
    log(f"  CE initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    build = phase_build(ce, spec, dev, rng)
    build_state = {k: build.pop(k) for k in ("ment", "ent", "scores")}

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 4: serve (10,000 items, 500 anchors, top-100 rerank, top-10)")
    serve = phase_serve(ce, spec, dev, rng)
    retriever, train_mat = serve.pop("retriever"), serve.pop("train")
    serve_answer = serve.pop("answer")

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 5: train (bert-base CE, bf16, 4 x 64 pairs of 255 tokens per step)")
    del ce  # phase 6 serves through phase 4's retriever, which keeps its CE
    torch.cuda.empty_cache()
    train = phase_train(dev, rng)
    train_start = train.pop("start")

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 6: adaptive serve ({ADAPTIVE_QUERIES} queries, budget 210 over 8 rounds, top-10; early stop)")
    adaptive = phase_adaptive(retriever, train_mat, spec, dev, rng)
    qtoks, train_dev = adaptive.pop("qtoks"), adaptive.pop("train_dev")
    adaptive_answer = adaptive.pop("answer")

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 7: retrieve and rerank (bert-base bi-encoder, seed 1, bf16; {RERANK_MENTIONS} mentions, top 64, CE rerank)")
    rerank = phase_retrieve_rerank(retriever, spec, dev, rng)
    embeds = rerank.pop("embeds")

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 8: AXN serve ({ADAPTIVE_QUERIES} queries, 210 over 8, full rank; early stop), oracle recall, host ADACUR")
    axn = phase_axn(retriever, qtoks, train_dev, dev)
    del train_dev
    torch.cuda.empty_cache()

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 9: bi-encoder training (bert-base towers, bf16, 16 mentions in 4 micro-batches; in-batch, 63 hard negatives, top-64 distillation)")
    bienc = phase_bienc_train(dev, rng)

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 10: the paper's evals (transductive and inductive CUR on the trained-CE matrices; entity-to-anchor scores)")
    evals = phase_evals(retriever, bienc.pop("bienc"), spec, dev, rng)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        log(f"[{time.perf_counter() - t_start:.0f} s] phase 11: the CLIs over ZeShEL-format files (bert-base, bf16; "
            f"{CLI['n_ents']} entities, {CLI['n_ments']} mentions)")
        t0 = time.perf_counter()
        cli = phase_cli(dev, np.random.default_rng(11), root, evals["matrices"][TRAINED_CE[0]]["cur_r@10_kr500_ne500"])
        cli["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.0f} s] phase 12: the analysis CLIs and the serving drivers (bert-base, "
            "bf16; phase 11's world; ZeShEL-military's 104,520 items)")
        t0 = time.perf_counter()
        drivers = phase_drivers(dev, root, cli.pop("shared"), evals["matrices"][TRAINED_CE[0]], smi)
        drivers["phase_s"] = time.perf_counter() - t0

    log(f"[{time.perf_counter() - t_start:.0f} s] phase 13: the parallel layer at world size 1 (NCCL; DP and TP "
        "training, sharded and multi-process builds, sharded MIPS, query-sharded serving, the dry run)")
    t0 = time.perf_counter()
    parallel = phase_parallel(
        dev, smi, dict(build_state, pairs_per_s=build["pairs_per_s"]), dict(serve, answer=serve_answer),
        {"start": train_start}, dict(adaptive, qtoks=qtoks, answer=adaptive_answer), embeds, retriever, train_mat,
    )
    parallel["phase_s"] = time.perf_counter() - t0
    del retriever, train_start, embeds
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        log(f"[{time.perf_counter() - t_start:.0f} s] phase 14: the last tools/ drivers and the examples (early stop "
            "at q=128, packing, quickstart, yugioh-scale eval, multichip at world size 1, the CPU-sized tools on the card)")
        t0 = time.perf_counter()
        tools = phase_tools(dev, root, smi)
        tools["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    decoder = run_phase_decoder(dev, t_start)
    fwd["causal_hd192"] = decoder["causal"]
    phases = (build, serve, train, adaptive, rerank, axn, bienc, evals, cli, drivers, parallel, tools, decoder)
    mips_f32["max_abs_err"] = max(mips_f32["max_abs_err"], serve["mips_err"], adaptive["mips_err"], rerank["mips_err"],
                                  axn["mips_err"], cli["tfidf"]["mips_err"], drivers["mips_err"])
    mips_f32["shapes"] += [cli["tfidf"]["kernel"], drivers["military_mips"]]
    mips_int8["max_abs_err"] = max(mips_int8["max_abs_err"], rerank["int8_err"])
    kernels = [fwd, *bwd, *mips_route_entries(mips_f32), mips_int8, *epilogue, *decoder["dispatch"],
               decoder["rms_norm"]]
    for kern in kernels:
        kern["launches"] = sum(ph["launches"][kern["name"]] for ph in phases)
    if any(kern["launches"] == 0 for kern in kernels):
        fail("a kernel of the main path was never launched")
    attn = next(kern for kern in kernels if kern["name"] == "attention_fwd")
    attn["tower_embed_rel_err"] = rerank["embed_err"]
    summary = {
        "build_pairs_per_s": build["pairs_per_s"],
        "query_qps_cost600": serve["qps"],
        "query_ce_pairs_per_s": serve["ce_pairs_per_s"],
        "train_pairs_per_s": train["pairs_per_s"],
        "train_step_s": train["step_s"],
        "train_losses": train["losses"],
        "train_loss_vs_plain": train["loss_vs_plain"],
        "train_grad_norm_vs_plain": train["grad_norm_vs_plain"],
        "launches_build": build["launches"],
        "launches_query_batch": serve["launches"],
        "launches_train": train["launches"],
        "adaptive_qps_b210r8": adaptive["qps"],
        "adaptive_ce_pairs_per_s": adaptive["ce_pairs_per_s"],
        "adaptive_call_s": adaptive["seconds"],
        "early_stop_worst_qps": adaptive["early_stop_qps"],
        "early_stop_call_s": adaptive["early_stop_seconds"],
        "early_stop_avg_budget": adaptive["early_stop_avg_budget"],
        "adaptive_scores_vs_plain_attention": adaptive["ce_err"],
        "oracle_recall": adaptive["recall"],
        "launches_adaptive_3_calls": adaptive["launches_base_calls"],
        "launches_early_stop_3_calls": adaptive["launches_early_stop_calls"],
        "rerank_mentions_per_s": rerank["mentions_per_s"],
        "rerank_call_s": rerank["seconds"],
        "rerank_stage_s": rerank["stage_seconds"],
        "embed_seqs_per_s": rerank["embed_seqs_per_s"],
        "search_ms": rerank["search_ms"],
        "rerank_ce_pairs_per_s": rerank["rerank_pairs_per_s"],
        "rerank_int8_overlap": rerank["int8_overlap"],
        "rerank_metrics": rerank["metrics"],
        "launches_retrieve_rerank": rerank["launches"],
        "axn_qps_b210r8": axn["qps"],
        "axn_call_s": axn["seconds"],
        "axn_early_stop_worst_qps": axn["early_stop_qps"],
        "axn_early_stop_call_s": axn["early_stop_seconds"],
        "axn_oracle_recall": axn["recall"],
        "host_adacur_qps_b100r3": axn["host_qps"],
        "launches_axn_3_calls": axn["launches_base_calls"],
        "launches_axn_early_stop_call": axn["launches_early_stop_calls"],
        "bienc_train": {k: {m: v for m, v in rec.items() if m not in ("launches",)}
                        for k, rec in bienc["strategies"].items()},
        "launches_bienc_train": {k: rec["launches"] for k, rec in bienc["strategies"].items()},
        "paper_evals": evals["matrices"],
        "e2e_pairs_per_s": evals["e2e_pairs_per_s"],
        "e2e_s": evals["e2e_s"],
        "launches_paper_evals": evals["launches"],
        "cli": {
            "phase_s": cli["phase_s"],
            "step_s": cli["seconds"],
            "tokenize": cli["tokenize"],
            "build_pairs_per_s": cli["build"]["pairs_per_s"],
            "serve_fixed_qps": cli["serve_fixed"]["qps"],
            "serve_fixed_qps_with_start": cli["serve_fixed"]["qps_with_start"],
            "serve_adaptive_qps": cli["serve_adaptive"]["qps"],
            "serve_adaptive_qps_with_start": cli["serve_adaptive"]["qps_with_start"],
            "http": cli["http"],
            "rerank_mentions_per_s": cli["retrieve_rerank"]["mentions_per_s"],
            "rerank_metrics": cli["retrieve_rerank"]["metrics"],
            "tfidf_d": cli["tfidf"]["d"],
            "tfidf_s": cli["tfidf"]["seconds"],
            "tfidf_kernel_b": cli["tfidf"]["kernel"],
            "eval_recall@10": cli["eval_recall@10"],
            "train": {k: v for k, v in cli["train"].items() if k != "launches"},
            "launches_train": cli["train"]["launches"],
        },
        "launches_cli": cli["launches"],
        "drivers": {"phase_s": drivers["phase_s"], "step_s": drivers["seconds"], "lines": drivers["lines"],
                    "military_mips_kernel_b": drivers["military_mips"]},
        "launches_drivers": drivers["launches"],
        "parallel": {"phase_s": parallel["phase_s"], "step_s": parallel["seconds"], "lines": parallel["lines"]},
        "launches_parallel": parallel["launches"],
        "tools": {"phase_s": tools["phase_s"], "step_s": tools["seconds"], "lines": tools["lines"]},
        "launches_tools": tools["launches"],
        "decoder": decoder["summary"],
        "launches_decoder": decoder["launches"],
        "card": smi,
    }
    summary["seconds"] = time.perf_counter() - t_start
    log(json.dumps({"summary": summary}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
