"""ZeShEL-military-scale drive of the port on one card.

Counterpart of ``tools/military_scale.py``. The reference's largest world
is military: 104,520 entities and 13,063 test mentions
(utils/zeshel_utils.py:6-42). This driver runs the port at that item
axis, stage by stage (``--stages``, default all), and writes one JSON:

1. mips          -- kernel B (``ops/mips_kernel.py::fused_mips_topk``)
                    against materialize-then-top-k (``torch.matmul`` in
                    true f32 + ``torch.topk``, a 5.5 GB score matrix) at
                    (13,063 x 104,520 x 768), k=64, inputs made on the
                    device from a seed; ids equal to the plain MIPS on a
                    128-row subsample where neighbours are separated.
2. offline_build -- the bert-base CE over the full 104,520-entity axis
                    (``ScoreMatrixBuilder``, kernel A), the mention rows
                    cut to ``--build_ments`` for wall clock, forwards of
                    about 2,048 pairs.
3. serving       -- ``CurRetriever`` over 104,520 items: fixed cost 600
                    at 32 queries and adaptive 210 over 8 rounds at 128.
                    The index is a synthetic rank-200 train matrix of 500
                    anchor queries at the full item axis (real CE train
                    rows at this scale are 52 M pairs); the CE calls at
                    query time are real.
4. serving_batch -- the adaptive engine at a production batch
                    (``--batch_q``) at each of ``--batch_budgets``.
5. adaptive_oracle -- recall@10 against budget at (128 queries, 104,520
                    items, rank 200 plus noise), no CE, beside fixed-anchor
                    at cost 600.

    python -m anncur_tpu_torch.tools.military_scale [--out results/torch/military_scale.json]
    python -m anncur_tpu_torch.tools.military_scale --quick --device cpu   # the tiny CPU run

What the JAX driver has and this one does not: it runs every stage in a
bounded subprocess with resume from its last artifact (``--fresh``,
``--refresh-pallas`` and the internal ``--*-only`` flags), because single
programs of that size wedged its remote TPU worker, and it times its
Pallas max-and-mask kernel and a chunk sweep of its streaming scan.
The port's stages run in one process in seconds; kernel B is the one
MIPS kernel (both Pallas kernels' counterpart) and chunks its queries to
its 256 MB score scratch whatever the caller asks. Its environment
variables (MS_BATCH_BUDGETS, MS_BATCH_NQ, MILITARY_BUILD_MENTS) are flags
here; its serving defaults (150 over 5 at 32 queries; budgets 200 and 300)
give way to the port's adaptive cell, 210 over 8.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device, true_f32

MILITARY_ENTS = 104_520
MILITARY_MENTS = 13_063
STAGES = ("mips", "offline_build", "serving", "serving_batch", "adaptive_oracle")
# kernel B's scores against cuBLAS's f32 product: 768-term sums in another
# order (chip_smoke.py's MIPS_RTOL), x max|score|
MIPS_RTOL = 1e-4


def mips_shape(quick):
    """(q, n, d, k) of the MIPS stage."""
    return (256, 4096, 64, 16) if quick else (MILITARY_MENTS, MILITARY_ENTS, 768, 64)


def mips_inputs(q, n, d, device, seed=0):
    """f32 normal queries (q, d) and items (n, d), made on the device from
    ``seed`` (the same tensors for a seed on one device)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(q, d, generator=gen, device=device), torch.randn(n, d, generator=gen, device=device)


def _timed(fn, device):
    """(seconds, result) of one call after a warm one, the card synchronised."""
    fn()
    _common.sync(device)
    t0 = time.perf_counter()
    out = fn()
    _common.sync(device)
    return time.perf_counter() - t0, out


def separated(scores: torch.Tensor, rtol: float = 1e-5) -> torch.Tensor:
    """Where a score stands apart from both neighbours in its row by more
    than ``rtol`` of the largest |score|: there the ids of two exact top-k
    computations must agree."""
    gap = (scores[:, :-1] - scores[:, 1:]) > rtol * float(scores.abs().max())
    sep = torch.ones_like(scores, dtype=torch.bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    return sep


def stage_mips(quick, device):
    from anncur_tpu_torch.ops.mips import mips_topk
    from anncur_tpu_torch.ops.mips_kernel import fused_mips_topk

    q, n, d, k = mips_shape(quick)
    queries, items = mips_inputs(q, n, d, device)
    kernel_s, (s_k, i_k) = _timed(lambda: fused_mips_topk(queries, items, k), device)

    def materialize():
        with true_f32():
            return torch.topk(queries @ items.T, k)

    mat_s, (s_m, _) = _timed(materialize, device)
    # exactness: scores against the materialised top-k on every row, ids
    # against the plain MIPS (ties to the lowest id) on a subsample
    sub = min(q, 128)
    s_p, i_p = mips_topk(queries[:sub], items, k)
    scale = float(s_m.abs().max())
    err = float((s_k - s_m).abs().max())
    sep = separated(s_p)
    ids_equal = bool(torch.equal(i_k[:sub][sep], i_p[sep]))
    if not (err <= MIPS_RTOL * scale and ids_equal):
        raise RuntimeError(f"kernel B disagrees with the materialised top-k: max |diff| {err}, ids equal {ids_equal}")
    return {
        "shape": {"q": q, "n": n, "d": d, "k": k},
        "kernel_b_wall_s": kernel_s,
        "materialize_wall_s": mat_s,
        "score_matrix_gb": q * n * 4 / 1e9,
        "kernel_vs_materialize_speedup": mat_s / kernel_s,
        "max_abs_err_vs_materialize": err,
        "exactness": f"top-{k} scores within {MIPS_RTOL} x max|s| of matmul + topk on every row; ids equal to the plain "
                     f"MIPS on {sub} rows at {int(sep.sum())} of {sep.numel()} places where neighbours are separated",
    }


# the serving stages' world: ZeShEL-military's item axis of 128-token
# random rows under a synthetic rank-200 train matrix of 500 anchor queries,
# 500 anchor items (real CE train rows at this scale are 52 M pairs)
MILITARY_WORLD = dict(n_items=MILITARY_ENTS, n_train=500, n_anchors=500, rank=200, seq_len=128)
QUICK_WORLD = dict(n_items=2048, n_train=40, n_anchors=20, rank=8, seq_len=16)
# the serving stages' batches (the port's cells: fixed cost 600 at 32
# queries, adaptive 210 over 8 rounds at 128, bench.py lines 2-3) and the
# build's CE pairs per forward (the build cell's 32 x 64)
SIZES = dict(fixed_q=32, ada_q=128, budget=210, rounds=8, pairs_per_forward=2048)
QUICK_SIZES = dict(fixed_q=8, ada_q=8, budget=20, rounds=3, pairs_per_forward=256)


def stage_build(encoder, ent, build_ments, pairs_per_forward):
    """The CE over every entity row of ``ent`` for ``build_ments`` random
    mention rows as long as the entity rows."""
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder

    rng = np.random.default_rng(1)
    ment = rng.integers(1, encoder.spec.vocab_size, size=(build_ments, ent.shape[1])).astype(np.int32)
    mb = min(32, build_ments)
    eb = max(1, pairs_per_forward // mb)
    builder = ScoreMatrixBuilder(encoder, ment_block=mb, ent_block=eb, device=encoder.device)
    builder(ment[:mb], ent[:eb])  # warm
    _common.sync(encoder.device)
    t0 = time.perf_counter()
    built = builder(ment, ent)
    _common.sync(encoder.device)
    dt = time.perf_counter() - t0
    if built.shape != (build_ments, ent.shape[0]) or not np.all(np.isfinite(built)):
        raise RuntimeError(f"the build returned shape {built.shape} or non-finite scores")
    return {
        "n_ments": build_ments, "n_ents": ent.shape[0], "pairs": build_ments * ent.shape[0],
        "pairs_per_forward": mb * eb, "wall_s": dt, "pairs_per_s": build_ments * ent.shape[0] / dt,
        "note": "the full military entity axis; mention rows cut for wall clock",
    }


def stage_serving(retriever, train_dev, sizes):
    rng = np.random.default_rng(2)
    vocab, lm = retriever.encoder.spec.vocab_size, retriever.max_query_len
    k_retvr = 100
    dev = retriever.device
    out = {"n_items": retriever.item_tokens.shape[0], "padded_items": retriever._padded_n_items()}
    n_q = sizes["fixed_q"]
    qtoks = rng.integers(1, vocab, size=(n_q, lm)).astype(np.int32)
    dt, _ = _timed(lambda: retriever.query_tokens_batch(qtoks, top_k=10, top_k_retvr=k_retvr), dev)
    out["fixed"] = {"n_q": n_q, "cost_per_query": retriever.cost_per_query + k_retvr, "q_per_s": n_q / dt, "wall_s": dt}
    n_q, budget, rounds = sizes["ada_q"], sizes["budget"], sizes["rounds"]
    qtoks = rng.integers(1, vocab, size=(n_q, lm)).astype(np.int32)
    kw = dict(total_budget=budget, n_rounds=rounds, top_k=10, train_scores=train_dev)
    dt, _ = _timed(lambda: retriever.query_tokens_adaptive_fused(qtoks, **kw), dev)
    out["adaptive"] = {"n_q": n_q, "budget": budget, "n_rounds": rounds, "q_per_s": n_q / dt, "wall_s": dt}
    return out


def stage_serving_batch(retriever, train_dev, n_q, budgets, rounds):
    """The adaptive engine at a production batch, one call per budget after
    the serving stage's warm calls."""
    rng = np.random.default_rng(3)
    vocab, lm = retriever.encoder.spec.vocab_size, retriever.max_query_len
    qtoks = rng.integers(1, vocab, size=(n_q, lm)).astype(np.int32)
    out = {"n_items": retriever.item_tokens.shape[0], "n_q": n_q, "n_rounds": rounds, "runs": {}}
    for budget in budgets:
        t0 = time.perf_counter()
        retriever.query_tokens_adaptive_fused(qtoks, total_budget=budget, n_rounds=rounds, top_k=10,
                                              train_scores=train_dev)
        _common.sync(retriever.device)
        dt = time.perf_counter() - t0
        out["runs"][str(budget)] = {"q_per_s": n_q / dt, "wall_s": dt}
        print(f"# serving_batch budget={budget}: {n_q / dt:.2f} q/s", flush=True)
    return out


def stage_adaptive_oracle(quick, device):
    from anncur_tpu_torch.core.adaptive_fused import adaptive_recall_oracle, fixed_anchor_recall

    if quick:
        n_q, n_train, n_items, rank = 16, 60, 2048, 30
        budgets, fixed_anc, fixed_retvr = (30, 60), 100, 20
    else:
        n_q, n_train, n_items, rank = 128, 500, MILITARY_ENTS, 200
        budgets, fixed_anc, fixed_retvr = (100, 150, 200, 300), 500, 100
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n_q + n_train, rank)).astype(np.float32)
    b = rng.standard_normal((rank, n_items)).astype(np.float32)
    m = a @ b + 0.05 * np.sqrt(rank) * rng.standard_normal((n_q + n_train, n_items)).astype(np.float32)
    full, train = m[:n_q], m[n_q:]
    t0 = time.perf_counter()
    fixed = fixed_anchor_recall(full, train, fixed_anc, fixed_retvr, 10, seed=0, device=device)
    sweep, matched = {}, None
    for bgt in budgets:
        sweep[bgt] = adaptive_recall_oracle(full, train, bgt, 5, 10, seed=0, device=device)
        if matched is None and sweep[bgt] >= fixed:
            matched = bgt
    return {"n_items": n_items, "rank": rank, "fixed_recall_cost600": fixed, "adaptive_sweep_r5": sweep,
            "matched_budget": matched, "wall_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="the tiny run (a tiny CE, 2,048 items)")
    ap.add_argument("--skip-build", action="store_true", help="skip the offline_build stage")
    ap.add_argument("--stages", nargs="+", choices=STAGES, default=list(STAGES))
    ap.add_argument("--build_ments", type=int, default=32, help="offline_build: mention rows")
    ap.add_argument("--batch_q", type=int, default=512, help="serving_batch: queries")
    ap.add_argument("--batch_budgets", type=int, nargs="+", default=[210], help="serving_batch: budgets")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sizes = QUICK_SIZES if args.quick else SIZES
    if args.quick:
        args.build_ments, args.batch_q, args.batch_budgets = 2, 16, [20]
    out_path = args.out or os.path.join(
        _common.RESULTS_DIR, "military_scale_quick.json" if args.quick else "military_scale.json")
    stages = [s for s in args.stages if not (args.skip_build and s == "offline_build")]

    out = {"device": _common.card(device),
           "reference_world": "military (zeshel_utils.py:6-42): 104,520 ents / 13,063 test mentions",
           "stages": {}}

    def record(name, res):
        out["stages"][name] = res
        print(json.dumps({name: res}), flush=True)

    if "mips" in stages:
        record("mips", stage_mips(args.quick, device))
    if any(s in stages for s in ("offline_build", "serving", "serving_batch")):
        world = QUICK_WORLD if args.quick else MILITARY_WORLD
        retriever, train, _ = _common.build_retriever(_common.make_encoder(args.quick, device), **world)
        if "offline_build" in stages:
            record("offline_build", stage_build(retriever.encoder, retriever.item_tokens, args.build_ments,
                                                sizes["pairs_per_forward"]))
        # the train matrix on the device, as a server keeps it
        train_dev = torch.as_tensor(train, device=device)
        if "serving" in stages:
            record("serving", stage_serving(retriever, train_dev, sizes))
        if "serving_batch" in stages:
            record("serving_batch", stage_serving_batch(retriever, train_dev, args.batch_q, args.batch_budgets,
                                                        sizes["rounds"]))
        del retriever, train_dev
    if "adaptive_oracle" in stages:
        record("adaptive_oracle", stage_adaptive_oracle(args.quick, device))
    _common.write_json(out_path, out)
    return out


if __name__ == "__main__":
    main()
