"""Adaptive multi-round CUR retrieval on the host (ADACUR-style).

Counterpart of ``anncur_tpu/core/adaptive.py`` (arXiv 2305.02996):
instead of spending the CE-call budget on a fixed anchor set, spend it in
rounds. Round 0 scores shared random anchors; each later round completes
every query's scores over all items through the train matrix (``vals @
pinv(M[:, scored]) @ M``, an f64 pinv on the host) or a caller's
``complete_fn``, picks its best unscored items (numpy ``argsort``, as the
JAX package picks them on the host), and scores the union of the batch's
picks once, keeping each query's own. The answer is the top-k of the
exact scores. ``core/adaptive_fused.py`` is the device engine of the same
method.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from anncur_tpu_torch.core.adaptive_fused import fixed_anchor_recall
from anncur_tpu_torch.core.metrics import topk_overlap_frac
from anncur_tpu_torch.ops.pinv import pinv_f64
from anncur_tpu_torch.utils.device import DeviceLike

LOGGER = logging.getLogger(__name__)


def cur_complete_fn(train_scores) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """The CUR completion of :func:`adaptive_cur_query`: ``(ids (k,), vals
    (q, k)) -> vals @ pinv(M[:, ids]) @ M`` (q, n_items), the pinv in f64,
    over host copies of ``train_scores`` (f32 and f64) made here, once."""
    train = np.asarray(train_scores, np.float32)
    train64 = train.astype(np.float64)

    def complete_fn(ids, vals):
        # anchored at the scored set
        latent_cols = (pinv_f64(train[:, ids]) @ train64).astype(np.float32)
        return np.asarray(vals, np.float32) @ latent_cols

    return complete_fn


def adaptive_cur_query(
    train_scores: Optional[np.ndarray],  # (n_train, n_items) exact CE scores
    score_items_fn: Callable[[np.ndarray], np.ndarray],
    # score_items_fn(item_ids (k,)) -> (q, k) exact CE scores of the query
    # batch against those items
    n_items: int,
    total_budget: int,
    n_rounds: int = 3,
    top_k: int = 10,
    seed: int = 0,
    q: Optional[int] = None,
    complete_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(topk_scores (q, top_k), topk_ids (q, top_k), scored_ids (q, budget),
    or a list of per-query arrays when queries exhaust the corpus at
    different rounds). Unfilled slots (fewer scored items than top_k) are
    id -1, score -inf.

    ``complete_fn(ids (k,), vals (q, k)) -> (q, n_items)`` replaces the CUR
    completion (``core/axn.py`` passes its ridge in the embedding space);
    ``train_scores`` may then be None."""
    rng = np.random.default_rng(seed)
    if total_budget < n_rounds:
        LOGGER.warning("total_budget=%d < n_rounds=%d: clamping to %d rounds", total_budget, n_rounds, total_budget)
        n_rounds = max(1, total_budget)
    per_round = max(1, total_budget // n_rounds)
    first_round = total_budget - per_round * (n_rounds - 1)
    total_budget = min(total_budget, n_items)
    first_round = min(first_round, n_items)
    if complete_fn is None:
        if train_scores is None:
            raise ValueError("train_scores is required without a complete_fn")
        complete_fn = cur_complete_fn(train_scores)

    # round 0: shared random anchors
    anchors0 = np.asarray(sorted(rng.choice(n_items, size=first_round, replace=False)))
    scores0 = np.asarray(score_items_fn(anchors0))  # (q, first_round)
    n_q = scores0.shape[0]
    if q is not None and q != n_q:
        raise ValueError(f"score_items_fn returned {n_q} rows, expected {q}")
    scored_ids = [list(anchors0) for _ in range(n_q)]
    scored_vals = [list(scores0[i]) for i in range(n_q)]

    for _ in range(n_rounds - 1):
        next_ids: list = [None] * n_q
        if all(scored_ids[i] == scored_ids[0] for i in range(1, n_q)):
            # every query shares its scored set: one completion serves all
            ids = np.asarray(scored_ids[0])
            approx = np.asarray(complete_fn(ids, np.asarray(scored_vals, np.float32)))  # (q, n_items)
            seen = set(ids.tolist())
            for i in range(n_q):
                next_ids[i] = [j for j in np.argsort(-approx[i]) if j not in seen][:per_round]
        else:
            for i in range(n_q):
                ids = np.asarray(scored_ids[i])
                approx = np.asarray(complete_fn(ids, np.asarray(scored_vals[i], np.float32)[None, :]))
                seen = set(ids.tolist())
                next_ids[i] = [j for j in np.argsort(-approx[0]) if j not in seen][:per_round]
        if not any(next_ids):
            break  # every query has scored the whole corpus
        # one batched scoring of the union; each query keeps its own picks
        # (the others' are computed and dropped, never counted in its budget)
        unique = np.unique(np.concatenate([np.asarray(p, np.int64) for p in next_ids if p]))
        uni_scores = np.asarray(score_items_fn(unique))  # (q, |unique|)
        pos = {int(j): c for c, j in enumerate(unique)}
        for i in range(n_q):
            for j in next_ids[i]:
                scored_ids[i].append(int(j))
                scored_vals[i].append(float(uni_scores[i, pos[int(j)]]))

    # exact where scored; -1 / -inf where fewer than top_k were scored (a 0
    # fill would report item 0 as a hit)
    out_scores = np.full((n_q, top_k), -np.inf, np.float32)
    out_ids = np.full((n_q, top_k), -1, np.int64)
    for i in range(n_q):
        ids = np.asarray(scored_ids[i])
        vals = np.asarray(scored_vals[i], np.float32)
        order = np.argsort(-vals)[:top_k]
        out_ids[i, : len(order)] = ids[order]
        out_scores[i, : len(order)] = vals[order]
    lens = {len(s) for s in scored_ids}
    scored_out = (
        np.asarray([np.asarray(s) for s in scored_ids]) if len(lens) == 1 else [np.asarray(s) for s in scored_ids]
    )
    return out_scores, out_ids, scored_out


def adaptive_recall_vs_fixed(
    full_scores: np.ndarray,  # (n_q, n_items) exact scores for eval
    train_scores: np.ndarray,
    total_budget: int,
    n_rounds: int,
    top_k: int,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Tuple[float, float]:
    """(recall@k of the host adaptive engine, recall@k of fixed-anchor CUR)
    at the same CE-call budget, with a precomputed query score matrix as
    the oracle. The fixed path splits the budget into budget // 2 anchors
    and the rest reranked, through ``adaptive_fused.fixed_anchor_recall`` on
    ``device``."""
    full = np.asarray(full_scores, np.float32)
    n_items = full.shape[1]
    exact_top = np.argsort(-full, axis=1)[:, :top_k]
    _, ada_ids, _ = adaptive_cur_query(
        train_scores, lambda ids: full[:, ids], n_items, total_budget, n_rounds, top_k, seed
    )
    ada_recall = float(topk_overlap_frac(torch.as_tensor(ada_ids), torch.as_tensor(exact_top)).mean())
    n_anchors = total_budget // 2
    fixed = fixed_anchor_recall(full, train_scores, n_anchors, total_budget - n_anchors, top_k, seed=seed, device=device)
    return ada_recall, fixed
