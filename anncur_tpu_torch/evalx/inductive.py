"""Inductive (online-query) retrieval eval with fixed train/test splits.

Counterpart of ``anncur_tpu/evalx/inductive.py``. It models the production
query path: the index is built from train-mention rows; test mentions are
unseen, each pays ``n_ent_anchors`` exact CE calls (its anchor-item
scores), is projected onto every item through the CUR latent factors on
the device, retrieves top_k_retvr and is reranked with exact scores.

Parity with eval/run_retrieval_eval_wrt_exact_crossenc_w_fixed_train_test
_splits.py:209-507: methods {cur, bienc, tfidf, fixed_anc_ent,
fixed_anc_ent_cur} and the adaptive {adaptive_cur, axn}, the same
retrieval-budget grids (fractional top_k_retvr values included), one
retrieval evaluated at every top_k (``evalx/core.py::eval_approx_grid``),
per-seed nested JSON at the same paths.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from anncur_tpu_torch.core.cur import build_cur
from anncur_tpu_torch.evalx.core import _overlap_stats, eval_approx_grid, on_device, to_host
from anncur_tpu_torch.utils.device import DeviceLike

LOGGER = logging.getLogger(__name__)

TOP_K_VALS = [1, 10, 50, 100]
TOP_K_RETVR_BASE = [1, 10, 50, 100, 200, 500, 1000]


def cur_retvr_grid(base: Sequence[int] = TOP_K_RETVR_BASE) -> list:
    """Budget grid with the 0.1..0.9 fractions for CUR methods
    (reference: :241)."""
    vals = list(base) + [int(k * frac) for k in base for frac in np.arange(0.1, 1.0, 0.1)]
    return sorted(set(v for v in vals if v >= 1))


def cur_project_test_scores(
    train_scores,  # (n_train, n_ents) exact CE scores
    test_anchor_scores,  # (n_test, n_anchors) exact CE scores
    anchor_ents: np.ndarray,  # (n_anchors,) sorted
    rcond=None,  # None | float | 'noise' (see build_cur)
    device: Optional[DeviceLike] = None,
) -> torch.Tensor:
    """Online projection: a CUR index with every train row as an anchor
    and the given anchor items, then ``get_complete_row`` of the unseen
    test rows (reference: :286-303); (n_test, n_ents) on ``device``
    (default: train_scores's device if it is a tensor, else the card)."""
    train = on_device(train_scores, device)
    ids = torch.as_tensor(np.asarray(anchor_ents, np.int64), device=train.device)
    index = build_cur(
        rows=train,
        cols=train[:, ids],
        row_idxs=np.arange(train.shape[0]),
        col_idxs=anchor_ents,
        approx_preference="rows",
        validate=False,
        rcond=rcond,
    )
    return index.get_complete_row(on_device(test_anchor_scores, train.device))


def _write(result: Dict, res_dir: str, method: str, seed: int, misc: str) -> None:
    out_dir = os.path.join(res_dir, f"method={method}_s={seed}{misc}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "res.json"), "w") as fout:
        json.dump(result, fout, indent=4)


def run_inductive_eval(
    test_scores: np.ndarray,  # (n_test, n_ents) exact matrix (ground truth)
    train_scores: Optional[np.ndarray],  # (n_train, n_ents), needed for cur
    res_dir: str,
    method: str = "cur",
    seed: int = 0,
    top_k_vals: Optional[Sequence[int]] = None,
    top_k_retvr_vals: Optional[Sequence[int]] = None,
    n_ent_anchors_vals: Optional[Sequence[int]] = None,
    bienc_scores: Optional[np.ndarray] = None,  # (n_test, n_ents)
    tfidf_scores: Optional[np.ndarray] = None,  # (n_test, n_ents)
    ent_to_ent_data: Optional[Dict] = None,  # {'scores': (n_e,k), 'anchor_ents': (k,)}
    misc: str = "",
    rcond=None,  # pinv cutoff for CUR methods: None | float | 'noise'
    device: DeviceLike = "cuda",
) -> Dict:
    """Per-seed nested result dict {top_k -> k_retvr -> anc_n_e -> metrics}
    written to ``res_dir/method={method}_s={seed}{misc}/res.json``. The
    projections (cur, fixed_anc_ent*) run on ``device`` (raises without CUDA
    unless ``device="cpu"``); the grid eval and the adaptive methods' host
    loops read the host copy."""
    from anncur_tpu_torch.evalx.transductive import (
        fixed_anc_ent_approx,
        fixed_anc_ent_cur_approx,
        sample_anchors,
    )

    test_host = np.asarray(test_scores, np.float32)
    n_test, n_ents = test_host.shape
    top_k_vals = list(top_k_vals or TOP_K_VALS)

    is_budget_method = "cur" in method or "fixed_anc_ent" in method
    if top_k_retvr_vals is None:
        top_k_retvr_vals = cur_retvr_grid() if is_budget_method else list(TOP_K_RETVR_BASE)
    top_k_retvr_vals = sorted(set(int(v) for v in top_k_retvr_vals if 1 <= v <= n_ents))

    if n_ent_anchors_vals is None:
        base = [10, 50, 100, 200, 500, 1000, 2000]
        n_ent_anchors_vals = sorted(set([v for v in base if v < n_ents] + [n_ents]))
    n_ent_anchors_vals = [v for v in n_ent_anchors_vals if v <= n_ents]

    rng = np.random.default_rng(seed=seed)

    # approximate test-mention scores per anchor budget
    approx_per_budget: Dict[int, object] = {}
    if method == "cur":
        if train_scores is None:
            raise ValueError("method 'cur' requires train_scores")
        train_dev = on_device(np.asarray(train_scores, np.float32), device)  # one upload each
        test_dev = on_device(test_host, device)
        for n_anc in n_ent_anchors_vals:
            anchor_ents = np.asarray(sorted(rng.choice(n_ents, size=n_anc, replace=False)))
            ids = torch.as_tensor(anchor_ents, device=test_dev.device)
            approx_per_budget[n_anc] = cur_project_test_scores(
                train_dev, test_dev[:, ids], anchor_ents, rcond=rcond
            )
    elif method == "bienc":
        if bienc_scores is None:
            raise ValueError("method 'bienc' requires bienc_scores")
        approx_per_budget = dict.fromkeys(n_ent_anchors_vals, np.asarray(bienc_scores))
    elif method == "tfidf":
        if tfidf_scores is None:
            raise ValueError("method 'tfidf' requires tfidf_scores")
        approx_per_budget = dict.fromkeys(n_ent_anchors_vals, np.asarray(tfidf_scores))
    elif method == "fixed_anc_ent":
        if ent_to_ent_data is None:
            raise ValueError("method 'fixed_anc_ent' requires ent_to_ent_data")
        scores = to_host(fixed_anc_ent_approx(
            test_host, ent_to_ent_data["scores"], ent_to_ent_data["anchor_ents"], device=device
        ))
        approx_per_budget = dict.fromkeys(n_ent_anchors_vals, scores)
    elif method == "fixed_anc_ent_cur":
        if ent_to_ent_data is None:
            raise ValueError("method 'fixed_anc_ent_cur' requires ent_to_ent_data")
        # ONE advancing rng across successive anchor budgets (the reference
        # draws every anchor set from a single rng,
        # run_..._w_fixed_train_test_splits.py:343-348)
        e2e = np.asarray(ent_to_ent_data["scores"])
        fae_rng = np.random.default_rng(seed=seed)
        test_dev = on_device(test_host, device)
        for n_anc in n_ent_anchors_vals:
            approx_per_budget[n_anc] = fixed_anc_ent_cur_approx(
                test_dev, e2e, n_anc, anchor_idxs=sample_anchors(fae_rng, e2e.shape[0], n_anc)
            )
    elif method in ("adaptive_cur", "axn"):
        return _run_adaptive(method, test_host, train_scores, res_dir, seed, top_k_vals,
                             n_ent_anchors_vals, misc, device)
    else:
        raise NotImplementedError(f"method={method!r}")

    result: Dict = defaultdict(lambda: defaultdict(dict))
    # each distinct approximation is evaluated once over the whole grid
    # (bienc/tfidf/fixed_anc_ent map every anchor budget to one array)
    grid_cache: Dict[int, Dict] = {}
    for n_anc, approx in approx_per_budget.items():
        key = id(approx)
        if key not in grid_cache:
            grid_cache[key] = eval_approx_grid(test_host, to_host(approx), top_k_vals, top_k_retvr_vals)
        for top_k_retvr, per_topk in grid_cache[key].items():
            for top_k, metrics in per_topk.items():
                result[f"top_k={top_k}"][f"k_retvr={top_k_retvr}"][f"anc_n_e={n_anc}"] = metrics

    result = json.loads(json.dumps(result))
    result["other_args"] = {
        "method": method,
        "seed": seed,
        "top_k_vals": top_k_vals,
        "top_k_retvr_vals": top_k_retvr_vals,
        "n_ent_anchors_vals": list(n_ent_anchors_vals),
        "n_test": n_test,
        "n_ents": n_ents,
        "cost_model": "cost = top_k_retvr + n_ent_anchors for cur, "
        "top_k_retvr for bienc/tfidf",
    }
    _write(result, res_dir, method, seed, misc)
    return result


def _run_adaptive(method, test_host, train_scores, res_dir, seed, top_k_vals, n_ent_anchors_vals, misc, device):
    """The adaptive multi-round methods: the whole CE budget is spent in
    host rounds (``core/adaptive.py``, ``core/axn.py``), recorded under
    k_retvr=0 so cost = n_ent_anchors (the total budget)."""
    if train_scores is None:
        raise ValueError(f"method {method!r} requires train_scores")
    n_test, n_ents = test_host.shape
    train_np = np.asarray(train_scores, np.float32)

    def score_items_fn(ids):
        return test_host[:, ids]

    order = np.argsort(-test_host, axis=1)  # once; slice per k
    result: Dict = defaultdict(lambda: defaultdict(dict))
    max_k = max(top_k_vals)
    for budget in n_ent_anchors_vals:
        if budget < max_k:
            continue
        if method == "adaptive_cur":
            from anncur_tpu_torch.core.adaptive import adaptive_cur_query

            _, ids, _ = adaptive_cur_query(
                train_np, score_items_fn, n_ents, budget, n_rounds=3, top_k=max_k, seed=seed,
            )
        else:
            from anncur_tpu_torch.core.axn import axn_query, fit_item_embeddings

            index = fit_item_embeddings(train_np, rank=min(128, train_np.shape[0]), device=device)
            _, ids = axn_query(index, score_items_fn, n_ents, budget, n_rounds=3, top_k=max_k, seed=seed)
        for k in top_k_vals:
            result[f"top_k={k}"]["k_retvr=0"][f"anc_n_e={budget}"] = _overlap_stats(
                order[:, :k], np.asarray(ids)[:, :k], k
            )
    result = json.loads(json.dumps(result))
    result["other_args"] = {
        "method": method, "seed": seed, "top_k_vals": top_k_vals,
        "n_ent_anchors_vals": list(n_ent_anchors_vals),
        "n_test": n_test, "n_ents": n_ents,
        "cost_model": "cost = n_ent_anchors (total adaptive CE budget)",
    }
    _write(result, res_dir, method, seed, misc)
    return result
