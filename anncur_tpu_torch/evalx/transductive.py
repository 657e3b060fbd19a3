"""Transductive retrieval eval: approximate one precomputed score matrix
from sampled anchor rows/cols and measure top-k recall of retrieve(approx)
-> rerank(exact) against the exact ranking.

Counterpart of ``anncur_tpu/evalx/transductive.py`` (parity with
eval/run_retrieval_eval_wrt_exact_crossenc.py:47-399): methods {cur,
cur_oracle, bienc, fixed_anc_ent, fixed_anc_ent_cur_N}, sweeps over
(top_k, top_k_retvr, n_ment_anchors, n_ent_anchors) x seeds,
anchor/non_anchor/all mention splits, the same anchor sampling
(``np.random.default_rng(seed).choice`` without replacement, sorted) and
the same nested result-JSON schema. The score matrix is uploaded to
``device`` once; every grid point's approximation, ranking and errors stay
there (``evalx/core.py``), and products run in true f32.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from anncur_tpu_torch.core.cur import build_cur_from_matrix
from anncur_tpu_torch.evalx.core import eval_split_overlap, on_device
from anncur_tpu_torch.ops.pinv import pinv_f64
from anncur_tpu_torch.utils.device import DeviceLike, true_f32

LOGGER = logging.getLogger(__name__)

DEFAULT_N_MENT_ANCHORS = [50, 100, 200, 500, 1000, 2000, 5000]
DEFAULT_N_ENT_ANCHORS = [50, 100, 200, 500, 1000, 2000]
DEFAULT_TOP_K = [1, 10, 50, 100]
DEFAULT_TOP_K_RETVR = [100, 500, 1000]


def sample_anchors(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Sorted sample without replacement, bit-identical to the reference
    (run_retrieval_eval_wrt_exact_crossenc.py:69-70)."""
    return np.asarray(sorted(rng.choice(n, size=size, replace=False)))


def run_approx_eval_w_seed(
    approx_method: str,
    exact,
    n_ment_anchors: int,
    n_ent_anchors: int,
    top_k: int,
    top_k_retvr: int,
    seed: int,
    precomp_approx=None,
    rcond: Optional[float] = None,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Dict[str, float]]:
    """One (seed, grid-point) evaluation (reference: run_approx_eval_w_seed,
    :47-158). ``exact`` and ``precomp_approx``: numpy or tensors, used on
    ``device`` (default: exact's device if it is a tensor, else the card).
    ``rcond``: the pinv cutoff (None: f32-eps relative, ``ops/pinv.py``)."""
    exact = on_device(exact, device)
    n_ments, n_ents = exact.shape
    rng = np.random.default_rng(seed=seed)
    anchor_ments = sample_anchors(rng, n_ments, n_ment_anchors)
    anchor_ents = sample_anchors(rng, n_ents, n_ent_anchors)
    non_anchor_ments = np.setdiff1d(np.arange(n_ments), anchor_ments)

    if approx_method in ("bienc", "fixed_anc_ent") or approx_method.startswith("fixed_anc_ent_cur_"):
        if precomp_approx is None:
            raise ValueError(f"method {approx_method} needs precomputed approx scores")
        approx = precomp_approx
    elif approx_method in ("cur", "cur_oracle"):
        index = build_cur_from_matrix(
            exact, anchor_ments, anchor_ents, approx_preference="rows",
            oracle=approx_method == "cur_oracle", rcond=rcond,
        )
        approx = index.reconstruct()
    else:
        raise NotImplementedError(f"approx_method={approx_method!r}")

    return eval_split_overlap(
        exact, approx, top_k, top_k_retvr,
        {"anchor": anchor_ments, "non_anchor": non_anchor_ments, "all": np.arange(n_ments)},
    )


def run_approx_eval(
    approx_method: str,
    exact,
    n_ment_anchors: int,
    n_ent_anchors: int,
    top_k: int,
    top_k_retvr: int,
    n_seeds: int,
    precomp_approx=None,
    rcond=None,
    device: Optional[DeviceLike] = None,
) -> Dict[str, Dict[str, float]]:
    """Mean over seeds 0..n_seeds-1 (reference: run_approx_eval, :162-200)."""
    acc: Dict[str, Dict[str, List[float]]] = defaultdict(lambda: defaultdict(list))
    for seed in range(n_seeds):
        res = run_approx_eval_w_seed(
            approx_method, exact, n_ment_anchors, n_ent_anchors, top_k, top_k_retvr,
            seed, precomp_approx, rcond=rcond, device=device,
        )
        for split, metrics in res.items():
            for metric, val in metrics.items():
                acc[split][metric].append(float(val))
    return {
        split: {metric: float(np.mean(vals)) for metric, vals in metrics.items()}
        for split, metrics in acc.items()
    }


def fixed_anc_ent_approx(
    exact,
    ent_to_ent_scores: np.ndarray,  # (n_ents, n_anchors)
    anchor_ents: np.ndarray,  # (n_anchors,)
    device: Optional[DeviceLike] = None,
) -> torch.Tensor:
    """Fixed-anchor-entity baseline: entity 'embeddings' are their CE
    scores against a fixed anchor-entity set, a mention's its scores with
    the same anchors (reference: run_retrieval_eval_wrt_exact_crossenc.py:
    288-309); the product in true f32 on ``device``."""
    exact = on_device(exact, device)
    e2e = on_device(ent_to_ent_scores, exact.device)
    ids = torch.as_tensor(np.asarray(anchor_ents, np.int64), device=exact.device)
    with true_f32():
        return exact[:, ids] @ e2e.T


def fixed_anc_ent_cur_approx(
    exact,
    ent_to_ent_scores: np.ndarray,  # (n_ents, n_fixed_anchors)
    n_ent_anchors: int,
    seed: int = 0,
    anchor_idxs: Optional[np.ndarray] = None,
    device: Optional[DeviceLike] = None,
) -> torch.Tensor:
    """CUR on top of the fixed-anchor ent2ent matrix (reference: :310-346):
    R = e2e.T, U = pinv(R[:, anc]) in f64 on the host,
    approx = M[:, anc] @ (U @ R) in true f32 on ``device``.

    ``anchor_idxs``: pre-sampled anchors, to replicate the reference's
    single advancing rng across successive n_ent_anchors values
    (:func:`run_transductive_eval` does); the ``seed`` fallback draws a
    fresh rng and matches the reference only for the first value."""
    exact = on_device(exact, device)
    n_ents = ent_to_ent_scores.shape[0]
    if anchor_idxs is None:
        anchor_idxs = sample_anchors(np.random.default_rng(seed=seed), n_ents, n_ent_anchors)
    r = np.asarray(ent_to_ent_scores).T  # (n_fixed, n_ents)
    u = pinv_f64(r[:, anchor_idxs])  # (n_anc, n_fixed)
    ur = on_device((u @ r.astype(np.float64)).astype(np.float32), exact.device)  # (n_anc, n_ents)
    ids = torch.as_tensor(np.asarray(anchor_idxs, np.int64), device=exact.device)
    with true_f32():
        return exact[:, ids] @ ur


def run_transductive_eval(
    exact: np.ndarray,
    res_dir: str,
    methods: Sequence[str] = ("cur", "cur_oracle"),
    n_seeds: int = 1,
    n_ment_anchors_vals: Optional[Sequence[int]] = None,
    n_ent_anchors_vals: Optional[Sequence[int]] = None,
    top_k_vals: Optional[Sequence[int]] = None,
    top_k_retvr_vals: Optional[Sequence[int]] = None,
    bienc_scores: Optional[np.ndarray] = None,
    ent_to_ent_data: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
    misc: str = "",
    progress_cb=None,
    rcond=None,  # pinv cutoff for cur methods: None | float | 'noise'
    device: DeviceLike = "cuda",
) -> Dict:
    """The full sweep, written to ``res_dir/retrieval_wrt_exact_crossenc.json``
    with the reference's schema (run, :203-399):
    eval_res[method][top_k=K][k_retvr=R][anc_n_m=M~anc_n_e=E] ->
    {anchor|non_anchor|all: {metric: value}}, plus ``other_args``.

    ``bienc_scores``: a precomputed (n_m, n_e) dual-encoder score matrix
    (method 'bienc'). ``ent_to_ent_data``: {n_anchors: {'scores': (n_e, k),
    'anchor_ents': (k,)}} for the fixed_anc_ent methods. Runs on ``device``
    (raises without CUDA unless ``device="cpu"``)."""
    # one upload; every grid point reads the device copy
    exact = on_device(exact, device)
    total_n_ment, total_n_ent = exact.shape

    n_ment_anchors_vals = [v for v in (n_ment_anchors_vals or DEFAULT_N_MENT_ANCHORS) if v <= total_n_ment]
    if n_ent_anchors_vals is None:
        n_ent_anchors_vals = [v for v in DEFAULT_N_ENT_ANCHORS if v < total_n_ent] + [total_n_ent]
    else:
        dropped = [v for v in n_ent_anchors_vals if v > total_n_ent]
        n_ent_anchors_vals = [v for v in n_ent_anchors_vals if v <= total_n_ent]
        if dropped:
            LOGGER.warning("n_ent_anchors values %s exceed n_ents=%d; dropped", dropped, total_n_ent)
        if not n_ent_anchors_vals:
            raise ValueError(f"every n_ent_anchors value exceeds n_ents={total_n_ent}")
    top_k_vals = list(top_k_vals or [10])
    top_k_retvr_vals = list(top_k_retvr_vals or [500])

    os.makedirs(res_dir, exist_ok=True)
    eval_res: Dict = defaultdict(lambda: defaultdict(lambda: defaultdict(dict)))

    for method in methods:
        LOGGER.info("transductive eval: method=%s", method)
        precomp: Dict[int, Optional[torch.Tensor]] = {}
        if method == "bienc":
            if bienc_scores is None:
                LOGGER.warning("method 'bienc' skipped: no bienc_scores provided")
                continue
            bienc_dev = on_device(bienc_scores, exact.device)  # one upload
            precomp = {v: bienc_dev for v in n_ent_anchors_vals}
        elif method in ("cur", "cur_oracle"):
            precomp = {v: None for v in n_ent_anchors_vals}
        elif method == "fixed_anc_ent":
            if not ent_to_ent_data:
                LOGGER.warning("method 'fixed_anc_ent' skipped: no ent_to_ent_data")
                continue
            precomp = {
                n_anc: fixed_anc_ent_approx(exact, d["scores"], d["anchor_ents"])
                for n_anc, d in ent_to_ent_data.items()
                if n_anc in n_ent_anchors_vals
            }
        elif method.startswith("fixed_anc_ent_cur_"):
            if not ent_to_ent_data:
                LOGGER.warning("%s skipped: no ent_to_ent_data", method)
                continue
            n_fixed = int(method[len("fixed_anc_ent_cur_"):])
            if n_fixed not in ent_to_ent_data:
                LOGGER.warning("%s skipped: no e2e data for %d anchors", method, n_fixed)
                continue
            e2e = np.asarray(ent_to_ent_data[n_fixed]["scores"])
            # ONE advancing rng across successive n_ent_anchors values: the
            # reference draws every anchor set from a single rng(0)
            # (run_retrieval_eval_wrt_exact_crossenc.py:330-346)
            fae_rng = np.random.default_rng(seed=0)
            precomp = {
                v: fixed_anc_ent_cur_approx(exact, e2e, v, anchor_idxs=sample_anchors(fae_rng, e2e.shape[0], v))
                for v in n_ent_anchors_vals
            }
        else:
            raise NotImplementedError(f"method={method!r}")

        grid = list(itertools.product(top_k_vals, top_k_retvr_vals, n_ment_anchors_vals, n_ent_anchors_vals))
        for ctr, (top_k, top_k_retvr, n_ment_anchors, n_ent_anchors) in enumerate(grid):
            if progress_cb:
                progress_cb(method, ctr / len(grid))
            if top_k_retvr < top_k or top_k_retvr > total_n_ent:
                continue
            if n_ent_anchors not in precomp:
                continue
            key_k, key_r = f"top_k={top_k}", f"k_retvr={top_k_retvr}"
            key_a = f"anc_n_m={n_ment_anchors}~anc_n_e={n_ent_anchors}"
            if method == "bienc":
                # anchor-independent: reuse the first grid point (reference :362-370)
                first = f"anc_n_m={n_ment_anchors_vals[0]}~anc_n_e={n_ent_anchors_vals[0]}"
                if key_a != first and first in eval_res[method][key_k][key_r]:
                    eval_res[method][key_k][key_r][key_a] = eval_res[method][key_k][key_r][first]
                    continue
            eval_res[method][key_k][key_r][key_a] = run_approx_eval(
                approx_method=method,
                exact=exact,
                n_ment_anchors=n_ment_anchors,
                n_ent_anchors=n_ent_anchors,
                top_k=top_k,
                top_k_retvr=top_k_retvr,
                n_seeds=n_seeds,
                precomp_approx=precomp[n_ent_anchors],
                rcond=rcond,
            )

    eval_res = json.loads(json.dumps(eval_res))  # defaultdict -> dict
    eval_res["other_args"] = {
        "top_k_vals": top_k_vals,
        "top_k_retr_vals": top_k_retvr_vals,
        "n_ent_anchors_vals": n_ent_anchors_vals,
        "n_ment_anchors_vals": n_ment_anchors_vals,
        "n_seeds": n_seeds,
        "misc": misc,
    }
    out_path = os.path.join(res_dir, "retrieval_wrt_exact_crossenc.json")
    with open(out_path, "w") as fout:
        json.dump(eval_res, fout, indent=4)
    LOGGER.info("wrote %s", out_path)
    return eval_res
