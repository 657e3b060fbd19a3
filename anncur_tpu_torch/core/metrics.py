"""Ranking metrics in plain PyTorch.

Counterpart of ``anncur_tpu/core/metrics.py`` (reference
eval/eval_utils.py:19-56, 115-150): reciprocal rank vs the gold label,
acc/MRR/recall@{1,5,10,64}, pairwise top-k set overlap and the Frobenius
approximation error, as array ops without per-example Python loops.
Inputs are tensors or numpy arrays; every function accepts either.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def reciprocal_ranks(gt_labels, pred_indices, pred_scores) -> torch.Tensor:
    """(q,) reciprocal rank of each gold label among the predictions
    sorted by score descending (ties keep their order); 0.0 where the gold
    label is absent (eval/eval_utils.py:19-29)."""
    gt_labels, pred_indices, pred_scores = _t(gt_labels), _t(pred_indices), _t(pred_scores)
    order = torch.sort(-pred_scores, dim=1, stable=True).indices
    hits = torch.gather(pred_indices, 1, order) == gt_labels[:, None]  # (q, k)
    pos = hits.int().argmax(dim=1)  # first True (0 if none)
    return torch.where(hits.any(dim=1), 1.0 / (pos + 1.0), 0.0)


def score_topk_preds(gt_labels, pred_indices, pred_scores) -> Dict[str, str]:
    """acc / mrr / recall@{1,5,10,64} (+ normalized variants) as "%.2f"
    strings, the reference's format (eval/eval_utils.py:47-55)."""
    rr = reciprocal_ranks(gt_labels, pred_indices, pred_scores).cpu().numpy()
    found = rr > 0
    with np.errstate(invalid="ignore"):
        norm_acc = float(np.mean(rr[found] == 1)) if found.any() else float("nan")
        norm_mrr = float(np.mean(rr[found])) if found.any() else float("nan")
    return {
        "acc": "{:.2f}".format(100 * np.mean(rr == 1)),
        "mrr": "{:.2f}".format(100 * np.mean(rr)),
        "recall": "{:.2f}".format(100 * np.mean(rr > 0)),
        "recall_5": "{:.2f}".format(100 * np.mean(rr > 1 / 6)),
        "recall_10": "{:.2f}".format(100 * np.mean(rr > 1 / 11)),
        "recall_64": "{:.2f}".format(100 * np.mean(rr > 1 / 65)),
        "norm_acc": "{:.2f}".format(100 * norm_acc),
        "norm_mrr": "{:.2f}".format(100 * norm_mrr),
    }


def topk_overlap_frac(indices_a, indices_b) -> torch.Tensor:
    """Per-row |set(a) ∩ set(b)| / k for two (q, k) index arrays, each row
    of distinct entries (true of top-k outputs)."""
    indices_a, indices_b = _t(indices_a), _t(indices_b).to(_t(indices_a).device)
    inter = (indices_a[:, :, None] == indices_b[:, None, :]).sum(dim=(1, 2))
    return inter.float() / indices_a.shape[1]


def overlap_metrics(indices_a, indices_b) -> Dict[str, tuple]:
    """mean/std/p50 strings per overlap metric (eval/eval_utils.py:115-138)."""
    metrics = ["common", "diff", "total", "common_frac", "diff_frac"]
    indices_a, indices_b = _t(indices_a), _t(indices_b)
    if indices_a.shape[0] == 0:
        return {m: ("mean 0.0", "std 0.0", "p50 0.0") for m in metrics}
    k = indices_a.shape[1]
    common_frac = topk_overlap_frac(indices_a, indices_b).cpu().numpy()
    vals = {
        "common": common_frac * k,
        "diff": (1 - common_frac) * k,
        # the reference's total is k, not len1 + len2 (eval/eval_utils.py:143-149)
        "total": np.full_like(common_frac, k),
        "common_frac": common_frac,
        "diff_frac": 1 - common_frac,
    }
    return {
        m: (
            "mean {:.4f}".format(float(np.mean(v))),
            "std {:.4f}".format(float(np.std(v))),
            "p50 {:.4f}".format(float(np.percentile(v, 50))),
        )
        for m, v in vals.items()
    }


def frobenius_error(approx, exact) -> Dict[str, float]:
    """Absolute and relative Frobenius error of an approximation
    (eval/run_retrieval_eval_wrt_exact_crossenc.py:146-147), in f32."""
    approx, exact = _t(approx).float(), _t(exact).float().to(_t(approx).device)
    err = torch.linalg.norm(approx - exact)
    base = torch.linalg.norm(exact)
    return {
        "approx_error": float(err),
        "approx_error_relative": float(err / torch.clamp(base, min=1e-30)),
    }
